"""The evaluation runner (counterpart of ``rslo_tpu/eval/runner.py``):
``run_eval``, two-frame inference over an ordered split, odometries
chained into trajectories, KITTI metrics; and ``run_eval_refined``,
multi-frame windows fused by pose-graph refinement, optionally with
bundle adjustment per window and loop closing per sequence, on the eval
step's device.

Over a data mesh of D ranks (``train/distributed.py``) step i evaluates
windows i..i+D-1, one a rank (clamped at the last window, as JAX's
device batch is), and gathers every rank's results; the metrics, the
fusion and the loop closing then run on every rank alike.
"""
from __future__ import annotations

import collections
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict

import numpy as np
import torch

from ..config.schema import PipelineCfg
from ..data.loader import collate
from ..geometry.transforms import (np_calc_vo, np_compose_pose,
                                   np_invert_pose, odom_to_abs_pose)
from ..pgo.ba_bridge import cov_sqrt_info, refine_window_ba
from ..pgo.loop_closure import close_loops
from ..pgo.refine import (calibrate_pair_info, duplicate_pair_variance,
                          fuse_window_odometry, window_pairs_to_edges)
from ..train.distributed import all_gather
from .kitti_odometry import evaluate_sequence


def _gather_rows(row: np.ndarray, mesh) -> np.ndarray:
    """This rank's float32 row -> (D, len) every rank's, in rank order."""
    if mesh is None or mesh.group is None:
        return row[None]
    return all_gather(torch.from_numpy(row).to(mesh.device),
                      mesh).cpu().numpy()


def run_eval(eval_step: Callable, dataset, cfg: PipelineCfg, logger=None,
             max_windows: int | None = None,
             plot_dir: str | None = None, mesh=None) -> Dict[str, dict]:
    """eval_step: collated batch of one window -> odometry (1, P, 7) on
    its device, as ``Trainer.eval_fn()`` returns it (the JAX version
    takes the net, its variables and a mesh beside a jitted step; here
    the step carries the net and its device).  Iterates the ordered eval
    split, sharded over ``mesh``'s ranks when it has a process group;
    returns per-sequence metric dicts, their average and a ``_meta``
    block with the throughput."""
    n = len(dataset) if max_windows is None else min(len(dataset),
                                                    max_windows)
    D, r = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    preds = np.zeros((n, 7), np.float32)
    gts = np.zeros((n, 7), np.float32)
    seq_ids = np.zeros((n,), np.int64)
    pin = torch.cuda.is_available()

    def host_prep(i):
        """Store read + collate (+ pinning, so that the step's copy to
        the card is asynchronous) of this rank's window of step i:
        CPU-bound, run in threads."""
        samples = [dataset[min(i + r, n - 1)]]
        batch = collate(samples, cfg.data)
        batch = {k: torch.from_numpy(batch[k])
                 for k in ("points", "point_mask")}
        if pin:
            batch = {k: v.pin_memory() for k, v in batch.items()}
        return i, samples, batch

    def dispatch(prepped):
        i, samples, batch = prepped
        return i, samples, eval_step(batch)

    def record(i, samples, out):
        out = out.cpu().numpy()      # the one wait for the device a window
        s = samples[0]
        rows = _gather_rows(np.concatenate(
            [out[0, 0], s["odometry"][0], [s["seq"]]]).astype(np.float32),
            mesh)
        for d in range(min(D, n - i)):
            preds[i + d] = rows[d, :7]
            gts[i + d] = rows[d, 7:14]
            seq_ids[i + d] = int(rows[d, 14])

    # warm-up outside the clock: the first window pays the kernels'
    # first launches and the allocator's growth
    t_warm = time.time()
    record(*dispatch(host_prep(0)))
    t_warm = time.time() - t_warm
    t0 = time.time()

    # a thread pool prepares windows ahead (store reads and padding),
    # and up to 3 windows are in flight on the card before the host
    # waits for the oldest
    inflight = collections.deque()
    with ThreadPoolExecutor(max_workers=2) as pool:
        prep = collections.deque()
        nxt = D  # windows 0..D-1 done in warm-up
        while nxt < n or prep or inflight:
            while nxt < n and len(prep) < 4:
                prep.append(pool.submit(host_prep, nxt))
                nxt += D
            while prep and prep[0].done() and len(inflight) < 3:
                inflight.append(dispatch(prep.popleft().result()))
            if not inflight:
                if prep:
                    inflight.append(dispatch(prep.popleft().result()))
                else:
                    break
            record(*inflight.popleft())
    elapsed = time.time() - t0
    if n > D:
        fps = (n - D) / max(elapsed, 1e-9)
    else:  # everything fit in the warm-up step
        elapsed, fps = t_warm, n / max(t_warm, 1e-9)

    results: Dict[str, dict] = {"_meta": {"windows": n,
                                          "elapsed_s": elapsed,
                                          "frames_per_s": fps}}
    for s in np.unique(seq_ids):
        m = seq_ids == s
        pred_odoms = np.concatenate(
            [np.array([[0, 0, 0, 1, 0, 0, 0]], np.float32), preds[m]])
        gt_odoms = np.concatenate(
            [np.array([[0, 0, 0, 1, 0, 0, 0]], np.float32), gts[m]])
        pred_abs = odom_to_abs_pose(pred_odoms)
        gt_abs = odom_to_abs_pose(gt_odoms)
        entry = evaluate_sequence(pred_abs, gt_abs)
        # frame-level odometry errors: the segment metrics chain poses
        # and are chaotic while per-frame error is still large, so the
        # steadier per-frame numbers are reported alongside
        dt = np.linalg.norm(preds[m][:, :3] - gts[m][:, :3], axis=1)
        qd = np.abs(np.sum(preds[m][:, 3:] * gts[m][:, 3:], axis=1))
        qd /= np.maximum(np.linalg.norm(preds[m][:, 3:], axis=1), 1e-9)
        entry["frame_t_err_m"] = float(dt.mean())
        entry["frame_q_err_deg"] = float(np.mean(
            2 * np.arccos(np.clip(qd, 0.0, 1.0)) * 180.0 / np.pi))
        results[f"seq_{int(s):02d}"] = entry
        if plot_dir is not None:
            from .trajectory import draw_trajectory
            draw_trajectory(pred_abs, gt_abs, title=f"seq {int(s):02d}",
                            save_path=f"{plot_dir}/traj_{int(s):02d}.png")
    seq_keys = [k for k in results if k.startswith("seq_")]
    if seq_keys:
        results["avg"] = {
            "t_rel_pct": float(np.mean(
                [results[k]["t_rel_pct"] for k in seq_keys])),
            "r_rel_deg_per_100m": float(np.mean(
                [results[k]["r_rel_deg_per_100m"] for k in seq_keys])),
            "ate_rmse_m": float(np.mean(
                [results[k]["ate_rmse_m"] for k in seq_keys])),
            "frame_t_err_m": float(np.mean(
                [results[k]["frame_t_err_m"] for k in seq_keys])),
            "frame_q_err_deg": float(np.mean(
                [results[k]["frame_q_err_deg"] for k in seq_keys])),
        }
    if logger is not None:
        logger.log_text(f"eval: {n} windows in {elapsed:.1f}s "
                        f"({fps:.2f}/s)")
    return results


def run_eval_refined(eval_step: Callable, dataset, cfg: PipelineCfg,
                     logger=None, max_windows: int | None = None,
                     window: int = 64, overlap: int = 16,
                     iters: int = 8, use_ba: bool = False,
                     ba_points: int = 4096, use_loops: bool = False,
                     loop_min_separation: int = 50,
                     loop_score_threshold: float = 0.8,
                     loop_points: int = 4096,
                     eval_step_cov: Callable | None = None,
                     plot_dir: str | None = None,
                     mesh=None) -> Dict[str, dict]:
    """Multi-frame-window eval + pose-graph refinement.  Needs an eval
    split with seq_length >= 3, so that windows contribute redundant
    (i, i+2) edges.  ``eval_step`` is ``Trainer.eval_fn()``'s: collated
    batch of one window -> odometry (1, P, 7) on its device, where the
    pose graph, BA and ICP then run.

    ``use_ba`` additionally runs geometric bundle adjustment per window
    (pgo/ba_bridge.py): the window's point clouds are associated into
    landmark tracks under the predicted motions and the window poses are
    re-estimated by Schur-complement BA before the global fusion.  When
    ``eval_step_cov`` (``Trainer.eval_fn(with_cov=True)``) is supplied,
    BA takes the network's voxel points with full 3x3
    covariance-whitened observations (cov_sqrt_info); otherwise the raw
    clouds with unit weights.

    ``use_loops`` runs a loop-closure pass (pgo/loop_closure.py) over
    each sequence's fused trajectory: polar-descriptor place
    recognition, ICP loop edges, pose-graph re-optimization.  The
    result has the JAX version's keys.  Sharded over ``mesh``'s ranks as
    ``run_eval``: each rank evaluates (and, under ``use_ba``, adjusts)
    its own window of a step, then the windows' pair motions, frames and
    loop clouds are gathered."""
    n = len(dataset) if max_windows is None else min(len(dataset),
                                                    max_windows)
    sample0 = dataset[0]
    L = len(sample0["points"])
    n_pairs = L * (L - 1) // 2
    offsets = [(i, j) for i in range(L) for j in range(i + 1, L)]

    preds = np.zeros((n, n_pairs, 7), np.float32)
    gts = np.zeros((n, n_pairs, 7), np.float32)
    seq_ids = np.zeros((n,), np.int64)
    starts = np.zeros((n,), np.int64)
    frame_clouds: Dict[tuple, np.ndarray] = {}

    def loop_cloud(pts_raw):
        p = np.asarray(pts_raw)[:, :3].astype(np.float32)
        step = max(1, len(p) // loop_points)
        p = p[::step][:loop_points]
        if len(p) < loop_points:   # pad by repetition: fixed ICP shapes
            p = np.concatenate(
                [p, p[np.arange(loop_points - len(p)) % len(p)]])
        return p

    D, r = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    t0 = time.time()
    use_cov_ba = use_ba and eval_step_cov is not None
    device = None
    for i in range(0, n, D):
        k = min(i + r, n - 1)
        sample = dataset[k] if k else sample0
        batch = collate([sample], cfg.data)
        batch = {key: torch.from_numpy(batch[key])
                 for key in ("points", "point_mask")}
        if use_cov_ba:
            out, vox_pts, vox_covs, vox_msk = eval_step_cov(batch)
            vox_pts = vox_pts.cpu().numpy()
            vox_covs = vox_covs.cpu().numpy()
            vox_msk = vox_msk.cpu().numpy()
        else:
            out = eval_step(batch)
        device = out.device
        pred = out.cpu().numpy()[0]
        if use_ba:
            consec = [pred[offsets.index((t, t + 1))]
                      for t in range(L - 1)]
            if use_cov_ba:
                # network voxel centroids + full-covariance whitening
                # from the uncertainty head
                pts, wts = [], []
                for t in range(L):
                    m = vox_msk[0, t]
                    p = vox_pts[0, t][m]
                    c = vox_covs[0, t][m]
                    step_n = max(1, len(p) // ba_points)
                    pts.append(p[::step_n][:ba_points])
                    wts.append(cov_sqrt_info(c[::step_n][:ba_points]))
                refined_poses = refine_window_ba(
                    pts, np.stack(consec), point_weights=wts,
                    device=device)
            else:
                pts = [np.asarray(sample["points"][t])[:, :3]
                       [::max(1, len(sample["points"][t]) // ba_points)]
                       for t in range(L)]
                refined_poses = refine_window_ba(pts, np.stack(consec),
                                                 device=device)
            for p_i, (a, b) in enumerate(offsets):
                pred[p_i] = np_calc_vo(refined_poses[a][None],
                                       refined_poses[b][None])[0]
        row = [pred.ravel(), np.asarray(sample["odometry"]).ravel(),
               [sample["seq"]], sample["frames"]]
        if use_loops:
            row += [loop_cloud(sample["points"][t]).ravel()
                    for t in range(L)]
        rows = _gather_rows(np.concatenate(row).astype(np.float32), mesh)
        for d in range(min(D, n - i)):
            row = rows[d]
            preds[i + d] = row[:n_pairs * 7].reshape(n_pairs, 7)
            gts[i + d] = row[n_pairs * 7:n_pairs * 14].reshape(n_pairs, 7)
            seq = int(row[n_pairs * 14])
            frames = row[n_pairs * 14 + 1:n_pairs * 14 + 1 + L].astype(int)
            seq_ids[i + d], starts[i + d] = seq, frames[0]
            if use_loops:
                clouds = row[n_pairs * 14 + 1 + L:].reshape(L, loop_points,
                                                             3)
                for t, fr in enumerate(frames):
                    frame_clouds.setdefault((seq, int(fr)), clouds[t])
    elapsed = time.time() - t0

    results: Dict[str, dict] = {"_meta": {"windows": n,
                                          "elapsed_s": elapsed,
                                          "refined": True}}
    for s in np.unique(seq_ids):
        m = seq_ids == s
        w_starts = starts[m]
        base = w_starts.min()
        w_starts = (w_starts - base).tolist()
        n_poses = max(w_starts) + L
        E, M, W = window_pairs_to_edges(w_starts, offsets, preds[m])
        # cycle-closure-calibrated per-class rotation and translation
        # information (uniform information makes the refined r_rel worse
        # than the chained one)
        dup = duplicate_pair_variance(w_starts, offsets, preds[m])
        info = calibrate_pair_info(E, M, W, dup_var=dup)
        refined = fuse_window_odometry(E, M, n_poses, W, window=window,
                                       overlap=overlap, iters=iters,
                                       pair_info=info, device=device)
        # unrefined chain + GT trajectory from consecutive edges
        Eg, Mg, _ = window_pairs_to_edges(w_starts, offsets, gts[m])
        lookup = {tuple(e): k for k, e in enumerate(Eg)}
        gt_odoms = np.zeros((n_poses, 7), np.float32)
        gt_odoms[:, 3] = 1.0
        chain = gt_odoms.copy()
        lookup_p = {tuple(e): k for k, e in enumerate(E)}
        for f in range(n_poses - 1):
            kgt = lookup.get((f, f + 1))
            kpr = lookup_p.get((f, f + 1))
            if kgt is not None:
                gt_odoms[f + 1] = Mg[kgt]
            if kpr is not None:
                chain[f + 1] = M[kpr]
        gt_abs = odom_to_abs_pose(gt_odoms)
        chain_abs = odom_to_abs_pose(chain)
        entry = {
            "refined": evaluate_sequence(refined, gt_abs),
            "chained": evaluate_sequence(chain_abs, gt_abs),
        }
        variants = {"chained": chain_abs, "refined": refined}
        if use_loops:
            have = [f for f in range(n_poses)
                    if (s, int(base) + f) in frame_clouds]
            if len(have) >= 2:
                # Loop-close over the subsequence of frames that have
                # clouds (all of them when windows are dense; the window
                # start/end keyframes when windows are strided), then
                # rigidly attach intermediate frames to the preceding
                # corrected keyframe.
                clouds = [frame_clouds[(s, int(base) + f)] for f in have]
                sub = refined[np.asarray(have)]
                r_odoms = np_compose_pose(np_invert_pose(sub[:-1]),
                                          sub[1:])
                # min_separation is in keyframe steps: rescale so the
                # temporal separation matches the dense-coverage case
                stride = max(1, (have[-1] - have[0]) //
                             max(1, len(have) - 1))
                sep = max(2, loop_min_separation // stride)
                lc_sub, cands = close_loops(
                    r_odoms, clouds, min_separation=sep,
                    score_threshold=loop_score_threshold, device=device)
                lc_abs = refined.copy()
                for k, f in enumerate(have):
                    delta = np_compose_pose(
                        lc_sub[k][None],
                        np_invert_pose(refined[f][None]))[0]
                    f_end = have[k + 1] if k + 1 < len(have) else n_poses
                    for g in range(f, f_end):
                        lc_abs[g] = np_compose_pose(
                            delta[None], refined[g][None])[0]
                entry["loop_closed"] = evaluate_sequence(lc_abs, gt_abs)
                entry["n_loops"] = int(len(cands.pairs))
                entry["loop_keyframes"] = len(have)
                variants["loop_closed"] = lc_abs
            else:
                entry["n_loops"] = -1   # no clouds kept: skipped
                if logger is not None:
                    logger.log_text(
                        f"seq {int(s):02d}: loop closing skipped "
                        f"({len(have)} keyframe clouds)")
        if plot_dir is not None:
            from .trajectory import draw_trajectories
            draw_trajectories(variants, gt_abs,
                              title=f"seq {int(s):02d} (refined eval)",
                              save_path=f"{plot_dir}/traj_refined_"
                                        f"{int(s):02d}.png")
        results[f"seq_{int(s):02d}"] = entry
    if logger is not None:
        logger.log_text(f"refined eval: {n} windows in {elapsed:.1f}s")
    return results
