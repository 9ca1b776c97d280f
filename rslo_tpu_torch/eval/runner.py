"""Evaluation driver on one card (counterpart of
``rslo_tpu/eval/runner.py::run_eval``): two-frame inference over an
ordered split, odometries chained into trajectories, KITTI metrics.
The refined evaluation (``run_eval_refined``: pose graph, bundle
adjustment, loop closing) is not ported yet.
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
from ..geometry.transforms import odom_to_abs_pose
from .kitti_odometry import evaluate_sequence


def run_eval(eval_step: Callable, dataset, cfg: PipelineCfg, logger=None,
             max_windows: int | None = None,
             plot_dir: str | None = None) -> Dict[str, dict]:
    """eval_step: collated batch of one window -> odometry (1, P, 7) on
    its device, as ``Trainer.eval_fn()`` returns it (the JAX version
    takes the net, its variables and a mesh beside a jitted step; here
    the step carries the net and its device).  Iterates the ordered eval
    split; returns per-sequence metric dicts, their average and a
    ``_meta`` block with the throughput."""
    n = len(dataset) if max_windows is None else min(len(dataset),
                                                    max_windows)
    preds = np.zeros((n, 7), np.float32)
    gts = np.zeros((n, 7), np.float32)
    seq_ids = np.zeros((n,), np.int64)
    pin = torch.cuda.is_available()

    def host_prep(i):
        """Store read + collate (+ pinning, so that the step's copy to
        the card is asynchronous): CPU-bound, run in threads."""
        samples = [dataset[i]]
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
        preds[i] = out[0, 0]
        gts[i] = samples[0]["odometry"][0]
        seq_ids[i] = samples[0]["seq"]

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
        nxt = 1  # window 0 done in warm-up
        while nxt < n or prep or inflight:
            while nxt < n and len(prep) < 4:
                prep.append(pool.submit(host_prep, nxt))
                nxt += 1
            while prep and prep[0].done() and len(inflight) < 3:
                inflight.append(dispatch(prep.popleft().result()))
            if not inflight:
                if prep:
                    inflight.append(dispatch(prep.popleft().result()))
                else:
                    break
            record(*inflight.popleft())
    elapsed = time.time() - t0
    if n > 1:
        fps = (n - 1) / max(elapsed, 1e-9)
    else:  # everything fit in the warm-up window
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
