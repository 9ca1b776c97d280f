"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference run on the same inputs from the same
weights.

Training (the first three steps of the object the window drives):
  * ``loss1_gap``: the first step's loss against the reference's, over
    its magnitude; ``loss_gap``: the widest gap of any step's loss, over
    the mean magnitude of the reference's three losses;
  * ``middle_gap``: the middle's output (the BEV features) of each frame
    of the first step, by the worst frame: the norm of the difference
    over the reference's norm;
  * ``grad_gap``: the first gradient as the optimizer got it (its first
    moment after one step over 1 - b1), by the worst leaf: the gap
    between the two norms over the reference's norm of that leaf or of
    the median leaf, whichever is larger;
  * ``grad_dir_gap``: the same by the norm of the difference (a
    gradient of the wrong sign reads 2);
  * ``change_gap``: the parameters' change after three steps, by the
    worst leaf likewise, over the leaves whose reference gradient is at
    least a thousandth of the median leaf's (under Adam a leaf with no
    gradient to speak of moves by round-off alone);
  * ``change_dir_gap``: the same leaves' change by the norm of the
    difference, ``|d_p - d_r|`` over ``|d_r|`` or the median leaf's
    (a change of the wrong sign or direction reads up to 2);
  * ``grad_median_gap``, ``grad_dir_median_gap``, ``change_median_gap``,
    ``change_dir_median_gap``: the same gaps of the median leaf;
and of the train data path (``data_numbers``), each check batch against
the reference's own build of the same window from the raw tree:
  * ``data_point_gap``: the widest gap of a valid point's x, y, z and
    reflectance (infinite where the masks differ or the window is not
    one the configuration draws);
  * ``data_normal_miss``: the share of valid points whose normal lies
    more than ``NORMAL_TOL`` off in a component;
  * ``data_odom_gap``: the widest gap of the pair motions' 7 numbers.
A cell compares the numbers its ``workloads/<cell>.json`` gives a
limit; the others are readings, printed beside them.
Streaming (a sample of the poses the window returned):
  * ``pose_t_gap_m``: the widest distance between a returned position
    and the reference's;
  * ``pose_r_gap_rad``: the widest angle between the orientations.
The reference's pose is its own odometry of the scan pair composed, in
float32 as the program composes it, with the pose the program returned
before: the stream is judged one answer at a time.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

GRAD_FLOOR = 1e-3     # of the median leaf's reference gradient norm
NORMAL_TOL = 1e-2     # a normal's component, for data_normal_miss


def _norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0):
    return {k: float(torch.linalg.vector_norm(v.double())) * scale
            for k, v in tensors.items()}


def train_numbers(prog: dict, refr: dict) -> Tuple[Dict[str, float], dict]:
    """``prog``/``refr``: {"loss": [3 floats], "mu1": {leaf: first moment
    after step 1}, "p0": {leaf: start}, "p3": {leaf: after step 3},
    "b1": Adam's b1 at step 1, "mid1": [the middle's output of each
    frame of step 1]}."""
    lp = np.asarray(prog["loss"], np.float64)
    lr = np.asarray(refr["loss"], np.float64)
    loss_gap = float(np.max(np.abs(lp - lr)) /
                     max(float(np.mean(np.abs(lr))), 1e-30))
    loss1_gap = float(abs(lp[0] - lr[0]) / max(abs(lr[0]), 1e-30))
    g_p = _norms(prog["mu1"], 1.0 / (1.0 - prog["b1"]))
    g_r = _norms(refr["mu1"], 1.0 / (1.0 - refr["b1"]))
    med_g = float(np.median(list(g_r.values())))
    grad = {k: abs(g_p[k] - g_r[k]) / max(g_r[k], med_g, 1e-30)
            for k in g_r}
    g_x = _norms({k: prog["mu1"][k] / (1.0 - prog["b1"]) -
                  refr["mu1"][k] / (1.0 - refr["b1"]) for k in g_r})
    grad_dir = {k: g_x[k] / max(g_r[k], med_g, 1e-30) for k in g_r}
    middle = max(float(torch.linalg.vector_norm((a - b).double()) /
                       max(float(torch.linalg.vector_norm(b.double())),
                           1e-30))
                 for a, b in zip(prog["mid1"], refr["mid1"]))
    moved = [k for k in g_r if g_r[k] >= GRAD_FLOOR * med_g]
    d_p = _norms({k: prog["p3"][k] - prog["p0"][k] for k in moved})
    d_r = _norms({k: refr["p3"][k] - refr["p0"][k] for k in moved})
    d_x = _norms({k: prog["p3"][k] - prog["p0"][k] -
                  (refr["p3"][k] - refr["p0"][k]) for k in moved})
    med_d = float(np.median(list(d_r.values())))
    change = {k: abs(d_p[k] - d_r[k]) / max(d_r[k], med_d, 1e-30)
              for k in moved}
    direction = {k: d_x[k] / max(d_r[k], med_d, 1e-30) for k in moved}
    unmoved = [k for k in moved if d_p[k] == 0.0]
    g_worst = max(grad, key=grad.get)
    c_worst = max(change, key=change.get)
    x_worst = max(direction, key=direction.get)
    numbers = {"loss1_gap": loss1_gap, "loss_gap": loss_gap,
               "middle_gap": middle,
               "grad_gap": grad[g_worst],
               "grad_dir_gap": max(grad_dir.values()),
               "change_gap": change[c_worst],
               "change_dir_gap": direction[x_worst],
               "grad_median_gap": float(np.median(list(grad.values()))),
               "grad_dir_median_gap": float(np.median(
                   list(grad_dir.values()))),
               "change_median_gap": float(np.median(list(change.values()))),
               "change_dir_median_gap": float(np.median(
                   list(direction.values())))}
    detail = {"loss_program": lp.tolist(), "loss_reference": lr.tolist(),
              "grad_worst_leaf": g_worst, "change_worst_leaf": c_worst,
              "change_dir_worst_leaf": x_worst,
              "unmoved": unmoved[:5], "n_unmoved": len(unmoved),
              "leaves": len(g_r), "leaves_moved": len(moved),
              "median_grad": med_g, "median_change": med_d}
    return numbers, detail


def data_numbers(prog: List[dict], refr: List[dict],
                 windows_ok: List[bool]) -> Dict[str, float]:
    """The program's check batches against the reference's (each a dict
    of ``points`` (L, N, 7), ``point_mask`` (L, N) and ``odometry``
    (P, 7) numpy arrays); ``windows_ok``: whether each batch's window is
    one the configuration draws."""
    point, miss, odom = 0.0, 0.0, 0.0
    for b, r, ok in zip(prog, refr, windows_ok):
        mask = np.asarray(b["point_mask"], bool)
        if not ok or not np.array_equal(mask, r["point_mask"]):
            point = float("inf")
            continue
        bp = np.asarray(b["points"])[mask]
        rp = r["points"][mask]
        point = max(point, float(np.max(np.abs(bp[:, :4] - rp[:, :4]))))
        off = np.max(np.abs(bp[:, 4:7] - rp[:, 4:7]), axis=1) > NORMAL_TOL
        miss = max(miss, float(np.mean(off)))
        odom = max(odom, float(np.max(np.abs(
            np.asarray(b["odometry"], np.float64) - r["odometry"]))))
    return {"data_point_gap": point, "data_normal_miss": miss,
            "data_odom_gap": odom}


def quat_angle(q1: np.ndarray, q2: np.ndarray) -> float:
    """Angle in radians between two (w, x, y, z) orientations."""
    q1 = np.asarray(q1, np.float64) / np.linalg.norm(q1)
    q2 = np.asarray(q2, np.float64) / np.linalg.norm(q2)
    if np.dot(q1, q2) < 0:
        q2 = -q2
    return float(2.0 * np.arctan2(np.linalg.norm(q1 - q2),
                                  np.linalg.norm(q1 + q2)))


def stream_numbers(pairs: List[Tuple[np.ndarray, np.ndarray]]
                   ) -> Dict[str, float]:
    """``pairs``: (program pose, reference pose), [t, q] each."""
    t = max(float(np.linalg.norm(np.asarray(p[:3], np.float64) -
                                 np.asarray(r[:3], np.float64)))
            for p, r in pairs)
    a = max(quat_angle(p[3:], r[3:]) for p, r in pairs)
    return {"pose_t_gap_m": t, "pose_r_gap_rad": a}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, number, limit)]) over the numbers that have a
    limit: each at or under it.  A cell without limits is not correct."""
    rows = [(k, numbers[k], lim) for k, lim in limits.items()]
    ok = bool(rows) and all(np.isfinite(v) and v <= lim
                            for _, v, lim in rows)
    return ok, rows


class FirstOutputs:
    """The first ``n`` outputs of ``module`` (the first element of a
    tuple), detached in float32 on the host, while the hook is
    installed."""

    def __init__(self, module, n: int):
        self.got = []

        def hook(mod, args, out):
            if len(self.got) < n:
                x = out[0] if isinstance(out, tuple) else out
                self.got.append(x.detach().float().cpu())

        self.handle = module.register_forward_hook(hook)

    def remove(self):
        self.handle.remove()
        return self.got


# ---- the reference's side ---------------------------------------------

def ref_frame_bev(ref, net, cfg, pts: torch.Tensor):
    """The reference's BEV features of one scan (N, F), all points
    valid, as the program's stream encodes a frame."""
    prep = ref.data.prepare
    mask = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    ex = prep.prepare_example(pts[None], mask[None],
                              prep.voxelizer_config(cfg),
                              mean_mode=prep.mean_vfe_ok(cfg))
    if prep.mean_vfe_ok(cfg):
        f = ex["voxel_features"][0]
    else:
        f = ref.models.vfe.simple_voxel_xyzi_normal(
            ex["voxels"][0], ex["num_points"][0],
            cfg.vfe.num_input_features)
    bev, _ = net.frame_features(f, ex["coords"][0], ex["voxel_mask"][0],
                                with_cov=False)
    return bev


@torch.no_grad()
def ref_pair_pose(ref, net, prev_bev, cur_bev, prev_pose):
    """The reference's answer to a push whose scan has the BEV features
    ``cur_bev``, after the scan of ``prev_bev``: its odometry of the
    pair composed in float32 with the pose returned before."""
    odom = net.pair_predict(prev_bev, cur_bev)
    odom = odom["odometry"][0].float().cpu().numpy()
    tr = ref.geometry.transforms
    return tr.np_compose_pose(np.asarray(prev_pose, np.float32)[None],
                              odom[None])[0]


@torch.no_grad()
def ref_stream_pose(ref, net, cfg, prev_pts, cur_pts, prev_pose):
    """``ref_pair_pose`` of the scans ``prev_pts`` and ``cur_pts``."""
    return ref_pair_pose(ref, net, ref_frame_bev(ref, net, cfg, prev_pts),
                         ref_frame_bev(ref, net, cfg, cur_pts), prev_pose)


def ref_train_batches(ref, cfg, tree, metas, prog_batches):
    """The reference's own batches for the program's check batches, from
    the raw tree: for each (sequence, frames) that a batch says it holds,
    the window built plainly (``rslo_ref/data/window.py``), mirrored
    where the program's points are (the flip is the loader's random
    draw; with ``random_flip_y`` off, never).  Returns (batches,
    windows_ok): whether each (sequence, frames) is a window the
    configuration draws; where not, the reference trains on the valid
    window from the same first frame."""
    win = ref.data.window
    d = cfg.data
    out, oks = [], []
    for (seq, frames), b in zip(metas, prog_batches):
        frames = [int(f) for f in frames]
        n = len(list((Path(tree) / "sequences" / f"{int(seq):02d}" /
                      "velodyne").glob("*.bin")))
        L = d.seq_length
        ok = (int(seq) in d.train_sequences and len(frames) == L and
              frames[0] >= 0 and frames[-1] < n and
              frames == [frames[0] + i * d.skip for i in range(L)])
        if not ok:
            f0 = min(max(frames[0] if frames else 0, 0),
                     n - 1 - (L - 1) * d.skip)
            frames = [f0 + i * d.skip for i in range(L)]
        r = win.window(tree, int(seq), frames, d.max_points)
        if d.random_flip_y:
            m = np.asarray(r["point_mask"], bool)
            y = np.asarray(b["points"])[..., 1][m]
            if np.sum(np.abs(y + r["points"][..., 1][m])) < \
                    np.sum(np.abs(y - r["points"][..., 1][m])):
                r = win.flipped(r)
        out.append(r)
        oks.append(ok)
    return out, oks


def ref_train_steps(ref, cfg, weights, batches, device, n_steps=3):
    """The reference's first ``n_steps`` train steps from ``weights`` on
    ``batches`` (host dicts of numpy arrays): the readings
    ``train_numbers`` takes."""
    from .weights import build
    step = ref.train.step
    net = build(ref.models.net.OdomNet, cfg, weights, device).train()
    opt = step.make_optimizer(cfg, net)
    state = ref.train.state.TrainState.create(
        net, opt, {"rot": cfg.loss.rotation_init_alpha,
                   "trans": cfg.loss.translation_init_alpha})
    p0 = {k: v.detach().clone() for k, v in state.trainable().items()}
    out = {"loss": [], "p0": p0, "b1": float(opt.b1(0))}
    for i, b in enumerate(batches[:n_steps]):
        batch = {k: torch.as_tensor(v).to(device) for k, v in b.items()}
        mid = FirstOutputs(net.middle, cfg.data.seq_length) if i == 0 \
            else None
        state, metrics = step.train_step(state, batch, cfg, opt,
                                         warmup=False)
        out["loss"].append(float(metrics["loss"]))
        if i == 0:
            out["mid1"] = mid.remove()
            out["mu1"] = {k: v.detach().clone()
                          for k, v in state.opt_state.mu.items()}
    out["p3"] = {k: v.detach().clone() for k, v in state.trainable().items()}
    return out
