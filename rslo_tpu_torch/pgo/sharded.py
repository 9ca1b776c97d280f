"""Windowed pose-graph refinement with every window solved at once,
sharded over the data mesh (counterpart of ``rslo_tpu/pgo/sharded.py``).

The trajectory is cut into fixed-size overlapping windows; every window
is the same static Gauss-Newton problem, so the batch of them is one
``torch.func.vmap``-ped solve.  Over a mesh of D ranks each rank solves
its contiguous share of the windows (the batch padded to a multiple of D
by repeating the last window, as JAX pads it), the solutions are
gathered, and every rank stitches the overlaps on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.transforms import (np_compose_pose, np_invert_pose,
                                   odom_to_abs_pose)
from ..train.distributed import all_gather
from .pose_graph import PoseGraph, optimize_pose_graph


def _batched_solve(P0, E, M, I, iters: int):
    """(W, window, 7) initial poses, (W, max_edges, ...) edges ->
    (W, window, 7) optimized poses, each window anchored at its first
    pose."""
    anchors = torch.zeros((P0.shape[1],), dtype=torch.bool,
                          device=P0.device)
    anchors[0] = True

    def solve_one(poses0, edges, meas, info):
        return optimize_pose_graph(poses0,
                                   PoseGraph(edges, meas, info, anchors),
                                   iters=iters)[0]

    return torch.func.vmap(solve_one)(P0, E, M, I)


def fuse_windows_sharded(pair_edges: np.ndarray, pair_motions: np.ndarray,
                         n_poses: int,
                         pair_weights: np.ndarray | None = None,
                         window: int = 64, overlap: int = 16,
                         iters: int = 8, mesh=None,
                         device="cuda") -> np.ndarray:
    """Parallel-window variant of
    :func:`rslo_tpu_torch.pgo.refine.fuse_window_odometry`: every window
    solves from the chained initialization in one batch, then the
    overlaps stitch left to right on the host.  ``mesh``
    (``train/distributed.py::DataMesh``) with a process group shards the
    batch over its ranks, on the mesh's device; without one the batch is
    solved on ``device``.  Every rank returns the same refined absolute
    poses (n_poses, 7)."""
    pair_edges = np.asarray(pair_edges)
    pair_motions = np.asarray(pair_motions, np.float32)
    if pair_weights is None:
        pair_weights = np.ones(len(pair_edges), np.float32)

    chain = {tuple(e): k for k, e in enumerate(pair_edges)}
    odoms = np.zeros((n_poses, 7), np.float32)
    odoms[:, 3] = 1.0
    for i in range(n_poses - 1):
        k = chain.get((i, i + 1))
        if k is not None:
            odoms[i + 1] = pair_motions[k]
    abs_poses = odom_to_abs_pose(odoms)

    step = window - overlap
    starts = list(range(0, max(n_poses - overlap - 1, 1), step))
    # group edges per window, pad to a common static capacity
    per_win = []
    for s in starts:
        e = min(s + window, n_poses)
        sel = [(k, ed) for k, ed in enumerate(pair_edges)
               if s <= ed[0] and ed[1] < e]
        per_win.append((s, e, sel))
    max_edges = max((len(sel) for _, _, sel in per_win), default=1)
    W = len(per_win)

    P0 = np.zeros((W, window, 7), np.float32)
    P0[:, :, 3] = 1.0
    E = np.zeros((W, max_edges, 2), np.int32)
    M = np.zeros((W, max_edges, 7), np.float32)
    M[:, :, 3] = 1.0
    I = np.zeros((W, max_edges, 6, 6), np.float32)
    for w, (s, e, sel) in enumerate(per_win):
        base_inv = np_invert_pose(abs_poses[s])
        for i in range(e - s):
            P0[w, i] = np_compose_pose(base_inv[None],
                                       abs_poses[s + i][None])[0]
        for i in range(e - s, window):
            P0[w, i] = P0[w, e - s - 1]  # park padding at last pose
        for j, (k, ed) in enumerate(sel):
            E[w, j] = ed - s
            M[w, j] = pair_motions[k]
            I[w, j] = np.eye(6) * pair_weights[k]

    args = (P0, E, M, I)
    if mesh is not None and mesh.group is not None:
        # pad W to a multiple of the ranks; this rank takes its share
        device = mesh.device
        per = -(-W // mesh.size)
        args = tuple(np.concatenate([a, np.repeat(a[-1:], per * mesh.size
                                                  - W, axis=0)])
                     [mesh.rank * per:(mesh.rank + 1) * per] for a in args)
    opt = _batched_solve(*(torch.as_tensor(a, device=device) for a in args),
                         iters=iters)
    opt = all_gather(opt, mesh).reshape(-1, window, 7)[:W].cpu().numpy()

    # stitch: compose each window's local solution onto the refined
    # trajectory so far (left to right)
    refined = abs_poses.copy()
    for w, (s, e, sel) in enumerate(per_win):
        base = refined[s]
        for i in range(e - s):
            refined[s + i] = np_compose_pose(base[None], opt[w, i][None])[0]
    return refined
