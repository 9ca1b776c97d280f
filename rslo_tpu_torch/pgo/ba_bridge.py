"""Bridge from network outputs to bundle-adjustment problems
(counterpart of ``rslo_tpu/pgo/ba_bridge.py``).

Turns a window of frames — per-frame point sets (voxel centroids in the
frame's own coordinates), per-point weights or square-root information
blocks from the network's uncertainty head, and chained pose
initializations — into a :class:`~rslo_tpu_torch.pgo.ba.BAProblem`:

  * world landmarks are seeded from the first frame's points (window
    frame 0 defines the window's world);
  * every other frame contributes observations by nearest-neighbor
    association of its points against the landmarks under the initial
    poses (host-side cKDTree — thousands of points, milliseconds);
  * association distance gates the tracks.

The observation arrays come out in the JAX version's order (frame 0's
landmarks, then each frame's kept points in index order), which is the
order of the solver's scatter-adds.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..geometry.transforms import odom_to_abs_pose, quat_to_matrix_np
from ..losses.consistency import span_cov
from .ba import BAProblem, solve_ba


def window_ba_problem(frame_points: Sequence[np.ndarray],
                      poses_init: np.ndarray,
                      point_weights: Sequence[np.ndarray] | None = None,
                      max_landmarks: int = 4096,
                      assoc_threshold: float = 0.5,
                      device="cuda") -> BAProblem | None:
    """Build a BA problem for one window, its tensors on ``device``.

    frame_points: list[L] of (N_i, 3) points in each frame's coords.
    poses_init: (L, 7) initial window poses (frame 0 == identity).
    point_weights: optional list[L] of (N_i,) association weights or
      (N_i, 3, 3) square-root information blocks.
    Returns None when too few associations survive the gate.
    """
    from scipy.spatial import cKDTree

    L = len(frame_points)
    p0 = np.asarray(frame_points[0], np.float32)
    if len(p0) > max_landmarks:
        sel = np.linspace(0, len(p0) - 1, max_landmarks).astype(int)
        p0 = p0[sel]
        w0 = (point_weights[0][sel] if point_weights is not None
              else np.ones(len(p0), np.float32))
    else:
        w0 = (np.asarray(point_weights[0], np.float32)
              if point_weights is not None
              else np.ones(len(p0), np.float32))
    K = len(p0)
    landmarks = p0.copy()          # world == window frame 0

    # frame 0 observes every landmark exactly
    obs_p = [np.zeros(K, np.int64)]
    obs_l = [np.arange(K)]
    obs_x = [p0]
    obs_w = [np.asarray(w0)]
    tree = cKDTree(landmarks)
    for i in range(1, L):
        pts = np.asarray(frame_points[i], np.float32)
        wts = (np.asarray(point_weights[i], np.float32)
               if point_weights is not None
               else np.ones(len(pts), np.float32))
        # transform frame-i points into world with the initial pose
        R = quat_to_matrix_np(poses_init[i, 3:])
        world = pts @ R.T + poses_init[i, :3]
        dist, idx = tree.query(world, k=1, workers=-1)
        keep = np.nonzero(dist < assoc_threshold)[0]
        obs_p.append(np.full(len(keep), i, np.int64))
        obs_l.append(idx[keep])
        obs_x.append(pts[keep])
        obs_w.append(wts[keep])

    if sum(len(p) for p in obs_p) < 6 * L + 3 * K // 8:
        return None
    anchor = np.zeros(L, bool)
    anchor[0] = True

    def on(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return BAProblem(
        on(poses_init, torch.float32), on(landmarks, torch.float32),
        on(np.concatenate(obs_p), torch.int32),
        on(np.concatenate(obs_l), torch.int32),
        on(np.concatenate(obs_x), torch.float32),
        # (O,) or (O, 3, 3)
        on(np.concatenate(obs_w).astype(np.float32), torch.float32),
        on(anchor, torch.bool))


def refine_window_ba(frame_points, pair_odometries,
                     point_weights=None, iters: int = 5,
                     assoc_threshold: float = 0.5,
                     device="cuda") -> np.ndarray:
    """Refine one window's poses with geometric BA on ``device``.

    pair_odometries: (L-1, 7) consecutive-frame motions (i -> i+1).
    Returns refined (L, 7) window poses (frame-0 anchored) — the chained
    initialization when associations are too sparse.
    """
    L = len(frame_points)
    odoms = np.zeros((L, 7), np.float32)
    odoms[:, 3] = 1.0
    odoms[1:] = np.asarray(pair_odometries, np.float32)
    poses0 = odom_to_abs_pose(odoms)
    problem = window_ba_problem(frame_points, poses0, point_weights,
                                assoc_threshold=assoc_threshold,
                                device=device)
    if problem is None:
        return poses0
    out, _cost = solve_ba(problem, iters=iters)
    return out.poses.cpu().numpy()


def cov_trace_weights(cov_params: np.ndarray) -> np.ndarray:
    """(N, 7) network covariance params -> association weights
    1 / (1 + tr(Sigma)); cumulative-eigenvalue parameterization makes
    the trace lam1 + (lam1+lam2') + (lam1+lam2'+lam3')."""
    lam1 = cov_params[:, 0]
    lam2 = lam1 + cov_params[:, 1]
    lam3 = lam2 + cov_params[:, 2]
    tr = lam1 + lam2 + lam3
    return (1.0 / (1.0 + tr)).astype(np.float32)


def cov_sqrt_info(cov_params: np.ndarray, eps: float = 1e-3
                  ) -> np.ndarray:
    """(N, 7) network covariance params -> (N, 3, 3) square-root
    information blocks W with W' W = (Sigma + eps I)^-1, on the host:
    the network's full, anisotropic 3D error model whitens the BA
    residuals instead of being collapsed to a scalar trace."""
    sigma = span_cov(torch.as_tensor(np.asarray(cov_params, np.float32))
                     ).numpy()
    sigma = sigma + eps * np.eye(3, dtype=np.float32)
    # W = inv(L) with Sigma = L L'  =>  W' W = L^-T L^-1 = Sigma^-1
    L = np.linalg.cholesky(sigma)
    W = np.linalg.inv(L)
    return W.astype(np.float32)
