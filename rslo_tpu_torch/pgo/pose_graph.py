"""Pose-graph optimization: Gauss-Newton on the SE(3) manifold
(counterpart of ``rslo_tpu/pgo/pose_graph.py``).

A refinement window holds N poses (N <= ~128), so the dense 6N x 6N
normal system is small: one Cholesky of it on the poses' device.  Edges
are (E, 2) index pairs, (E, 7) measurements and (E, 6, 6) information
matrices (zero information disables an edge).  The Jacobian of the
manifold residual is ``torch.func.jacfwd``'s at zero local coordinates,
as JAX's ``jax.jacfwd``; every matrix product runs in full float32 (no
TF32), as JAX pins ``Precision.HIGHEST``, whatever the process's flag.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import (compose_pose, invert_pose, qexp, qlog, qmult,
                        qnormalize)
from ..geometry.transforms import odom_to_abs_pose
from ..ops.precision import f32_matmul


class PoseGraph(NamedTuple):
    """Static-capacity pose-graph problem.

    edges:    (E, 2) int32 (i, j) pose indices.
    meas:     (E, 7) measured relative pose of j in i's frame.
    info:     (E, 6, 6) information matrices (zero rows disable an edge).
    anchors:  (N,) bool — poses held fixed (at least one must be True).
    """
    edges: torch.Tensor
    meas: torch.Tensor
    info: torch.Tensor
    anchors: torch.Tensor


def edge_residual(pose_i: torch.Tensor, pose_j: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """6-dim manifold residual of one edge: log(z^-1 * (Ti^-1 Tj))."""
    rel = compose_pose(invert_pose(pose_i), pose_j)
    err = compose_pose(invert_pose(z), rel)
    return torch.cat([err[..., :3], 2.0 * qlog(err[..., 3:])], dim=-1)


def _retract(poses: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Apply local updates delta (N, 6) to poses (N, 7)."""
    t = poses[:, :3] + delta[:, :3]
    dq = qexp(0.5 * delta[:, 3:])
    q = qnormalize(qmult(poses[:, 3:], dq))
    return torch.cat([t, q], dim=-1)


def _residuals(delta: torch.Tensor, poses: torch.Tensor, graph: PoseGraph):
    p = _retract(poses, delta)
    pi = p[graph.edges[:, 0].long()]
    pj = p[graph.edges[:, 1].long()]
    return edge_residual(pi, pj, graph.meas)      # (E, 6)


def _cost(r: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    return torch.einsum('ea,eab,eb->', r, info, r)


def _normal_equations(poses: torch.Tensor, graph: PoseGraph):
    """Information-weighted Gauss-Newton system (H, g) at ``poses``,
    before the gauge fix: H = J' Lambda J, g = J' Lambda r."""
    N = poses.shape[0]
    delta0 = torch.zeros((N, 6), dtype=poses.dtype, device=poses.device)
    r = _residuals(delta0, poses, graph)                  # (E, 6)
    J = torch.func.jacfwd(lambda d: _residuals(d, poses, graph))(delta0)
    E = r.shape[0]
    J = J.reshape(E * 6, N * 6)
    Lam = graph.info                                      # (E, 6, 6)
    r_w = torch.einsum('eab,eb->ea', Lam, r).reshape(-1)
    J_w = torch.einsum('eab,ebn->ean', Lam,
                       J.reshape(E, 6, N * 6)).reshape(E * 6, N * 6)
    return J.T @ J_w, J.T @ r_w


# a Gauss-Newton step that multiplies the cost by more than this has
# diverged (f32 rounding moves a converged cost by a few ulps)
DIVERGED = 1e3


@f32_matmul()
def optimize_pose_graph(poses_init: torch.Tensor, graph: PoseGraph,
                        iters: int = 10, damping: float = 1e-6):
    """Gauss-Newton with Levenberg damping, on the device of
    ``poses_init``.  Returns (poses, final_cost).

    poses_init: (N, 7).  Anchored poses keep their initial value (their
    6x6 block is replaced by identity and their residual gradient
    zeroed, the standard gauge fix).  The factorization's status is not
    read (no host sync).  A step that multiplies the cost by more than
    ``DIVERGED`` or leaves the poses non-finite is not taken (the poses
    and the cost stay): where H is too ill-conditioned for f32 (relative
    motions of kilometres, an untrained network's predictions fused)
    the solve otherwise diverges or returns NaN poses, as JAX's does.
    Every other step is JAX's."""
    N = poses_init.shape[0]
    dev, dt = poses_init.device, poses_init.dtype
    free = ~graph.anchors.repeat_interleave(6)
    both_free = free[:, None] & free[None, :]
    diag = torch.diag(torch.where(free, damping, 1.0).to(dt))
    jitter = 1e-9 * torch.eye(N * 6, dtype=dt, device=dev)
    zeros = torch.zeros((N, 6), dtype=dt, device=dev)
    poses = poses_init
    cost = _cost(_residuals(zeros, poses, graph), graph.info)
    for _ in range(iters):
        H, g = _normal_equations(poses, graph)
        # gauge fix: anchored blocks -> identity rows/cols, zero gradient
        H = torch.where(both_free, H, 0.0) + diag
        g = torch.where(free, g, 0.0)
        U, _ = torch.linalg.cholesky_ex(H + jitter, upper=True)
        step = -torch.cholesky_solve(g[:, None], U, upper=True)[:, 0]
        moved = _retract(poses, step.reshape(N, 6))
        moved_cost = _cost(_residuals(zeros, moved, graph), graph.info)
        take = torch.isfinite(moved).all() & (moved_cost <=
                                               DIVERGED * cost)
        poses = torch.where(take, moved, poses)
        cost = torch.where(take, moved_cost, cost)
    return poses, cost


def chain_graph(odoms: torch.Tensor, info_scale: float = 1.0,
                loop_edges: torch.Tensor | None = None,
                loop_meas: torch.Tensor | None = None,
                loop_info: torch.Tensor | None = None) -> tuple:
    """Build a chain pose graph from sequential odometry, on the device
    of ``odoms``.

    odoms: (N-1, 7) relative motions (frame k -> k+1 expressed in k).
    Optional loop-closure edges append to the chain.  Returns
    (poses_init (N, 7), PoseGraph)."""
    n = len(odoms) + 1
    dev = odoms.device
    ident = np.array([[0.0, 0, 0, 1, 0, 0, 0]], np.float32)
    odoms_full = np.concatenate([ident, odoms.cpu().numpy()])
    poses0 = torch.as_tensor(odom_to_abs_pose(odoms_full), device=dev)
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    edges = torch.stack([ar[:-1], ar[1:]], dim=-1)
    meas = odoms
    info = (torch.eye(6, device=dev)[None] * info_scale).repeat(n - 1, 1, 1)
    if loop_edges is not None:
        edges = torch.cat([edges, loop_edges.to(torch.int32)])
        meas = torch.cat([meas, loop_meas])
        info = torch.cat([info, loop_info])
    anchors = torch.zeros((n,), dtype=torch.bool, device=dev)
    anchors[0] = True
    return poses0, PoseGraph(edges, meas, info, anchors)
