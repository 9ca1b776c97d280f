"""Windowed bundle adjustment with Schur-complement landmark elimination
(counterpart of ``rslo_tpu/pgo/ba.py``), on one device or with the
landmarks sharded over the data mesh (``solve_ba_sharded``).

Poses and landmarks (voxel-map points) are optimized jointly inside a
keyframe window.  The normal system

    [ Hpp  Hpl ] [dp]   [ -gp ]
    [ Hpl' Hll ] [dl] = [ -gl ]

has a block-diagonal landmark block (each landmark's 3x3), so landmarks
are eliminated analytically:

    S  = Hpp - Hpl Hll^-1 Hpl'          (reduced camera system)
    dp = solve(S, -gp + Hpl Hll^-1 gl)
    dl = Hll^-1 (-gl - Hpl' dp)

Observations are (O,) triples (pose idx, landmark idx, measured point in
the pose frame, weight); per-observation Jacobians come from
``torch.func.vmap(torch.func.jacfwd(...))`` and the blocks are
``index_add_`` scatter-adds (their order is not fixed on CUDA, so card
results match the CPU's to a tolerance).  Every matrix product runs in
full float32 (no TF32), as JAX pins ``Precision.HIGHEST``.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..geometry import qexp, qmult, qnormalize, rotate_vec_by_q
from ..losses.consistency import inv3x3
from ..ops.precision import f32_matmul
from ..train.distributed import all_gather
from ..utils.mesh_axis import bind_axis, psum_if_present


class BAProblem(NamedTuple):
    """poses: (W, 7) initial world-from-frame poses [t, q].
    landmarks: (K, 3) initial world positions.
    obs_pose: (O,) int32; obs_lm: (O,) int32.
    obs_xyz: (O, 3) measured landmark position in the pose's frame.
    obs_w: (O,) scalar weights (0 disables an observation) OR
      (O, 3, 3) square-root information blocks W = chol(Sigma^-1)' —
      the full 3D error model: residuals/Jacobians are whitened
      r' = W r so r''r' = r' Sigma^-1 r.
    anchor: (W,) bool poses held fixed (gauge)."""
    poses: torch.Tensor
    landmarks: torch.Tensor
    obs_pose: torch.Tensor
    obs_lm: torch.Tensor
    obs_xyz: torch.Tensor
    obs_w: torch.Tensor
    anchor: torch.Tensor


def _retract_pose(pose, d6):
    t = pose[:3] + d6[:3]
    q = qnormalize(qmult(pose[3:], qexp(0.5 * d6[3:])))
    return torch.cat([t, q])


def _obs_residual(pose, lm, meas):
    """Landmark in the pose frame minus measurement: T^-1 l - z."""
    pred = rotate_vec_by_q((lm - pose[:3])[None],
                           torch.cat([pose[3:4], -pose[4:]])[None])[0]
    return pred - meas


def _res_fn(dp, dl, pose, lm, meas):
    return _obs_residual(_retract_pose(pose, dp), lm + dl, meas)


def _linearize(problem: BAProblem):
    """Per-observation residuals + Jacobians at zero local coords.

    Returns r (O, 3), Jp (O, 3, 6), Jl (O, 3, 3), weighted."""
    poses = problem.poses[problem.obs_pose.long()]        # (O, 7)
    lms = problem.landmarks[problem.obs_lm.long()]        # (O, 3)
    z6 = torch.zeros((6,), dtype=poses.dtype, device=poses.device)
    z3 = torch.zeros((3,), dtype=poses.dtype, device=poses.device)

    def one(pose, lm, meas):
        r = _res_fn(z6, z3, pose, lm, meas)
        Jp, Jl = torch.func.jacfwd(_res_fn, argnums=(0, 1))(
            z6, z3, pose, lm, meas)
        return r, Jp, Jl

    r, Jp, Jl = torch.func.vmap(one)(poses, lms, problem.obs_xyz)
    if problem.obs_w.dim() == 3:
        # full-covariance whitening: (O, 3, 3) sqrt-information blocks
        Wm = problem.obs_w
        return (torch.einsum('oab,ob->oa', Wm, r),
                torch.einsum('oab,obj->oaj', Wm, Jp),
                torch.einsum('oab,obj->oaj', Wm, Jl))
    w = problem.obs_w[:, None]
    return r * w, Jp * w[..., None], Jl * w[..., None]


def _assemble(problem: BAProblem, r, Jp, Jl):
    """Blocks of the normal equations via segment scatter-adds."""
    W = problem.poses.shape[0]
    K = problem.landmarks.shape[0]
    dev, dt = r.device, r.dtype
    # Hpp blocks (per pose) and gp
    HppO = torch.einsum('oai,oaj->oij', Jp, Jp)            # (O, 6, 6)
    gpO = torch.einsum('oai,oa->oi', Jp, r)                # (O, 6)
    Hpp = torch.zeros((W, 6, 6), dtype=dt, device=dev).index_add_(
        0, problem.obs_pose, HppO)
    gp = torch.zeros((W, 6), dtype=dt, device=dev).index_add_(
        0, problem.obs_pose, gpO)
    # Hll blocks (per landmark) and gl
    HllO = torch.einsum('oai,oaj->oij', Jl, Jl)            # (O, 3, 3)
    glO = torch.einsum('oai,oa->oi', Jl, r)
    Hll = torch.zeros((K, 3, 3), dtype=dt, device=dev).index_add_(
        0, problem.obs_lm, HllO)
    gl = torch.zeros((K, 3), dtype=dt, device=dev).index_add_(
        0, problem.obs_lm, glO)
    return Hpp, gp, Hll, gl


def _reduced_system(problem: BAProblem, r, Jp, Jl, damping):
    """Schur complement pieces. Returns (S (6W, 6W), rhs (6W,), Hll_inv,
    gl, B (K, 6W, 3)), the last three for the back-substitution."""
    W = problem.poses.shape[0]
    K = problem.landmarks.shape[0]
    dev, dt = r.device, r.dtype
    Hpp, gp, Hll, gl = _assemble(problem, r, Jp, Jl)
    Hll = Hll + damping * torch.eye(3, dtype=dt, device=dev)
    Hll_inv, _ = inv3x3(Hll, eps=1e-9)
    # B_j = sum_{o: lm=j} Jp_o' Jl_o at its pose's rows: (K, W, 6, 3),
    # scattered through the flat index lm * W + pose; then
    # S = blockdiag(Hpp) - sum_j B_j Hll_inv_j B_j'
    HplO = torch.einsum('oai,oaj->oij', Jp, Jl)            # (O, 6, 3)
    B = torch.zeros((K * W, 6, 3), dtype=dt, device=dev).index_add_(
        0, problem.obs_lm * W + problem.obs_pose, HplO)
    B = B.reshape(K, W * 6, 3)
    S = torch.zeros((W, 6, W, 6), dtype=dt, device=dev)
    ii = torch.arange(W, device=dev)
    S[ii, :, ii, :] = Hpp
    S = S.reshape(W * 6, W * 6)
    corr = torch.einsum('kab,kbc,kdc->ad', B, Hll_inv, B)
    S = S - corr
    rhs = -gp.reshape(W * 6) + torch.einsum('kab,kbc,kc->a', B, Hll_inv, gl)
    return S, rhs, Hll_inv, gl, B


def _identity(x):
    return x


@f32_matmul()
def ba_step(problem: BAProblem, damping: float = 1e-4, psum=_identity):
    """One Gauss-Newton step with Schur elimination, on the problem's
    device.  Returns the updated problem and the cost before the step.
    The factorization's status is not read (no host sync): a failed one
    gives NaN, as in JAX.  ``psum`` sums the cost and the reduced
    system over the shards of a sharded problem (``solve_ba_sharded``)."""
    r, Jp, Jl = _linearize(problem)
    cost = psum(torch.sum(r * r))
    W = problem.poses.shape[0]
    S, rhs, Hll_inv, gl, B = _reduced_system(problem, r, Jp, Jl, damping)
    S, rhs = psum(S), psum(rhs)
    free = ~problem.anchor.repeat_interleave(6)
    S = torch.where(free[:, None] & free[None, :], S, 0.0)
    S = S + torch.diag(torch.where(free, damping, 1.0).to(S.dtype))
    rhs = torch.where(free, rhs, 0.0)
    U, _ = torch.linalg.cholesky_ex(
        S + 1e-9 * torch.eye(W * 6, dtype=S.dtype, device=S.device),
        upper=True)
    dp = torch.cholesky_solve(rhs[:, None], U, upper=True)[:, 0]  # (6W,)
    # back-substitute landmarks: dl_j = Hll_inv_j (-gl_j - B_j' dp)
    dl = torch.einsum('kbc,kc->kb', Hll_inv,
                      -gl - torch.einsum('kab,a->kb', B, dp))
    new_poses = torch.func.vmap(_retract_pose)(problem.poses,
                                               dp.reshape(W, 6))
    new_lms = problem.landmarks + dl
    return problem._replace(poses=new_poses, landmarks=new_lms), cost


@f32_matmul()
def solve_ba(problem: BAProblem, iters: int = 5, damping: float = 1e-4):
    """``iters`` Gauss-Newton steps.  Returns (problem, final cost)."""
    for _ in range(iters):
        problem, _ = ba_step(problem, damping)
    r, _, _ = _linearize(problem)
    return problem, torch.sum(r * r)


@f32_matmul()
def solve_ba_sharded(problem: BAProblem, mesh=None, iters: int = 5,
                     damping: float = 1e-4):
    """``solve_ba`` with the landmarks and observations sharded over the
    ranks of ``mesh`` (``train/distributed.py::DataMesh``): ``problem``
    holds this rank's landmark shard and the observations of it, with
    ``obs_lm`` local to the shard; the poses and anchors are replicated.
    Each step sums the cost and the reduced camera system over the ranks,
    every rank solves the same system and back-substitutes its own
    landmarks.  Returns (poses (W, 7), every rank's landmarks in rank
    order (D * K, 3), the cost before the last step), the same on every
    rank; without a process group, the unsharded problem's."""
    group = None if mesh is None else mesh.group
    with (bind_axis("data", group, mesh.size) if group is not None
          else contextlib.nullcontext()):
        cost = torch.zeros((), device=problem.poses.device)
        for _ in range(iters):
            problem, cost = ba_step(problem, damping,
                                    lambda x: psum_if_present(x, "data"))
    return (problem.poses, all_gather(problem.landmarks, mesh).reshape(-1, 3),
            cost)
