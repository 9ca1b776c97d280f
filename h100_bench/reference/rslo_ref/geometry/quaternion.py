"""Quaternion algebra on torch tensors (counterpart of
``rslo_tpu/geometry/quaternion.py``).

Quaternions are wxyz (scalar first); a pose is a 7-vector ``[t(3),
q(4)]``, and ``compose_pose(p1, p2)`` applies ``p2`` first, then ``p1``.
Every function works on the trailing axis of ``(..., D)`` tensors, and
each keeps the JAX version's order of operations.  ``qexp`` (through
``safe_norm``) and ``qlog`` (through ``atan2``) keep finite derivatives
at exactly zero local coordinates, where the pose-graph and BA solvers
differentiate them.
"""
from __future__ import annotations

import torch

EPS = 1e-12


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = True,
              eps: float = EPS) -> torch.Tensor:
    """sqrt(sum(x^2) + eps^2): finite gradient at x == 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) +
                      eps * eps)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternion(s) to unit norm along the last axis."""
    return q / safe_norm(q, eps=1e-8)


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (== inverse for unit quaternions)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qmult(q1: torch.Tensor, q2: torch.Tensor,
          normalize: bool = True) -> torch.Tensor:
    """Hamilton product ``q1 * q2`` (wxyz), re-normalized unless
    ``normalize`` is false."""
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - torch.sum(v1 * v2, dim=-1, keepdim=True)
    v = w2 * v1 + w1 * v2 + torch.linalg.cross(*torch.broadcast_tensors(
        v1, v2))
    q = torch.cat([w.expand(v.shape[:-1] + (1,)), v], dim=-1)
    return qnormalize(q) if normalize else q


def qexp(v: torch.Tensor) -> torch.Tensor:
    """Exponential map from R^3 (log-quaternion) to a unit quaternion
    (wxyz); safe_norm keeps its Jacobian finite at v == 0."""
    n = safe_norm(v, eps=1e-8)
    return torch.cat([torch.cos(n), v * (torch.sin(n) / n)], dim=-1)


def qlog(q: torch.Tensor) -> torch.Tensor:
    """Log map from a unit quaternion (wxyz) to R^3: the atan2 form,
    whose derivative stays finite as the angle goes to 0."""
    v = q[..., 1:]
    w = q[..., :1]
    s = safe_norm(v, eps=1e-8)
    ang = torch.atan2(s, w)
    return v * (ang / s)


def rotate_vec_by_q(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``t`` by unit quaternion(s) ``q``:
    ``t' = t + 2 q_w (q_v x t) + 2 q_v x (q_v x t)``."""
    qw, qv = q[..., :1], q[..., 1:]
    qv, t = torch.broadcast_tensors(qv, t)
    b = torch.linalg.cross(qv, t)
    c = 2.0 * torch.linalg.cross(qv, b)
    return t + 2.0 * qw * b + c


def compose_pose(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Compose 7-dim poses: apply ``p2`` first, then ``p1``."""
    t1, q1 = p1[..., :3], p1[..., 3:]
    t2, q2 = p2[..., :3], p2[..., 3:]
    q = qmult(q1, q2)
    t = t1 + rotate_vec_by_q(t2, q1)
    return torch.cat([t, q], dim=-1)


def invert_pose(p: torch.Tensor) -> torch.Tensor:
    """Inverse of a 7-dim pose."""
    t, q = p[..., :3], p[..., 3:]
    qi = qinv(q)
    ti = -rotate_vec_by_q(t, qi)
    return torch.cat([ti, qi], dim=-1)


def calc_vo(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Relative pose of ``p1`` expressed in the ``p0`` frame."""
    return compose_pose(invert_pose(p0), p1)


def transform_points(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose ``[t, q]`` ((7,) or (..., 7)) to points (..., N, 3)."""
    t, q = pose[..., None, :3], pose[..., None, 3:]
    return rotate_vec_by_q(pts, q.expand(pts.shape[:-1] + (4,))) + t


def slerp(q0: torch.Tensor, q1: torch.Tensor, alpha) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions (wxyz);
    a linear blend where they are nearly parallel."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-6
    safe_sin = torch.where(use_lerp, 1.0, sin_theta)
    w0 = torch.where(use_lerp, 1.0 - alpha,
                     torch.sin((1 - alpha) * theta) / safe_sin)
    w1 = torch.where(use_lerp, alpha, torch.sin(alpha * theta) / safe_sin)
    return qnormalize(w0 * q0 + w1 * q1)


def hemisphere(q: torch.Tensor) -> torch.Tensor:
    """Flip quaternion(s) onto the q_w >= 0 hemisphere (an exactly-zero
    scalar part keeps its sign)."""
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (wxyz, (..., 4)) -> rotation matrix (..., 3, 3)."""
    q = qnormalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (wxyz, (..., 4)):
    branch-free Shepperd selection of the best of four extractions."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw0 = safe_sqrt(1.0 + tr)
    q0 = torch.stack([qw0, (m21 - m12) / qw0, (m02 - m20) / qw0,
                      (m10 - m01) / qw0], dim=-1) * 0.5
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / qx1, qx1, (m01 + m10) / qx1,
                      (m02 + m20) / qx1], dim=-1) * 0.5
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / qy2, (m01 + m10) / qy2, qy2,
                      (m12 + m21) / qy2], dim=-1) * 0.5
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / qz3, (m02 + m20) / qz3,
                      (m12 + m21) / qz3, qz3], dim=-1) * 0.5

    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)       # (..., 4 cand, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return qnormalize(torch.gather(qs, -2, idx).squeeze(-2))
