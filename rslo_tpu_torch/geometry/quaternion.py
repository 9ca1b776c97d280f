"""Quaternion algebra on torch tensors (counterpart of
``rslo_tpu/geometry/quaternion.py``).

Quaternions are wxyz (scalar first); every function works on the
trailing axis of ``(..., D)`` tensors.
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


def rotate_vec_by_q(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``t`` by unit quaternion(s) ``q``:
    ``t' = t + 2 q_w (q_v x t) + 2 q_v x (q_v x t)``."""
    qw, qv = q[..., :1], q[..., 1:]
    qv, t = torch.broadcast_tensors(qv, t)
    b = torch.linalg.cross(qv, t)
    c = 2.0 * torch.linalg.cross(qv, b)
    return t + 2.0 * qw * b + c
