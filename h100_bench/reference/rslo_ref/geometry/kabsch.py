"""Weighted Kabsch / Procrustes alignment (counterpart of
``rslo_tpu/geometry/kabsch.py``): the rigid ``(R, t)`` with
``src ≈ R @ tgt + t`` for weighted correspondences ``src[i] <-> tgt[i]``.

An f32 island, as JAX pins ``Precision.HIGHEST`` there: the 3x3 cross
covariance and every small product are broadcast multiply-and-sum, so
no matrix product runs in TF32 on the card.  Callers use it under
stop-gradient (the ICP loop), so no SVD gradient is needed.
"""
from __future__ import annotations

from typing import Optional

import torch


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) in plain f32 multiply-adds."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * v[..., None, :], dim=-1)


def weighted_kabsch(src: torch.Tensor, tgt: torch.Tensor,
                    weight: Optional[torch.Tensor] = None,
                    eps: float = 1e-12):
    """src, tgt: (B, N, 3); weight: (B, N) non-negative (also the
    validity mask).  Returns R (B, 3, 3), t (B, 3)."""
    src = src.float()
    tgt = tgt.float()
    if weight is None:
        weight = torch.ones(src.shape[:2], device=src.device)
    w = weight.float()[..., None]
    wsum = torch.sum(w, dim=1, keepdim=True) + eps
    src_mean = torch.sum(src * w, dim=1, keepdim=True) / wsum
    tgt_mean = torch.sum(tgt * w, dim=1, keepdim=True) / wsum
    src_c = src - src_mean
    tgt_c = tgt - tgt_mean
    H = torch.sum((src_c * w)[..., :, None] * tgt_c[..., None, :], dim=1)

    U, _, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    det = torch.linalg.det(_mm(V, U.transpose(-1, -2)))
    flip = torch.stack([torch.ones_like(det), torch.ones_like(det),
                        torch.sign(det)], dim=-1)
    V = V * flip[..., None, :]
    R0 = _mm(V, U.transpose(-1, -2))
    t0 = tgt_mean.squeeze(1) - _mv(R0, src_mean.squeeze(1))
    R = R0.transpose(-1, -2)
    t = -_mv(R, t0)
    return R, t
