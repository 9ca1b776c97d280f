"""Batched mean-shift clustering with a fixed number of iterations
(counterpart of ``rslo_tpu/geometry/meanshift.py``): Gaussian-kernel
mode seeking over a point set, optionally confidence-weighted, with
Euclidean or cosine distances.  The all-pairs kernels are f32 matrix
products with TF32 off (``ops/precision.py::f32_matmul``), as JAX's
``HIGHEST``; everything runs on the points' device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.precision import f32_matmul


def _pairwise_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (N, K), b: (M, K) -> (N, M) squared Euclidean distances."""
    aa = torch.sum(a * a, -1)[:, None]
    bb = torch.sum(b * b, -1)[None, :]
    return torch.clamp(aa + bb - 2.0 * (a @ b.T), min=0.0)


def _cosine_dist(a: torch.Tensor, b: torch.Tensor,
                 eps: float = 1e-12) -> torch.Tensor:
    an = a / torch.sqrt(torch.sum(a * a, -1, keepdim=True) + eps)
    bn = b / torch.sqrt(torch.sum(b * b, -1, keepdim=True) + eps)
    return 1.0 - an @ bn.T


def mean_shift(points: torch.Tensor, conf: Optional[torch.Tensor] = None,
               bandwidth: float = 2.5, iters: int = 5,
               dist_type: str = "euclidean") -> torch.Tensor:
    """Shift every point to its local density mode.

    points: (N, K); conf: optional (N,) sample weights.
    Returns modes (N, K), float32."""
    x = points.float()
    w = (torch.ones(x.shape[0], device=x.device) if conf is None
         else conf.float())
    y = x
    with f32_matmul():
        for _ in range(iters):
            d2 = (_cosine_dist(y, x) ** 2 if dist_type == "cosine"
                  else _pairwise_sq(y, x))
            k = torch.exp(-0.5 * d2 / (bandwidth * bandwidth)) * w[None, :]
            y = (k @ x) / torch.clamp(torch.sum(k, -1, keepdim=True),
                                      min=1e-12)
    return y


def label_modes(modes: torch.Tensor, tol: float = 1e-1) -> torch.Tensor:
    """Cluster labels from converged modes: each point's label is the
    smallest point index whose mode lies within ``tol``.  (N,) int32."""
    with f32_matmul():
        close = _pairwise_sq(modes, modes) <= tol * tol       # (N, N)
    n = modes.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=modes.device)
    return torch.amin(torch.where(close, idx[None, :], n), dim=1).to(
        torch.int32)


def mean_shift_cluster(points, conf=None, bandwidth=2.5, iters=5,
                       tol=1e-1, dist_type="euclidean"):
    """Convenience: (modes, labels)."""
    m = mean_shift(points, conf, bandwidth=bandwidth, iters=iters,
                   dist_type=dist_type)
    return m, label_modes(m, tol)
