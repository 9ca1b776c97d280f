"""One-direction nearest-neighbor search, the chamfer association
(counterpart of ``rslo_tpu/ops/chamfer.py``).

For each src point: the squared distance to, and the index of, its
nearest valid tgt point.  ``nn_search`` launches the hand-written Hopper
kernel ``csrc/nn_search.cu`` (replacing the Pallas kernel
``nn_search_pallas``) on a CUDA tensor, and runs ``nn_search_plain`` on
a CPU tensor; there is no fallback from one to the other.

Both follow the Pallas kernel's semantics at every shape: the distance
is ``((dx*dx + dy*dy) + dz*dz) + penalty`` from the direct f32
differences, penalty ``BIG`` for an invalid tgt, the lowest index wins a
tie, a masked src gives ``(BIG, 0)``, and distances are clamped at
>= 0.  (The JAX package falls back to an XLA scan that expands the
distance as |s|^2 - 2 s.t + |t|^2 where shapes do not tile; the port
does not.)  The argmin is piecewise constant, so nothing here carries a
gradient: callers re-gather differentiable values through ``idx``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

BIG = 1e30


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("nn_search")
    lib.nn_search_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.nn_search_launch.restype = ctypes.c_int
    return lib


@torch.no_grad()
def nn_search_plain(src, src_mask, tgt, tgt_mask, chunk: int = 1024):
    """Plain PyTorch version of ``nn_search`` (same arguments), over tgt
    chunks so that no (N, M) matrix is held at once."""
    src = src.float()
    tgt = tgt.float()
    P, N, _ = src.shape
    M = tgt.shape[1]
    pen = torch.where(tgt_mask, 0.0, BIG).to(torch.float32)
    best_d = torch.full((P, N), BIG, dtype=torch.float32, device=src.device)
    best_i = torch.zeros((P, N), dtype=torch.int32, device=src.device)
    s = src[:, :, None, :]
    for m0 in range(0, M, chunk):
        t = tgt[:, None, m0:m0 + chunk, :]
        dx = s[..., 0] - t[..., 0]
        dy = s[..., 1] - t[..., 1]
        dz = s[..., 2] - t[..., 2]
        d = dx * dx + dy * dy
        d = d + dz * dz
        d = d + pen[:, None, m0:m0 + chunk]
        td = d.min(dim=-1).values
        iota = torch.arange(d.shape[-1], dtype=torch.int32,
                            device=src.device)
        ti = torch.where(d <= td[..., None], iota, d.shape[-1]).min(
            dim=-1).values
        upd = td < best_d
        best_i = torch.where(upd, ti + m0, best_i)
        best_d = torch.where(upd, td, best_d)
    dist = torch.where(src_mask, best_d, BIG)
    idx = torch.where(src_mask, best_i, 0)
    return torch.clamp(dist, min=0.0), idx.to(torch.int32)


@torch.no_grad()
def nn_search(src: torch.Tensor, src_mask: torch.Tensor, tgt: torch.Tensor,
              tgt_mask: torch.Tensor):
    """For each src point, its nearest valid tgt point.

    src (P, N, 3) f32, src_mask (P, N) bool, tgt (P, M, 3) f32, tgt_mask
    (P, M) bool.  Returns dist (P, N) f32 (BIG where src is masked or
    no tgt is valid) and idx (P, N) int32 (0 there).
    ``nn_search.launches`` counts the CUDA kernel's launches: one serves
    every pair."""
    if src.dim() != 3:
        raise ValueError(f"nn_search takes a leading pair axis, got src "
                         f"{tuple(src.shape)}")
    P, N = src.shape[:2]
    M = tgt.shape[1]
    if (src.shape != (P, N, 3) or tgt.shape != (P, M, 3) or
            src_mask.shape != (P, N) or tgt_mask.shape != (P, M)):
        raise ValueError(f"nn_search takes src (P, N, 3), src_mask (P, N), "
                         f"tgt (P, M, 3), tgt_mask (P, M); got "
                         f"{tuple(src.shape)}, {tuple(src_mask.shape)}, "
                         f"{tuple(tgt.shape)}, {tuple(tgt_mask.shape)}")
    if src_mask.dtype != torch.bool or tgt_mask.dtype != torch.bool:
        raise ValueError("nn_search masks must be bool")
    dev = src.device
    if any(t.device != dev for t in (src_mask, tgt, tgt_mask)):
        raise ValueError("nn_search operands lie on different devices")
    if dev.type == "cpu":
        return nn_search_plain(src, src_mask, tgt, tgt_mask)
    if dev.type == "cuda":
        return _launch(src, src_mask, tgt, tgt_mask)
    raise ValueError(f"nn_search runs on cpu or cuda, not {dev}")


def _launch(src, src_mask, tgt, tgt_mask):
    P, N = src.shape[:2]
    M = tgt.shape[1]
    src = src.detach().float().contiguous()
    tgt = tgt.detach().float().contiguous()
    src_mask = src_mask.contiguous()
    tgt_mask = tgt_mask.contiguous()
    dist = torch.empty((P, N), dtype=torch.float32, device=src.device)
    idx = torch.empty((P, N), dtype=torch.int32, device=src.device)
    if P == 0 or N == 0:
        return dist, idx
    lib = _library()
    with torch.cuda.device(src.device):
        err = lib.nn_search_launch(
            src.data_ptr(), src_mask.data_ptr(), tgt.data_ptr(),
            tgt_mask.data_ptr(), dist.data_ptr(), idx.data_ptr(), P, N, M,
            torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nn_search kernel launch failed: CUDA error "
                           f"{err} (P={P}, N={N}, M={M})")
    nn_search.launches += 1
    return dist, idx


nn_search.launches = 0
