"""Fused sparse-conv apply: the hand-written Hopper gather-GEMM kernel
(counterpart of ``rslo_tpu/ops/dma_gather.py::dma_gather_matmul``).

``gather_matmul`` computes ``sparse_conv_apply``'s contract,
``out[v] = sum_k valid[v,k] * f[idx[v,k]] @ W[k]`` (+ bias, zeroed where
``out_mask`` is false), with operands rounded to the compute dtype and
fp32 sums.  On a CUDA tensor it launches ``csrc/gather_matmul.cu`` or
raises; on a CPU tensor it runs the plain ``sparse_conv_apply``.  There
is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .sparse_conv import ConvIndex, sparse_conv_apply

_COMPUTE_DTYPES = (torch.bfloat16, torch.float32)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built and loaded at the first CUDA call."""
    lib = _build.load_library("gather_matmul")
    lib.gather_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.gather_matmul_launch.restype = ctypes.c_int
    lib.gather_matmul_max_channels.argtypes = []
    lib.gather_matmul_max_channels.restype = ctypes.c_int
    return lib


def _check(features, idx, valid, weights, bias, out_mask, compute_dtype):
    if features.dim() != 2 or features.dtype != torch.float32:
        raise ValueError(f"features must be (Vin, Cin) float32, got "
                         f"{tuple(features.shape)} {features.dtype}")
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be (V, K) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if valid.shape != idx.shape or valid.dtype != torch.bool:
        raise ValueError(f"valid must be {tuple(idx.shape)} bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    V, K = idx.shape
    Cin = features.shape[1]
    if (weights.dim() != 3 or weights.dtype != torch.float32 or
            tuple(weights.shape[:2]) != (K, Cin)):
        raise ValueError(f"weights must be ({K}, {Cin}, Cout) float32, got "
                         f"{tuple(weights.shape)} {weights.dtype}")
    Cout = weights.shape[2]
    if bias is not None and (tuple(bias.shape) != (Cout,) or
                             bias.dtype != torch.float32):
        raise ValueError(f"bias must be ({Cout},) float32, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if out_mask is not None and (tuple(out_mask.shape) != (V,) or
                                 out_mask.dtype != torch.bool):
        raise ValueError(f"out_mask must be ({V},) bool, got "
                         f"{tuple(out_mask.shape)} {out_mask.dtype}")
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {_COMPUTE_DTYPES}, "
                         f"got {compute_dtype}")
    tensors = [t for t in (features, idx, valid, weights, bias, out_mask)
               if t is not None]
    if any(t.device != features.device for t in tensors):
        raise ValueError("gather_matmul operands lie on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    return tensors


def gather_matmul(features: torch.Tensor, idx: torch.Tensor,
                  valid: torch.Tensor, weights: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  out_mask: Optional[torch.Tensor] = None,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Sparse-conv apply through a rulebook.

    features (Vin, Cin) f32; idx (V, K) int32 rows into features; valid
    (V, K) bool; weights (K, Cin, Cout) f32; bias (Cout,) f32 or None;
    out_mask (V,) bool or None; compute_dtype torch.bfloat16 or
    torch.float32.  Returns (V, Cout) f32.  ``gather_matmul.launches``
    counts the CUDA kernel's launches."""
    tensors = _check(features, idx, valid, weights, bias, out_mask,
                     compute_dtype)
    dev = features.device
    if dev.type == "cpu":
        return sparse_conv_apply(features, ConvIndex(idx, valid), weights,
                                 bias, out_mask, compute_dtype)
    if dev.type != "cuda":
        raise ValueError(f"gather_matmul runs on cpu or cuda, not {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gather_matmul needs contiguous operands")
    V, K = idx.shape
    Vin, Cin = features.shape
    Cout = weights.shape[2]
    lib = _library()
    max_c = lib.gather_matmul_max_channels()
    if Cin > max_c or Cout > max_c:
        raise ValueError(f"gather_matmul takes Cin, Cout <= {max_c}, got "
                         f"{Cin}, {Cout}")
    out = torch.empty((V, Cout), dtype=torch.float32, device=dev)
    if V == 0:
        return out
    if Vin == 0:
        raise ValueError("gather_matmul needs at least one feature row")
    with torch.cuda.device(dev):   # launch on the operands' card
        err = lib.gather_matmul_launch(
            features.data_ptr(), idx.data_ptr(), valid.data_ptr(),
            weights.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if out_mask is None else out_mask.data_ptr(),
            out.data_ptr(), Vin, V, K, Cin, Cout,
            int(compute_dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_matmul kernel launch failed: CUDA error "
                           f"{err} (V={V}, K={K}, Cin={Cin}, Cout={Cout})")
    gather_matmul.launches += 1
    return out


gather_matmul.launches = 0
