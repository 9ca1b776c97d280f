"""The sparse conv's hand-written Hopper kernels and its gradient
(counterpart of ``rslo_tpu/ops/dma_gather.py``).

  * ``gather_matmul`` computes ``sparse_conv_apply``'s contract,
    ``out[v] = sum_k valid[v,k] * f[idx[v,k]] @ W[k]`` (+ bias, zeroed
    where ``out_mask`` is false), with operands rounded to the compute
    dtype and fp32 sums (``csrc/gather_matmul.cu``, replacing
    ``dma_gather_matmul``; its body is the gather-GEMM of
    ``csrc/gather_gemm.cuh``, shared with the band engine's B4).
  * ``gather_matmul_dgrad`` is the same kernel's feature-gradient mode
    over a transposed rulebook (plain version ``sparse_conv_dgrad``).
  * ``row_gather`` is ``features[idx]`` (``csrc/row_gather.cu``,
    replacing ``dma_row_gather``); its fused mode writes the d_W im2col
    (invalid taps zeroed, rounded to the compute dtype) in one pass.
  * ``sparse_conv`` is the differentiable conv: a
    ``torch.autograd.Function`` whose backward is the two kernels above
    plus one f32 matrix product, equal to JAX's autodiff of
    ``sparse_conv_apply``.

Each wrapper launches its kernel on a CUDA tensor or raises; on a CPU
tensor it runs the plain version.  There is no fallback from one to the
other.  Each counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .precision import f32_matmul
from .sparse_conv import (ConvIndex, round_operand, sparse_conv_apply,
                          sparse_conv_dgrad)

_COMPUTE_DTYPES = (torch.bfloat16, torch.float32)


# kernel modes of csrc/gather_matmul.cu
_MODE_F32, _MODE_BF16, _MODE_BF16_DGRAD = 0, 1, 2


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built and loaded at the first CUDA call."""
    lib = _build.load_library("gather_matmul")
    lib.gather_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.gather_matmul_launch.restype = ctypes.c_int
    lib.gather_matmul_max_channels.argtypes = []
    lib.gather_matmul_max_channels.restype = ctypes.c_int
    lib.gather_matmul_shared_bytes.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    lib.gather_matmul_shared_bytes.restype = ctypes.c_int
    return lib


@functools.cache
def _row_gather_library() -> ctypes.CDLL:
    lib = _build.load_library("row_gather")
    lib.row_gather_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.row_gather_launch.restype = ctypes.c_int
    lib.row_gather_fused_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.row_gather_fused_launch.restype = ctypes.c_int
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


def require_cuda(dev, name, tensors):
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous operands")


def _launch_gather_matmul(features, idx, valid, weights, bias, out_mask,
                          mode):
    V, K = idx.shape
    Vin, Cin = features.shape
    Cout = weights.shape[2]
    lib = _library()
    max_c = lib.gather_matmul_max_channels()
    if Cin > max_c or Cout > max_c:
        raise ValueError(f"gather_matmul takes Cin, Cout <= {max_c}, got "
                         f"{Cin}, {Cout}")
    dev = features.device
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
            out.data_ptr(), Vin, V, K, Cin, Cout, mode,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_matmul kernel launch failed: CUDA error "
                           f"{err} (V={V}, K={K}, Cin={Cin}, Cout={Cout}, "
                           f"mode={mode})")
    return out


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
    require_cuda(dev, "gather_matmul", tensors)
    out = _launch_gather_matmul(
        features, idx, valid, weights, bias, out_mask,
        _MODE_BF16 if compute_dtype == torch.bfloat16 else _MODE_F32)
    if idx.shape[0]:
        gather_matmul.launches += 1
    return out


gather_matmul.launches = 0


def gather_matmul_dgrad(ct: torch.Tensor, idx_t: torch.Tensor,
                        valid_t: torch.Tensor, weights_t: torch.Tensor,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Feature gradient of a sparse conv over its transposed rulebook.

    ct (V, Cout) f32 output cotangent (zero on masked rows); idx_t,
    valid_t (Vin, K) the transposed rulebook (rows into ct); weights_t
    (K, Cout, Cin) f32, already rounded to ``compute_dtype``, transposed
    and (for a submanifold conv) tap-flipped.  Returns (Vin, Cin) f32
    = sum_k valid_t * round(ct[idx_t] @ weights_t[k]), each tap's
    partial rounded to ``compute_dtype``.  Launches
    ``csrc/gather_matmul.cu`` in its backward mode on a CUDA tensor
    (counted in ``gather_matmul_dgrad.launches``)."""
    tensors = _check(ct, idx_t, valid_t, weights_t, None, None,
                     compute_dtype)
    dev = ct.device
    if dev.type == "cpu":
        return sparse_conv_dgrad(ct, ConvIndex(idx_t, valid_t), weights_t,
                                 compute_dtype)
    require_cuda(dev, "gather_matmul_dgrad", tensors)
    out = _launch_gather_matmul(
        ct, idx_t, valid_t, weights_t, None, None,
        _MODE_BF16_DGRAD if compute_dtype == torch.bfloat16 else _MODE_F32)
    if idx_t.shape[0]:
        gather_matmul_dgrad.launches += 1
    return out


gather_matmul_dgrad.launches = 0


def row_gather(features: torch.Tensor, idx: torch.Tensor,
               check: bool = True, valid: Optional[torch.Tensor] = None,
               compute_dtype=None) -> torch.Tensor:
    """``features[idx]`` for features (Vin, C) of a 4-byte dtype and idx
    (N,) int32 in [0, Vin); out-of-range indices raise.  ``check=False``
    skips that range check (and its device sync) for indices that are in
    range by construction, as a rulebook's are.

    With ``valid`` ((N,) bool) or ``compute_dtype`` (torch.bfloat16 or
    torch.float32) it is the sparse conv's d_W im2col in one pass:
    ``round_operand(torch.where(valid[:, None], features[idx], 0),
    compute_dtype)`` for float32 features (``valid`` None: every row;
    ``compute_dtype`` None: float32, no rounding).  A row whose valid is
    False is written as zeros (the kernel does not read its feature
    row).  Launches ``csrc/row_gather.cu`` on a CUDA tensor (counted in
    ``row_gather.launches``)."""
    if features.dim() != 2 or features.element_size() != 4:
        raise ValueError(f"features must be (Vin, C) of a 4-byte dtype, "
                         f"got {tuple(features.shape)} {features.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be (N,) int32, got {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if idx.device != features.device:
        raise ValueError("row_gather operands lie on different devices")
    N = idx.shape[0]
    Vin, C = features.shape
    fused = valid is not None or compute_dtype is not None
    if fused:
        compute_dtype = compute_dtype or torch.float32
        if features.dtype != torch.float32:
            raise ValueError(f"the fused im2col takes float32 features, got "
                             f"{features.dtype}")
        if compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{_COMPUTE_DTYPES}, got {compute_dtype}")
        if valid is not None and (tuple(valid.shape) != (N,) or
                                  valid.dtype != torch.bool or
                                  valid.device != features.device):
            raise ValueError(f"valid must be ({N},) bool on "
                             f"{features.device}, got {tuple(valid.shape)} "
                             f"{valid.dtype} on {valid.device}")
    if N and check:
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= Vin:
            raise IndexError(f"row_gather index out of range [0, {Vin}): "
                             f"min {lo}, max {hi}")
    dev = features.device
    if dev.type == "cpu":
        g = features[idx]
        if valid is not None:
            g = torch.where(valid[:, None], g, 0.0)
        return round_operand(g, compute_dtype) if fused else g
    require_cuda(dev, "row_gather",
                 [t for t in (features, idx, valid) if t is not None])
    return _launch_row_gather(features, idx, valid, compute_dtype)


def _launch_row_gather(features: torch.Tensor, idx: torch.Tensor,
                       valid: Optional[torch.Tensor] = None,
                       compute_dtype=None) -> torch.Tensor:
    """The kernel launch of ``row_gather``, after its checks: the fused
    im2col when ``valid`` or ``compute_dtype`` is given."""
    N = idx.shape[0]
    Vin, C = features.shape
    dev = features.device
    out = torch.empty((N, C), dtype=features.dtype, device=dev)
    if N == 0 or C == 0:
        return out
    lib = _row_gather_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if valid is None and compute_dtype is None:
            err = lib.row_gather_launch(features.data_ptr(), idx.data_ptr(),
                                        out.data_ptr(), N, C, stream)
        else:
            err = lib.row_gather_fused_launch(
                features.data_ptr(), idx.data_ptr(),
                None if valid is None else valid.data_ptr(), out.data_ptr(),
                N, C, int(compute_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"row_gather kernel launch failed: CUDA error "
                           f"{err} (N={N}, C={C})")
    row_gather.launches += 1
    return out


row_gather.launches = 0


class _SparseConv(torch.autograd.Function):
    """``gather_matmul`` with JAX's autodiff of ``sparse_conv_apply`` as
    its backward.  With ct the output cotangent zeroed where
    ``out_mask`` is false, r() the rounding to the compute dtype and W_r
    = r(W):
      d_features[u] = sum over (v, k) with idx[v,k] = u, valid, of
                      r(ct[v] @ W_r[k]^T)       (transposed rulebook)
      d_W[k]        = r(sum_v valid[v,k] r(f[idx[v,k]])^T ct[v])
      d_bias        = sum_v ct[v]
    """

    @staticmethod
    def forward(ctx, features, weights, bias, rulebook, rulebook_t,
                flip_taps, out_mask, compute_dtype):
        ctx.save_for_backward(features, weights, rulebook.idx,
                              rulebook.valid, rulebook_t.idx,
                              rulebook_t.valid, out_mask)
        ctx.flip_taps = flip_taps
        ctx.compute_dtype = compute_dtype
        return gather_matmul(features, rulebook.idx, rulebook.valid,
                             weights, bias, out_mask, compute_dtype)

    @staticmethod
    def backward(ctx, ct):
        features, weights, idx, valid, idx_t, valid_t, out_mask = \
            ctx.saved_tensors
        ct = ct.contiguous()
        if out_mask is not None:
            ct = torch.where(out_mask[:, None], ct, 0.0)
        d_feat, d_w = sparse_conv_grads(
            features, weights, ConvIndex(idx, valid),
            ConvIndex(idx_t, valid_t), ctx.flip_taps, ct, ctx.compute_dtype,
            *ctx.needs_input_grad[:2])
        d_bias = ct.sum(0) if ctx.needs_input_grad[2] else None
        return d_feat, d_w, d_bias, None, None, None, None, None


def sparse_conv_grads(features: torch.Tensor, weights: torch.Tensor,
                      rulebook: ConvIndex, rulebook_t: ConvIndex,
                      flip_taps: bool, ct: torch.Tensor, compute_dtype,
                      need_features: bool = True,
                      need_weights: bool = True):
    """(d_features, d_W) of ``gather_matmul`` for the output cotangent
    ``ct`` (already zeroed where ``out_mask`` is false); either is None
    when not needed.  d_features runs ``gather_matmul_dgrad`` over
    ``rulebook_t``; d_W is ``row_gather``'s fused im2col times ``ct`` in
    one f32 product, rounded to the compute dtype (see ``_SparseConv``)."""
    d_feat = d_w = None
    if need_features:
        w_t = round_operand(weights, compute_dtype)
        if flip_taps:
            w_t = w_t.flip(0)
        d_feat = gather_matmul_dgrad(
            ct, rulebook_t.idx, rulebook_t.valid,
            w_t.transpose(1, 2).contiguous(), compute_dtype)
    if need_weights:
        V, K = rulebook.idx.shape
        Cin = features.shape[1]
        # rulebook rows lie in [0, Vin) by construction (the slot-map
        # lookup clamps them); one pass gathers, zeroes the invalid taps
        # and rounds to the compute dtype
        g = row_gather(features.contiguous(), rulebook.idx.reshape(-1),
                       check=False, valid=rulebook.valid.reshape(-1),
                       compute_dtype=compute_dtype)
        with f32_matmul():
            d_w = g.reshape(V, K * Cin).t() @ ct
        d_w = round_operand(d_w, compute_dtype).reshape(K, Cin, -1)
    return d_feat, d_w


def sparse_conv(features: torch.Tensor, rulebook: ConvIndex,
                rulebook_t: ConvIndex, weights: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_mask: Optional[torch.Tensor] = None,
                compute_dtype=torch.bfloat16,
                flip_taps: bool = False) -> torch.Tensor:
    """Differentiable ``gather_matmul``.  ``rulebook_t`` is the
    transposed rulebook (for every in row, the out rows that read it,
    per tap); ``flip_taps`` is True for a submanifold conv, whose
    transpose is its own rulebook with the taps flipped."""
    return _SparseConv.apply(features, weights, bias, rulebook,
                             rulebook_t, flip_taps, out_mask,
                             compute_dtype)
