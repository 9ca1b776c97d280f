"""Banded sparse-conv engine (counterpart of ``rslo_tpu/ops/band_conv.py``).

Both the out sites and the in sites of every rulebook are sorted by
linearized voxel id, and each kernel tap adds a constant id offset, so
per tap the map ``out row -> in row`` is monotone and the in rows that a
block of B consecutive out rows reads lie in a narrow window.  A band
plan (``BandIndex``, built once per frame from a rulebook by
``build_band_index``) stores per (block, tap) the window start ``base``
and per row the offset ``sel`` inside the window (-1 for none).  Pairs
whose in row falls outside its window ("overflow") go to a compacted
list applied by a scatter-add, so the conv stays exact while that list
has room; ``overflow_saturated`` says when it had not.

Plans and their integer fields are bit-equal to the JAX package's.

Kernels (``csrc/band_conv.cu``, built at first use):
  * ``band_matmul`` (B4, replacing ``_windowed_pallas_conv``): the
    in-window pairs of the conv, (Vp, Cout) f32 =
    sum_k [sel >= 0] rnd(f[base + sel]) @ rnd(W[k]);
  * ``band_matmul_dgrad``: the same kernel for the submanifold
    d_features (tap-flipped, transposed weights over the same plan),
    counted apart;
  * ``band_gather`` (B5, replacing ``_windowed_pallas_gather``): the
    same selection written as an im2col (Vp, K*Cin) in the compute dtype;
    with ``overflow=`` it is the submanifold d_W operand in one call, the
    im2col plus the overflow rows in float32 (``_overflow_add_g`` and
    ``astype(f32)`` of JAX's custom VJP fused in).
Their plain versions ``band_conv_plain``, ``band_gather_plain`` and
``band_gather_dw_plain`` sit beside them.  Each wrapper launches its
kernel on a CUDA tensor or raises, and runs the plain version on a CPU
tensor; each counts its launches in ``<wrapper>.launches``.

``band_conv_apply`` follows the JAX package's Pallas path
(``_full_pallas_raw``): the in-window sums, then the overflow pairs in
f32 with neither features nor weights rounded.  JAX's XLA fallback
(``_full_xla``) rounds the overflow rows to the compute dtype instead;
the two differ in bf16 wherever a plan overflows.  ``band_conv`` is the
differentiable conv, with JAX's custom VJP as its backward.

``RSLO_BAND_IMPL`` (the JAX package's choice between the Pallas kernel
and the XLA one-hot formulation) is not ported: on the card B4 runs every
time.  The plain version is the kernel's reference, not a fallback.
``RSLO_BAND_CHECK`` is: when it is set, applying a saturated plan raises.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional

import torch

from . import _build
from .dma_gather import require_cuda, sparse_conv_grads
from .precision import f32_matmul
from .sparse_conv import ConvIndex, round_operand

_COMPUTE_DTYPES = (torch.bfloat16, torch.float32)

# Per-rulebook-kind window widths (subm, down, inverse) of the JAX
# package, all multiples of 128.
SUBM_WINDOW = 384
DOWN_WINDOW = 1280
INV_WINDOW = 768


class BandIndex(NamedTuple):
    """Banded gather plan of one rulebook (built once per frame).

    base:     (nB, K) int32 window starts into the in level's rows, in
              [0, v_in - window], multiples of 16.
    sel:      (nB, K, B) int32 in-window offsets (in row - base), -1 for
              invalid and out-of-window taps.
    ov_out:   (OV,) int32 overflow out row (Vp = nB * B: dropped slot).
    ov_in:    (OV,) int32 overflow in row.
    ov_tap:   (OV,) int32 overflow tap.
    ov_count: () int32 number of valid out-of-window pairs; the plan
              stores at most OV of them.
    v_out:    true number of out rows.
    v_in:     padded in-row count the bases were clamped against.
    window:   window width W.
    self_transpose: the plan of a submanifold rulebook, which is its own
              transpose with the taps flipped; its d_features is B4 over
              the same plan.
    """
    base: torch.Tensor
    sel: torch.Tensor
    ov_out: torch.Tensor
    ov_in: torch.Tensor
    ov_tap: torch.Tensor
    ov_count: torch.Tensor
    v_out: int
    v_in: int
    window: int
    self_transpose: bool = False

    @property
    def ov_capacity(self) -> int:
        return self.ov_out.shape[0]


def overflow_saturated(band: BandIndex) -> torch.Tensor:
    """() bool: True iff overflow pairs were dropped (plan inexact)."""
    return band.ov_count > band.ov_capacity


def build_band_index(rulebook: ConvIndex, v_in: int, block: int = 256,
                     window: int = SUBM_WINDOW, ov_capacity: int = 4096,
                     self_transpose: bool = False) -> BandIndex:
    """Convert a rulebook into a banded gather plan.

    v_in: the in level's row capacity.  Window starts are floored to a
    multiple of 16 and clamped to [0, vp_in - W], where vp_in is
    max(v_in, W) rounded up to 16; ``band_conv_apply`` pads the features
    to that many rows."""
    idx, valid = rulebook.idx, rulebook.valid
    V, K = idx.shape
    dev = idx.device
    B = min(block, V)
    nB = -(-V // B)
    Vp = nB * B
    Wd = min(window, max(v_in, window))
    vp_in = -(-max(v_in, Wd) // 16) * 16

    idx = torch.cat([idx, torch.zeros((Vp - V, K), dtype=idx.dtype,
                                      device=dev)])
    valid = torch.cat([valid, torch.zeros((Vp - V, K), dtype=torch.bool,
                                          device=dev)])
    idx_b = idx.reshape(nB, B, K)
    val_b = valid.reshape(nB, B, K)
    big = torch.iinfo(torch.int32).max
    base = torch.where(val_b, idx_b, big).amin(dim=1)         # (nB, K)
    base = torch.where(base == big, 0, base)
    base = torch.div(base, 16, rounding_mode="floor") * 16
    base = torch.clamp(base, 0, vp_in - Wd).to(torch.int32)

    delta = idx_b - base[:, None, :]                           # (nB, B, K)
    in_win = val_b & (delta >= 0) & (delta < Wd)
    sel = torch.where(in_win, delta, -1).to(torch.int32)
    sel = sel.permute(0, 2, 1).contiguous()                    # (nB, K, B)

    # Overflow pairs (valid but out of window), compacted by rank: the
    # (r+1)-th set flag sits at searchsorted(cum, r+1), and past ov_count
    # searchsorted returns Vp*K, which decodes to the ov_out == Vp drop
    # slot.  With no overflow every query gives Vp*K, so no branch on the
    # count (and no device-to-host sync) is needed.
    ov_flag = (valid & ~in_win.reshape(Vp, K)).reshape(-1)
    ov_count = ov_flag.sum(dtype=torch.int32)
    cum = torch.cumsum(ov_flag, 0, dtype=torch.int32)
    packed = torch.searchsorted(
        cum, torch.arange(1, ov_capacity + 1, dtype=torch.int32,
                          device=dev), out_int32=True)
    ov_out = torch.div(packed, K, rounding_mode="floor")
    ov_tap = packed % K
    ov_in = idx.reshape(-1)[torch.clamp(packed, max=Vp * K - 1).long()]
    keep = ov_out < Vp
    ov_in = torch.where(keep, ov_in, 0).to(torch.int32)
    ov_tap = torch.where(keep, ov_tap, 0).to(torch.int32)
    return BandIndex(base, sel, ov_out.to(torch.int32), ov_in, ov_tap,
                     ov_count, V, vp_in, Wd, self_transpose)


# ---------------------------------------------------------------------------
# Plain versions

def _sources(base: torch.Tensor, sel: torch.Tensor):
    """(Vp*K,) int64 in row of every (out row, tap), 0 where there is
    none, and its (Vp*K, 1) validity; out-row major, tap minor."""
    valid = (sel >= 0).permute(0, 2, 1).reshape(-1, 1)
    src = (base[:, :, None] + sel).permute(0, 2, 1).reshape(-1)
    return torch.where(valid[:, 0], src, 0).long(), valid


def band_gather_plain(f_pad: torch.Tensor, base: torch.Tensor,
                      sel: torch.Tensor, compute_dtype) -> torch.Tensor:
    """(Vp, K*Cin) in ``compute_dtype``: row v, tap k holds
    f_pad[base + sel] rounded, or 0 where sel is -1."""
    nB, K, B = sel.shape
    src, valid = _sources(base, sel)
    g = torch.where(valid, f_pad[src], 0.0)
    return g.reshape(nB * B, K * f_pad.shape[1]).to(compute_dtype)


def overflow_add_g(g: torch.Tensor, f_pad: torch.Tensor, ov_out: torch.Tensor,
                   ov_in: torch.Tensor, ov_tap: torch.Tensor) -> torch.Tensor:
    """The im2col ``g`` (Vp, K*Cin) plus the overflow pairs' rows,
    f_pad[ov_in] rounded to g's dtype and added in it
    (``_overflow_add_g``).  Dropped slots (ov_out == Vp) add nothing."""
    Vp = g.shape[0]
    Cin = f_pad.shape[1]
    K = g.shape[1] // Cin
    rows = torch.where(ov_out < Vp, ov_out * K + ov_tap, Vp * K).long()
    g = torch.cat([g.reshape(Vp * K, Cin), g.new_zeros(1, Cin)])
    g.index_add_(0, rows, f_pad[ov_in.long()].to(g.dtype))
    return g[:-1].reshape(Vp, K * Cin)


def band_gather_dw_plain(f_pad: torch.Tensor, base: torch.Tensor,
                         sel: torch.Tensor, compute_dtype,
                         overflow) -> torch.Tensor:
    """(Vp, K*Cin) float32, the submanifold d_W operand of JAX's custom
    VJP: ``band_gather_plain``'s im2col, the overflow pairs (ov_out,
    ov_in, ov_tap) added in ``compute_dtype``, widened to float32."""
    g = band_gather_plain(f_pad, base, sel, compute_dtype)
    return overflow_add_g(g, f_pad, *overflow).float()


def band_conv_plain(f_pad: torch.Tensor, w: torch.Tensor,
                    base: torch.Tensor, sel: torch.Tensor,
                    compute_dtype) -> torch.Tensor:
    """(Vp, Cout) f32 over the in-window pairs: f_pad[base + sel] and
    w rounded to ``compute_dtype`` and multiplied as f32 tensors (exact
    products; a bf16 ``torch.matmul`` would round its output)."""
    K, Cin, Cout = w.shape
    g = band_gather_plain(f_pad, base, sel, compute_dtype).float()
    return g @ round_operand(w.reshape(K * Cin, Cout), compute_dtype)


# ---------------------------------------------------------------------------
# Kernels

@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, built and loaded at the first CUDA call."""
    lib = _build.load_library("band_conv")
    lib.band_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.band_matmul_launch.restype = ctypes.c_int
    lib.band_gather_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.band_gather_launch.restype = ctypes.c_int
    lib.band_gather_fused_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.band_gather_fused_launch.restype = ctypes.c_int
    lib.band_matmul_max_channels.argtypes = []
    lib.band_matmul_max_channels.restype = ctypes.c_int
    return lib


def _check(name, f_pad, base, sel, compute_dtype, w=None):
    if f_pad.dim() != 2 or f_pad.dtype != torch.float32:
        raise ValueError(f"{name}: features must be (Vin, Cin) float32, got "
                         f"{tuple(f_pad.shape)} {f_pad.dtype}")
    if sel.dim() != 3 or sel.dtype != torch.int32:
        raise ValueError(f"{name}: sel must be (nB, K, B) int32, got "
                         f"{tuple(sel.shape)} {sel.dtype}")
    nB, K, _ = sel.shape
    if tuple(base.shape) != (nB, K) or base.dtype != torch.int32:
        raise ValueError(f"{name}: base must be ({nB}, {K}) int32, got "
                         f"{tuple(base.shape)} {base.dtype}")
    if w is not None and (w.dim() != 3 or w.dtype != torch.float32 or
                          tuple(w.shape[:2]) != (K, f_pad.shape[1])):
        raise ValueError(f"{name}: weights must be ({K}, {f_pad.shape[1]}, "
                         f"Cout) float32, got {tuple(w.shape)} {w.dtype}")
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"{name}: compute_dtype must be one of "
                         f"{_COMPUTE_DTYPES}, got {compute_dtype}")
    tensors = [t for t in (f_pad, base, sel, w) if t is not None]
    if any(t.device != f_pad.device for t in tensors):
        raise ValueError(f"{name} operands lie on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if f_pad.shape[0] == 0:
        raise ValueError(f"{name} needs at least one feature row")
    return tensors


def _launch_band_matmul(f_pad, w, base, sel, compute_dtype):
    nB, K, B = sel.shape
    Vin, Cin = f_pad.shape
    Cout = w.shape[2]
    lib = _library()
    max_c = lib.band_matmul_max_channels()
    if Cin > max_c or Cout > max_c:
        raise ValueError(f"band_matmul takes Cin, Cout <= {max_c}, got "
                         f"{Cin}, {Cout}")
    dev = f_pad.device
    out = torch.empty((nB * B, Cout), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.band_matmul_launch(
            f_pad.data_ptr(), base.data_ptr(), sel.data_ptr(), w.data_ptr(),
            out.data_ptr(), Vin, nB, K, B, Cin, Cout,
            int(compute_dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"band_matmul kernel launch failed: CUDA error "
                           f"{err} (nB={nB}, K={K}, B={B}, Cin={Cin}, "
                           f"Cout={Cout})")
    return out


def band_matmul(f_pad: torch.Tensor, w: torch.Tensor, base: torch.Tensor,
                sel: torch.Tensor, compute_dtype=torch.bfloat16
                ) -> torch.Tensor:
    """B4: the in-window pairs of a band conv.

    f_pad (Vin, Cin) f32 padded features; w (K, Cin, Cout) f32; base
    (nB, K) and sel (nB, K, B) int32 of a plan.  Returns (nB*B, Cout)
    f32.  Launches ``csrc/band_conv.cu`` on a CUDA tensor (counted in
    ``band_matmul.launches``); runs ``band_conv_plain`` on a CPU one."""
    tensors = _check("band_matmul", f_pad, base, sel, compute_dtype, w)
    if f_pad.device.type == "cpu":
        return band_conv_plain(f_pad, w, base, sel, compute_dtype)
    require_cuda(f_pad.device, "band_matmul", tensors)
    out = _launch_band_matmul(f_pad, w, base, sel, compute_dtype)
    band_matmul.launches += 1
    return out


band_matmul.launches = 0


def band_matmul_dgrad(ct_pad: torch.Tensor, w_t: torch.Tensor,
                      base: torch.Tensor, sel: torch.Tensor,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """B4 in the submanifold d_features: ``band_matmul`` of the padded
    output cotangent with the tap-flipped, transposed weights w_t (K,
    Cout, Cin) over the conv's own plan; the kernel rounds both to the
    compute dtype.  Counted in ``band_matmul_dgrad.launches``."""
    tensors = _check("band_matmul_dgrad", ct_pad, base, sel, compute_dtype,
                     w_t)
    if ct_pad.device.type == "cpu":
        return band_conv_plain(ct_pad, w_t, base, sel, compute_dtype)
    require_cuda(ct_pad.device, "band_matmul_dgrad", tensors)
    out = _launch_band_matmul(ct_pad, w_t, base, sel, compute_dtype)
    band_matmul_dgrad.launches += 1
    return out


band_matmul_dgrad.launches = 0


def _check_overflow(overflow, device):
    """The (ov_out, ov_in, ov_tap) of a plan: three (OV,) contiguous int32
    tensors on ``device``."""
    if not (isinstance(overflow, (tuple, list)) and len(overflow) == 3 and
            all(isinstance(t, torch.Tensor) for t in overflow)):
        raise ValueError("band_gather: overflow must be the tensors "
                         "(ov_out, ov_in, ov_tap)")
    n = overflow[0].shape
    for name, t in zip(("ov_out", "ov_in", "ov_tap"), overflow):
        if (t.dim() != 1 or t.shape != n or t.dtype != torch.int32 or
                t.device != device or not t.is_contiguous()):
            raise ValueError(
                f"band_gather: {name} must be a contiguous {tuple(n)} int32 "
                f"tensor on {device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")
    return list(overflow)


def band_gather(f_pad: torch.Tensor, base: torch.Tensor, sel: torch.Tensor,
                compute_dtype=torch.bfloat16, overflow=None) -> torch.Tensor:
    """B5: the plan's selection as an im2col, (nB*B, K*Cin) in
    ``compute_dtype``, zero where sel is -1.

    With ``overflow`` = (ov_out, ov_in, ov_tap) of the plan it is the
    submanifold conv's d_W operand in one call: (nB*B, K*Cin) float32,
    bit-equal to ``band_gather_dw_plain`` (the im2col, the overflow rows
    added in ``compute_dtype``, widened).  Launches ``csrc/band_conv.cu``
    on a CUDA tensor (counted in ``band_gather.launches``, once a call in
    either mode); runs the plain version on a CPU one."""
    tensors = _check("band_gather", f_pad, base, sel, compute_dtype)
    if overflow is not None:
        tensors += _check_overflow(overflow, f_pad.device)
    if f_pad.device.type == "cpu":
        if overflow is None:
            return band_gather_plain(f_pad, base, sel, compute_dtype)
        return band_gather_dw_plain(f_pad, base, sel, compute_dtype, overflow)
    require_cuda(f_pad.device, "band_gather", tensors)
    nB, K, B = sel.shape
    Vin, Cin = f_pad.shape
    dev = f_pad.device
    out = torch.empty((nB * B, K * Cin), device=dev, dtype=(
        compute_dtype if overflow is None else torch.float32))
    if out.numel() == 0:
        return out
    bf16 = int(compute_dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if overflow is None:
            err = _library().band_gather_launch(
                f_pad.data_ptr(), base.data_ptr(), sel.data_ptr(),
                out.data_ptr(), Vin, nB, K, B, Cin, bf16, stream)
        else:
            err = _library().band_gather_fused_launch(
                f_pad.data_ptr(), base.data_ptr(), sel.data_ptr(),
                *(t.data_ptr() for t in overflow), out.data_ptr(), Vin, nB,
                K, B, Cin, overflow[0].shape[0], bf16, stream)
    if err != 0:
        raise RuntimeError(f"band_gather kernel launch failed: CUDA error "
                           f"{err} (nB={nB}, K={K}, B={B}, Cin={Cin}, "
                           f"fused={overflow is not None})")
    band_gather.launches += 1
    return out


band_gather.launches = 0


# ---------------------------------------------------------------------------
# The conv

def pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``n`` rows (as it is if it has
    that many)."""
    if x.shape[0] >= n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])])


def overflow_add_out(out: torch.Tensor, f_pad: torch.Tensor,
                     w: torch.Tensor, band: BandIndex) -> torch.Tensor:
    """``out`` (Vp, Cout) f32 plus the plan's overflow pairs, each
    f_pad[ov_in] @ w[ov_tap] in f32 with neither operand rounded (the
    JAX Pallas path's epilogue).  Dropped slots add nothing."""
    Vp, Cout = out.shape
    keep = band.ov_out < Vp
    with f32_matmul():
        vals = torch.bmm(f_pad[band.ov_in.long()].unsqueeze(1),
                         w[band.ov_tap.long()]).squeeze(1)
    vals = torch.where(keep[:, None], vals, 0.0)
    out = torch.cat([out, out.new_zeros(1, Cout)])
    out.index_add_(0, torch.clamp(band.ov_out, max=Vp).long(), vals)
    return out[:-1]


def _check_saturation(band: BandIndex):
    """The opt-in ``RSLO_BAND_CHECK`` guard (a device-to-host sync, so
    off by default)."""
    if os.environ.get("RSLO_BAND_CHECK") and bool(overflow_saturated(band)):
        raise RuntimeError(
            f"band plan overflow saturated: {int(band.ov_count)} pairs > "
            f"capacity {band.ov_capacity}; the conv result is inexact; "
            f"widen band_windows or raise ov_capacity")


def band_conv_apply(features: torch.Tensor, band: BandIndex,
                    weights: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    out_mask: Optional[torch.Tensor] = None,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Sparse conv through a band plan.

    features (V_in, Cin) f32; weights (K, Cin, Cout) f32.  Returns
    (v_out, Cout) f32: B4's in-window sums plus the overflow pairs in
    f32, cut to v_out rows, plus ``bias``, zeroed where ``out_mask`` is
    false (in that order)."""
    _check_saturation(band)
    f_pad = pad_rows(features, band.v_in).contiguous()
    out = band_matmul(f_pad, weights, band.base, band.sel, compute_dtype)
    out = overflow_add_out(out, f_pad, weights, band)[:band.v_out]
    if bias is not None:
        out = out + bias
    if out_mask is not None:
        out = torch.where(out_mask[:, None], out, 0.0)
    return out


class _BandConv(torch.autograd.Function):
    """``band_conv_apply`` with the JAX package's custom VJP of the
    Pallas band conv as its backward.  With ct the output cotangent
    zeroed where ``out_mask`` is false:

    self-transpose (submanifold) plans:
      d_features = B4 over the same plan of ct (padded to v_in rows and
                   rounded to the compute dtype inside the kernel) with
                   w_t = flip(W, taps)^T, plus the overflow pairs in f32;
      d_W        = B5's fused mode (its im2col plus the overflow rows in
                   the compute dtype, as f32) times ct in one f32
                   product, not rounded;
    other plans (down, inverse): JAX differentiates the XLA formulation,
    which is the rulebook conv's autodiff on the same pairs, so the
    backward is ``sparse_conv_grads`` over the raw rulebook and its
    transpose (B1's dgrad mode, B2's im2col, d_W rounded).
      d_bias     = sum_v ct[v].
    """

    @staticmethod
    def forward(ctx, features, weights, bias, band, out_mask, compute_dtype,
                rulebook, rulebook_t):
        ctx.save_for_backward(features, weights, out_mask)
        ctx.band = band
        ctx.rulebooks = (rulebook, rulebook_t)
        ctx.compute_dtype = compute_dtype
        return band_conv_apply(features, band, weights, bias, out_mask,
                               compute_dtype)

    @staticmethod
    def backward(ctx, ct):
        features, weights, out_mask = ctx.saved_tensors
        band, cdt = ctx.band, ctx.compute_dtype
        need_f, need_w, need_b = ctx.needs_input_grad[:3]
        ct = ct.contiguous()
        if out_mask is not None:
            ct = torch.where(out_mask[:, None], ct, 0.0)
        d_feat = d_w = None
        if not band.self_transpose:
            rulebook, rulebook_t = ctx.rulebooks
            d_feat, d_w = sparse_conv_grads(features, weights, rulebook,
                                            rulebook_t, False, ct, cdt,
                                            need_f, need_w)
        if band.self_transpose and need_f:
            w_t = weights.flip(0).transpose(1, 2).contiguous()
            ct_pad = pad_rows(ct, band.v_in)
            df = band_matmul_dgrad(ct_pad, w_t, band.base, band.sel, cdt)
            df = overflow_add_out(df, ct_pad, w_t, band)
            d_feat = pad_rows(df[:band.v_in], band.v_in)
            d_feat = d_feat[:features.shape[0]]
        if band.self_transpose and need_w:
            K, Cin, Cout = weights.shape
            f_pad = pad_rows(features, band.v_in).contiguous()
            g = band_gather(f_pad, band.base, band.sel, cdt,
                            overflow=(band.ov_out, band.ov_in, band.ov_tap))
            with f32_matmul():
                d_w = g.t() @ pad_rows(ct, g.shape[0])
            d_w = d_w.reshape(K, Cin, Cout)
        d_bias = ct.sum(0) if need_b else None
        return d_feat, d_w, d_bias, None, None, None, None, None


def band_conv(features: torch.Tensor, band: BandIndex, weights: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              out_mask: Optional[torch.Tensor] = None,
              compute_dtype=torch.bfloat16,
              rulebook: Optional[ConvIndex] = None,
              rulebook_t: Optional[ConvIndex] = None) -> torch.Tensor:
    """Differentiable ``band_conv_apply``.  A plan that is not
    self-transpose needs the raw ``rulebook`` it was built from and its
    transposed rulebook ``rulebook_t`` for the backward."""
    if not band.self_transpose and (rulebook is None or rulebook_t is None):
        raise ValueError("band_conv of a down or inverse plan needs its raw "
                         "rulebook and the transposed rulebook for the "
                         "backward: build the geometry with transposed=True")
    return _BandConv.apply(features, weights, bias, band, out_mask,
                           compute_dtype, rulebook, rulebook_t)
