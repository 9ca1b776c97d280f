"""Sparse 3D convolution geometry and the plain conv apply on torch
tensors (counterpart of ``rslo_tpu/ops/sparse_conv.py``; the slot-map
lookup path only).

  * A *level* is a fixed-capacity set of active voxels with coordinates
    sorted by linearized (z, y, x) id, padding rows at the end with the
    sentinel id ``nz*ny*nx``.
  * A level's dense *slot map* ((nz*ny*nx + 1,) int32, id -> slot+1,
    0 = inactive) turns each neighbor lookup into one gather.
  * A *rulebook* (``ConvIndex``) holds, per (out site, kernel tap), the
    row of the contributing in site and whether it exists.  Rulebooks
    are built once per frame and shared by every layer at that
    geometry.

Every index computed here is integer arithmetic on int32 tensors, so
levels and rulebooks are bit-equal to the JAX package's.  Floor
division and ``%`` on negative coordinates follow Python semantics in
both frameworks.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SparseLevel:
    """coords (V, 3) int32 zyx, -1 on padding; ids (V,) int32 sorted
    ascending, sentinel on padding; mask (V,) bool; shape (nz, ny, nx);
    slot_map optional (nz*ny*nx + 1,) int32 id -> slot+1 table."""
    coords: torch.Tensor
    ids: torch.Tensor
    mask: torch.Tensor
    shape: tuple
    slot_map: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    @property
    def sentinel(self) -> int:
        nz, ny, nx = self.shape
        return nz * ny * nx


class ConvIndex(NamedTuple):
    """Rulebook: idx (V_out, K) int32 row into the in level's features;
    valid (V_out, K) bool."""
    idx: torch.Tensor
    valid: torch.Tensor


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=device)


def linearize(coords: torch.Tensor, shape) -> torch.Tensor:
    nz, ny, nx = shape
    return (coords[..., 0] * ny + coords[..., 1]) * nx + coords[..., 2]


def level_from_coords(coords: torch.Tensor, mask: torch.Tensor,
                      shape) -> SparseLevel:
    """Sorted SparseLevel from (V, 3) zyx coords + validity mask (coords
    of valid rows must lie inside ``shape``)."""
    nz, ny, nx = shape
    sent = nz * ny * nx
    ids = torch.where(mask, linearize(coords, shape), sent).to(torch.int32)
    ids, order = torch.sort(ids, stable=True)
    coords = torch.where(mask[order, None], coords[order], -1)
    return SparseLevel(coords, ids, ids < sent, (nz, ny, nx))


def with_slot_map(level: SparseLevel) -> SparseLevel:
    """Attach the dense id -> slot+1 lookup table (one scatter)."""
    sm = torch.zeros(level.sentinel + 1, dtype=torch.int32,
                     device=level.ids.device)
    sm[torch.where(level.mask, level.ids, level.sentinel).long()] = \
        torch.arange(1, level.capacity + 1, dtype=torch.int32,
                     device=sm.device)
    # padding rows all wrote the sentinel bin; clear it
    sm[level.sentinel] = 0
    return dataclasses.replace(level, slot_map=sm)


def _kernel_offsets(kernel: Sequence[int]) -> np.ndarray:
    kz, ky, kx = kernel
    g = np.stack(np.meshgrid(np.arange(kz), np.arange(ky), np.arange(kx),
                             indexing="ij"), axis=-1).reshape(-1, 3)
    return g  # (K, 3) in (z, y, x)


def _lookup(level: SparseLevel, query_ids: torch.Tensor,
            query_valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Find query ids (any shape) in a level through its slot map.
    Returns (idx, found) of the query shape; idx is 0 where not found.

    Invalid queries read the sentinel bin, and the ``minimum`` keeps
    every read inside the table: a device gather asserts on an
    out-of-range index where JAX would clamp."""
    if level.slot_map is None:
        raise ValueError("level has no slot map; only the slot-map "
                         "lookup is ported")
    shape = query_ids.shape
    q = torch.where(query_valid, query_ids, level.sentinel).reshape(-1)
    slot1 = level.slot_map[torch.clamp(q, max=level.sentinel).long()]
    idx = torch.clamp(slot1 - 1, min=0).to(torch.int32)
    found = (slot1 > 0) & query_valid.reshape(-1)
    return idx.reshape(shape), found.reshape(shape)


def build_submanifold_index(level: SparseLevel,
                            kernel=(3, 3, 3)) -> ConvIndex:
    """Rulebook for submanifold conv: out sites == in sites, neighbors
    looked up at coord + offset - k//2."""
    dev = level.coords.device
    offs = _kernel_offsets(kernel)
    half = np.array([k // 2 for k in kernel])
    nb = level.coords[:, None, :] + _i32(offs - half, dev)
    inb = torch.all((nb >= 0) & (nb < _i32(level.shape, dev)), dim=-1)
    q = linearize(nb, level.shape)
    idx, found = _lookup(level, q, inb & level.mask[:, None])
    return ConvIndex(idx, found)


def downsample_level(level: SparseLevel, kernel, stride, padding,
                     out_capacity: int) -> SparseLevel:
    """Active out sites of a strided sparse conv.

    An out site o (per dim) is active iff some in site i satisfies
    ``i = s*o + d - p`` for d in [0, k); each in site activates out
    sites in ``[ceil((i + p - k + 1)/s), floor((i + p)/s)]``.  Out sites
    beyond ``out_capacity`` (the largest ids) are dropped."""
    dev = level.coords.device
    kernel = np.asarray(kernel)
    stride = np.asarray(stride)
    padding = np.asarray(padding)
    out_shape = tuple(int((level.shape[d] + 2 * padding[d] - kernel[d])
                          // stride[d] + 1) for d in range(3))
    if not all(s > 0 for s in out_shape):
        raise ValueError(
            f"downsample of {level.shape} with k={tuple(kernel)} "
            f"s={tuple(stride)} p={tuple(padding)} collapses to "
            f"{out_shape}")
    n_cand = [int(np.ceil(kernel[d] / stride[d])) for d in range(3)]
    nz, ny, nx = out_shape
    sent = nz * ny * nx
    s_t = _i32(stride, dev)
    lo = -(-(level.coords + _i32(padding - kernel + 1, dev)) // s_t)
    hi = (level.coords + _i32(padding, dev)) // s_t
    bound = _i32(out_shape, dev)

    cand_ids = []
    for az in range(n_cand[0]):
        for ay in range(n_cand[1]):
            for ax in range(n_cand[2]):
                o = lo + _i32([az, ay, ax], dev)
                ok = torch.all((o <= hi) & (o >= 0) & (o < bound), dim=-1)
                ok = ok & level.mask
                oid = (o[:, 0] * ny + o[:, 1]) * nx + o[:, 2]
                cand_ids.append(torch.where(ok, oid, sent))
    ids = torch.sort(torch.cat(cand_ids)).values
    n_all = ids.shape[0]
    # unique, keeping first occurrences: the (r+1)-th unique valid id
    # sits at searchsorted(cum, r+1); past the unique count that is
    # n_all, which maps to the sentinel
    head = torch.ones_like(ids, dtype=torch.bool)
    head[1:] = ids[1:] != ids[:-1]
    cum = torch.cumsum(head & (ids < sent), 0)
    pos = torch.searchsorted(
        cum, torch.arange(1, out_capacity + 1, device=dev))
    out_ids = torch.where(pos < n_all,
                          ids[torch.clamp(pos, max=n_all - 1)],
                          sent).to(torch.int32)
    zz = out_ids // (ny * nx)
    yy = (out_ids // nx) % ny
    xx = out_ids % nx
    mask = out_ids < sent
    coords = torch.where(mask[:, None], torch.stack([zz, yy, xx], -1), -1)
    return SparseLevel(coords.to(torch.int32), out_ids, mask, out_shape)


def build_conv_index(in_level: SparseLevel, out_level: SparseLevel,
                     kernel, stride, padding) -> ConvIndex:
    """Rulebook for a strided conv: in site = s*o + d - p per tap d."""
    dev = out_level.coords.device
    offs = _kernel_offsets(kernel)
    src = out_level.coords[:, None, :] * _i32(stride, dev) \
        + _i32(offs - np.asarray(padding), dev)              # (V, K, 3)
    inb = torch.all((src >= 0) & (src < _i32(in_level.shape, dev)), dim=-1)
    q = linearize(src, in_level.shape)
    idx, found = _lookup(in_level, q, inb & out_level.mask[:, None])
    return ConvIndex(idx, found)


def build_inverse_index(coarse: SparseLevel, fine: SparseLevel,
                        kernel, stride, padding) -> ConvIndex:
    """Rulebook for inverse (transposed) conv: out sites are the FINE
    level; tap d contributes from coarse site c when ``f = s*c + d - p``,
    i.e. ``c = (f + p - d) / s`` is integral and active."""
    dev = fine.coords.device
    offs = _kernel_offsets(kernel)
    s_t = _i32(stride, dev)
    num = fine.coords[:, None, :] + _i32(np.asarray(padding) - offs, dev)
    divisible = torch.all(num % s_t == 0, dim=-1)
    c = num // s_t
    inb = torch.all((c >= 0) & (c < _i32(coarse.shape, dev)), dim=-1)
    q = linearize(c, coarse.shape)
    idx, found = _lookup(coarse, q, divisible & inb & fine.mask[:, None])
    return ConvIndex(idx, found)


def round_operand(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Round an f32 operand to ``compute_dtype`` and widen it back: the
    products of two rounded operands are then exact in f32, which is
    what an fp32-accumulating MMA on ``compute_dtype`` inputs computes."""
    if compute_dtype == torch.float32:
        return x
    return x.to(compute_dtype).to(torch.float32)


def sparse_conv_apply(features: torch.Tensor, rulebook: ConvIndex,
                      weights: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      out_mask: Optional[torch.Tensor] = None,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """Apply a sparse conv given its rulebook — the plain version of
    ``ops.dma_gather.gather_matmul``.

    features: (V_in, Cin) f32; weights: (K, Cin, Cout) f32; returns
    (V_out, Cout) f32 = sum_k valid[v,k] * f[idx[v,k]] @ W[k] (+ bias,
    zeroed where ``out_mask`` is false).  Gathered rows and weights are
    rounded to ``compute_dtype`` and multiplied as f32 tensors, which
    emulates JAX's ``preferred_element_type=float32``: a bf16
    ``torch.matmul`` would round its output to bf16 instead."""
    V_out, K = rulebook.idx.shape
    Cin = features.shape[1]
    Cout = weights.shape[-1]
    g = features[rulebook.idx.reshape(-1)].reshape(V_out, K, Cin)
    g = torch.where(rulebook.valid[..., None], g, 0.0)
    g = round_operand(g.reshape(V_out, K * Cin), compute_dtype)
    w = round_operand(weights.reshape(K * Cin, Cout), compute_dtype)
    out = g @ w
    if bias is not None:
        out = out + bias
    if out_mask is not None:
        out = torch.where(out_mask[:, None], out, 0.0)
    return out


def sparse_conv_dgrad(ct: torch.Tensor, rulebook_t: ConvIndex,
                      weights_t: torch.Tensor,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """Feature gradient of a sparse conv over its transposed rulebook —
    the plain version of ``ops.dma_gather.gather_matmul_dgrad``.

    ct: (V_out, Cout) f32 cotangent; rulebook_t: (V_in, K) rows into ct;
    weights_t: (K, Cout, Cin) f32, already rounded to ``compute_dtype``.
    Returns (V_in, Cin) f32 = sum_k valid * round(ct[idx] @ W_t[k]):
    the gathered rows stay f32 and each tap's partial is rounded to
    ``compute_dtype`` before the f32 sum over taps, which is what JAX's
    autodiff of a bf16 ``sparse_conv_apply`` computes."""
    V_in, K = rulebook_t.idx.shape
    Cout = ct.shape[1]
    g = ct[rulebook_t.idx.reshape(-1)].reshape(V_in, K, Cout)
    g = torch.where(rulebook_t.valid[..., None], g, 0.0)
    part = torch.bmm(g.transpose(0, 1), weights_t)     # (K, V_in, Cin)
    return round_operand(part, compute_dtype).sum(0)


def to_dense(features: torch.Tensor, level: SparseLevel) -> torch.Tensor:
    """Scatter (V, C) features into a dense (nz, ny, nx, C) grid
    (channels-last)."""
    nz, ny, nx = level.shape
    C = features.shape[-1]
    flat = torch.zeros((nz * ny * nx + 1, C), dtype=features.dtype,
                       device=features.device)
    slot = torch.where(level.mask, level.ids, nz * ny * nx).long()
    flat[slot] = torch.where(level.mask[:, None], features, 0.0)
    return flat[:-1].reshape(nz, ny, nx, C)
