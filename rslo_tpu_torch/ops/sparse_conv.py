"""Sparse 3D convolution geometry and the plain conv apply on torch
tensors (counterpart of ``rslo_tpu/ops/sparse_conv.py``).

  * A *level* is a fixed-capacity set of active voxels with coordinates
    sorted by linearized (z, y, x) id, padding rows at the end with the
    sentinel id ``nz*ny*nx``.
  * A level's dense *slot map* ((nz*ny*nx + 1,) int32, id -> slot+1,
    0 = inactive) turns each neighbor lookup into one gather.  Without
    one a lookup is a binary search of the sorted ids.
  * A *rulebook* (``ConvIndex``) holds, per (out site, kernel tap), the
    row of the contributing in site and whether it exists.  Rulebooks
    are built once per frame and shared by every layer at that
    geometry.
  * The lookup methods of ``LOOKUP_METHODS`` build the same rulebooks
    by other means: "ranked" ranks each 256-row block's queries in one
    window of the sorted ids; the "*_planes" builders look up only the
    centre x tap of each (dz, dy) kernel plane and derive the other two
    from id adjacency.

Every index computed here is integer arithmetic on int32 tensors, so
levels and rulebooks are bit-equal to the JAX package's.  Floor
division and ``%`` on negative coordinates follow Python semantics in
both frameworks.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..utils import timing
from .precision import f32_matmul


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
    """Find query ids (any shape) in a level.  Returns (idx, found) of
    the query shape.

    With the level's slot map one gather: invalid queries read the
    sentinel bin, and the ``clamp`` keeps every read inside the table
    (a device gather asserts on an out-of-range index where JAX would
    clamp); idx is 0 where not found.  Without one a binary search of
    the sorted ids, idx clamped to the last row."""
    shape = query_ids.shape
    q = torch.where(query_valid, query_ids, level.sentinel).reshape(-1)
    if level.slot_map is not None:
        slot1 = level.slot_map[torch.clamp(q, max=level.sentinel).long()]
        idx = torch.clamp(slot1 - 1, min=0).to(torch.int32)
        found = (slot1 > 0) & query_valid.reshape(-1)
    else:
        idx = torch.searchsorted(level.ids, q.to(torch.int32),
                                 out_int32=True)
        idx = torch.clamp(idx, max=level.capacity - 1)
        found = (level.ids[idx.long()] == q) & query_valid.reshape(-1) & \
            (q < level.sentinel)
    return idx.reshape(shape), found.reshape(shape)


def _lookup_ranked(level: SparseLevel, query_ids: torch.Tensor,
                   query_valid: torch.Tensor, block: int = 256,
                   win: int = 4096, stray_capacity: int = 8192,
                   _return_rank: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed-rank lookup, the same contract as :func:`_lookup`.

    ``level.ids`` is sorted and unique, so a voxel's row IS the rank of
    its id: idx(q) = #{ids < q}, present(q) = q in ids.  Out rows are
    sorted too, so the K taps of a block of ``block`` rows fall in a
    narrow slice of ``ids``: each block ranks its queries in one window
    of ``win`` ids, starting at the rank of its smallest query.  The
    window is sorted, so the rank in it is a batched binary search
    (JAX's compare-reduce over the window counts the same).

    Queries above a window's last id ("strays") are resolved by a binary
    search of the whole id array and scattered back: the result equals
    :func:`_lookup`'s while the stray count of the whole call fits
    ``stray_capacity``.  Past it the first ``stray_capacity`` strays in
    flat order are resolved and the rest keep ``found=False``, as in
    JAX.  ``RSLO_BAND_CHECK=1`` raises on that (a host sync); the
    resolve itself runs unconditionally, which gives the same result as
    JAX's ``cond(n_stray > 0)`` without reading the count.
    ``_return_rank`` returns the unclamped rank in [0, Vin] for the
    plane builders."""
    dev = query_ids.device
    shape = query_ids.shape
    Vin = level.ids.shape[0]
    qp, vp, lo, wids = _rank_windows(level, query_ids, query_valid, block,
                                     win)
    W = wids.shape[1]
    n = query_ids.numel()
    npad = qp.numel()
    rank = torch.searchsorted(wids, qp, out_int32=True)  # #{wids < q}
    present = (rank < W) & (torch.gather(
        wids, 1, torch.clamp(rank, max=W - 1).long()) == qp)
    idx = lo[:, None] + rank
    resolved = qp <= wids[:, -1:]
    found = present & vp & resolved

    stray = (vp & ~resolved).reshape(-1)
    if os.environ.get("RSLO_BAND_CHECK"):
        n_stray = int(torch.sum(stray))
        if n_stray > stray_capacity:
            raise RuntimeError(
                f"ranked-lookup stray overflow: {n_stray} strays > "
                f"capacity {stray_capacity} — rulebook entries would "
                f"be dropped; widen `win` or raise stray_capacity")
    # the first stray_capacity strays in flat order: positions past the
    # stray count are npad, which the scatters below send to a dump
    # entry that is sliced off (JAX: mode="drop")
    cum = torch.cumsum(stray.to(torch.int32), 0, dtype=torch.int32)
    pos = torch.searchsorted(
        cum, torch.arange(1, stray_capacity + 1, dtype=torch.int32,
                          device=dev), out_int32=True).long()
    sq = qp.reshape(-1)[torch.clamp(pos, max=npad - 1)]
    si = torch.searchsorted(level.ids, sq, out_int32=True)
    sfound = (si < Vin) & (level.ids[torch.clamp(si, max=Vin - 1).long()]
                           == sq)
    idx_f = torch.cat([idx.reshape(-1), idx.new_zeros(1)])
    found_f = torch.cat([found.reshape(-1), found.new_zeros(1)])
    idx_f[pos] = si
    found_f[pos] = sfound
    found_out = found_f[:n].reshape(shape) & query_valid
    if _return_rank:
        return idx_f[:n].reshape(shape), found_out
    return torch.clamp(idx_f[:n], max=Vin - 1).reshape(shape), found_out


def _rank_windows(level: SparseLevel, query_ids: torch.Tensor,
                  query_valid: torch.Tensor, block: int, win: int):
    """The ranked lookup's blocks: queries (invalid ones the sentinel)
    and validity padded to whole blocks of ``block`` rows, (nB, block*K)
    each; each block's window start ``lo`` (nB,) and its ids (nB, W)."""
    dev = query_ids.device
    Vin = level.ids.shape[0]
    sent = level.sentinel
    K = query_ids.shape[-1] if query_ids.dim() > 1 else 1
    rows = query_ids.shape[0]
    nB = -(-rows // block)
    rpad = nB * block
    q2 = torch.where(query_valid, query_ids, sent).to(torch.int32) \
        .reshape(rows, K)
    qp = torch.cat([q2, torch.full((rpad - rows, K), sent,
                                   dtype=torch.int32, device=dev)]
                   ).reshape(nB, block * K)
    vp = torch.cat([query_valid.reshape(rows, K),
                    torch.zeros((rpad - rows, K), dtype=torch.bool,
                                device=dev)]).reshape(nB, block * K)
    W = min(win, Vin)
    qmin = torch.amin(torch.where(vp, qp, sent), dim=1)         # (nB,)
    lo = torch.searchsorted(level.ids, qmin, out_int32=True)
    lo = torch.clamp(lo, 0, Vin - W)
    wids = level.ids[(lo[:, None] + torch.arange(
        W, dtype=torch.int32, device=dev)).long()]              # (nB, W)
    return qp, vp, lo, wids


def ranked_strays(level: SparseLevel, query_ids: torch.Tensor,
                  query_valid: torch.Tensor, block: int = 256,
                  win: int = 4096) -> torch.Tensor:
    """The ranked lookup's stray count (a 0-d tensor): the valid queries
    above their block's window, which the exact resolve has to find.
    Diagnostics only; the lookup itself never reads it."""
    qp, vp, _, wids = _rank_windows(level, query_ids, query_valid, block,
                                    win)
    return torch.sum(vp & (qp > wids[:, -1:]))


LOOKUP_METHODS = ("slot_map", "ranked", "ranked_planes", "sorted_planes",
                  "slot_planes")


def _dispatch_lookup(level: SparseLevel, q: torch.Tensor,
                     v: torch.Tensor, method: Optional[str]):
    if method is not None and method not in LOOKUP_METHODS:
        raise ValueError(
            f"unknown plan_lookup method {method!r}; "
            f"expected one of {LOOKUP_METHODS}")
    if method in ("ranked", "ranked_planes"):
        return _lookup_ranked(level, q, v)
    return _lookup(level, q, v)


def _rank_lookup(level: SparseLevel, q: torch.Tensor, v: torch.Tensor,
                 method: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(rank, found), rank = #{ids < q} unclamped in [0, Vin]: by the
    windowed path ("ranked") or one binary search ("sorted")."""
    if method == "ranked":
        return _lookup_ranked(level, q, v, _return_rank=True)
    shape = q.shape
    Vin = level.capacity
    qf = torch.where(v, q, level.sentinel).to(torch.int32).reshape(-1)
    r = torch.searchsorted(level.ids, qf, out_int32=True)
    found = (r < Vin) & (level.ids[torch.clamp(r, max=Vin - 1).long()]
                         == qf) & v.reshape(-1)
    return r.reshape(shape), found.reshape(shape)


def _derive_x_taps(level: SparseLevel, q: torch.Tensor, vq: torch.Tensor,
                   rank: torch.Tensor, found_c: torch.Tensor,
                   xm_ok: torch.Tensor, xp_ok: torch.Tensor) -> ConvIndex:
    """Expand per-plane centre-tap ranks into the (m, c, p) x-offset
    triple: ids are sorted and unique, so the -1 neighbour can only sit
    at rank - 1 and the +1 one at rank + found, each verified by an id
    compare.  q/vq/rank/found_c: (V, P); xm_ok/xp_ok: x-bound validity
    of the side taps.  Returns a (V, 3P) ConvIndex, x fastest."""
    Vin = level.capacity
    ids = level.ids
    pos_m = torch.clamp(rank - 1, 0, Vin - 1)
    ok_m = (rank > 0) & (ids[pos_m.long()] == q - 1) & vq & xm_ok
    pos_p = torch.clamp(rank + found_c.to(torch.int32), max=Vin - 1)
    ok_p = (ids[pos_p.long()] == q + 1) & vq & xp_ok
    idx_c = torch.clamp(rank, max=Vin - 1)
    idx = torch.stack([pos_m, idx_c, pos_p], dim=-1)       # (V, P, 3)
    ok = torch.stack([ok_m, found_c, ok_p], dim=-1)
    V, P = q.shape
    return ConvIndex(idx.reshape(V, 3 * P).to(torch.int32),
                     ok.reshape(V, 3 * P))


def _slot_segments(level: SparseLevel, q_c: torch.Tensor) -> torch.Tensor:
    """The 4-entry slot-map segments covering ids [q_c - 1, q_c + 2) of
    each (row, plane) centre query: (V, P, 3) slot+1 values of the
    (m, c, p) taps, 0 where a clipped segment does not hold the id."""
    if level.slot_map is None:
        raise ValueError("slot_planes needs a slot map")
    V, P = q_c.shape
    T = level.sentinel            # the slot map has T + 1 entries
    start = torch.clamp(q_c.reshape(-1) - 1, 0, T - 3)
    four = torch.arange(4, dtype=start.dtype, device=start.device)
    seg = level.slot_map[(start[:, None] + four).long()]          # (VP, 4)
    o = q_c.reshape(-1) - 1 - start
    three = four[:3]
    cols = torch.clamp(o[:, None] + three, 0, 3)
    picked = torch.gather(seg, 1, cols.long())
    picked = torch.where((o[:, None] + three) == cols, picked, 0)
    return picked.reshape(V, P, 3)


def _slot_planes_index(level: SparseLevel, q_c: torch.Tensor,
                       vq: torch.Tensor, xm_ok: torch.Tensor,
                       xp_ok: torch.Tensor) -> ConvIndex:
    slot3 = _slot_segments(level, q_c)
    ok3 = torch.stack([vq & xm_ok, vq, vq & xp_ok], dim=-1) & (slot3 > 0)
    idx3 = torch.clamp(slot3 - 1, min=0)
    V, P, _ = slot3.shape
    return ConvIndex(idx3.reshape(V, 3 * P).to(torch.int32),
                     ok3.reshape(V, 3 * P))


def _plane_queries(coords, mask, in_shape, kernel, base, offset):
    """Per (row, (dz, dy) plane) centre-tap coords ``base + offs -
    offset`` (x offset 1), their z/y-bound validity and linear ids."""
    dev = coords.device
    kz, ky, _ = kernel
    offs = _kernel_offsets(kernel).reshape(kz * ky, 3, 3)[:, 1, :]
    nz, ny, _ = in_shape
    src = base[:, None, :] + _i32(offs - offset, dev)          # (V, P, 3)
    vq = ((src[..., 0] >= 0) & (src[..., 0] < nz) &
          (src[..., 1] >= 0) & (src[..., 1] < ny)) & mask[:, None]
    return src, vq, linearize(src, in_shape)


def build_submanifold_index_slot_planes(level: SparseLevel,
                                        kernel=(3, 3, 3)) -> ConvIndex:
    """:func:`build_submanifold_index` through one 4-entry slot-map
    segment per (row, plane); bit-equal to the slot-map builder."""
    assert kernel[2] == 3
    half = np.array([k // 2 for k in kernel])
    _, vq, q = _plane_queries(level.coords, level.mask, level.shape,
                              kernel, level.coords, half)
    q = torch.where(vq, q, level.sentinel)
    nx = level.shape[2]
    return _slot_planes_index(level, q, vq, level.coords[:, 2:3] >= 1,
                              level.coords[:, 2:3] + 1 < nx)


def build_conv_index_slot_planes(in_level: SparseLevel,
                                 out_level: SparseLevel,
                                 kernel, stride, padding) -> ConvIndex:
    """Strided-conv rulebook through per-plane slot-map segments."""
    assert kernel[2] == 3 and padding[2] == 1
    base = out_level.coords * _i32(stride, out_level.coords.device)
    src, vq, q = _plane_queries(out_level.coords, out_level.mask,
                                in_level.shape, kernel, base,
                                np.asarray(padding))
    q = torch.where(vq, q, in_level.sentinel)
    nx = in_level.shape[2]
    return _slot_planes_index(in_level, q, vq, src[:, :, 2] - 1 >= 0,
                              src[:, :, 2] + 1 < nx)


def build_submanifold_index_planes(level: SparseLevel, kernel=(3, 3, 3),
                                   rank_method: str = "ranked"
                                   ) -> ConvIndex:
    """:func:`build_submanifold_index` with one rank lookup per (dz, dy)
    plane (9 for a 3^3 kernel) and the x taps derived; bit-equal to the
    generic builder while the ranked path has no saturated strays."""
    assert kernel[2] == 3, "plane derivation needs an x-extent-3 kernel"
    half = np.array([k // 2 for k in kernel])
    _, vq, q = _plane_queries(level.coords, level.mask, level.shape,
                              kernel, level.coords, half)
    rank, found_c = _rank_lookup(level, q, vq, rank_method)
    nx = level.shape[2]
    return _derive_x_taps(level, q, vq, rank, found_c,
                          level.coords[:, 2:3] >= 1,
                          level.coords[:, 2:3] + 1 < nx)


def build_conv_index_planes(in_level: SparseLevel, out_level: SparseLevel,
                            kernel, stride, padding,
                            rank_method: str = "ranked") -> ConvIndex:
    """Plane-derived strided-conv rulebook (k_x = 3, p_x = 1: the centre
    tap's x = s*o_x always lies inside the grid)."""
    assert kernel[2] == 3 and padding[2] == 1, \
        "plane derivation assumes k_x=3, p_x=1 (center x always valid)"
    base = out_level.coords * _i32(stride, out_level.coords.device)
    src, vq, q = _plane_queries(out_level.coords, out_level.mask,
                                in_level.shape, kernel, base,
                                np.asarray(padding))
    rank, found_c = _rank_lookup(in_level, q, vq, rank_method)
    nx = in_level.shape[2]
    return _derive_x_taps(in_level, q, vq, rank, found_c,
                          src[:, :, 2] - 1 >= 0, src[:, :, 2] + 1 < nx)


def build_submanifold_index(level: SparseLevel, kernel=(3, 3, 3),
                            lookup: Optional[str] = None) -> ConvIndex:
    """Rulebook for submanifold conv: out sites == in sites, neighbors
    looked up at coord + offset - k//2."""
    dev = level.coords.device
    offs = _kernel_offsets(kernel)
    half = np.array([k // 2 for k in kernel])
    nb = level.coords[:, None, :] + _i32(offs - half, dev)
    inb = torch.all((nb >= 0) & (nb < _i32(level.shape, dev)), dim=-1)
    q = linearize(nb, level.shape)
    idx, found = _dispatch_lookup(level, q, inb & level.mask[:, None],
                                  lookup)
    return ConvIndex(idx, found)


def downsample_level(level: SparseLevel, kernel, stride, padding,
                     out_capacity: int,
                     name: Optional[str] = None) -> SparseLevel:
    """Active out sites of a strided sparse conv.

    An out site o (per dim) is active iff some in site i satisfies
    ``i = s*o + d - p`` for d in [0, k); each in site activates out
    sites in ``[ceil((i + p - k + 1)/s), floor((i + p)/s)]``.  Out sites
    beyond ``out_capacity`` (the largest ids) are dropped.  ``name``
    (e.g. "L1") counts the out sites found and kept while tracing is on
    (``utils/timing.py::count_sites``)."""
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
    if name is not None and timing.tracing_on():
        timing.count_sites(name, cum[-1], out_capacity)
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


def downsample_level_scatter(level: SparseLevel, kernel, stride, padding,
                             out_capacity: int) -> SparseLevel:
    """Sort-free :func:`downsample_level`: the candidate out sites are
    deduplicated by a scatter into the out grid's occupancy and
    compacted by a cumsum rank, which gives the same sorted level."""
    dev = level.coords.device
    kernel = np.asarray(kernel)
    stride = np.asarray(stride)
    padding = np.asarray(padding)
    out_shape = tuple(int((level.shape[d] + 2 * padding[d] - kernel[d])
                          // stride[d] + 1) for d in range(3))
    assert all(s > 0 for s in out_shape)
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
    occ = torch.zeros(sent + 1, dtype=torch.bool, device=dev)
    occ[torch.cat(cand_ids).long()] = True
    occ = occ[:sent]
    rank = torch.cumsum(occ.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(occ & (rank < out_capacity), rank, out_capacity)
    out_ids = torch.full((out_capacity + 1,), sent, dtype=torch.int32,
                         device=dev)
    out_ids[slot.long()] = torch.where(
        slot < out_capacity,
        torch.arange(sent, dtype=torch.int32, device=dev), sent
    ).to(torch.int32)
    out_ids = out_ids[:out_capacity]
    zz = out_ids // (ny * nx)
    yy = (out_ids // nx) % ny
    xx = out_ids % nx
    mask = out_ids < sent
    coords = torch.where(mask[:, None], torch.stack([zz, yy, xx], -1), -1)
    return SparseLevel(coords.to(torch.int32), out_ids, mask, out_shape)


def build_conv_index(in_level: SparseLevel, out_level: SparseLevel,
                     kernel, stride, padding,
                     lookup: Optional[str] = None) -> ConvIndex:
    """Rulebook for a strided conv: in site = s*o + d - p per tap d."""
    dev = out_level.coords.device
    offs = _kernel_offsets(kernel)
    src = out_level.coords[:, None, :] * _i32(stride, dev) \
        + _i32(offs - np.asarray(padding), dev)              # (V, K, 3)
    inb = torch.all((src >= 0) & (src < _i32(in_level.shape, dev)), dim=-1)
    q = linearize(src, in_level.shape)
    idx, found = _dispatch_lookup(in_level, q,
                                  inb & out_level.mask[:, None], lookup)
    return ConvIndex(idx, found)


def build_inverse_index(coarse: SparseLevel, fine: SparseLevel,
                        kernel, stride, padding,
                        lookup: Optional[str] = None) -> ConvIndex:
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
    idx, found = _dispatch_lookup(coarse, q,
                                  divisible & inb & fine.mask[:, None],
                                  lookup)
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


def sparse_conv_apply_planes(features: torch.Tensor, rulebook: ConvIndex,
                             weights: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             out_mask: Optional[torch.Tensor] = None,
                             compute_dtype=torch.float32) -> torch.Tensor:
    """:func:`sparse_conv_apply` for 27-tap rulebooks through one
    (4, Cin) row window per (out row, (dz, dy) plane) instead of three
    row gathers.  A plane's valid x taps are consecutive rows of the
    sorted level (<= 3 of them), so the window starting at the smallest
    valid row holds them all; taps outside it are dropped as invalid
    ones are.  The window start is clipped to [0, Vin - 4], then
    ``take_along_axis`` picks the three taps, then one product sums
    them in f32: the operand equals sparse_conv_apply's, so the result
    is bit-equal to it.  Not for the (3, 1, 1) z-collapse, whose taps
    are never row-adjacent."""
    V, K = rulebook.idx.shape
    assert K % 3 == 0, "plane apply needs x-minor (P, 3) tap grouping"
    assert K == 27, (
        "plane apply's 4-row-window property is argued/tested only for "
        "the 27-tap subm/down/inverse rulebooks; the (3,1,1) z-collapse "
        "rulebook's taps differ in z and are never row-adjacent")
    P = K // 3
    Vin, Cin = features.shape
    assert Vin >= 4, f"plane apply needs >=4 feature rows, got {Vin}"
    Cout = weights.shape[-1]
    f = round_operand(features, compute_dtype)
    idx = rulebook.idx.reshape(V, P, 3)
    valid = rulebook.valid.reshape(V, P, 3)
    s = torch.amin(torch.where(valid, idx, Vin), dim=-1)
    s = torch.clamp(s, 0, Vin - 4)                           # (V, P)
    cols = idx - s[..., None]
    ok = valid & (cols >= 0) & (cols < 4)
    colsc = torch.clamp(cols, 0, 3).reshape(-1, 3).long()
    four = torch.arange(4, device=s.device)
    seg = f[(s.reshape(-1, 1).long() + four)]              # (VP, 4, Cin)
    g = torch.gather(seg, 1, colsc[:, :, None].expand(-1, -1, Cin))
    g = torch.where(ok.reshape(-1, 3, 1), g, 0.0).reshape(V, K * Cin)
    w = round_operand(weights.reshape(K * Cin, Cout), compute_dtype)
    with f32_matmul():
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
