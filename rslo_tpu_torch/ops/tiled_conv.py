"""Tiled dense engine of the sparse middle (counterpart of
``rslo_tpu/ops/tiled_conv.py``): the same 3-D convolutions as the
rulebook engine over blocks of dense tiles instead of gathered rows.

  * Each high-resolution level is a fixed-capacity set of dense tiles
    (default 2x8x8) plus one always-zero pad row.  Features live as
    ``(T+1, tz, ty, tx, C)`` blocks (channels last, as in JAX); each
    conv permutes its halo-extended input to NCDHW once and runs one
    ``F.conv3d`` over every tile.  Submanifold semantics come from
    masking the output with the per-tile occupancy.
  * Halos are the 3-pass axis exchange: after the z faces are attached,
    a y face gathered from an already z-haloed neighbour carries the zy
    corners, and so on.
  * A strided conv's output cell is owned by exactly one input tile
    (``owner = floor(cell / half_tile)``); tile activity is dilated one
    tile towards lower indices ("ghost tiles") so the owner of every
    reachable output cell exists.  The owned half blocks scatter into
    the coarse level without overlap.
  * Levels 2-4 (1/4, 1/8 resolution and the z collapse) are dense
    grids.
  * Tile discovery scatters occupancy over the dense tile grid and
    compacts it by a cumsum rank: nothing sorts.

The convs compute in float32 whatever the middle's ``conv_dtype`` says,
as JAX's dispatch passes no compute dtype to this module, with TF32 off
in the forward and the backward (``ops/precision.py::f32_conv``).
Every gather clamps as JAX's does, and every scatter that JAX drops or
sends to a junk row writes a dump row here that is sliced off.

Coordinates are (z, y, x); a level's grid is padded up to a tile
multiple (padded cells are never active).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .precision import f32_conv
from .sparse_conv import _i32

DEFAULT_TILE = (2, 8, 8)


def _cdiv(a, b):
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class TileLevel:
    """Active-tile structure of one tiled level.

    tile_coords: (T, 3) int32 tile-grid coords (invalid rows 0).
    tile_mask:   (T,) bool.
    slot_map:    (TG + 1,) int32 tile-grid id -> slot + 1 (0 = none).
    nb_lo/nb_hi: (T + 1, 3) int32 neighbour slot per axis; absent / pad
                 row -> T (the zero pad row).
    occ:         (T + 1, tz, ty, tx) bool cell activity (pad row False).
    grid, tgrid, tile: the level's (nz, ny, nx), its tile-grid dims and
                 the tile shape (even dims).
    """
    tile_coords: torch.Tensor
    tile_mask: torch.Tensor
    slot_map: torch.Tensor
    nb_lo: torch.Tensor
    nb_hi: torch.Tensor
    occ: torch.Tensor
    grid: tuple
    tgrid: tuple
    tile: tuple

    @property
    def capacity(self) -> int:
        return self.tile_coords.shape[0]

    @property
    def cells(self) -> int:
        return int(np.prod(self.tile))

    @property
    def half(self) -> tuple:
        return tuple(t // 2 for t in self.tile)


@dataclasses.dataclass(frozen=True)
class TiledGeometry:
    """Per-frame geometry of the tiled engine."""
    l0: TileLevel
    l1: TileLevel
    cell_index: torch.Tensor     # (V,) voxel row -> flat cell (dump = last)
    occ2: torch.Tensor           # (z2, y2, x2) bool (dense levels)
    occ3: torch.Tensor
    occ4: torch.Tensor


def _linearize(c, tgrid):
    return (c[..., 0] * tgrid[1] + c[..., 1]) * tgrid[2] + c[..., 2]


def _compact_tiles(act_flat: torch.Tensor, tgrid, capacity: int):
    """Dense activity flags -> (tile_coords, tile_mask, slot_map), by a
    cumsum rank; tiles past ``capacity`` are dropped."""
    dev = act_flat.device
    TG = int(np.prod(tgrid))
    rank = torch.cumsum(act_flat.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(act_flat & (rank < capacity), rank, capacity)
    ids = torch.full((capacity + 1,), TG, dtype=torch.int32, device=dev)
    ids[slot.long()] = torch.where(
        slot < capacity, torch.arange(TG, dtype=torch.int32, device=dev),
        TG).to(torch.int32)
    ids = ids[:capacity]
    mask = ids < TG
    zz = ids // (tgrid[1] * tgrid[2])
    yy = (ids // tgrid[2]) % tgrid[1]
    xx = ids % tgrid[2]
    coords = torch.where(mask[:, None], torch.stack([zz, yy, xx], -1), 0)
    slot_map = torch.zeros(TG + 1, dtype=torch.int32, device=dev)
    slot_map[torch.where(mask, ids, TG).long()] = torch.arange(
        1, capacity + 1, dtype=torch.int32, device=dev)
    slot_map[TG] = 0
    return coords.to(torch.int32), mask, slot_map


def _neighbors(coords, mask, slot_map, tgrid, capacity):
    """Per-axis lo/hi neighbour slots, (T + 1, 3); absent -> pad row T."""
    TG = int(np.prod(tgrid))
    nb = []
    for sgn in (-1, 1):
        cols = []
        for ax in range(3):
            q = coords.clone()
            q[:, ax] += sgn
            inb = (q[:, ax] >= 0) & (q[:, ax] < tgrid[ax]) & mask
            qid = torch.where(inb, _linearize(q, tgrid), TG)
            s = slot_map[qid.long()] - 1
            cols.append(torch.where(s >= 0, s, capacity))
        col = torch.stack(cols, -1).to(torch.int32)
        nb.append(torch.cat([col, torch.full(
            (1, 3), capacity, dtype=torch.int32, device=col.device)], 0))
    return nb[0], nb[1]


def _ghost_dilate(act3d: torch.Tensor) -> torch.Tensor:
    """Activate a tile when it or its -1 neighbour along any axis (after
    the earlier axes' dilation) is occupied: the owner of a strided
    conv's output cell c is floor(c / half), fed by the input tiles
    owner and owner - 1, so the owner must exist whenever owner - 1 is
    occupied."""
    out = act3d
    for ax in range(3):
        n = out.shape[ax]
        shifted = torch.cat([torch.zeros_like(out.narrow(ax, 0, 1)),
                             out.narrow(ax, 0, n - 1)], ax)
        out = out | shifted
    return out


def _build_level(occ_flag, tgrid, capacity: int):
    act = _ghost_dilate(occ_flag.reshape(tgrid)).reshape(-1)
    coords, mask, slot_map = _compact_tiles(act, tgrid, capacity)
    nb_lo, nb_hi = _neighbors(coords, mask, slot_map, tgrid, capacity)
    return coords, mask, slot_map, nb_lo, nb_hi


def build_l0(coords: torch.Tensor, vmask: torch.Tensor, sparse_shape,
             capacity: int, tile=DEFAULT_TILE):
    """Voxel coords (V, 3) zyx -> the L0 TileLevel and each voxel's flat
    cell index (the dump cell, one past the blocks, where a voxel has no
    tile)."""
    dev = coords.device
    tz, ty, tx = tile
    cells = tz * ty * tx
    tgrid = tuple(_cdiv(sparse_shape[d], tile[d]) for d in range(3))
    TG = int(np.prod(tgrid))
    tile_t = _i32(tile, dev)
    tcoord = torch.div(coords, tile_t, rounding_mode="floor")
    tid = torch.where(vmask, _linearize(tcoord, tgrid), TG)
    occ_flag = torch.zeros(TG + 1, dtype=torch.bool, device=dev)
    occ_flag[tid.long()] = True
    c, m, sm, nlo, nhi = _build_level(occ_flag[:TG], tgrid, capacity)
    slot = sm[torch.clamp(tid, max=TG).long()] - 1
    lc = coords - tcoord * tile_t
    lcell = (lc[:, 0] * ty + lc[:, 1]) * tx + lc[:, 2]
    ok = vmask & (slot >= 0)
    dump = (capacity + 1) * cells
    cell_index = torch.where(ok, slot * cells + lcell, dump).to(torch.int32)
    occ = torch.zeros((capacity + 1) * cells + 1, dtype=torch.bool,
                      device=dev)
    occ[cell_index.long()] = ok
    occ = occ[:-1].reshape((capacity + 1,) + tuple(tile))
    lvl = TileLevel(c, m, sm, nlo, nhi, occ, tuple(sparse_shape), tgrid,
                    tuple(tile))
    return lvl, cell_index


def scatter_voxels(features: torch.Tensor, cell_index: torch.Tensor,
                   lvl: TileLevel) -> torch.Tensor:
    """(V, C) rows -> (T + 1, tz, ty, tx, C) blocks (pad row zero; rows
    without a cell write the dump row, which is sliced off)."""
    C = features.shape[-1]
    flat = features.new_zeros(((lvl.capacity + 1) * lvl.cells + 1, C))
    flat = flat.index_put((cell_index.long(),), features)
    return flat[:-1].reshape((lvl.capacity + 1,) + lvl.tile + (C,))


def gather_voxels(blocks: torch.Tensor,
                  cell_index: torch.Tensor) -> torch.Tensor:
    """(T + 1, tz, ty, tx, C) blocks -> (V, C) rows (the dump reads 0)."""
    C = blocks.shape[-1]
    flat = torch.cat([blocks.reshape(-1, C), blocks.new_zeros((1, C))], 0)
    return flat[cell_index.long()]


def _halo_axis(x: torch.Tensor, nb_lo_ax, nb_hi_ax, axis: int,
               lo: int = 1, hi: int = 1) -> torch.Tensor:
    """Attach lo/hi face slabs gathered from neighbour rows along one
    spatial axis of x (T + 1, d0, d1, d2, C); the pad row stays zero
    because its neighbours are itself."""
    ax = axis + 1
    parts = []
    if lo:
        parts.append(x.narrow(ax, x.shape[ax] - lo, lo)[nb_lo_ax.long()])
    parts.append(x)
    if hi:
        parts.append(x.narrow(ax, 0, hi)[nb_hi_ax.long()])
    return torch.cat(parts, ax)


def halo(x: torch.Tensor, lvl: TileLevel, lo=(1, 1, 1),
         hi=(1, 1, 1)) -> torch.Tensor:
    """Multi-pass halo: axis k's pass gathers faces that already carry
    the halos of axes < k, so edge and corner tiles arrive for free."""
    for ax in range(3):
        if lo[ax] or hi[ax]:
            x = _halo_axis(x, lvl.nb_lo[:, ax], lvl.nb_hi[:, ax], ax,
                           lo[ax], hi[ax])
    return x


class _Conv(torch.autograd.Function):
    """A 3-D convolution (or transposed convolution) with TF32 off in
    the forward and in the backward, which autograd would otherwise run
    under the process's cuDNN setting."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, transposed):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, transposed)
        with f32_conv():
            return torch.ops.aten.convolution(
                x, w, None, stride, padding, [1, 1, 1], transposed,
                [0, 0, 0], 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, transposed = ctx.conf
        with f32_conv():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g.contiguous(), x, w, None, stride, padding, [1, 1, 1],
                transposed, [0, 0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None


def _conv3d(x: torch.Tensor, w: torch.Tensor, stride=(1, 1, 1),
            padding=(0, 0, 0), transposed: bool = False) -> torch.Tensor:
    """Channels-last (N, D, H, W, C) in and out, float32; ``w`` in
    torch's layout for the op."""
    y = _Conv.apply(x.float().permute(0, 4, 1, 2, 3).contiguous(),
                    w.float(), list(stride), list(padding), transposed)
    return y.permute(0, 2, 3, 4, 1)


def _wconv(weights: torch.Tensor, kernel) -> torch.Tensor:
    """(K, Cin, Cout) tap-major (z, y, x) -> (Cout, Cin, kz, ky, kx).
    Both frameworks' convs are cross-correlations: no flip."""
    kz, ky, kx = kernel
    cin, cout = weights.shape[1], weights.shape[2]
    return weights.reshape(kz, ky, kx, cin, cout).permute(4, 3, 0, 1, 2)


def _masked(occ: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.where(occ[..., None], y, 0.0)


def subm_conv(x: torch.Tensor, lvl: TileLevel, weights,
              bias) -> torch.Tensor:
    """Submanifold 3x3x3 conv on tile blocks; output masked by occ."""
    y = _conv3d(halo(x, lvl), _wconv(weights, (3, 3, 3))) + bias
    return _masked(lvl.occ, y)


def down_conv(x: torch.Tensor, fine: TileLevel, coarse: TileLevel,
              weights, bias) -> torch.Tensor:
    """k3 s2 p1 strided conv: fine tiles -> coarse tile blocks.  Each
    fine tile owns the coarse cells [half*t, half*(t+1)) per dim,
    computed from its lo-haloed input."""
    h = halo(x, fine, lo=(1, 1, 1), hi=(0, 0, 0))
    y = _conv3d(h, _wconv(weights, (3, 3, 3)), stride=(2, 2, 2)) + bias
    out = _scatter_half_blocks(y, fine, coarse.slot_map, coarse.tgrid,
                               coarse.capacity, coarse.tile)
    return _masked(coarse.occ, out)


def _scatter_half_blocks(y, fine: TileLevel, coarse_slot_map,
                         coarse_tgrid, coarse_capacity: int,
                         coarse_tile):
    """Scatter each fine tile's owned half block (T+1, hz, hy, hx, C)
    into its parent coarse tile, at the octant its parity names
    (coarse_tile == fine.tile, so 2 owned blocks fill a coarse tile per
    dim).  One scatter over (coarse slot, octant) rows; a tile without a
    parent writes the dump row, which is sliced off (JAX writes pad row
    Tc and clears it)."""
    assert tuple(coarse_tile) == tuple(fine.tile)
    hz, hy, hx = fine.half
    C = y.shape[-1]
    Tc = coarse_capacity
    parent = torch.div(fine.tile_coords, 2, rounding_mode="floor")
    parity = fine.tile_coords % 2
    pid = _linearize(parent, coarse_tgrid)
    pslot = coarse_slot_map[torch.clamp(
        pid, max=int(np.prod(coarse_tgrid))).long()] - 1
    sel = fine.tile_mask & (pslot >= 0)
    octant = (parity[:, 0] * 2 + parity[:, 1]) * 2 + parity[:, 2]
    dump = (Tc + 1) * 8
    tgt = torch.where(sel, pslot * 8 + octant, dump)
    rows = y.new_zeros((dump + 1, hz, hy, hx, C))
    rows = rows.index_put((tgt.long(),), y[:fine.capacity])[:dump]
    out = rows.reshape(Tc + 1, 2, 2, 2, hz, hy, hx, C)
    out = out.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return out.reshape((Tc + 1,) + tuple(coarse_tile) + (C,))


def down_to_dense(x: torch.Tensor, fine: TileLevel, out_pad_shape,
                  weights, bias, occ_out) -> torch.Tensor:
    """k3 s2 p1 strided conv: fine tiles -> a dense (z, y, x, C) grid of
    ``out_pad_shape`` = fine.tgrid * fine.half (the owned layout)."""
    h = halo(x, fine, lo=(1, 1, 1), hi=(0, 0, 0))
    y = _conv3d(h, _wconv(weights, (3, 3, 3)), stride=(2, 2, 2)) + bias
    return _masked(occ_out, _scatter_blocks_to_dense(y, fine,
                                                     out_pad_shape))


def _scatter_blocks_to_dense(y, fine: TileLevel, out_pad_shape):
    """(T+1, hz, hy, hx, C) owned blocks -> dense grid tgrid * half."""
    C = y.shape[-1]
    tg = fine.tgrid
    hz, hy, hx = fine.half
    assert tuple(out_pad_shape) == (tg[0] * hz, tg[1] * hy,
                                    tg[2] * hx), (out_pad_shape, tg,
                                                  fine.half)
    nrows = tg[0] * tg[1] * tg[2]
    rid = torch.where(fine.tile_mask, _linearize(fine.tile_coords, tg),
                      nrows)
    vals = torch.where(fine.tile_mask[:, None, None, None, None],
                       y[:fine.capacity], 0.0)
    rows = y.new_zeros((nrows + 1, hz, hy, hx, C))
    rows = rows.index_put((rid.long(),), vals)[:nrows]
    d = rows.reshape(tuple(tg) + (hz, hy, hx, C))
    d = d.permute(0, 3, 1, 4, 2, 5, 6)
    return d.reshape(tuple(out_pad_shape) + (C,))


def _owned_occ_pool(lvl: TileLevel) -> torch.Tensor:
    """k3 s2 p1 activity dilation into the owned half-block layout,
    (T+1, hz, hy, hx) float 0/1."""
    h = halo(lvl.occ[..., None].float(), lvl, lo=(1, 1, 1),
             hi=(0, 0, 0))[..., 0]
    return F.max_pool3d(h[:, None], 3, 2)[:, 0]


def dense_occ_pool(occ, stride, kernel, padding) -> torch.Tensor:
    """Dense activity dilation (strided max-pool, -inf padding), bool
    in and out.  ``padding`` is per dim (before, after), symmetric."""
    y = F.max_pool3d(occ.float()[None, None], tuple(kernel), tuple(stride),
                     tuple(p[0] for p in padding))
    return y[0, 0] > 0.0


def dense_subm_conv(x, occ, weights, bias) -> torch.Tensor:
    """Submanifold conv on a dense level (p=1, masked by occ)."""
    y = _conv3d(x[None], _wconv(weights, (3, 3, 3)),
                padding=(1, 1, 1))[0] + bias
    return _masked(occ, y)


def dense_down_conv(x, occ_out, weights, bias, kernel, stride,
                    padding) -> torch.Tensor:
    """Dense strided conv between dense levels."""
    y = _conv3d(x[None], _wconv(weights, kernel), stride=tuple(stride),
                padding=tuple(padding))[0] + bias
    return _masked(occ_out, y)


def _inv_blocks(regions, fine_tile, weights, bias) -> torch.Tensor:
    """Shared inverse-conv core: (T+1, hz+1, hy+1, hx+1, Cin) coarse
    regions at offset half*t -> (T+1, tz, ty, tx, Cout) fine blocks.
    out(f) = sum_d w[d] in(c) with f = 2c + d - 1 (k3 s2 p1 transposed):
    a transposed conv of stride 2 and padding 1, whose leading
    (tz, ty, tx) outputs are the tile (JAX: the flipped kernel over the
    2-dilated input)."""
    w = _wconv(weights, (3, 3, 3)).transpose(0, 1)   # (Cin, Cout, k...)
    y = _conv3d(regions, w, stride=(2, 2, 2), padding=(1, 1, 1),
                transposed=True)
    tz, ty, tx = fine_tile
    return y[:, :tz, :ty, :tx, :] + bias


def _windows(src, rows, starts, extent):
    """src[rows[t], s0 + i, s1 + j, s2 + k] for i, j, k < extent (rows
    None: src is one grid): (T, e0, e1, e2, C)."""
    ar = [torch.arange(e, device=starts.device) for e in extent]
    zi = (starts[:, 0:1] + ar[0])[:, :, None, None]
    yi = (starts[:, 1:2] + ar[1])[:, None, :, None]
    xi = (starts[:, 2:3] + ar[2])[:, None, None, :]
    if rows is None:
        return src[zi, yi, xi]
    return src[rows[:, None, None, None], zi, yi, xi]


def inverse_from_dense(dense, fine: TileLevel, weights,
                       bias) -> torch.Tensor:
    """Inverse (transposed) conv from a DENSE coarse level onto the
    fine tile set (decoder L2 -> L1)."""
    half = fine.half
    reg = tuple(h + 1 for h in half)
    pad = F.pad(dense, (0, 0, 0, reg[2], 0, reg[1], 0, reg[0]))
    # a dynamic_slice start is clamped so that the window fits
    starts = fine.tile_coords.long() * torch.tensor(half,
                                                    device=dense.device)
    starts = torch.minimum(starts, torch.tensor(
        [pad.shape[d] - reg[d] for d in range(3)], device=dense.device))
    regions = _windows(pad, None, starts, reg)
    regions = torch.cat([regions, regions.new_zeros((1,) +
                                                    regions.shape[1:])], 0)
    return _masked(fine.occ, _inv_blocks(regions, fine.tile, weights, bias))


def inverse_from_tiles(xc: torch.Tensor, coarse: TileLevel,
                       fine: TileLevel, weights, bias) -> torch.Tensor:
    """Inverse conv from a TILED coarse level onto the fine tile set
    (decoder L1 -> L0).  Fine tile t needs coarse cells
    [half*t, half*(t+1)]: the hi-haloed parent block's window at the
    half*parity octant (the pad row where a tile has no parent)."""
    assert tuple(coarse.tile) == tuple(fine.tile)
    half = fine.half
    hc = halo(xc, coarse, lo=(0, 0, 0), hi=(1, 1, 1))
    parent = torch.div(fine.tile_coords, 2, rounding_mode="floor")
    parity = fine.tile_coords % 2
    pid = _linearize(parent, coarse.tgrid)
    pslot = coarse.slot_map[torch.clamp(
        pid, max=int(np.prod(coarse.tgrid))).long()] - 1
    pslot = torch.where((pslot >= 0) & fine.tile_mask, pslot,
                        coarse.capacity)
    starts = parity.long() * torch.tensor(half, device=xc.device)
    regions = _windows(hc, pslot.long(), starts,
                       tuple(h + 1 for h in half))
    regions = torch.cat([regions, regions.new_zeros((1,) +
                                                    regions.shape[1:])], 0)
    return _masked(fine.occ, _inv_blocks(regions, fine.tile, weights, bias))


def zcollapse_conv(x, occ_out, weights, bias) -> torch.Tensor:
    """(3,1,1) s(2,1,1) p0 dense conv (L3 -> L4 z collapse)."""
    y = _conv3d(x[None], _wconv(weights, (3, 1, 1)),
                stride=(2, 1, 1))[0] + bias
    return _masked(occ_out, y)


def _kill_beyond(occ: torch.Tensor, grid) -> torch.Tensor:
    """occ with every cell at or past ``grid`` along some dim cleared."""
    out = occ.clone()
    for d, g in enumerate(grid):
        if out.shape[d] > g:
            out.narrow(d, g, out.shape[d] - g).fill_(False)
    return out


def build_tiled_geometry(coords: torch.Tensor, vmask: torch.Tensor,
                         sparse_shape, tile_capacities,
                         tile=DEFAULT_TILE) -> TiledGeometry:
    """The per-frame geometry: L0/L1 tile levels + dense L2-L4 occ.

    sparse_shape: (nz, ny, nx) with the +1 z pad applied.
    tile_capacities: (T0, T1), clamped to the tile-grid size."""
    dev = coords.device
    T0, T1 = tile_capacities
    tile = tuple(tile)
    assert all(t % 2 == 0 for t in tile), tile
    tg0 = tuple(_cdiv(sparse_shape[d], tile[d]) for d in range(3))
    T0 = min(T0, int(np.prod(tg0)))
    l0, cell_index = build_l0(coords, vmask, sparse_shape, T0, tile)
    half = l0.half

    # L1 grid (k3 s2 p1 per dim)
    g1 = tuple((sparse_shape[d] + 2 - 3) // 2 + 1 for d in range(3))
    tg1 = tuple(_cdiv(g1[d], tile[d]) for d in range(3))
    T1 = min(T1, int(np.prod(tg1)))
    # L1 occupancy: L0 occ pooled into owned half blocks, laid out over
    # the owned grid (tg0 * half, covers >= g1), then re-tiled
    occ1_pad = _scatter_blocks_to_dense(
        _owned_occ_pool(l0)[..., None], l0,
        tuple(tg0[d] * half[d] for d in range(3)))[..., 0] > 0.0
    ext1 = tuple(tg1[d] * tile[d] for d in range(3))
    occ1_d = torch.zeros(ext1, dtype=torch.bool, device=dev)
    sl = tuple(slice(0, min(ext1[d], occ1_pad.shape[d])) for d in range(3))
    occ1_d[sl] = occ1_pad[sl]
    occ1_d = _kill_beyond(occ1_d, g1)
    blocks6 = occ1_d.reshape(tg1[0], tile[0], tg1[1], tile[1], tg1[2],
                             tile[2])
    tflag1 = blocks6.any(5).any(3).any(1).reshape(-1)
    c1, m1, sm1, nlo1, nhi1 = _build_level(tflag1, tg1, T1)
    occ1_rows = blocks6.permute(0, 2, 4, 1, 3, 5).reshape((-1,) + tile)
    rid1 = torch.where(m1, _linearize(c1, tg1), occ1_rows.shape[0])
    none = torch.zeros((1,) + tile, dtype=torch.bool, device=dev)
    occ1_rows = torch.cat([occ1_rows, none], 0)
    occ1 = torch.cat([occ1_rows[rid1.long()], none], 0)
    l1 = TileLevel(c1, m1, sm1, nlo1, nhi1, occ1, g1, tg1, tile)

    # dense levels
    g2 = tuple((g1[d] + 2 - 3) // 2 + 1 for d in range(3))
    pad2 = tuple(tg1[d] * half[d] for d in range(3))
    occ2 = _scatter_blocks_to_dense(_owned_occ_pool(l1)[..., None], l1,
                                    pad2)[..., 0] > 0.0
    occ2 = _kill_beyond(occ2, g2)
    # L3: k3 s2, z unpadded, y/x p=1 — on the true-grid semantics
    g3 = ((g2[0] - 3) // 2 + 1,
          (g2[1] + 2 - 3) // 2 + 1, (g2[2] + 2 - 3) // 2 + 1)
    occ3 = dense_occ_pool(occ2, (2, 2, 2), (3, 3, 3),
                          ((0, 0), (1, 1), (1, 1)))
    occ3 = occ3[:g3[0], :g3[1], :g3[2]]
    # L4: k(3,1,1) s(2,1,1) p0
    g4 = ((g3[0] - 3) // 2 + 1, g3[1], g3[2])
    occ4 = dense_occ_pool(occ3, (2, 1, 1), (3, 1, 1),
                          ((0, 0), (0, 0), (0, 0)))
    occ4 = occ4[:g4[0], :g4[1], :g4[2]]
    return TiledGeometry(l0, l1, cell_index, occ2, occ3, occ4)
