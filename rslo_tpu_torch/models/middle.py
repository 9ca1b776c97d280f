"""Sparse 3D middle feature extractor + per-voxel covariance decoder
(counterpart of ``rslo_tpu/models/middle.py``; rulebook, band and tiled
engines).

Channel plan: 16-16 @ full res -> 32-32 @ 1/2 -> 64s @ 1/4, 1/8 ->
z-collapse -> dense BEV at 1/8 with C*D channels, plus an inverse-conv
decoder from the 1/4-res level back to full resolution emitting 7
covariance parameters per active voxel.

Three engines share one parameter tree:
  * ``engine="rulebook"``: each of the 20 sparse convs runs through the
    Hopper kernel ``ops.dma_gather.gather_matmul``; in train mode
    through ``ops.dma_gather.sparse_conv``, whose backward runs over the
    transposed rulebooks that ``build_geometry(transposed=True)`` adds.
  * ``engine="band"``: ``build_band_geometry`` wraps the rulebooks into
    banded window plans (``ops.band_conv``), and each conv with a plan
    runs through ``band_conv_apply`` (kernel B4); in train mode through
    ``band_conv``.  Rulebooks narrower than ``band_min_channels`` stay
    raw and go through the rulebook kernels.
  * ``engine="tiles"``: ``build_tiled_geometry`` lays levels 0-1 out as
    blocks of dense tiles and levels 2-4 as dense grids
    (``ops.tiled_conv``); every conv is a cuDNN convolution in float32,
    differentiable by autograd.
The rulebook lookup (``plan_lookup``, ``ops.sparse_conv.LOOKUP_METHODS``)
changes how the rulebooks are built, not what they hold.  With
``plane_apply`` the 27-tap rulebook convs without a band plan run
``ops.sparse_conv.sparse_conv_apply_planes`` instead of the gather-GEMM
kernel, in both modes (autograd takes its gradient).

``MiddleCfg.remat`` is accepted and not applied: the port's rulebook
and band convs keep only their (V, Cin) inputs for the backward, so the
middle's activations stay small against the card's memory; the tiled
engine's convs keep their halo-extended blocks (``PERF.md``).

Submodules carry the flax auto-names of the reference (``SpConv_<i>``,
``MaskedBatchNorm_<i>``, in creation order), so ``convert.py`` maps
parameters by name.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import MiddleCfg
from ..ops import band_conv as bc
from ..ops import sparse_conv as sc
from ..ops import tiled_conv as tc
from ..ops.dma_gather import gather_matmul, sparse_conv
from ..utils.mesh_axis import psum_if_present


class FrameGeometry(NamedTuple):
    """Per-frame sparse geometry shared across layers.  On the band
    engine the entries of sub_rb, down_rb and inv_rb are band plans (or
    raw rulebooks, for rulebooks left to the rulebook kernels)."""
    levels: tuple          # L0 (full res) .. L4 (z-collapsed)
    sub_rb: tuple          # submanifold rulebooks for L0..L3
    down_rb: tuple         # strided-conv rulebooks L0->L1 .. L3->L4
    inv_rb: tuple          # inverse rulebooks L2->L1, L1->L0 (() when
                           # built with inverse=False)
    # transposes of down_rb (inverse rulebooks L1->L0 .. L4->L3), for
    # the backward; None unless built with transposed=True
    down_rb_t: Optional[tuple] = None
    # band engine in training: the rulebook geometry the plans were
    # built from (with its down_rb_t), whose raw rulebooks the backward
    # of the down and inverse plans runs over
    raw: Optional["FrameGeometry"] = None


DOWN_SPECS = (
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),   # L0 -> L1
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),   # L1 -> L2
    ((3, 3, 3), (2, 2, 2), (0, 1, 1)),   # L2 -> L3 (z unpadded)
    ((3, 1, 1), (2, 1, 1), (0, 0, 0)),   # L3 -> L4 (z collapse)
)


def build_geometry(coords: torch.Tensor, mask: torch.Tensor, sparse_shape,
                   capacities, lookup: Optional[str] = None,
                   transposed: bool = False,
                   inverse: bool = True) -> FrameGeometry:
    """coords: (V, 3) zyx int32; sparse_shape: (nz, ny, nx) with the +1
    on z applied; capacities: per-level caps (L4 reuses the L3 one).

    lookup: None/"slot_map" (dense slot maps, one gather per (row,
    tap)), "ranked" (windowed ranks, no slot maps), "ranked_planes" /
    "sorted_planes" (one rank query per (dz, dy) kernel plane, the x
    taps derived; the ranks windowed or by binary search, no slot maps)
    or "slot_planes" (one 4-entry slot-map segment per plane).  The
    rulebooks without a plane form (z collapse, inverse, transposed)
    take the matching elementwise lookup.  ``transposed`` also builds
    the rulebooks the backward needs (and, with slot maps, L4's, which
    they look up); ``inverse=False`` skips the covariance decoder's
    inverse rulebooks."""
    no_slot = lookup in ("ranked", "ranked_planes", "sorted_planes")
    planes = lookup in ("ranked_planes", "sorted_planes")
    slot_planes = lookup == "slot_planes"
    rank_method = "ranked" if lookup == "ranked_planes" else "sorted"
    elt_lookup = ("ranked" if lookup == "ranked_planes" else
                  None if lookup in ("sorted_planes", "slot_planes")
                  else lookup)
    attach = (lambda lv: lv) if no_slot else sc.with_slot_map
    l0 = attach(sc.level_from_coords(coords, mask, sparse_shape))
    levels = [l0]
    down_rb = []
    caps = list(capacities) + [capacities[-1]]
    for i, (k, s, p) in enumerate(DOWN_SPECS):
        # L4, the z collapse of L3 under L3's capacity, drops nothing:
        # the site counters name L1-L3
        nxt = sc.downsample_level(
            levels[-1], k, s, p, out_capacity=caps[min(i + 1, len(caps) - 1)],
            name=f"L{i + 1}" if i < 3 else None)
        if transposed or i < len(DOWN_SPECS) - 1:
            nxt = attach(nxt)   # L4 is looked up only by the transposed
                                # rulebooks
        if planes and k[2] == 3 and p[2] == 1:
            down_rb.append(sc.build_conv_index_planes(
                levels[-1], nxt, k, s, p, rank_method=rank_method))
        elif slot_planes and k[2] == 3 and p[2] == 1:
            down_rb.append(sc.build_conv_index_slot_planes(
                levels[-1], nxt, k, s, p))
        else:
            down_rb.append(sc.build_conv_index(levels[-1], nxt, k, s, p,
                                               lookup=elt_lookup))
        levels.append(nxt)
    if planes:
        sub_rb = tuple(sc.build_submanifold_index_planes(
            lv, rank_method=rank_method) for lv in levels[:4])
    elif slot_planes:
        sub_rb = tuple(sc.build_submanifold_index_slot_planes(lv)
                       for lv in levels[:4])
    else:
        sub_rb = tuple(sc.build_submanifold_index(lv, lookup=elt_lookup)
                       for lv in levels[:4])
    inv_rb = ()
    if inverse:
        inv_rb = (
            sc.build_inverse_index(levels[2], levels[1], *DOWN_SPECS[1],
                                   lookup=elt_lookup),
            sc.build_inverse_index(levels[1], levels[0], *DOWN_SPECS[0],
                                   lookup=elt_lookup))
    down_rb_t = None
    if transposed:
        down_rb_t = tuple(
            sc.build_inverse_index(levels[i + 1], levels[i], *spec,
                                   lookup=elt_lookup)
            for i, spec in enumerate(DOWN_SPECS))
    return FrameGeometry(tuple(levels), sub_rb, tuple(down_rb), inv_rb,
                         down_rb_t)


# the tiled engine's per-frame geometry, at JAX's module path
build_tiled_geometry = tc.build_tiled_geometry


def build_band_geometry(coords: torch.Tensor, mask: torch.Tensor,
                        sparse_shape, capacities,
                        windows=(bc.SUBM_WINDOW, bc.DOWN_WINDOW,
                                 bc.INV_WINDOW),
                        block: int = 256, channels=None,
                        min_channels: int = 0,
                        lookup: Optional[str] = None,
                        transposed: bool = False,
                        inverse: bool = True) -> FrameGeometry:
    """Rulebook geometry with its rulebooks wrapped into band plans
    (``ops.band_conv``): subm ones with ``windows[0]`` (self-transpose
    plans), strided ones with ``windows[1]``, inverse ones with
    ``windows[2]``.  When ``channels`` (the middle's (c0, c1, c2, c3)) is
    given, a rulebook whose widest conv is narrower than
    ``min_channels`` stays a raw rulebook.  ``transposed`` (training)
    keeps the rulebook geometry, with its transposed rulebooks, in
    ``raw``; ``inverse=False`` builds no inverse rulebook or plan."""
    geo = build_geometry(coords, mask, sparse_shape, capacities,
                         lookup=lookup, transposed=transposed,
                         inverse=inverse)
    sw, dw, iw = windows
    ch = (min_channels,) * 4 if channels is None else tuple(channels)
    # widest conv through each rulebook (encoder + cov decoder reuse)
    sub_w = ch
    down_w = tuple(max(ch[i], ch[min(i + 1, 3)]) for i in range(4))
    inv_w = (max(ch[2], ch[1]), max(ch[1], ch[0]))

    def wrap(rb, v_in, window, width, self_transpose=False):
        if width < min_channels:
            return rb
        return bc.build_band_index(rb, v_in, block=block, window=window,
                                   self_transpose=self_transpose)

    lv = geo.levels
    sub = tuple(wrap(rb, lv[i].capacity, sw, sub_w[i], True)
                for i, rb in enumerate(geo.sub_rb))
    down = tuple(wrap(rb, lv[i].capacity, dw, down_w[i])
                 for i, rb in enumerate(geo.down_rb))
    inv = tuple(wrap(rb, lv[2 - i].capacity, iw, inv_w[i])
                for i, rb in enumerate(geo.inv_rb))
    return FrameGeometry(geo.levels, sub, down, inv,
                         raw=geo if transposed else None)


def band_overflow_counts(geo: FrameGeometry) -> dict:
    """{"sub0".."inv1": (ov_count, ov_capacity)} of every band plan in
    the geometry, the guard against the inexact saturated-overflow
    path."""
    out = {}
    for name, rbs in (("sub", geo.sub_rb), ("down", geo.down_rb),
                      ("inv", geo.inv_rb)):
        for i, rb in enumerate(rbs):
            if isinstance(rb, bc.BandIndex):
                out[f"{name}{i}"] = (rb.ov_count, rb.ov_capacity)
    return out


class ConvOp(NamedTuple):
    """A conv's raw rulebook, the transposed rulebook its backward runs
    over (None without one), whether that transpose flips the taps, and
    the conv's band plan on the band engine (None on the rulebook
    engine; ``rb`` is then None outside training)."""
    rb: Optional[sc.ConvIndex]
    rb_t: Optional[sc.ConvIndex] = None
    flip_taps: bool = False
    plan: Optional[bc.BandIndex] = None


# ---- the tiled engine's op descriptors ------------------------------------

class SubmOp(NamedTuple):
    lvl: tc.TileLevel


class DownOp(NamedTuple):
    fine: tc.TileLevel
    coarse: tc.TileLevel


class DownDenseOp(NamedTuple):
    fine: tc.TileLevel
    out_pad_shape: tuple
    occ_out: torch.Tensor


class DenseSubmOp(NamedTuple):
    occ: torch.Tensor


class DenseDownOp(NamedTuple):
    occ_out: torch.Tensor
    kernel: tuple
    stride: tuple
    padding: tuple


class InvDenseOp(NamedTuple):
    fine: tc.TileLevel


class InvTileOp(NamedTuple):
    coarse: tc.TileLevel
    fine: tc.TileLevel


class SpConv(nn.Module):
    """One sparse conv layer: kernel (taps, Cin, Cout) + bias, applied
    through a band plan by ``band_conv_apply``, through a rulebook by
    the gather-GEMM kernel (or the plane apply), or through a tiled op
    by ``ops.tiled_conv``."""

    def __init__(self, in_features: int, features: int, taps: int,
                 dtype: str = "bf16", plane_apply: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(taps, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.compute_dtype = (torch.bfloat16 if dtype == "bf16"
                              else torch.float32)
        self.plane_apply = plane_apply and taps == 27

    def forward(self, feats: torch.Tensor, op,
                out_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not isinstance(op, ConvOp):
            return _tiled_conv(feats, op, self.kernel, self.bias)
        train = self.training and torch.is_grad_enabled()
        if op.plan is None and self.plane_apply:
            return sc.sparse_conv_apply_planes(
                feats, op.rb, self.kernel, self.bias, out_mask,
                self.compute_dtype)
        if op.plan is not None:
            if train:
                return bc.band_conv(feats, op.plan, self.kernel, self.bias,
                                    out_mask, self.compute_dtype, op.rb,
                                    op.rb_t)
            return bc.band_conv_apply(feats, op.plan, self.kernel,
                                      self.bias, out_mask,
                                      self.compute_dtype)
        if train:
            if op.rb_t is None:
                raise ValueError(
                    "SpConv in train mode needs the transposed rulebook: "
                    "build the geometry with transposed=True")
            return sparse_conv(feats, op.rb, op.rb_t, self.kernel,
                               self.bias, out_mask, self.compute_dtype,
                               op.flip_taps)
        return gather_matmul(feats, op.rb.idx, op.rb.valid, self.kernel,
                             self.bias, out_mask, self.compute_dtype)


def _tiled_conv(feats, op, w, b) -> torch.Tensor:
    """The tiled engine's conv of op descriptor ``op`` (float32)."""
    if isinstance(op, SubmOp):
        return tc.subm_conv(feats, op.lvl, w, b)
    if isinstance(op, DownOp):
        return tc.down_conv(feats, op.fine, op.coarse, w, b)
    if isinstance(op, DownDenseOp):
        return tc.down_to_dense(feats, op.fine, op.out_pad_shape, w, b,
                                op.occ_out)
    if isinstance(op, DenseSubmOp):
        return tc.dense_subm_conv(feats, op.occ, w, b)
    if isinstance(op, DenseDownOp):
        return tc.dense_down_conv(feats, op.occ_out, w, b, op.kernel,
                                  op.stride, op.padding)
    if isinstance(op, InvDenseOp):
        return tc.inverse_from_dense(feats, op.fine, w, b)
    if isinstance(op, InvTileOp):
        return tc.inverse_from_tiles(feats, op.coarse, op.fine, w, b)
    raise TypeError(f"unknown conv op {type(op)}")


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of a (V, C) feature array (or of an
    N-D block or grid with channels last and a mask of its shape, as
    the tiled engine's levels are).  Train
    mode normalizes with the batch statistics of the valid rows
    (n = sum(mask) + 1e-6, biased variance) and updates the running
    statistics as 0.99 * old + 0.01 * batch; eval mode applies them.
    With ``sync``, inside a data-parallel step, n, sum(x) and sum(x^2)
    are summed over the ranks of the "data" axis: the statistics of the
    pooled rows, not a mean of the ranks' means (each rank's n carries
    its own 1e-6, as in JAX)."""

    def __init__(self, num_features: int, eps: float = 1e-3,
                 momentum: float = 0.99, sync: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.sync = sync
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if x.dim() > 2:
            return self(x.reshape(-1, x.shape[-1]),
                        mask.reshape(-1)).reshape(x.shape)
        if self.training:
            m = mask[:, None].to(x.dtype)
            n = torch.sum(m) + 1e-6
            s1 = torch.sum(x * m, dim=0)
            s2 = torch.sum(x * x * m, dim=0)
            if self.sync:
                n, s1, s2 = (psum_if_present(t, "data") for t in (n, s1, s2))
            mean = s1 / n
            var = s2 / n - mean * mean
            var = torch.maximum(var, torch.zeros_like(var))
            update_running_stats(self, mean, var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.scale \
            + self.bias
        return torch.where(mask[:, None], y, 0.0)


@torch.no_grad()
def update_running_stats(norm: nn.Module, mean: torch.Tensor,
                         var: torch.Tensor):
    """``running = momentum * running + (1 - momentum) * batch``, the
    flax convention (torch's BatchNorm weighs the other way round and
    keeps the unbiased variance)."""
    mom = norm.momentum
    norm.mean.copy_(mom * norm.mean + (1 - mom) * mean.detach())
    norm.var.copy_(mom * norm.var + (1 - mom) * var.detach())


class SparseMiddleCov(nn.Module):
    """Sparse middle net with BEV output + full-res covariance decoder."""

    def __init__(self, cfg: MiddleCfg):
        super().__init__()
        if cfg.engine not in ("rulebook", "band", "tiles"):
            raise ValueError(f"unknown middle engine {cfg.engine!r}")
        if cfg.bn_type not in ("none", "bn", "sync_bn"):
            raise ValueError(f"unknown middle bn_type {cfg.bn_type!r}")
        self.cfg = cfg
        c0, c1, c2, c3 = cfg.channels
        cin = cfg.num_input_features
        encoder = [(cin, c0, 27), (c0, c0, 27), (c0, c1, 27),
                   (c1, c1, 27), (c1, c1, 27), (c1, c2, 27),
                   (c2, c2, 27), (c2, c2, 27), (c2, c2, 27), (c2, c3, 27),
                   (c3, c3, 27), (c3, c3, 27), (c3, c3, 27), (c3, c3, 3)]
        decoder = [(c2, c1, 27), (c1, c1, 27), (c1, c0, 27), (c0, c0, 27),
                   (c0, c0, 27), (c0, cfg.cov_channels, 27)]
        self._convs = []
        for i, (ci, co, taps) in enumerate(encoder + decoder):
            m = SpConv(ci, co, taps, cfg.conv_dtype, cfg.plane_apply)
            self.add_module(f"SpConv_{i}", m)
            self._convs.append(m)
        # the encoder is normalized only under bn_type != "none"; the
        # decoder always is (all but its last conv)
        norm_widths = ([co for _, co, _ in encoder]
                       if cfg.bn_type != "none" else [])
        self._n_enc_norms = len(norm_widths)
        norm_widths += [co for _, co, _ in decoder[:-1]]
        self._norms = []
        for i, c in enumerate(norm_widths):
            # the encoder's syncs under "sync_bn"; the decoder's never
            m = MaskedBatchNorm(c, sync=(cfg.bn_type == "sync_bn" and
                                         i < self._n_enc_norms))
            self.add_module(f"MaskedBatchNorm_{i}", m)
            self._norms.append(m)

    def forward(self, voxel_features: torch.Tensor, geo,
                with_cov: bool = True):
        """voxel_features: (V0, F) per-voxel features aligned with the
        frame's voxel stream; geo: a FrameGeometry (rulebook and band
        engines) or a TiledGeometry (tiled engine).  Returns
        (bev (ny, nx, nz*C), cov (V0, 7)); ``with_cov=False`` skips the
        covariance decoder (6 of the 20 convs, and its BNs) and returns
        None for cov."""
        plan = (_TiledPlan(geo) if isinstance(geo, tc.TiledGeometry)
                else _RulebookPlan(geo))
        convs = iter(self._convs)
        norms = iter(self._norms)
        enc_norm = self._n_enc_norms > 0

        def conv(x, op, lvl):
            return next(convs)(x, op, plan.mask(lvl))

        def norm_relu(x, lvl, always=False):
            if enc_norm or always:
                x = next(norms)(x, plan.mask(lvl))
            return F.relu(x)

        def block(x, lvl, n_layers):
            for _ in range(n_layers):
                x = norm_relu(conv(x, plan.subm(lvl), lvl), lvl)
            return x

        # encoder: L0 subm x2 -> down -> L1 subm x2 -> down
        x = block(plan.inject(voxel_features), 0, 2)
        x = norm_relu(conv(x, plan.down(0), 1), 1)
        x = block(x, 1, 2)
        x = norm_relu(conv(x, plan.down(1), 2), 2)
        x_mid = x  # L2 features feed the covariance decoder
        # tail: L2 subm x3 -> down -> L3 subm x3 -> z-collapse to L4
        x = block(x, 2, 3)
        x = norm_relu(conv(x, plan.down(2), 3), 3)
        x = block(x, 3, 3)
        x = norm_relu(conv(x, plan.down(3), 4), 4)
        bev = plan.to_bev(x)
        if not with_cov:
            return bev, None

        # covariance decoder: inverse convs back to full res, always BN
        y = norm_relu(conv(x_mid, plan.inv(0), 1), 1, always=True)
        y = norm_relu(conv(y, plan.subm(1), 1), 1, always=True)
        y = norm_relu(conv(y, plan.inv(1), 0), 0, always=True)
        y = norm_relu(conv(y, plan.subm(0), 0), 0, always=True)
        y = norm_relu(conv(y, plan.subm(0), 0), 0, always=True)
        cov = plan.extract_rows(conv(y, plan.subm(0), 0))
        cov = torch.cat([F.elu(cov[:, :3]) + 1 + 1e-6, cov[:, 3:]], dim=-1)
        cov = torch.where(plan.row_mask()[:, None], cov, 0.0)
        return bev, cov


class _RulebookPlan:
    """Op/mask provider for the sorted-level engines (rulebook, band).
    Every op carries its transposed rulebook when the geometry has them:
    a submanifold rulebook is its own transpose with the taps flipped;
    inv(0) and inv(1) are transposed by down_rb[1] and down_rb[0].  On
    the band engine an op carries its plan, and in training also its
    raw rulebook."""

    def __init__(self, geo: FrameGeometry):
        self.geo = geo
        self.rbs = geo if geo.raw is None else geo.raw   # raw rulebooks
        self.grad = self.rbs.down_rb_t is not None

    def _op(self, entry, raw, rb_t, flip=False):
        rb_t = rb_t if self.grad else None
        if isinstance(entry, bc.BandIndex):
            return ConvOp(raw if self.grad else None, rb_t, flip, entry)
        return ConvOp(entry, rb_t, flip)

    def subm(self, i):
        rb = self.rbs.sub_rb[i]
        return self._op(self.geo.sub_rb[i], rb, rb, True)

    def down(self, i):
        return self._op(self.geo.down_rb[i], self.rbs.down_rb[i],
                        (self.rbs.down_rb_t or self.rbs.down_rb)[i])

    def inv(self, i):
        return self._op(self.geo.inv_rb[i], self.rbs.inv_rb[i],
                        self.rbs.down_rb[1 - i])

    def inject(self, rows):
        return rows

    def extract_rows(self, cov):
        return cov

    def mask(self, i):
        return self.geo.levels[i].mask

    def row_mask(self):
        return self.geo.levels[0].mask

    def to_bev(self, x):
        dense = sc.to_dense(x, self.geo.levels[4])
        nz, ny, nx, C = dense.shape
        # z-major channel order: channel = z*C + c
        return dense.permute(1, 2, 0, 3).reshape(ny, nx, nz * C)


class _TiledPlan:
    """Op/mask provider for the tiled engine: levels 0-1 are tile
    blocks, levels 2-4 dense grids; masks follow the data layout."""

    def __init__(self, geo: tc.TiledGeometry):
        self.geo = geo
        l1 = geo.l1
        self._pad2 = tuple(l1.tgrid[d] * l1.half[d] for d in range(3))

    def inject(self, rows):
        return tc.scatter_voxels(rows, self.geo.cell_index, self.geo.l0)

    def subm(self, i):
        if i <= 1:
            return SubmOp((self.geo.l0, self.geo.l1)[i])
        return DenseSubmOp((self.geo.occ2, self.geo.occ3)[i - 2])

    def down(self, i):
        g = self.geo
        if i == 0:
            return DownOp(g.l0, g.l1)
        if i == 1:
            return DownDenseOp(g.l1, self._pad2, g.occ2)
        if i == 2:
            return DenseDownOp(g.occ3, (3, 3, 3), (2, 2, 2), (0, 1, 1))
        return DenseDownOp(g.occ4, (3, 1, 1), (2, 1, 1), (0, 0, 0))

    def inv(self, i):
        if i == 0:
            return InvDenseOp(self.geo.l1)       # dense L2 -> tiled L1
        return InvTileOp(self.geo.l1, self.geo.l0)

    def mask(self, i):
        g = self.geo
        if i <= 1:
            return (g.l0, g.l1)[i].occ
        return (g.occ2, g.occ3, g.occ4)[i - 2]

    def row_mask(self):
        flat = self.geo.l0.occ.reshape(-1)
        flat = torch.cat([flat, flat.new_zeros(1)])
        return flat[self.geo.cell_index.long()]

    def extract_rows(self, cov):
        return tc.gather_voxels(cov, self.geo.cell_index)

    def to_bev(self, x):
        # x dense (z4p, H, W, C); the true z4 from occ4's shape
        z4, H, W = self.geo.occ4.shape
        d = x[:z4, :H, :W]
        return d.permute(1, 2, 0, 3).reshape(H, W, z4 * d.shape[-1])
