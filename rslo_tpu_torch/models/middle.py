"""Sparse 3D middle feature extractor + per-voxel covariance decoder
(counterpart of ``rslo_tpu/models/middle.py``; rulebook engine, eval
mode).

Channel plan: 16-16 @ full res -> 32-32 @ 1/2 -> 64s @ 1/4, 1/8 ->
z-collapse -> dense BEV at 1/8 with C*D channels, plus an inverse-conv
decoder from the 1/4-res level back to full resolution emitting 7
covariance parameters per active voxel.  Each of the 20 sparse convs
runs through the Hopper kernel ``ops.dma_gather.gather_matmul``.

Submodules carry the flax auto-names of the reference (``SpConv_<i>``,
``MaskedBatchNorm_<i>``, in creation order), so ``convert.py`` maps
parameters by name.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from rslo_tpu.config.schema import MiddleCfg

from ..ops import sparse_conv as sc
from ..ops.dma_gather import gather_matmul


class FrameGeometry(NamedTuple):
    """Per-frame sparse geometry shared across layers."""
    levels: tuple          # L0 (full res) .. L4 (z-collapsed)
    sub_rb: tuple          # submanifold rulebooks for L0..L3
    down_rb: tuple         # strided-conv rulebooks L0->L1 .. L3->L4
    inv_rb: tuple          # inverse rulebooks L2->L1, L1->L0


DOWN_SPECS = (
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),   # L0 -> L1
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),   # L1 -> L2
    ((3, 3, 3), (2, 2, 2), (0, 1, 1)),   # L2 -> L3 (z unpadded)
    ((3, 1, 1), (2, 1, 1), (0, 0, 0)),   # L3 -> L4 (z collapse)
)


def build_geometry(coords: torch.Tensor, mask: torch.Tensor, sparse_shape,
                   capacities, lookup: Optional[str] = None
                   ) -> FrameGeometry:
    """coords: (V, 3) zyx int32; sparse_shape: (nz, ny, nx) with the +1
    on z applied; capacities: per-level caps (L4 reuses the L3 one).
    Lookups go through dense slot maps (``lookup`` None or
    "slot_map")."""
    if lookup not in (None, "slot_map"):
        raise NotImplementedError(
            f"plan_lookup={lookup!r} is not ported; only 'slot_map'")
    l0 = sc.with_slot_map(sc.level_from_coords(coords, mask, sparse_shape))
    levels = [l0]
    down_rb = []
    caps = list(capacities) + [capacities[-1]]
    for i, (k, s, p) in enumerate(DOWN_SPECS):
        nxt = sc.downsample_level(levels[-1], k, s, p,
                                  out_capacity=caps[min(i + 1, len(caps) - 1)])
        if i < len(DOWN_SPECS) - 1:  # L4 is never looked up in
            nxt = sc.with_slot_map(nxt)
        down_rb.append(sc.build_conv_index(levels[-1], nxt, k, s, p))
        levels.append(nxt)
    sub_rb = tuple(sc.build_submanifold_index(lv) for lv in levels[:4])
    inv_rb = (sc.build_inverse_index(levels[2], levels[1], *DOWN_SPECS[1]),
              sc.build_inverse_index(levels[1], levels[0], *DOWN_SPECS[0]))
    return FrameGeometry(tuple(levels), sub_rb, tuple(down_rb), inv_rb)


class SpConv(nn.Module):
    """One sparse conv layer: kernel (taps, Cin, Cout) + bias, applied
    through a rulebook by the gather-GEMM kernel."""

    def __init__(self, in_features: int, features: int, taps: int,
                 dtype: str = "bf16"):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(taps, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.compute_dtype = (torch.bfloat16 if dtype == "bf16"
                              else torch.float32)

    def forward(self, feats: torch.Tensor, op: sc.ConvIndex,
                out_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return gather_matmul(feats, op.idx, op.valid, self.kernel,
                             self.bias, out_mask, self.compute_dtype)


def _require_eval(module: nn.Module):
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: train-mode batch statistics are not "
            f"ported; call .eval()")


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of a (V, C) feature array, applied
    with its running statistics (eval mode)."""

    def __init__(self, num_features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        _require_eval(self)
        y = (x - self.mean) * torch.rsqrt(self.var + self.eps) * self.scale \
            + self.bias
        return torch.where(mask[:, None], y, 0.0)


class SparseMiddleCov(nn.Module):
    """Sparse middle net with BEV output + full-res covariance decoder."""

    def __init__(self, cfg: MiddleCfg):
        super().__init__()
        if cfg.engine != "rulebook":
            raise NotImplementedError(
                f"engine={cfg.engine!r} is not ported; only 'rulebook' "
                f"('band' is still to port, 'tiles' is not ported by "
                f"decision)")
        if cfg.plan_lookup not in (None, "slot_map"):
            raise NotImplementedError(
                f"plan_lookup={cfg.plan_lookup!r} is not ported, by "
                f"decision; only 'slot_map'")
        if cfg.plane_apply:
            raise NotImplementedError(
                "plane_apply is not ported, by decision")
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
            m = SpConv(ci, co, taps, cfg.conv_dtype)
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
            m = MaskedBatchNorm(c)
            self.add_module(f"MaskedBatchNorm_{i}", m)
            self._norms.append(m)

    def forward(self, voxel_features: torch.Tensor, geo: FrameGeometry):
        """voxel_features: (V0, F) per-voxel features aligned with the
        frame's voxel stream.  Returns (bev (ny, nx, nz*C),
        cov (V0, 7))."""
        plan = _RulebookPlan(geo)
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
        x = block(voxel_features, 0, 2)
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

        # covariance decoder: inverse convs back to full res, always BN
        y = norm_relu(conv(x_mid, plan.inv(0), 1), 1, always=True)
        y = norm_relu(conv(y, plan.subm(1), 1), 1, always=True)
        y = norm_relu(conv(y, plan.inv(1), 0), 0, always=True)
        y = norm_relu(conv(y, plan.subm(0), 0), 0, always=True)
        y = norm_relu(conv(y, plan.subm(0), 0), 0, always=True)
        cov = conv(y, plan.subm(0), 0)
        cov = torch.cat([F.elu(cov[:, :3]) + 1 + 1e-6, cov[:, 3:]], dim=-1)
        cov = torch.where(plan.row_mask()[:, None], cov, 0.0)
        return bev, cov


class _RulebookPlan:
    """Op/mask provider for the sorted-level rulebook engine."""

    def __init__(self, geo: FrameGeometry):
        self.geo = geo

    def subm(self, i):
        return self.geo.sub_rb[i]

    def down(self, i):
        return self.geo.down_rb[i]

    def inv(self, i):
        return self.geo.inv_rb[i]

    def mask(self, i):
        return self.geo.levels[i].mask

    def row_mask(self):
        return self.geo.levels[0].mask

    def to_bev(self, x):
        dense = sc.to_dense(x, self.geo.levels[4])
        nz, ny, nx, C = dense.shape
        # z-major channel order: channel = z*C + c
        return dense.permute(1, 2, 0, 3).reshape(ny, nx, nz * C)
