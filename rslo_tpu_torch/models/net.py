"""Top-level odometry network: VFE -> middle (+cov) -> BEV pair
encoder/decoder -> ego-motion vote (counterpart of
``rslo_tpu/models/net.py``).  An example carries either the per-voxel
point stacks (``voxels``), which ``cfg.vfe.name``'s encoder
(``models/vfe.py``) turns into features, or those features already
(``voxel_features``, mean-mode preparation).  The middle is
``cfg.middle.name``: ``SparseMiddleCov`` (sparse convs over per-frame
geometry) or ``PillarMiddleCov`` (dense 2-D convs over a pillar image,
no geometry).

A new ``OdomNet`` is in eval mode; a trainer calls ``.train()``, which
switches every BN to batch statistics and makes the sparse convs
differentiable.

One sample at a time: a window of L frames is encoded with shared
weights and all C(L, 2) frame pairs are predicted.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..config.schema import PipelineCfg, grid_size
from ..parallel.spatial import bev_constraint
from ..utils.timing import span
from .bev_net import BEVOdomNet, Norm, cycle_pairs, identity_pose_bias
from .middle import (MaskedBatchNorm, SparseMiddleCov, SpConv,
                     build_band_geometry, build_geometry,
                     build_tiled_geometry)
from .middle_pillar import PillarMiddleCov
from .semiglobal_bn import SemiGlobalSyncBN
from .vfe import VFES


# flax's truncated_normal: N(0, 1) cut at +-2, then scaled by
# 1/std(that cut normal) so the result has the requested variance
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def truncated_normal_(t: torch.Tensor, variance: float,
                      generator: Optional[torch.Generator] = None):
    """In place: flax's ``variance_scaling(..., "truncated_normal")``
    draw, i.e. N(0, 1) truncated to [-2, 2] (by inverse CDF) times
    sqrt(variance) / 0.8796."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.empty(t.shape, dtype=torch.float64)
    u.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    z = torch.clamp(torch.special.erfinv(u) * math.sqrt(2.0), -2.0, 2.0)
    t.copy_(z * (math.sqrt(variance) / _TRUNC_STD))
    return t


class OdomNet(nn.Module):
    def __init__(self, cfg: PipelineCfg,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        if cfg.middle.name == "PillarMiddleCov":
            self.middle = PillarMiddleCov(cfg.middle, self.sparse_shape)
        elif cfg.middle.name == "SparseMiddleCov":
            self.middle = SparseMiddleCov(cfg.middle)
        else:
            # JAX's OdomNet builds no other middle either (it maps every
            # other name to the sparse one); models/middle_dense.py's
            # DenseMiddleCov is reached on its own
            raise NotImplementedError(
                f"middle {cfg.middle.name!r}: OdomNet builds "
                f"'SparseMiddleCov' or 'PillarMiddleCov'")
        self.bev_net = BEVOdomNet(cfg.odom,
                                  cfg.voxelizer.point_cloud_range)
        self.reset_parameters(generator)
        self.eval()

    @property
    def sparse_shape(self):
        nx, ny, nz = grid_size(self.cfg.voxelizer)
        return (nz + 1, ny, nx)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Random init drawn from ``generator``, with flax's
        initializers: He-normal sparse-conv kernels (fan_in = taps*Cin,
        scale 2), LeCun-normal dense convs (fan_in = kh*kw*Cin/groups,
        scale 1) and dense layers (fan_in = in_features), all truncated
        normals; zero biases (identity pose for the 7-channel tq heads),
        unit BN scales and statistics."""
        for mod in self.modules():
            if isinstance(mod, SpConv):
                taps, cin, _ = mod.kernel.shape
                truncated_normal_(mod.kernel, 2.0 / (taps * cin), generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d):
                truncated_normal_(mod.weight, 1.0 / mod.weight[0].numel(),
                                  generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                truncated_normal_(mod.weight, 1.0 / mod.in_features,
                                  generator)
                mod.bias.zero_()
            elif isinstance(mod, (MaskedBatchNorm, Norm)) and \
                    hasattr(mod, "scale"):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
            elif isinstance(mod, SemiGlobalSyncBN):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.reset_statistics()
        # the BEV net's own layers with a 7-wide bias are its pose heads:
        # the 1x1 tq convs, or the FC head's last dense layer
        for mod in self.bev_net.children():
            bias = getattr(mod, "bias", None)
            if bias is not None and bias.shape == (7,):
                mod.bias.copy_(identity_pose_bias())

    def _middle_geometry(self, coords, vmask, with_cov: bool = True):
        """Per-frame sparse geometry of the configured engine, with the
        transposed rulebooks when training needs gradients and the
        inverse ones when the covariance decoder runs (the tiled
        engine's geometry serves every case)."""
        m = self.cfg.middle
        grad = self.training and torch.is_grad_enabled()
        if m.engine == "tiles":
            return build_tiled_geometry(coords, vmask, self.sparse_shape,
                                        tuple(m.tile_capacities),
                                        tuple(m.tile_shape))
        if m.engine == "band":
            return build_band_geometry(
                coords, vmask, self.sparse_shape, m.level_capacities,
                windows=tuple(m.band_windows), block=m.band_block,
                channels=tuple(m.channels), min_channels=m.band_min_channels,
                lookup=m.plan_lookup, transposed=grad, inverse=with_cov)
        return build_geometry(coords, vmask, self.sparse_shape,
                              m.level_capacities, lookup=m.plan_lookup,
                              transposed=grad, inverse=with_cov)

    def forward(self, example: Dict[str, Any],
                with_cov: bool = True) -> dict:
        """example (single sample, no batch dim), as prepare_example
        emits it:
          voxel_features: (L, V, F) float (mean mode), or
          voxels:         (L, V, P, F) float and num_points (L, V) int32
          coords:         (L, V, 3) int32 zyx (-1 padding)
          voxel_mask:     (L, V) bool
        Returns the prediction dict (pair-major tensors), with
        ``normal_gt`` (list[L] of (V, 3)) from the cross-normal VFE;
        ``with_cov=False`` skips the covariance decoder and leaves
        ``voxel_covs`` out."""
        self.bev_net.check_train_mode()
        coords = example["coords"]
        vmask = example["voxel_mask"]
        L = coords.shape[0]
        vfe = VFES[self.cfg.vfe.name]
        bevs, covs, feats, normal_gts = [], [], [], []
        for t in range(L):
            if "voxel_features" in example:
                f = example["voxel_features"][t]
            else:
                f = vfe(example["voxels"][t], example["num_points"][t],
                        self.cfg.vfe.num_input_features)
            if isinstance(f, tuple):             # the cross-normal VFE
                f, gt = f
                normal_gts.append(gt)
            bev, cov = self.frame_features(f, coords[t], vmask[t],
                                           with_cov)
            bevs.append(bev[None])
            covs.append(cov)
            feats.append(f)
        with span("bev_net"):
            x1, x2 = cycle_pairs(bevs)
            # the split hook: this rank's columns under a spatial split
            # (parallel/spatial.py), the tensor itself otherwise
            preds = self.bev_net(bev_constraint(torch.cat([x1, x2],
                                                          dim=-1)))
        preds["voxel_features"] = feats        # list[L] of (V, F)
        if with_cov:
            preds["voxel_covs"] = covs         # list[L] of (V, 7)
        preds["voxel_masks"] = [vmask[t] for t in range(L)]
        if normal_gts:
            preds["normal_gt"] = normal_gts    # cross-normal supervision
        preds["seq_length"] = L
        return preds

    def frame_features(self, voxel_features, coords, vmask,
                       with_cov: bool = True):
        """Encode one frame: (V, F) features + coords -> (BEV (H, W, C),
        cov (V, 7), or None with ``with_cov=False``)."""
        if isinstance(self.middle, PillarMiddleCov):
            with span("middle"):
                return self.middle(voxel_features, coords, vmask, with_cov)
        with span("geometry"):
            geo = self._middle_geometry(coords, vmask, with_cov)
        with span("middle"):
            return self.middle(voxel_features, geo, with_cov)

    def pair_predict(self, bev_prev, bev_new) -> dict:
        """Predict the motion from the previous frame to the new one
        given their cached BEV features (H, W, C) each."""
        with span("bev_net"):
            return self.bev_net(torch.cat([bev_prev, bev_new],
                                          dim=-1)[None])
