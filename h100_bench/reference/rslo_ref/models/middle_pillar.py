"""Pillar middle extractor + per-voxel covariance head (counterpart of
``rslo_tpu/models/middle_pillar.py``).

The sparse middle's output contract, computed with dense 2-D convs:

  * pillarize: the voxels collapse into a dense (ny, nx, zbins + F + 2)
    image: the z-occupancy histogram, the mean voxel feature, the
    normalized mean z and a scaled count per pillar, all scattered in
    float32 and cast to bfloat16;
  * a 10-conv encoder with the stride plan 1, 1, 2, 1, 2, 1, 1, 2, 1, 1
    gives the BEV map at 1/8 resolution (2 * c3 channels);
  * a decoder upsamples the 1/4 map by 4 (nearest), concatenates the
    full-resolution map and runs 2 more convs; a per-voxel head takes
    the decoder's feature at the voxel's (y, x), a one-hot of its z
    band and its own feature through two dense layers to the 7
    covariance parameters.

The convs compute in bfloat16 with bfloat16 bias, as the JAX module
hard-codes; the dense head computes in float32.  Padding follows flax's
``padding="SAME"`` (``ops/same.py::pad_same``).  Submodules
carry the flax auto-names (``Conv2dBNRelu_<i>``, ``Dense_<i>``) so
``convert.py`` maps the parameters by name.  ``MiddleCfg.remat`` is
accepted and not applied, as for the sparse middle.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import MiddleCfg
from ..ops.same import pad_same
from .bev_net import Norm

_BF16 = torch.bfloat16
# the encoder's (width index into (c1, c2, c3) doubled, stride) plan
_ENCODER = ((1, 1), (1, 1), (2, 2), (2, 1), (2, 2), (2, 1), (2, 1),
            (3, 2), (3, 1), (3, 1))
_FULL, _QUARTER = 1, 6      # encoder outputs the decoder reads


class Conv2dBNRelu(nn.Module):
    """3x3 SAME conv in bfloat16 (bias added in bfloat16 after the
    conv's rounding), then ``Norm`` unless bn_type is "none", then relu.
    NCHW in and out."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 bn_type: str = "none"):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, 3, stride)
        if bn_type != "none":
            self.Norm_0 = Norm(features, bn_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.Conv_0
        s = c.stride[0]
        y = F.conv2d(pad_same(x, 3, s), c.weight.to(_BF16), None, s)
        y = y + c.bias.to(_BF16).view(1, -1, 1, 1)
        if hasattr(self, "Norm_0"):
            y = self.Norm_0(y)
        return F.relu(y)


def z_onehot(pz: torch.Tensor, zbins: int) -> torch.Tensor:
    """(V,) z bins -> (V, 8) float32 one-hot of the z band
    ``pz // max(zbins // 8, 1)``; a band >= 8 gives a zero row, as
    ``jax.nn.one_hot`` does."""
    cls = pz // max(zbins // 8, 1)
    return (cls[:, None] == torch.arange(8, device=pz.device)).float()


class PillarMiddleCov(nn.Module):
    def __init__(self, cfg: MiddleCfg, sparse_shape: Tuple[int, int, int]):
        super().__init__()
        self.cfg = cfg
        self.sparse_shape = tuple(sparse_shape)      # (nz, ny, nx)
        zbins = self.sparse_shape[0] - 1
        n_feat = cfg.num_input_features
        c0, c1, c2, c3 = cfg.channels
        widths = (None, 2 * c1, 2 * c2, 2 * c3)
        bnt = cfg.bn_type
        cin = zbins + n_feat + 2
        self._encoder = []
        for i, (w, s) in enumerate(_ENCODER):
            m = Conv2dBNRelu(cin, widths[w], s, bnt)
            self.add_module(f"Conv2dBNRelu_{i}", m)
            self._encoder.append(m)
            cin = widths[w]
        self.Conv2dBNRelu_10 = Conv2dBNRelu(2 * c2 + 2 * c1, c1, 1, bnt)
        self.Conv2dBNRelu_11 = Conv2dBNRelu(c1, c0, 1, bnt)
        self.Dense_0 = nn.Linear(c0 + 8 + n_feat, 32)
        self.Dense_1 = nn.Linear(32, cfg.cov_channels)

    def pillar_image(self, voxel_features: torch.Tensor,
                     coords: torch.Tensor,
                     vmask: torch.Tensor) -> torch.Tensor:
        """(V, F) features, (V, 3) zyx coords, (V,) mask -> the float32
        (ny, nx, zbins + F + 2) pillar image [occupancy, mean feature,
        mean z / zbins, count * 0.1].  Invalid voxels scatter into a
        spare row ny, which is dropped."""
        nz, ny, nx = self.sparse_shape
        zbins = nz - 1
        V, n_feat = voxel_features.shape
        dev = voxel_features.device
        py = torch.where(vmask, coords[:, 1], ny).long()
        px = torch.where(vmask, coords[:, 2], 0).long()
        pz = torch.clamp(coords[:, 0], 0, zbins - 1).long()
        m = vmask.float()
        occ = torch.zeros((ny + 1) * nx * zbins, dtype=torch.float32,
                          device=dev)
        occ.index_put_(((py * nx + px) * zbins + pz,),
                       torch.ones(V, device=dev), accumulate=True)
        # the feature sum, the count and the z sum in one scatter: each
        # column still adds its terms in voxel order
        rows = torch.cat([torch.where(vmask[:, None],
                                      voxel_features.float(), 0.0),
                          m[:, None], (pz.float() * m)[:, None]], dim=1)
        sums = torch.zeros(((ny + 1) * nx, n_feat + 2), dtype=torch.float32,
                           device=dev)
        sums.index_put_((py * nx + px,), rows, accumulate=True)
        sums = sums[:ny * nx].view(ny, nx, n_feat + 2)
        cnt = sums[..., n_feat:n_feat + 1]
        den = torch.clamp(cnt, min=1.0)
        # the JAX module's "/ den / zbins", as XLA compiles it: the
        # divide by a constant becomes a multiply by its reciprocal
        return torch.cat([occ[:ny * nx * zbins].view(ny, nx, zbins),
                          sums[..., :n_feat] / den,
                          sums[..., n_feat + 1:] / den * (1.0 / zbins),
                          cnt * 0.1], dim=-1)

    def forward(self, voxel_features: torch.Tensor, coords: torch.Tensor,
                vmask: torch.Tensor, with_cov: bool = True):
        """Returns (bev (ny/8, nx/8, 2 * c3) float32, cov (V, 7) float32);
        ``with_cov=False`` skips the decoder and the head and returns
        None for cov."""
        x = self.pillar_image(voxel_features, coords, vmask)
        x = x.permute(2, 0, 1)[None].to(_BF16)
        for i, conv in enumerate(self._encoder):
            x = conv(x)
            if i == _FULL:
                x_full = x
            elif i == _QUARTER:
                x_quarter = x
        bev = x[0].permute(1, 2, 0).float()
        if not with_cov:
            return bev, None
        y = x_quarter.repeat_interleave(4, 2).repeat_interleave(4, 3)
        y = torch.cat([y, x_full], dim=1)
        y = self.Conv2dBNRelu_11(self.Conv2dBNRelu_10(y))
        # padded coords are -1 and wrap to the last row and column, as
        # in the JAX module; the mask below zeroes their rows
        pfeat = y[0][:, coords[:, 1], coords[:, 2]].t().float()
        zbins = self.sparse_shape[0] - 1
        pz = torch.clamp(coords[:, 0], 0, zbins - 1)
        h = torch.cat([pfeat, z_onehot(pz, zbins),
                       voxel_features.float()], dim=-1)
        cov = self.Dense_1(F.relu(self.Dense_0(h)))
        cov = torch.cat([F.elu(cov[:, :3]) + 1 + 1e-6, cov[:, 3:]], dim=-1)
        return bev, torch.where(vmask[:, None], cov, 0.0)
