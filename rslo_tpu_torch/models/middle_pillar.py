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
hard-codes; the dense head computes in float32.  Every map between the
image and the BEV is NCHW-shaped and channels_last in memory (NHWC, the
layout cuDNN's bfloat16 kernels read and write), so no conv transposes
its input or its output.  Padding follows flax's ``padding="SAME"``
(``parallel/spatial.py::same_pad``) inside the conv: symmetric pads as
the conv's own padding, the (0, 1) of a stride-2 conv on an even size
as a zero first row or column of the kernel with one more pad on each
side, so no conv reads a padded copy of its input.  Submodules carry
the flax auto-names (``Conv2dBNRelu_<i>``, ``Dense_<i>``) so
``convert.py`` maps the parameters by name.  ``MiddleCfg.remat`` is
accepted and not applied, as for the sparse middle.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import MiddleCfg
from ..parallel.spatial import same_pad
from .bev_net import Norm

_BF16 = torch.bfloat16
_NHWC = torch.channels_last
# the encoder's (width index into (c1, c2, c3) doubled, stride) plan
_ENCODER = ((1, 1), (1, 1), (2, 2), (2, 1), (2, 2), (2, 1), (2, 1),
            (3, 2), (3, 1), (3, 1))
_FULL, _QUARTER = 1, 6      # encoder outputs the decoder reads


def same_conv2d(x: torch.Tensor, w: torch.Tensor,
                stride: int) -> torch.Tensor:
    """``F.conv2d(pad_same(x, k, stride), w, None, stride)`` for a k x k
    ``w``, with the pads inside the conv, so it reads ``x`` itself: a
    symmetric SAME pad (p, p) is the conv's padding p; a (p, p + 1),
    the (0, 1) of a stride-2 conv on an even size, is a zero first row
    or column of the kernel and padding p + 1, whose extra leading pad
    meets only that zero tap."""
    (ph, ph1), (pw, pw1) = (same_pad(n, w.shape[-1], stride)
                            for n in x.shape[-2:])
    if (ph, pw) != (ph1, pw1):
        w = F.pad(w, (pw1 - pw, 0, ph1 - ph, 0))
    return F.conv2d(x, w, None, stride, (ph1, pw1))


class Conv2dBNRelu(nn.Module):
    """3x3 SAME conv in bfloat16 (bias added in bfloat16 after the
    conv's rounding), then ``Norm`` unless bn_type is "none", then relu.
    NCHW-shaped in and out, channels_last in memory."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 bn_type: str = "none"):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, 3, stride)
        if bn_type != "none":
            self.Norm_0 = Norm(features, bn_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.Conv_0
        y = same_conv2d(x, c.weight.to(_BF16, memory_format=_NHWC),
                        c.stride[0])
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
        # (ny, nx, C) is NHWC: view it NCHW-shaped with channels_last
        # strides, which the cast keeps (permute(2, 0, 1)[None] would
        # give the batch the stride C, which reads as NCHW)
        x = self.pillar_image(voxel_features, coords, vmask)
        x = x[None].permute(0, 3, 1, 2).to(_BF16)
        for i, conv in enumerate(self._encoder):
            x = conv(x)
            if i == _FULL:
                x_full = x
            elif i == _QUARTER:
                x_quarter = x
        bev = x[0].permute(1, 2, 0).float()        # cast of an HWC view
        if not with_cov:
            return bev, None
        # the x4 nearest upsample and the concat in one copy, on NHWC
        # views: the upsample is a broadcast of the 1/4 map
        n, c, h, w = x_quarter.shape
        up = x_quarter.permute(0, 2, 3, 1)[:, :, None, :, None].expand(
            n, h, 4, w, 4, c)
        full = x_full.permute(0, 2, 3, 1).reshape(n, h, 4, w, 4,
                                                  x_full.shape[1])
        y = torch.cat([up, full], dim=-1).view(n, 4 * h, 4 * w, -1)
        y = y.permute(0, 3, 1, 2)
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
