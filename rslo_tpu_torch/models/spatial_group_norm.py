"""Spatial-grouped instance norm (counterpart of
``rslo_tpu/models/spatial_group_norm.py``).

The W (or H) axis is split into ``groups`` spatial slabs; each (sample,
row, slab, channel) is instance-normalized over the slab's columns,
with per-slab affine parameters.  Where W does not divide, the last
slab takes the remainder: ``groups - 1`` slabs of ``W // groups``
columns and one of the rest.  NHWC layout, as the JAX module.
"""
from __future__ import annotations

import torch
from torch import nn


class SpatialGroupedInstanceNorm(nn.Module):
    """num_groups: (gH, gW) with one of them 1; the other is the slab
    count along that axis.  Parameters ``weight`` and ``bias`` are
    (groups, C)."""

    def __init__(self, channels: int, num_groups=(1, 5), eps: float = 1e-5):
        super().__init__()
        gh, gw = num_groups
        if gh != 1 and gw != 1:
            raise ValueError(f"num_groups {num_groups}: one entry must be 1")
        self.transpose = gh > 1
        self.groups = gh if self.transpose else gw
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(self.groups, channels))
        self.bias = nn.Parameter(torch.zeros(self.groups, channels))

    def _norm_slab(self, xs, w, b):
        # xs: (N, H, G, S, C): normalize over S per (N, H, G, C)
        mu = torch.mean(xs, dim=3, keepdim=True)
        var = torch.mean((xs - mu) ** 2, dim=3, keepdim=True)
        y = (xs - mu) / torch.sqrt(var + self.eps)
        return y * w[None, None, :, None, :] + b[None, None, :, None, :]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.transpose:
            x = x.transpose(1, 2)
        N, H, W, C = x.shape
        groups = self.groups
        gsize = W // groups
        n_std = groups if W % groups == 0 else groups - 1
        last = W - n_std * gsize
        first = x[:, :, :W - last].reshape(N, H, n_std, gsize, C)
        out = self._norm_slab(first, self.weight[:n_std],
                              self.bias[:n_std]).reshape(N, H, W - last, C)
        if last > 0:
            tail = x[:, :, W - last:].reshape(N, H, 1, last, C)
            tail = self._norm_slab(tail, self.weight[n_std:],
                                   self.bias[n_std:])
            out = torch.cat([out, tail.reshape(N, H, last, C)], dim=2)
        if self.transpose:
            out = out.transpose(1, 2)
        return out
