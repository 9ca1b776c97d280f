"""Learned voxel feature encoders (counterpart of
``rslo_tpu/models/vfe_learned.py``): PointNet-style VFE layers.

Per-point linear -> norm over the valid points -> relu, masked max-pool
over the voxel's points, pointwise concat of the pooled context; a
final linear and a masked max-pool.  Points are augmented with their
offset from the voxel's centroid (and optionally their range); masking
uses the per-voxel point counts.  Like the JAX module it is not in the
VFE registry (``models/vfe.py::VFES``): no config reaches it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _point_mask(voxels: torch.Tensor, num_points: torch.Tensor):
    """(V, P, 1) validity from the counts."""
    P = voxels.shape[1]
    ar = torch.arange(P, device=voxels.device)[None, :]
    return (ar < num_points[:, None])[..., None].to(voxels.dtype)


class VFELayer(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, out_features // 2, bias=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.Dense_0(x)
        # per-feature norm over the valid points (a BatchNorm1d analog)
        n = torch.sum(mask) + 1e-6
        mu = torch.sum(h * mask, dim=(0, 1)) / n
        var = torch.sum(((h - mu) * mask) ** 2, dim=(0, 1)) / n
        h = (h - mu) * torch.rsqrt(var + 1e-3)
        h = F.relu(h) * mask
        pooled = torch.amax(h + (mask - 1.0) * 1e9, dim=1, keepdim=True)
        return torch.cat([h, pooled.expand_as(h)], dim=-1) * mask


class LearnedVFE(nn.Module):
    """VoxelFeatureExtractor: VFE layers of ``num_filters`` widths, a
    linear to the last width and a masked max-pool.  (V, P, F) point
    stacks and (V,) counts -> (V, num_filters[-1]); empty voxels give
    zero rows."""

    def __init__(self, in_features: int,
                 num_filters: Tuple[int, ...] = (32, 128),
                 with_distance: bool = False):
        super().__init__()
        self.with_distance = with_distance
        cin = in_features + 3 + int(with_distance)
        for i, f in enumerate(num_filters):
            self.add_module(f"VFELayer_{i}", VFELayer(cin, f))
            cin = f
        self.n_layers = len(num_filters)
        self.Dense_0 = nn.Linear(cin, num_filters[-1])

    def forward(self, voxels: torch.Tensor,
                num_points: torch.Tensor) -> torch.Tensor:
        mask = _point_mask(voxels, num_points)
        n = torch.clamp(num_points, min=1).to(voxels.dtype)[:, None, None]
        centroid = torch.sum(voxels[..., :3] * mask, dim=1,
                             keepdim=True) / n
        feats = [voxels, (voxels[..., :3] - centroid) * mask]
        if self.with_distance:
            d = torch.sqrt(torch.sum(voxels[..., :3] ** 2, -1,
                                     keepdim=True) + 1e-16)
            feats.append(d * mask)
        x = torch.cat(feats, dim=-1)
        for i in range(self.n_layers):
            x = getattr(self, f"VFELayer_{i}")(x, mask)
        x = self.Dense_0(x) * mask
        out = torch.amax(x + (mask - 1.0) * 1e9, dim=1)
        return torch.where((num_points > 0)[:, None], out, 0.0)
