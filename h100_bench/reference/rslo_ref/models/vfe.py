"""Voxel feature encoders (counterpart of ``rslo_tpu/models/vfe.py``):
parameter-free functions of the (V, P, F) point stacks that
``ops/voxelize.py::voxelize`` makes and their per-slot point counts.
The deployed encoder, ``SimpleVoxelXYZINormal``, is the per-voxel mean
of (x, y, z, intensity, nx, ny, nz) with the normal re-normalized.

``VFES`` maps ``cfg.vfe.name`` to its function, each called as
``fn(voxels, num_points, num_input_features)``.  The means sum each
voxel's points rank by rank (``rank_sum``), as the mean path of
``voxelize_sorted_mean`` does, so ``SimpleVoxelXYZINormal`` on the
stacks rounds exactly as that path.
"""
from __future__ import annotations

import torch

from ..ops.voxelize import rank_sum


def _voxel_mean(voxels: torch.Tensor, num_points: torch.Tensor,
                n_feat: int) -> torch.Tensor:
    n = torch.clamp(num_points, min=1).to(voxels.dtype)[:, None]
    return rank_sum(voxels[:, :, :n_feat]) / n


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.sum(v * v, -1, keepdim=True) + 1e-16)


def simple_voxel_xyzi_normal(voxels, num_points, num_input_features=7):
    """(V, P, >=7) -> (V, num_input_features): the mean over the valid
    points, columns 4:7 (normals) re-normalized to unit length."""
    m = _voxel_mean(voxels, num_points, num_input_features)
    return torch.cat([m[:, :4], _unit(m[:, 4:7]),
                      m[:, 7:num_input_features]], dim=-1)


def simple_voxel_xyz_normal(voxels, num_points, num_input_features=6):
    """(V, P, >=6) -> (V, 6): the intensity-free variant, columns 3:6
    re-normalized."""
    m = _voxel_mean(voxels, num_points, num_input_features)
    return torch.cat([m[:, :3], _unit(m[:, 3:6])], dim=-1)


def simple_voxel(voxels, num_points, num_input_features=4):
    """The plain per-voxel mean."""
    return _voxel_mean(voxels, num_points, num_input_features)


def simple_voxel_xyzi_normal_gt(voxels, num_points, num_input_features=10):
    """The cross-normal variant: columns 4:7 are the network-input
    normals, 7:10 the supervision normals.  Returns (features (V, 7),
    normal_gt (V, 3))."""
    m = _voxel_mean(voxels, num_points, num_input_features)
    net_in = simple_voxel_xyzi_normal(voxels, num_points, 7)
    return net_in, _unit(m[:, 7:10])


def simple_voxel_radius(voxels, num_points, num_input_features=4):
    """The mean with the xy radius in place of x, y: [r, z, intensity,
    ...]."""
    m = _voxel_mean(voxels, num_points, num_input_features)
    r = torch.sqrt(torch.sum(m[:, :2] ** 2, -1, keepdim=True) + 1e-16)
    return torch.cat([r, m[:, 2:num_input_features]], dim=-1)


def simple_voxel_xyzi_normal_normalize(
        voxels, num_points, num_input_features=7,
        pc_range=(-70.4, -38.4, -3.0, 70.4, 38.4, 5.0)):
    """The range-normalized mean: xyz divided by the range maxima,
    intensity zeroed, normals re-normalized."""
    m = _voxel_mean(voxels, num_points, num_input_features)
    hi = torch.tensor(pc_range[3:6], dtype=m.dtype, device=m.device)
    return torch.cat([m[:, :3] / hi, torch.zeros_like(m[:, 3:4]),
                      _unit(m[:, 4:7]), m[:, 7:num_input_features]],
                     dim=-1)


def simple_voxel_bound_xyzi_normal(voxels, num_points,
                                   num_input_features=7):
    """The boundary-point encoder: xyzi of the voxel's point nearest the
    sensor (the first one at the least range), the normal (and extra)
    columns the re-normalized mean.  Padding rows get +inf range so they
    never win."""
    P = voxels.shape[1]
    valid = (torch.arange(P, device=voxels.device)[None, :] <
             torch.clamp(num_points, min=1)[:, None])
    rng2 = torch.sum(voxels[:, :, :3] ** 2, dim=-1)
    rng2 = torch.where(valid, rng2, torch.inf)
    imin = torch.argmin(rng2, dim=1)
    xyzi = torch.gather(voxels[:, :, :4], 1,
                        imin[:, None, None].expand(-1, 1, 4))[:, 0]
    m = _voxel_mean(voxels, num_points, num_input_features)
    return torch.cat([xyzi, _unit(m[:, 4:7]), m[:, 7:num_input_features]],
                     dim=-1)


VFES = {
    "SimpleVoxelXYZINormal": simple_voxel_xyzi_normal,
    "SimpleVoxelXYZNormal": simple_voxel_xyz_normal,
    "SimpleVoxel": simple_voxel,
    "SimpleVoxelXYZINormalNormalGT": simple_voxel_xyzi_normal_gt,
    "SimpleVoxelRadius": simple_voxel_radius,
    "SimpleVoxelXYZINormalNormalize": simple_voxel_xyzi_normal_normalize,
    "SimpleVoxelBoundXYZINormal": simple_voxel_bound_xyzi_normal,
}
