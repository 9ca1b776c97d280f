"""Dense local-transformation (tq) maps over the BEV grid (counterpart
of ``rslo_tpu/geometry/tq_map.py``).

Maps are channels-last ``(..., H, W, 7)`` with H indexed by the grid
row ``i`` (world y decreasing) and W by column ``j`` (world x
increasing):
``x(j) = (j - ox) * vx``,  ``y(i) = (oy - i) * vy``.
"""
from __future__ import annotations

import numpy as np
import torch

from .quaternion import qinv, qnormalize, rotate_vec_by_q


def grid_cell_coords(spatial_size, pc_range, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """World xyz of each BEV cell anchor, shape (H, W, 3) for an (H, W)
    ``spatial_size`` or (H, W, D, 3) for (H, W, D)."""
    if len(spatial_size) == 2:
        H, W = spatial_size
        D = 1
    else:
        H, W, D = spatial_size
    pc_range = np.asarray(pc_range, np.float64)
    gs = np.array([W, H, D], np.float64)
    voxel_size = (pc_range[3:] - pc_range[:3]) / gs
    ox = (0.0 - pc_range[0]) / (pc_range[3] - pc_range[0]) * W
    oy = (pc_range[4] - 0.0) / (pc_range[4] - pc_range[1]) * H
    oz = (0.0 - pc_range[2]) / (pc_range[5] - pc_range[2]) * D

    i = torch.arange(H, dtype=dtype, device=device)[:, None, None]
    j = torch.arange(W, dtype=dtype, device=device)[None, :, None]
    k = torch.arange(D, dtype=dtype, device=device)[None, None, :]
    xv = (j - float(ox)) * float(voxel_size[0])
    yv = (float(oy) - i) * float(voxel_size[1])
    zv = (k - float(oz)) * float(voxel_size[2])
    xyz = torch.stack(torch.broadcast_tensors(xv, yv, zv), dim=-1)
    if len(spatial_size) == 2:
        xyz = xyz[:, :, 0, :]
    return xyz.to(dtype)


def _warp_coords(coords: torch.Tensor,
                 inv_trans_factor: float) -> torch.Tensor:
    """Optional inverse-distance xy warp of the anchor coordinates:
    cells are re-anchored at ``f / (|xy| + 0.1)^2 * xy``."""
    if inv_trans_factor <= 0:
        return coords
    xy = coords[..., :2]
    r = torch.sqrt(torch.sum(xy * xy, dim=-1, keepdim=True)) + 0.1
    return torch.cat([inv_trans_factor / (r * r) * xy, coords[..., 2:]],
                     dim=-1)


def generate_tq_map(tq: torch.Tensor, spatial_size, pc_range,
                    inv_trans_factor: float = -1.0) -> torch.Tensor:
    """Encode global pose(s) ``tq`` (..., 7) into a local tq map
    (..., H, W, 7) for an (H, W) ``spatial_size``, or (..., H, W, D, 7)
    for (H, W, D): ``t_l(c) = R(q)^-1 (t - c) + c``, ``q_l(c) = q``."""
    coords = grid_cell_coords(spatial_size, pc_range, dtype=tq.dtype,
                              device=tq.device)
    coords = _warp_coords(coords, inv_trans_factor)
    expand = (None,) * (coords.dim() - 1)
    t_g = tq[(..., *expand, slice(0, 3))]
    q_g = tq[(..., *expand, slice(3, 7))]
    t_l = rotate_vec_by_q(t_g - coords, qinv(q_g)) + coords
    q_map = q_g.expand(t_l.shape[:-1] + (4,))
    return torch.cat([t_l, q_map], dim=-1)


def decode_tq_map(tq_map: torch.Tensor, pc_range, dims: int = 2,
                  inv_trans_factor: float = -1.0) -> torch.Tensor:
    """Decode a local tq map (..., H, W, 7) (``dims=2``) or
    (..., H, W, D, 7) (``dims=3``) to per-cell global pose votes;
    quaternions are re-normalized."""
    spatial = tuple(tq_map.shape[-(dims + 1):-1])
    coords = grid_cell_coords(spatial, pc_range, dtype=tq_map.dtype,
                              device=tq_map.device)
    coords = _warp_coords(coords, inv_trans_factor)
    t_l = tq_map[..., :3]
    q_l = tq_map[..., 3:]
    t_g = rotate_vec_by_q(t_l - coords, q_l) + coords
    return torch.cat([t_g, qnormalize(q_l)], dim=-1)
