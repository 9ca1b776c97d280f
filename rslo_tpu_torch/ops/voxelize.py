"""Fixed-capacity point-cloud voxelization on torch tensors (counterpart
of ``rslo_tpu/ops/voxelize.py``; the sorted-mean path only).

Voxels come out sorted by linearized (z, y, x) id.  At most
``max_voxels`` voxels are kept (the largest ids are dropped) and only
the first ``max_points`` points of each voxel, in stable-sorted input
order, contribute to its mean.  Coordinates are (z, y, x), -1 on
padding rows.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class VoxelizerConfig(NamedTuple):
    point_cloud_range: tuple  # (x0, y0, z0, x1, y1, z1)
    voxel_size: tuple         # (vx, vy, vz)
    max_points: int = 10
    max_voxels: int = 40000
    height_threshold: float = -1.0
    block_size: int = 8       # BEV block edge (in voxels) for ground filter

    @property
    def grid_size(self) -> np.ndarray:
        """(nx, ny, nz) — x, y, z order like the reference's grid_size."""
        pr = np.asarray(self.point_cloud_range, np.float64)
        vs = np.asarray(self.voxel_size, np.float64)
        return np.round((pr[3:] - pr[:3]) / vs).astype(np.int64)


class MeanVoxels(NamedTuple):
    """features (V, F) per-voxel means; coords (V, 3) int32 zyx (-1
    padding); num_points (V,) int32 points in each voxel's mean;
    num_voxels () int32; point_voxel (N,) int32 slot per input point
    (-1 dropped)."""
    features: torch.Tensor
    coords: torch.Tensor
    num_points: torch.Tensor
    num_voxels: torch.Tensor
    point_voxel: torch.Tensor

    @property
    def mask(self) -> torch.Tensor:
        return self.num_points > 0


def voxelize_sorted_mean(points: torch.Tensor, point_mask: torch.Tensor,
                         config: VoxelizerConfig) -> MeanVoxels:
    """Stable-sort voxelization emitting per-voxel MEAN features.

    points: (N, F) float, columns 0:3 are x, y, z; point_mask: (N,) bool.

    The per-voxel sums are taken over a (V+1, P, F) stack filled by
    unique (slot, rank) writes and added rank by rank, i.e. each voxel's
    points in input order.  That makes them deterministic on the GPU,
    where a float scatter-add is not.
    """
    if config.height_threshold >= 0:
        raise NotImplementedError(
            "the block ground filter (height_threshold >= 0) is not "
            "ported; the shipped configs disable it")
    N, F = points.shape
    V, P = config.max_voxels, config.max_points
    dev = points.device
    pr = torch.tensor(config.point_cloud_range, dtype=points.dtype,
                      device=dev)
    vs = torch.tensor(config.voxel_size, dtype=points.dtype, device=dev)
    nx, ny, nz = (int(g) for g in config.grid_size)

    cxyz = torch.floor((points[:, :3] - pr[:3]) / vs).to(torch.int32)
    bounds = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    valid = torch.all((cxyz >= 0) & (cxyz < bounds), dim=-1) & point_mask
    vid = (cxyz[:, 2] * ny + cxyz[:, 1]) * nx + cxyz[:, 0]
    sentinel = nx * ny * nz
    vid = torch.where(valid, vid, sentinel)

    svid, order = torch.sort(vid, stable=True)
    iota = torch.arange(N, dtype=torch.int32, device=dev)
    head = torch.ones_like(svid, dtype=torch.bool)
    head[1:] = svid[1:] != svid[:-1]
    head &= svid < sentinel
    voxel_slot = torch.cumsum(head, 0, dtype=torch.int32) - 1
    seg_start = torch.cummax(torch.where(head, iota, -1), 0).values
    rank = iota - seg_start
    keep_s = (svid < sentinel) & (voxel_slot < V) & (rank < P)
    slot_s = torch.where(keep_s, voxel_slot, V).long()   # V = drop bin

    stack = torch.zeros((V + 1, P, F), dtype=points.dtype, device=dev)
    stack[slot_s, torch.where(keep_s, rank, 0).long()] = torch.where(
        keep_s[:, None], points[order], 0.0)
    fsum = stack[:V, 0]
    for r in range(1, P):
        fsum = fsum + stack[:V, r]
    num_points = torch.zeros(V + 1, dtype=torch.int32, device=dev)
    num_points = num_points.index_add_(0, slot_s,
                                       keep_s.to(torch.int32))[:V]
    mean = fsum / torch.clamp(num_points, min=1)[:, None].to(points.dtype)

    ids_arr = torch.full((V + 1,), sentinel, dtype=torch.int32, device=dev)
    ids_arr[slot_s] = torch.where(keep_s, svid, sentinel)
    ids_arr = ids_arr[:V]
    mask_v = num_points > 0
    zz = ids_arr // (ny * nx)
    yy = (ids_arr // nx) % ny
    xx = ids_arr % nx
    coords = torch.where(mask_v[:, None], torch.stack([zz, yy, xx], -1),
                         -1).to(torch.int32)
    mean = torch.where(mask_v[:, None], mean, 0.0)

    num_voxels = torch.sum(head & (voxel_slot < V)).to(torch.int32)
    pslot = torch.empty(N, dtype=torch.int32, device=dev)
    pslot[order] = torch.where(keep_s, voxel_slot, -1)
    return MeanVoxels(mean, coords, num_points, num_voxels, pslot)
