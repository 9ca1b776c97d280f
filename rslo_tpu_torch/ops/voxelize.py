"""Fixed-capacity point-cloud voxelization on torch tensors (counterpart
of ``rslo_tpu/ops/voxelize.py``): the (V, P, F) point stack
(``voxelize``), the sorted-mean path (``voxelize_sorted_mean``), the
sort-free mean path (``voxelize_mean``) and the numpy oracle
(``voxelize_np``).

Voxels come out sorted by linearized (z, y, x) id.  At most
``max_voxels`` voxels are kept (the largest ids are dropped) and at most
``max_points`` points of each voxel, its first in stable-sorted input
order.  Coordinates are (z, y, x), -1 on padding rows.  ``voxelize``
also applies the optional block ground filter (``height_threshold >=
0``: per BEV block of ``block_size`` voxels, points lower than the
block's lowest z + ``height_threshold`` are dropped); the mean path
does not, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import timing


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


class Voxels(NamedTuple):
    """voxels (V, P, F) per-voxel point stacks, zero-padded; coords
    (V, 3) int32 zyx (-1 padding); num_points (V,) int32 valid points of
    each slot; num_voxels () int32; point_voxel (N,) int32 slot of each
    input point (-1 dropped)."""
    voxels: torch.Tensor
    coords: torch.Tensor
    num_points: torch.Tensor
    num_voxels: torch.Tensor
    point_voxel: torch.Tensor

    @property
    def mask(self) -> torch.Tensor:
        return self.num_points > 0


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


def _ground_filter(z, cxyz, valid, config):
    """``valid`` without the points below their BEV block's lowest z +
    ``height_threshold``.  The block minimum is an order-free
    ``scatter_reduce`` amin; invalid points are parked in an extra
    block."""
    nx, ny, _ = (int(g) for g in config.grid_size)
    bs = config.block_size
    bx, by = (nx + bs - 1) // bs, (ny + bs - 1) // bs
    bid = (cxyz[:, 1] // bs) * bx + cxyz[:, 0] // bs
    bid = torch.where(valid, bid, bx * by).long()
    zbig = torch.where(valid, z, torch.inf)
    block_min = torch.full((bx * by + 1,), torch.inf, dtype=z.dtype,
                           device=z.device)
    block_min = block_min.scatter_reduce(0, bid, zbig, "amin")
    return valid & (z >= block_min[bid] + config.height_threshold)


def voxelize(points: torch.Tensor, point_mask: torch.Tensor,
             config: VoxelizerConfig) -> Voxels:
    """Voxelize a padded point cloud into per-voxel point stacks.

    points: (N, F) float, columns 0:3 are x, y, z; point_mask: (N,) bool.

    A stable sort by linear (z, y, x) voxel id gives each point its slot
    (its voxel's rank among the kept voxels) and its rank within the
    voxel.  Each kept (slot, rank) is written once, and each slot's
    coords once; every dropped point goes to the drop bin V, a row the
    returned tensors leave out, so no two writes meet in what is
    returned (a CUDA ``index_put_`` picks among duplicates in no fixed
    order).
    """
    N, F = points.shape
    V, P = config.max_voxels, config.max_points
    dev = points.device
    nx, ny, nz = (int(g) for g in config.grid_size)
    pr = torch.tensor(config.point_cloud_range, dtype=points.dtype,
                      device=dev)
    vs = torch.tensor(config.voxel_size, dtype=points.dtype, device=dev)
    cxyz = torch.floor((points[:, :3] - pr[:3]) / vs).to(torch.int32)
    bounds = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    valid = torch.all((cxyz >= 0) & (cxyz < bounds), dim=-1) & point_mask
    if config.height_threshold >= 0:
        valid = _ground_filter(points[:, 2], cxyz, valid, config)
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
    keep = (svid < sentinel) & (voxel_slot < V) & (rank < P)
    slot = torch.where(keep, voxel_slot, V).long()     # V = drop bin
    rnk = torch.where(keep, rank, 0).long()

    voxels = torch.zeros((V + 1, P, F), dtype=points.dtype, device=dev)
    voxels[slot, rnk] = torch.where(keep[:, None], points[order], 0.0)
    num_points = torch.zeros(V + 1, dtype=torch.int32, device=dev)
    num_points = num_points.index_add_(0, slot, keep.to(torch.int32))
    # a voxel's coords are written once, by its first point
    first = keep & head
    coords = torch.full((V + 1, 3), -1, dtype=torch.int32, device=dev)
    coords[torch.where(first, slot, V)] = torch.where(
        first[:, None], cxyz[order].flip(-1), -1)
    num_voxels = torch.sum(head & (voxel_slot < V)).to(torch.int32)
    if timing.tracing_on():
        timing.count_sites("L0", torch.sum(head), V)
    point_voxel = torch.empty(N, dtype=torch.int32, device=dev)
    point_voxel[order] = torch.where(keep, voxel_slot, -1)
    return Voxels(voxels[:V], coords[:V], num_points[:V], num_voxels,
                  point_voxel)


def rank_sum(voxels: torch.Tensor) -> torch.Tensor:
    """(V, P, F) -> (V, F): the sum over the point axis, rank by rank
    (each voxel's points in input order), so that the mean path and the
    point-stack VFEs round alike."""
    total = voxels[:, 0]
    for r in range(1, voxels.shape[1]):
        total = total + voxels[:, r]
    return total


def voxelize_sorted_mean(points: torch.Tensor, point_mask: torch.Tensor,
                         config: VoxelizerConfig) -> MeanVoxels:
    """Per-voxel MEAN features of ``voxelize``'s stacks: the same voxels,
    slots and point cap.  As in the JAX package, the block ground filter
    is not applied here (``height_threshold`` is ignored).

    points: (N, F) float, columns 0:3 are x, y, z; point_mask: (N,) bool.

    The sums are ``rank_sum``s of the stacks, which unique (slot, rank)
    writes fill: deterministic on the GPU, where a float scatter-add is
    not.
    """
    vox = voxelize(points, point_mask,
                   config._replace(height_threshold=-1.0))
    n = torch.clamp(vox.num_points, min=1)[:, None].to(points.dtype)
    mean = torch.where(vox.mask[:, None], rank_sum(vox.voxels) / n, 0.0)
    return MeanVoxels(mean, vox.coords, vox.num_points, vox.num_voxels,
                      vox.point_voxel)


def voxelize_mean(points: torch.Tensor, point_mask: torch.Tensor,
                  config: VoxelizerConfig) -> MeanVoxels:
    """Sort-free voxelization: each voxel's slot is the exclusive prefix
    sum of the dense occupancy grid at its id, so slots are id-ordered
    and the cells beyond ``max_voxels`` (the largest ids) are dropped, as
    in ``voxelize``.  The means take ALL of a voxel's points (no
    ``max_points`` cap).  The ground filter is not applied.

    points: (N, F) float, columns 0:3 are x, y, z; point_mask: (N,) bool.

    The integer outputs are order-free (an occupancy write, a prefix sum,
    a scatter-min of ids).  The feature sums are an ``index_add_``: in
    point order on the CPU, in no fixed order on a CUDA card, so there a
    mean moves by a few float32 ulps from run to run.  JAX builds the
    prefix sum in two levels; one int32 cumsum gives the same slots.
    """
    N, F = points.shape
    V = config.max_voxels
    dev = points.device
    nx, ny, nz = (int(g) for g in config.grid_size)
    G = nx * ny * nz
    pr = torch.tensor(config.point_cloud_range, dtype=points.dtype,
                      device=dev)
    vs = torch.tensor(config.voxel_size, dtype=points.dtype, device=dev)
    cxyz = torch.floor((points[:, :3] - pr[:3]) / vs).to(torch.int32)
    bounds = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    valid = torch.all((cxyz >= 0) & (cxyz < bounds), dim=-1) & point_mask
    vid = (cxyz[:, 2] * ny + cxyz[:, 1]) * nx + cxyz[:, 0]
    vid = torch.where(valid, vid, G).long()

    occ = torch.zeros(G + 1, dtype=torch.int32, device=dev)
    occ[vid] = 1
    occ = occ[:G]
    csum = torch.cumsum(occ, 0, dtype=torch.int32)
    slot_all = torch.cat([csum - occ,
                          torch.full((1,), V, dtype=torch.int32,
                                     device=dev)])
    pslot = slot_all[vid]
    keep = valid & (pslot < V)
    pslot = torch.where(keep, pslot, V).long()

    feat_sum = torch.zeros((V + 1, F), dtype=points.dtype, device=dev)
    feat_sum.index_add_(0, pslot, torch.where(keep[:, None], points, 0.0))
    count = torch.zeros(V + 1, dtype=torch.int32, device=dev)
    count.index_add_(0, pslot, keep.to(torch.int32))
    features = feat_sum[:V] / torch.clamp(count[:V, None], min=1)

    # coords per slot: min-scatter of ids (a slot's points share one id)
    ids = torch.full((V + 1,), G, dtype=torch.int64, device=dev)
    ids = ids.scatter_reduce(0, pslot, torch.where(keep, vid, G), "amin")
    ids = ids[:V]
    mask_v = count[:V] > 0
    zyx = torch.stack([ids // (ny * nx), (ids // nx) % ny, ids % nx], -1)
    coords = torch.where(mask_v[:, None], zyx, -1).to(torch.int32)
    features = torch.where(mask_v[:, None], features, 0.0)
    point_voxel = torch.where(keep, pslot, -1).to(torch.int32)
    return MeanVoxels(features, coords, count[:V],
                      torch.clamp(csum[-1], max=V), point_voxel)


def voxelize_np(points: np.ndarray, config: VoxelizerConfig) -> Voxels:
    """Numpy oracle with ``voxelize``'s semantics (for tests and host
    prep): every point kept, run on the CPU, each field a numpy array."""
    pts = torch.as_tensor(np.asarray(points))
    out = voxelize(pts, torch.ones(len(pts), dtype=torch.bool), config)
    return Voxels(*(t.numpy() for t in out))
