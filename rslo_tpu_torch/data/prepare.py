"""Device-side example preparation: padded raw point clouds -> voxelized
model inputs (counterpart of ``rslo_tpu/data/prepare.py``)."""
from __future__ import annotations

from typing import Dict

import torch

from ..config.schema import PipelineCfg
from ..ops.voxelize import VoxelizerConfig, voxelize, voxelize_sorted_mean
from ..utils.timing import span
from .loader import quant_scale


def voxelizer_config(cfg: PipelineCfg) -> VoxelizerConfig:
    v = cfg.voxelizer
    return VoxelizerConfig(
        point_cloud_range=tuple(v.point_cloud_range),
        voxel_size=tuple(v.voxel_size),
        max_points=v.max_points_per_voxel,
        max_voxels=v.max_voxels,
        height_threshold=v.height_threshold,
        block_size=v.block_size,
    )


def dequantize_points(points: torch.Tensor) -> torch.Tensor:
    """Undo the loader's int16 transfer quantization on the points'
    device (float inputs pass through unchanged).  The scales are the
    constants of ``data/loader.py::quant_scale``."""
    if torch.is_floating_point(points):
        return points
    s = torch.as_tensor(quant_scale(points.shape[-1]), device=points.device)
    return points.float() * s


def prepare_example(points: torch.Tensor, point_mask: torch.Tensor,
                    vcfg: VoxelizerConfig,
                    mean_mode: bool = False) -> Dict[str, torch.Tensor]:
    """points: (L, N, F) padded frames (float, or int16 transfer-quantized
    and dequantized here); point_mask: (L, N) bool.
    Returns the voxelized example consumed by OdomNet (no batch dim):
    the per-voxel point stacks (``voxels`` (L, V, P, F)) that the model's
    VFE encodes, or with ``mean_mode`` the pre-encoded per-voxel mean
    features (``voxel_features`` (L, V, F), the normal columns 4:7
    re-normalized after averaging), which is what the mean VFE
    ``SimpleVoxelXYZINormal`` makes of the stacks."""
    with span("prepare"):
        points = dequantize_points(points)
        L = points.shape[0]
        if not mean_mode:
            vox = [voxelize(points[t], point_mask[t], vcfg)
                   for t in range(L)]
            return {
                "voxels": torch.stack([v.voxels for v in vox]),
                "num_points": torch.stack([v.num_points for v in vox]),
                "coords": torch.stack([v.coords for v in vox]),
                "voxel_mask": torch.stack([v.mask for v in vox]),
            }
        vox = [voxelize_sorted_mean(points[t], point_mask[t], vcfg)
               for t in range(L)]
        feats = []
        for v in vox:
            f = v.features
            if f.shape[1] >= 7:
                normal = f[:, 4:7]
                normal = normal / torch.sqrt(
                    torch.sum(normal * normal, -1, keepdim=True) + 1e-16)
                f = torch.cat([f[:, :4], normal, f[:, 7:]], dim=-1)
            feats.append(f)
        return {
            "voxel_features": torch.stack(feats),
            "num_points": torch.stack([v.num_points for v in vox]),
            "coords": torch.stack([v.coords for v in vox]),
            "voxel_mask": torch.stack([v.mask for v in vox]),
        }


def mean_vfe_ok(cfg) -> bool:
    """True when the configured VFE is the plain per-voxel mean that
    voxelize_sorted_mean emits directly."""
    return cfg.vfe.name == "SimpleVoxelXYZINormal"
