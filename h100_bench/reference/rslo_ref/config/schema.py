"""Typed configuration schema of the pipeline (the port's own copy of
``rslo_tpu/config/schema.py``; plain Python and numpy).

Frozen dataclasses with the same names, fields, defaults and JSON form
as the JAX package's, so one JSON file configures both packages.  Field
defaults reproduce the reference's deployed workload.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class VoxelizerCfg:
    point_cloud_range: Tuple[float, ...] = (-70.4, -38.4, -3.0,
                                            70.4, 38.4, 5.0)
    voxel_size: Tuple[float, ...] = (0.1, 0.1, 0.2)
    max_points_per_voxel: int = 10
    max_voxels: int = 40000
    height_threshold: float = -1.0   # <0 disables the block ground filter
    block_size: int = 8


@dataclass(frozen=True)
class VFECfg:
    name: str = "SimpleVoxelXYZINormal"
    num_input_features: int = 7      # x, y, z, intensity, nx, ny, nz


@dataclass(frozen=True)
class MiddleCfg:
    """Sparse middle extractor + covariance decoder: 16-16 @ full res,
    32-32 @ 1/2, 64s @ 1/4 and 1/8, z-collapse to a BEV map, plus an
    inverse-conv decoder back to full res emitting 7 covariance params.
    """
    name: str = "SparseMiddleCov"
    bn_type: str = "none"            # none | bn  (per-voxel feature BN)
    num_input_features: int = 7
    # execution engine of SparseMiddleCov: "rulebook" (sorted levels +
    # gather-matmul), "band" (rulebook geometry + banded window plans,
    # ops/band_conv.py) or "tiles" (dense tile blocks, ops/tiled_conv.py)
    engine: str = "rulebook"
    # rulebook lookup method, one of ops/sparse_conv.py::LOOKUP_METHODS
    plan_lookup: str = "slot_map"
    # band engine: out-row block size and (subm, down, inverse) window
    # widths, which should cover the per-block spread of the in rows
    # (pairs outside a window go through the overflow list, so the conv
    # stays exact while the list has room).  The JAX package needs every
    # window to be a multiple of 128.
    band_block: int = 256
    band_windows: Tuple[int, ...] = (384, 1280, 768)
    # rulebooks whose widest conv is narrower than this stay raw
    # rulebooks (gather-matmul); 0 gives every rulebook a band plan
    band_min_channels: int = 0
    # tiled engine: active-tile capacities (L0, L1) and tile shape
    tile_capacities: Tuple[int, ...] = (16384, 8192)
    tile_shape: Tuple[int, ...] = (2, 8, 8)
    # static per-level voxel capacities (level 0 = full res)
    level_capacities: Tuple[int, ...] = (40960, 40960, 20480, 10240)
    channels: Tuple[int, ...] = (16, 32, 64, 64)
    cov_channels: int = 7
    remat: bool = True               # rematerialize the middle in backward
    # conv compute dtype of the sparse engines ("bf16" | "f32"), with
    # fp32 accumulation either way
    conv_dtype: str = "bf16"
    # plane-grouped slice-gather conv apply of the 27-tap rulebook convs
    plane_apply: bool = False


@dataclass(frozen=True)
class OdomCfg:
    """BEV encoder/decoder with mask-aware convs + dense tq-map heads."""
    name: str = "UNetOdomPred"
    num_input_features: int = 128
    layer_nums: Tuple[int, ...] = (3, 5, 5)
    layer_strides: Tuple[int, ...] = (2, 2, 2)
    num_filters: Tuple[int, ...] = (128, 128, 256)
    upsample_strides: Tuple[int, ...] = (2, 2, 2)
    num_upsample_filters: Tuple[int, ...] = (128, 64, 64)
    bn_type: str = "sync_bn"         # none | bn | sync_bn
    conv_type: str = "mask_conv"     # mask_conv | sparse_conv (normalized)
    block_type: str = "basic"        # basic | fire | bottleneck
    conf_type: str = "softmax"       # softmax | linear
    conf_temperature: float = 20.0   # temperature for pyramid-mask confs
    cycle_constraint: bool = True
    dense_predict: bool = True
    use_svd: bool = False            # vote via weighted Kabsch vs conf-avg
    use_deep_supervision: bool = True
    dropout: float = 0.1
    odom_format: str = "rx+t"        # 'rx+t' | 'r(x+t)'
    first_conv_groups: int = 2       # pair-concat input is grouped
    compute_dtype: str = "bf16"      # bf16 | fp32 (heads stay fp32)
    use_se: bool = False             # SE channel attention in blocks
    use_sa: bool = False             # spatial attention in blocks
    # aggregate an odometry vote at every pyramid level; the deployed
    # reference config emits a single-element list
    multi_level_odom: bool = False


@dataclass(frozen=True)
class LossCfg:
    rotation_weight: float = 1.0
    rotation_init_alpha: float = -2.5
    translation_weight: float = 1.0
    translation_init_alpha: float = 0.0
    focal_gamma: float = 0.0
    pyramid_rotation_weight: float = 1.0
    pyramid_translation_weight: float = 1.0
    pyloss_exp_w_base: float = 0.5
    consistency_weight: float = 1.0
    penalize_ratio: float = 0.97
    reg_weight: float = 0.005
    sph_weight: float = 1.0
    icp_iter: int = 2
    warmup_steps: int = 1500         # identity-R phase + icp_iter=5 phase
    warmup_icp_iter: int = 5
    pyramid_level_weights: Tuple[float, ...] = (0.01, 0.01, 0.05, 0.1, 1.0)
    # static capacity of the consistency-loss point set per frame
    max_loss_points: int = 20480
    # consistency on the offline hier clouds instead of middle-net
    # voxels+covs
    use_hier_points: bool = False


@dataclass(frozen=True)
class DataCfg:
    dataset: str = "kitti_hdf5"
    root: str = "/data/kitti/all.h5"
    seq_length: int = 3
    skip: int = 1
    random_skip: bool = False
    # repeat every review_cycle*n_samples block once; <= 0 disables
    review_cycle: float = -1.0
    batch_size: int = 1
    num_workers: int = 2
    random_flip_y: bool = True
    # global-yaw rotation augmentation, theta ~ U(-yaw_aug_rad,
    # yaw_aug_rad); 0 disables
    yaw_aug_rad: float = 0.0
    # pose-interpolation augmentation strength; 0 disables
    pose_interp_ratio: float = 0.0
    max_points: int = 131072         # static host->device point capacity
    # int16-quantize the host->device point transfer (~2 mm rounding)
    quantize_transfer: bool = False
    downsample_voxel_sizes: Tuple[float, ...] = (0.1,)
    # ship the offline hier clouds to device (for loss.use_hier_points)
    load_hier_points: bool = False
    max_hier_points: int = 32768     # static hier-cloud capacity
    train_sequences: Tuple[int, ...] = (0, 1, 2, 3, 4, 5, 6)
    val_sequences: Tuple[int, ...] = (7, 8, 9, 10)
    eval_train_sequences: Tuple[int, ...] = (0,)


@dataclass(frozen=True)
class OptimizerCfg:
    optimizer: str = "adam"
    lr_max: float = 8.0e-4
    onecycle_div_factor: float = 10.0
    onecycle_pct_start: float = 0.05
    onecycle_moms: Tuple[float, float] = (0.95, 0.85)
    weight_decay: float = 1.0e-5     # decoupled (AdamW-style)
    grad_clip_norm: float = 10.0
    # per-submodule lr multipliers
    group_lr_mult: Tuple[Tuple[str, float], ...] = ()


@dataclass(frozen=True)
class TrainCfg:
    steps: int = 200000
    steps_per_eval: int = 4000
    display_step: int = 50
    checkpoint_max_keep: int = 8
    # periodic save cadence, independent of eval; None = save only at
    # steps_per_eval and on exit
    checkpoint_interval: Optional[int] = 250
    seed: int = 0
    loss_scale: Optional[float] = None


@dataclass(frozen=True)
class PipelineCfg:
    voxelizer: VoxelizerCfg = field(default_factory=VoxelizerCfg)
    vfe: VFECfg = field(default_factory=VFECfg)
    middle: MiddleCfg = field(default_factory=MiddleCfg)
    odom: OdomCfg = field(default_factory=OdomCfg)
    loss: LossCfg = field(default_factory=LossCfg)
    data: DataCfg = field(default_factory=DataCfg)
    optimizer: OptimizerCfg = field(default_factory=OptimizerCfg)
    train: TrainCfg = field(default_factory=TrainCfg)

    # ---- (de)serialization ------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "PipelineCfg":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineCfg":
        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                fields = {f.name: f for f in dataclasses.fields(tp)}
                kwargs = {}
                for k, v in val.items():
                    if k not in fields:
                        raise KeyError(f"unknown config key {tp.__name__}.{k}")
                    ft = fields[k].type
                    sub = _DATACLASS_BY_NAME.get(str(ft).split(".")[-1])
                    if sub is not None and isinstance(v, dict):
                        kwargs[k] = build(sub, v)
                    elif isinstance(v, list):
                        kwargs[k] = tuple(tuple(x) if isinstance(x, list)
                                          else x for x in v)
                    else:
                        kwargs[k] = v
                return tp(**kwargs)
            return val
        return build(cls, d)

    def replace(self, **kw) -> "PipelineCfg":
        return dataclasses.replace(self, **kw)


_DATACLASS_BY_NAME = {c.__name__: c for c in
                      (VoxelizerCfg, VFECfg, MiddleCfg, OdomCfg, LossCfg,
                       DataCfg, OptimizerCfg, TrainCfg, PipelineCfg)}


def grid_size(cfg: VoxelizerCfg):
    """(nx, ny, nz) from range and voxel size (x, y, z order)."""
    import numpy as np
    pr = np.asarray(cfg.point_cloud_range, np.float64)
    vs = np.asarray(cfg.voxel_size, np.float64)
    return tuple(int(x) for x in np.round((pr[3:] - pr[:3]) / vs))
