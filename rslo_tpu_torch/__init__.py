"""rslo_tpu_torch — the PyTorch/CUDA port of ``rslo_tpu`` for NVIDIA
Hopper (H100).

Mirrors the module paths of the JAX package beside it, which stays the
reference: each module here has its counterpart at the same path under
``rslo_tpu/``.  The port imports ``torch`` and never ``jax``/``flax``;
the one module it shares with the JAX package is the pure-dataclass
``rslo_tpu.config.schema``.

Ported so far (the streaming odometry path under the shipped
``configs/kitti_eval_ours.json``):
  utils.synthetic   — numpy synthetic LiDAR scans
  geometry          — quaternion/tq-map helpers the vote needs
  ops.voxelize      — sort-based mean voxelizer
  ops.sparse_conv   — sorted levels + slot-map rulebooks, plain conv apply
  ops.dma_gather    — ``gather_matmul``: the hand-written Hopper
                      gather-GEMM sparse-conv kernel (csrc/)
  data.prepare      — mean-mode example preparation
  models            — SparseMiddleCov (rulebook), BEVOdomNet, OdomNet
  eval.streaming    — StreamingOdometry
  convert           — flax variables -> torch state_dict
"""

__version__ = "0.1.0"
