"""rslo_tpu_torch — the PyTorch/CUDA port of ``rslo_tpu`` for NVIDIA
Hopper (H100).

Mirrors the module paths of the JAX package beside it, which stays the
reference: each module here has its counterpart at the same path under
``rslo_tpu/``.  The port imports ``torch`` and never ``jax``/``flax``;
the one module it shares with the JAX package is the pure-dataclass
``rslo_tpu.config.schema``.

Ported so far (the streaming odometry path under the shipped
``configs/kitti_eval_ours.json`` and the self-supervised train step
under ``configs/kitti_train_ours.json``):
  utils.synthetic   — numpy synthetic LiDAR scans
  geometry          — quaternion, tq-map and weighted-Kabsch helpers
  ops.voxelize      — sort-based mean voxelizer
  ops.sparse_conv   — sorted levels + slot-map rulebooks (and their
                      transposes), plain conv apply and its gradient
  ops.dma_gather    — the hand-written Hopper kernels of the sparse conv
                      (csrc/gather_matmul.cu, csrc/row_gather.cu) and
                      the differentiable ``sparse_conv``
  ops.chamfer       — the chamfer NN search (csrc/nn_search.cu)
  data.prepare      — mean-mode example preparation
  models            — SparseMiddleCov (rulebook), BEVOdomNet, OdomNet,
                      eval and train mode
  losses            — adaptive L2, consistency/ICP, the whole objective
  train             — OneCycle AdamW, train state, step, checkpoints,
                      single-card Trainer
  eval.streaming    — StreamingOdometry
  convert           — flax variables <-> torch names and layouts
"""

__version__ = "0.1.0"
