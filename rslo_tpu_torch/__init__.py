"""rslo_tpu_torch — the PyTorch/CUDA port of ``rslo_tpu`` for NVIDIA
Hopper (H100).

Mirrors the module paths of the JAX package beside it, which stays the
reference: each module here has its counterpart at the same path under
``rslo_tpu/``.  The port imports ``torch`` and never ``jax``/``flax``,
and shares no module with the JAX package: what it needs of a module
there, even a pure-Python one, it keeps as its own copy (``config``,
``utils``, ``geometry.transforms``, the data and eval modules).  h5py
and matplotlib are imported only where a store is opened or a plot
drawn.

Ported so far (the streaming odometry path and the evaluation under the
shipped ``configs/kitti_eval_ours.json`` and the self-supervised train
step under ``configs/kitti_train_ours.json``, on the rulebook and the
band sparse-conv engines):
  config            — the pipeline's configuration schema
  utils             — numpy synthetic LiDAR scans, the metric logger
                      and its TensorBoard event writer
  geometry          — quaternion, tq-map and weighted-Kabsch helpers;
                      numpy pose helpers (transforms)
  ops.voxelize      — sort-based mean voxelizer
  ops.sparse_conv   — sorted levels + slot-map rulebooks (and their
                      transposes), plain conv apply and its gradient
  ops.dma_gather    — the hand-written Hopper kernels of the sparse conv
                      (csrc/gather_matmul.cu, csrc/row_gather.cu) and
                      the differentiable ``sparse_conv``
  ops.band_conv     — banded window plans and the band engine's conv
                      (csrc/band_conv.cu) with its gradient
  ops.chamfer       — the chamfer NN search (csrc/nn_search.cu)
  data              — mean-mode example preparation; KITTI parsing, the
                      HDF5 store's reader, window datasets, collation
  models            — SparseMiddleCov (rulebook, band), BEVOdomNet, OdomNet,
                      eval and train mode
  losses            — adaptive L2, consistency/ICP, the whole objective
  train             — OneCycle AdamW, train state, train and eval
                      steps, checkpoints, single-card Trainer
  eval              — StreamingOdometry, run_eval, KITTI metrics, plots
  cli               — ``python -m rslo_tpu_torch.cli evaluate``
  convert           — flax variables <-> torch names and layouts
"""

__version__ = "0.1.0"
