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

What it has (everything the JAX package does, apart from three modules
left out by decision: ``config/registry.py``, whose place the ``VFES``
dict and ``OdomNet``'s dispatch take, ``utils/jax_cache.py``, XLA's
compile cache, and ``ops/tiled_conv.py`` with ``engine="tiles"``):
  config            — the pipeline's configuration schema
  utils             — synthetic LiDAR scans and the raycast world, the
                      metric logger and its TensorBoard event writer,
                      the mesh axes ("data", "space", "model") and their
                      collectives, parameter surgery, the section timer
                      and profiler trace
  geometry          — quaternions, tq maps, weighted Kabsch, warps,
                      mean shift; numpy pose helpers (transforms)
  ops.voxelize      — the point-stack voxelizer (ground filter), the
                      sorted and sort-free mean paths, the numpy oracle
  ops.sparse_conv   — sorted levels + slot-map rulebooks (and their
                      transposes), plain conv apply and its gradient
  ops.dma_gather    — the hand-written Hopper kernels of the sparse conv
                      (csrc/gather_matmul.cu, csrc/row_gather.cu) and
                      the differentiable ``sparse_conv``
  ops.band_conv     — banded window plans and the band engine's conv
                      (csrc/band_conv.cu) with its gradient
  ops.chamfer       — the chamfer NN search (csrc/nn_search.cu)
  data              — example preparation, KITTI parsing, the HDF5
                      store (build and read), normals (native build),
                      window datasets, augmentation, the train loader
  models            — SparseMiddleCov (rulebook, band), PillarMiddleCov,
                      DenseMiddleCov, the VFEs, BEVOdomNet with every
                      option of the schema, OdomNet; eval and train mode
  parallel          — spatial and tensor parallelism of the BEV stage
                      over a (space x model) grid of ranks
  losses            — adaptive L2, consistency/ICP, the whole objective
                      (hier clouds, cross normals)
  train             — OneCycle AdamW and the other schedules, train
                      state, train and eval steps, checkpoints, the
                      Trainer, one card or data-parallel over many
  eval              — StreamingOdometry, run_eval and the refined
                      runner, KITTI metrics, plots
  pgo               — pose graph, windowed refinement, bundle adjustment
                      (and sharded), loop closing, sharded fusion
  bench             — the two-frame and streaming throughput bench
  cli               — ``python -m rslo_tpu_torch.cli create_hdf5 | train
                      | evaluate | bench``
  convert           — flax variables <-> torch names and layouts
"""

__version__ = "0.1.0"
