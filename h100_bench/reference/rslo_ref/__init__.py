"""The benchmark's plain reference of the odometry network, its train
step and its streaming forward.

A frozen copy of the program's plain-path modules (config schema,
voxelizer, rulebooks, the sparse middle on the rulebook engine, the
pillar and BEV nets, the objective, OneCycle AdamW), in plain PyTorch,
cut to what the benchmark's configurations run on one card: every
hand-written kernel is replaced by its plain version
(``ops/dma_gather.py``, ``ops/chamfer.py``); the program's other
engines, BEV-net options and splits over several cards are left out.
``data/window.py`` builds the train batches from the raw KITTI tree.
It imports nothing of the program, so a later change to the program
cannot move it.  Modules keep the
program's names and relative paths, so the benchmark's seeded weights
load into both by name.
"""
