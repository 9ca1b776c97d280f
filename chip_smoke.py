"""Smoke run of the PyTorch port (``rslo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Builds the port's CUDA kernels from ``rslo_tpu_torch/csrc/`` and drives
its main paths with seeded random weights: the serving path,
``StreamingOdometry``, at the full width of ``configs/kitti_eval_ours.json``,
the self-supervised train step, ``Trainer.fit``, at the full width
of ``configs/kitti_train_ours.json``, and the evaluation of the trained
checkpoints through the CLI's ``evaluate`` verb, each on the rulebook
engine and on the band engine (``middle.engine="band"`` with the schema's band
defaults: block 256, windows (384, 1280, 768), min_channels 0, so every
one of the 20 convs of a frame gets a band plan); then the pillar
configuration streamed, trained through the CLI's ``train`` verb and
evaluated at its best checkpoint, and the train verb on the shipped
config warm-started from it; the refined evaluation (pose-graph
fusion, bundle adjustment, loop closing) through the evaluate verb, and
each refinement solver on the card against the CPU; last, the data
build from a rendered world with the hier-cloud and cross-normal
training it feeds and loop closing on a true revisit; every BEV-net
option of the schema, with DenseMiddleCov; data-parallel training
and evaluation: the train verb on an NCCL group, and two ranks sharing
the card over gloo; the BEV stage split over four ranks sharing the
card (spatial, tensor and both), the ``bench`` verb, and the small
modules only tests reach.  Phases (each one exits non-zero when it fails):

  1. require a CUDA card; print its name and power limit; turn TF32 off
  2. build the kernels (one nvcc per source, all at once)
  3. hold ``gather_matmul`` (B1) against its plain version on the card,
     at the 20 sparse-conv calls of one KITTI-scale frame, in bf16 and
     f32, plus an edge case (all-invalid rows, masked rows, ragged V,
     NaN rows that only invalid taps point at), and a dense case: a
     solid cube of 32^3 active voxels (~25 of 27 taps valid per row) at
     64 -> 64, where B1 and B4 (forward and feature gradient, bf16 and
     f32) are held against their plain versions
  4. stream 8 synthetic KITTI-scale scans: finite poses, exactly 14
     kernel launches per scan (streaming skips the covariance decoder's
     6 convs), pose after scan 2 == the two-frame forward
  5. time streaming, the two-frame forward and the kernel vs its plain
     version; B1's device time at each of the 20 convs and its frame sum
  6. band engine, serving: the overflow audit (every plan's overflow
     count at most half its capacity); ``band_matmul`` (B4) and
     ``band_gather`` (B5) against their plain versions at the 20 band
     convs of the frame in bf16 and f32 (B5 bit-equal), plus edge cases
     (an overflow-heavy tiny-window plan, a plan block of 100 rows,
     all-invalid ``sel``, a ragged V, NaN rows that only ``sel = -1``
     would point at); 8 scans through
     ``StreamingOdometry``: exactly 14 B4 and 0 ``gather_matmul``
     launches per scan, pose after scan 2 == the two-frame forward;
     timing of streaming, the two-frame forward, and B4 and B5 against
     their plain versions and against B1 at the same conv, B5 also
     against ``torch.index_select`` computing the same im2col; B4 at each
     of the 20 band convs and its frame sum
  7. ``nn_search`` (B3) bit-equal to its plain version at the deployed
     3 x 20000 x 20000, plus ties, an all-invalid tgt, masked src rows,
     ragged N, M, and the kernel's own boundaries: ties that straddle its
     chunks, cluster shares and register blocks, N of 257 and 1, M of 5,
     1 and 0, invalid tgts exactly on src points
  8. ``row_gather`` (B2) bit-equal to ``features[idx]`` at the L0 im2col
     and at rows of 1-100 words (every vector width, an int32 array, a
     misaligned view); its fused d_W im2col mode bit-equal to
     ``round_operand(torch.where(valid, features[idx], 0))`` at the 20
     train convs in bf16 and f32, an all-invalid ``valid`` and NaN rows
     that only invalid taps point at
  9. B5 in both modes bit-equal to its plain versions, bf16 and f32: its
     fused d_W mode (``overflow=``) to the three-pass chain it replaces
     (``band_gather_dw_plain``), at the 14 submanifold plans of a train
     frame, an overflow-heavy tiny-window plan, a saturated plan,
     all-invalid ``sel``, NaN rows behind ``sel = -1``, -0.0 rows (+0.0
     at an overflow slot), 7, 16, 32 and 64 channels and misaligned
     feature views; the band conv's d_W bit-equal with the fused mode
     and with the three-pass chain; then the sparse conv's backward
     against torch autograd through the plain conv, at the 20 conv calls
     of one frame, bf16 and f32: on the rulebook engine
     (``gather_matmul_dgrad`` + ``row_gather`` + one f32 product) and on
     the band engine (B4 over the flipped weights and B5's fused mode for
     the submanifold plans, the rulebook backward for the others)
 10. train: ``Trainer.fit`` for 2 warmup and 2 post-warmup steps on
     3-frame windows of 100k-point scans padded to 131072 (for this run
     only ``loss.warmup_steps`` is 1: a step is a warmup step while its
     index, from 0, is <= warmup_steps), on each engine; finite metrics,
     changed parameters and statistics, each kernel's launches per step
     equal to the prediction worked out from the convs' ops; the
     checkpoint written and restored
 11. time the train step (both variants, both engines), peak device
     memory, and each backward kernel against its plain version; B1's
     feature gradient at the 19 backward convs and B4's at the
     submanifold plans, each with its frame sum; the dense case; the d_W
     im2col at the 20 train convs, fused ``row_gather`` against the
     three passes it replaced, with its frame sum; the band d_W operand
     at the 14 submanifold plans, B5's fused mode against the three
     passes it replaced, with its frame sum (phases 5, 6 and 11 run
     before 12 and 13, whose CPU threads would share the host)
 12. the two-frame forward on the card against the same model on the
     CPU (plain versions), in float32 at the same widths; and the band
     engine against the rulebook engine on the card, in float32
 13. one f32 train step on the card against the CPU, same weights (the
     seeded initial weights of phase 10's rulebook trainer) and batch:
     loss terms (each beside the change that weights jittered by 1e-7
     make on the card) and per-leaf gradients; and the band engine's f32
     step against the rulebook engine's on the card
 14. evaluate: ``rslo_tpu_torch.cli.main(["evaluate", ...])`` in this
     process, with no ``--device`` (the default, the card), on the
     synthetic val split of ``configs/kitti_eval_ours.json`` from phase
     10's checkpoints: 16 windows on the rulebook engine, 8 on the band
     engine (a copy of the config with ``middle.engine="band"``);
     ``eval_results.json`` written with the JAX package's keys, finite
     frame-level metrics, exactly 28 launches of the engine's conv
     kernel per window (2 frames x 14, the covariance decoder skipped)
     and none of any other, and window 0's odometry == the checkpoint's
     two-frame forward on the same collated points; its frames/s and
     ms/window are printed
 15. the pillar configuration (``pillar_config``: ``PipelineCfg()`` with
     the overrides of ``scripts/accuracy_proxy.py::base_cfg``, the
     recipe of every committed accuracy result, ``loss.warmup_steps`` 1
     and ``train.steps_per_eval`` 2) at the shipped grid: the pillar
     image 768 x 1408 x 49 and the BEV 96 x 176 x 128, the convs' FLOPs
     a frame; 8 scans through ``StreamingOdometry`` with no kernel of
     B1-B5 launched, the pose after scan 2 == the two-frame forward;
     ms/scan, device ms and ops a scan
 16. the CLI's train verb on it, ``--synthetic``, in two legs (``--steps
     6 --leg_until 4``, then ``--steps 6``, which resumes at 4): each
     step's launches (only ``nn_search``, ``warmup_icp_iter`` or
     ``icp_iter`` a step) and host ms, none in the eval hook, which ran
     at steps 2, 4 and 6 and wrote ``best_ckpt.json`` and ``ckpt_best/``;
     the train step timed at the trained weights (both variants, peak
     device memory, device ms and ops of a post-warmup step)
 17. ``evaluate --ckpt_step best`` on that run (phase 14's checks, no
     kernel launched, 16 windows)
 18. the train verb on ``configs/kitti_train_ours.json`` (rulebook) for 2
     steps, warm-started from the pillar run with ``--pretrained_include
     bev_net``: at step 0 every ``bev_net`` tensor is the pillar
     checkpoint's, the middle keeps its seeded init and the alphas are
     carried; each step's B1 (forward and dgrad), B2 and B3 launches
     equal ``predicted_launches``
 19. the refined evaluate verb from phase 10's rulebook checkpoint at
     ``configs/kitti_eval_ours.json``, on the synthetic 3-frame split:
     ``--refine`` (16 windows), ``--refine_ba`` (8) and ``--refine_loops
     --loop_min_separation 10 --loop_score_threshold 0.7`` (16, at least
     one candidate); ``eval_results.json`` with the JAX
     package's keys and finite t_rel, r_rel and ATE for every
     trajectory; exactly 42 B1 launches a window (3 frames x 14), 60
     under ``--refine_ba`` (its eval step keeps the covariance decoder),
     no other kernel but B3 under ``--refine_loops``, 8 launches (ICP
     iterations) per candidate ICP measured; windows/s and ms/window,
     the pose-graph fusion's ms a sequence, BA's ms a window (and its
     solve alone) and loop closing's ms
 20. refinement on the card against the CPU: ``fuse_window_odometry``
     (window 64, overlap 16, 8 iterations) on phase 19's ``--refine``
     predictions repeated 7 times through the runner's edge and
     information pipeline (114 poses: two full pose-graph windows, a
     third of 18, two stitchings), within 1e-4 (translations) and 1e-5
     (quaternions), two card solves bit-equal, and bit-equal with TF32
     turned on globally (the solver pins f32 itself);
     ``refine_window_ba`` on window 0's network voxel
     points with ``cov_sqrt_info`` weights within 1e-5; ``close_loops``
     on tests/test_loop_closure.py's closed circuit (25 poses, clouds of
     4096 points): at least one loop, the endpoint error below half the
     drifted chain's, 8 B3 launches per ICP run, the CPU's loops and
     poses; B3 bit-equal to its plain version (distances and indices)
     on the inputs of every ICP iteration of that run and on the loop's
     clouds with every 7th point masked; each solve timed on the host
     and profiled on the device; B3 timed at ICP's call (1 x 4096 x
     4096) against its plain version
 21. the data build from a rendered world (``data_build_phases``): the
     KITTI tree, every frame's store record, 2 steps each on the hier
     clouds and with the cross-normal VFE, and loop closing on the
     rendered loop
 22. every BEV-net option of the schema (``option_phases``), at the
     shipped configs' full width on the rulebook engine: ``options``
     (semi-global BN, normalized convs, SE and spatial attention,
     linear confidence, per-level votes, SVD vote) through the train
     verb for 4 steps, ``evaluate`` (8 windows) and 8 streamed scans;
     ``fire`` and ``bottleneck`` blocks, 2 train-verb steps and 8 scans
     each; ``fc`` (``dense_predict`` false) 2 steps at dropout 0, then
     ``evaluate`` and 8 scans at the schema's dropout, and a train step
     at that dropout raises (as in JAX); each step's B1, B2 and B3
     launches equal ``predicted_launches`` (B3 once per consistency
     level: 3 under ``multi_level_odom``), a post-warmup step timed with
     its peak memory; each run's BEV net in f32 on one 96 x 176 x 256
     pair, card against CPU; DenseMiddleCov at the shipped grid, one
     forward and backward on a scan's voxel features (finite, peak
     memory, device ms, no B1-B5 launch), and card against CPU in f32 at
     a 41 x 128 x 128 grid (the scan's voxels around the sensor)
 23. data-parallel training and evaluation (``data_parallel_phases``):
     (a) the train verb at phase 10's config under torchrun's
     environment at world size 1, so on an NCCL group, fed phase 10's
     batches: each step's loss and ``grad_norm`` against phase 10's
     within ``TRAIN_LOSS_TOL``, its launches against
     ``predicted_launches``, the parameters after 2 steps against a
     one-card ``Trainer.fit`` (``param_gap``); (b) two ranks on the one
     card over gloo (NCCL takes one rank a card), started after the
     build and loading it (``dp_rank``): 2 ``Trainer.fit`` steps at full
     width, a window of phase 10's a rank a step (finite losses,
     parameters and BN buffers bit-equal across the ranks after each
     step, each rank's launches a step those of (a)), ``run_eval`` on
     16 windows (each window's odometry against the one-card run of
     rank 0's checkpoint), ``fuse_windows_sharded`` on 1105 poses (23
     windows of 64) and ``solve_ba_sharded`` on 4096 landmarks against
     their one-process runs; (c) the same ranks at the CPU tests' tiny
     config, 2 data-parallel steps on the card against the same on the
     CPU; each path's ms a step per rank and peak memory (the gloo
     numbers host-staged)
 24. the BEV stage split over ranks (``split_phases``): four ranks on
     the card over gloo (``split_rank``, started after the build and
     loading it) form a 4 x 1 and a 2 x 2 grid and run the two-frame
     forward of phase 4's seeded weights and scans at
     ``configs/kitti_eval_ours.json`` (bf16) and its float32 twin: (a)
     SP over 2 ranks (176 columns, 88/88), (b) TP over 2, (c) SP x TP
     over 2 x 2, (d) SP over 4 (48/48/40/40); every map and the
     odometry against this process's unsplit forward within
     SPLIT_REL_TOL of each one's largest value, each rank's launches
     those of the unsplit forward, ms a forward per rank (host-staged);
     (e) the ``bench`` verb with RSLO_BENCH_STREAMING=1: its JSON line
     (the JAX bench's keys), finite rates, its B1 launches; (f)
     ``voxelize_mean`` on a 100k-point scan, ``mean_shift`` on 3000
     points and ``SectionTimer`` on card tensors, card against CPU

Kernel times (``ms``, ``plain_ms``, ``frame_ms``) are device times: the
calls are captured in a CUDA graph and replayed, so the host's launch
rate does not enter them.  B1 at the L0 conv, B2 and B3 are also timed
over back-to-back calls launched from the host (CUDA events,
``host_ms``), which keeps the wrapper's host cost in view.
``--parent DIR`` also builds the four kernel sources of another checkout
(``DIR/rslo_tpu_torch/csrc/``, the same C interface) and times them
against this one, in turns: the gather-GEMM at every conv, B3 at the
deployed call, B2 at the L0 im2col and, in its three-pass composition,
at every d_W im2col, B5 at the L0 plan and, in its three-pass
composition, at every band d_W operand; the band train step with the
parent's d_W chain (phase 11); phase 9 holds the band d_W against the
parent's three-pass chain; and in phase 13 it reads the f32 train step
at the trained weights (the rulebook trainer's, after phases 10 and 11)
on the card, with this checkout's kernels and with the other's, each
against the CPU (printed, not held: the trained weights differ from run
to run).

The last two lines of standard output are the kernel summary (JSON;
each kernel's ``launches`` from phase 10 and its launches on the paths
of phases 14-24 beside them) and the result (JSON); the card's
``nvidia-smi`` line comes before.
Needs one card, no network, and no JAX.
"""
import argparse
import contextlib
import ctypes
import copy
import dataclasses
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "kitti_eval_ours.json")
TRAIN_CONFIG = os.path.join(REPO, "configs", "kitti_train_ours.json")
TRAIN_DIR = os.path.join(REPO, "build", "smoke_train")
BAND_TRAIN_DIR = os.path.join(REPO, "build", "smoke_train_band")
# phases 15-18: the pillar configuration's run dir (its config JSON, the
# train verb's model dir) and the shipped config's warm-started run
PILLAR_DIR = os.path.join(REPO, "build", "smoke_pillar")
VERB_DIR = os.path.join(REPO, "build", "smoke_train_verb")
PILLAR_STEPS, PILLAR_LEG = 6, 4
VERB_STEPS = 2
# phase 19: the refined evaluate verb, (flag, windows, extra arguments).
# Each synthetic window is a scene of its own, so no keyframe pair
# revisits a place: the best candidates score 0.70-0.73, none reaches
# the default 0.8, and a threshold of 0.7 makes ICP (and B3) measure
# them on the verb's path
REFINE_RUNS = (("--refine", 16, ()), ("--refine_ba", 8, ()),
               ("--refine_loops", 16, ("--loop_min_separation", "10",
                                       "--loop_score_threshold", "0.7")))
# sparse convs a frame with the covariance decoder (the BA eval step)
ALL_CONVS = 20
REFINE_FRAMES = 3          # frames of a refined eval window
ICP_ITERS = 8              # close_loops' icp_iters: B3 launches a candidate
# the JAX package's run_eval_refined result keys (rslo_tpu/eval/runner.py)
REFINED_KEYS = {"_meta": ["windows", "elapsed_s", "refined"],
                "seq_00": ["refined", "chained"]}
LOOP_KEYS = ["loop_closed", "n_loops", "loop_keyframes"]
# phase 20: the synthetic split gives the verb at most 32 windows, so
# the pose graph is held on phase 19's --refine predictions repeated
# this many times: 16 x 7 windows, 114 poses, two full 64-pose windows
# of the fusion and a third of 18 (KITTI's val sequences run ~1100
# frames, ~23 such windows)
FUSE_TILES = 7
# phase 20: card against CPU, tests/test_torch_pgo.py's and
# tests/test_torch_ba.py's tolerances: pose graph translations 1e-4 and
# quaternions (up to sign) 1e-5; BA poses 1e-5
PGO_T_TOL, PGO_Q_TOL, BA_TOL = 1e-4, 1e-5, 1e-5
# the closed circuit of tests/test_loop_closure.py::
# test_close_loops_corrects_drift, with clouds of loop_points
LOOP_WORLD = dict(seed=3, n_points=60000, extent=45.0)
LOOP_POSES, LOOP_CLOUD = 25, 4096
# phase 21: the raycast world's KITTI tree at the full 64 x 2048 beam
# grid: a loop at 8 m/s (tests/test_cli_loops_e2e.py's 36 frames) whose
# last ~7 frames revisit its start, and a curve to train on; the cross
# normals' radius; the train steps of each new mode; the loop's
# separation in frames
WORLD_DIR = os.path.join(REPO, "build", "smoke_world")
WORLD_SEQS = {0: (36, "loop", 8.0), 1: (6, "curve", 8.0)}
WORLD_BEAMS = (64, 2048)
CROSS_NORMAL_RADIUS = 1.5
DATA_STEPS = 2
LOOP_SEPARATION = 10
KERNELS = ("gather_matmul", "row_gather", "nn_search", "band_conv")
N_SCANS = 8
# the H100 SXM's published peaks (NVIDIA data sheet, dense): HBM bytes/s,
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
N_POINTS = 100000
SEED = 0
# |kernel - plain| <= REL * sum_k,c |g w| + ABS: both sides add the same
# exact f32 products, in another order; reordering n f32 terms moves the
# sum by a few n^(1/2) ulps of the sum of their magnitudes
KERNEL_REL_TOL = 1e-5
KERNEL_ABS_TOL = 1e-6
# the backward in bf16: both sides round each tap's d_features partial
# and the d_W sum to bf16 after f32 sums in other orders, so an entry
# may land one bf16 ulp apart: |err| <= 2^-8 * sum|terms| + ABS
BWD_REL_TOL = {"bf16": 2.0 ** -8, "f32": KERNEL_REL_TOL}
# the band engine's backward in bf16: for a submanifold plan B4 rounds the
# cotangent before its exact products, where autograd through the plain
# conv rounds each tap's d_features partial and the in-window d_W (the
# kernel's d_W is not rounded); each side is within bf16's unit roundoff
# 2^-8 of the exact sum of the same terms, so |err| <= 2^-7 * sum|terms|
BAND_BWD_REL_TOL = {"bf16": 2.0 ** -7, "f32": KERNEL_REL_TOL}
# streaming vs two-frame: the same kernels on the same inputs
POSE_TOL = dict(rtol=1e-5, atol=1e-5)
# sparse convs a frame without the covariance decoder (streaming, eval)
ENCODER_CONVS = 14
# phase 14: windows evaluated on each engine
EVAL_WINDOWS = {"rulebook": 16, "band": 8, "pillar": 16, "options": 8,
                "fc": 8}
# the JAX package's run_eval result keys (rslo_tpu/eval/runner.py)
EVAL_KEYS = {
    "_meta": ["windows", "elapsed_s", "frames_per_s"],
    "seq_00": ["ate_rmse_m", "t_rel_pct", "r_rel_deg_per_100m",
               "t_rmse_pct", "r_rmse_deg_per_100m", "segments",
               "speed_bins", "n_segments", "segments_scaled",
               "frame_t_err_m", "frame_q_err_deg"],
    "avg": ["t_rel_pct", "r_rel_deg_per_100m", "ate_rmse_m",
            "frame_t_err_m", "frame_q_err_deg"]}
# card (kernel, cuDNN f32 without TF32) vs CPU (plain versions), f32:
# ~40 layers whose f32 sums are taken in different orders; held as
# max |card - cpu| <= CPU_TOL * max |cpu| for each output
CPU_TOL = 1e-3
# f32 train step, card vs CPU: loss terms to 1e-4 relative.  The step's
# gradients are ill-conditioned (train-mode BN, the chamfer association
# at near-ties): f32 rounding-level changes move some leaves by ~1e-2
# (ROADMAP C).  So each leaf's relative L2 error card vs CPU is held to
# TRAIN_GRAD_FACTOR times that leaf's own sensitivity, measured on the
# card as the relative change its gradient makes when every weight is
# scaled by (1 + 1e-7 * N(0, 1)), plus TRAIN_GRAD_ABS, the median such
# sensitivity over all leaves in the first runs (3.4e-3); leaves whose
# norm is below 1e-6 of the largest are skipped.  A wrong gradient is
# off by O(1), far outside this bound.
TRAIN_LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
TRAIN_GRAD_NOISE = 1e-7
TRAIN_GRAD_FACTOR = 10.0
TRAIN_GRAD_ABS = 3e-3
TRAIN_STEPS = 4
SMOKE_WARMUP_STEPS = 1  # steps 0 and 1 warm up, 2 and 3 do not
# the overflow audit: a plan's overflow count may use at most this share
# of its capacity (tests/test_band_conv.py's deployed-shape guard)
OVERFLOW_SHARE = 0.5
AUDIT_POINTS = 131072   # that guard's frame: PipelineCfg().data.max_points
# the pillar configuration's shapes at the shipped grid (1408 x 768 x 40)
PILLAR_IMAGE = (768, 1408, 49)
PILLAR_BEV = (96, 176, 128)


# phase 22: every BEV-net option of the schema on the shipped configs,
# (name, odom overrides, train-verb steps, evaluate-verb windows)
OPTION_RUNS = (
    ("options", dict(bn_type="semiglobal_sync_bn", conv_type="sparse_conv",
                     use_se=True, use_sa=True, conf_type="linear",
                     multi_level_odom=True, use_svd=True), 4, 8),
    ("fire", dict(block_type="fire"), 2, 0),
    ("bottleneck", dict(block_type="bottleneck"), 2, 0),
    ("fc", dict(dense_predict=False), 2, 8),
)
OPTIONS_DIR = os.path.join(REPO, "build", "smoke_options")
OPTION_PAIR_HW = (96, 176)       # the shipped BEV, one pair of 2 x 128
# the BEV nets card vs CPU in f32, element by element: |card - cpu| <=
# BEV_CPU_TOL * (|cpu| + min(1, max |cpu|)), the f32 rtol/atol of
# tests/test_torch_bev_options.py with the atol scaled down for a tensor
# whose values are all small (a softmax confidence over 96 x 176 cells
# holds ~6e-5)
BEV_CPU_TOL = 1e-5
# DenseMiddleCov card vs CPU, f32, train mode, at a small grid: 20 conv3d
# layers of up to 27 x 64-term sums in other orders, and their
# gradients; max |card - cpu| <= DENSE_CPU_TOL * max |cpu| per tensor
DENSE_GRID_SMALL = (41, 128, 128)
DENSE_CPU_TOL = 1e-4
# ... except the biases of the convs that a train-mode BN follows, whose
# exact gradient is 0 (tests/test_torch_middle_dense.py's f32 ZERO)
DENSE_ZERO_GRAD = 1e-5


# phase 23: data-parallel training and evaluation over DP_RANKS ranks on
# the one card (gloo; NCCL takes one rank a card) and the NCCL verb at
# world size 1: DP_STEPS train steps, DP_EVAL_WINDOWS eval windows; the
# sharded pose graph at a KITTI val sequence's 23 windows of 64 poses;
# the sharded BA at the refined eval's 4096 landmarks a window
DP_DIR = os.path.join(REPO, "build", "smoke_dp")
DP_RANKS, DP_STEPS, DP_EVAL_WINDOWS = 2, 2, 16
DP_TIMEOUT_S = 600
DP_FUSE = dict(window=64, overlap=16, iters=8)
DP_FUSE_POSES = 1 + 23 * 48
DP_BA_POSES, DP_BA_LANDMARKS, DP_BA_ITERS = 6, 4096, 5
# two runs' parameters after DP_STEPS Adam steps: most entries within
# this (tests/test_torch_train_step.py's PARAM_ATOL; see ``param_gap``)
DP_PARAM_ATOL = 1e-5
# the sharded fusion against one process: a rank's batch of half the
# windows rounds other than the whole batch, and the stitch composes 23
# windows' f32 solutions along a ~100 m trajectory
DP_FUSE_TOL = dict(rtol=1e-4, atol=1e-4)
DP_FUSE_Q_TOL = 1e-4
DP_LM_TOL = 1e-4            # tests/test_torch_ba.py's landmark tolerance


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def require_card(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off for "
        f"cuDNN convs and cuBLAS matmuls")
    return smi.stdout.strip()


def build_kernels(_build):
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        logs = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for name in KERNELS:
        _build.load_library(name)
    say(f"[build] {', '.join(KERNELS)} built in "
        f"{time.perf_counter() - t0:.2f} s")
    # ptxas -v: registers of each kernel; the gather-GEMM instantiations
    # by mode (0 f32, 1 bf16, 2 bf16 dgrad), k steps and n tiles
    modes = {"0": "f32", "1": "bf16", "2": "bf16-dgrad"}
    for name, log in logs.items():
        entry = name
        for line in log.splitlines():
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                g = re.search(r"gather_gemm_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                              m.group(1))
                entry = (f"gather_gemm<{modes[g[1]]}, KS {g[2]}, NT {g[3]}>"
                         if g else m.group(1)[:40])
            elif "registers" in line or ("spill" in line and
                                         " 0 bytes spill stores, 0 bytes "
                                         "spill loads" not in line):
                say(f"  {name}: {entry}: {line.split(':', 1)[-1].strip()}")


def randomize_bn(net, gen):
    """Random running statistics and affine terms for every BN, so that
    no BN is the identity."""
    import torch
    with torch.no_grad():
        for mod in net.modules():
            if hasattr(mod, "var") and hasattr(mod, "scale"):
                n = mod.var.numel()
                mod.mean.copy_(torch.randn(n, generator=gen) * 0.1)
                mod.var.copy_(torch.rand(n, generator=gen) + 0.5)
                mod.scale.copy_(torch.rand(n, generator=gen) * 0.4 + 0.8)
                mod.bias.copy_(torch.randn(n, generator=gen) * 0.1)


def capture_conv_calls(net, run):
    """Record (features, op, weights, bias, out_mask) of every sparse
    conv that ``run()`` makes."""
    calls = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: calls.append(
            (args[0].detach(), args[1], mod.kernel.detach(),
             mod.bias.detach(), args[2])))
        for m in net.middle._convs]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return calls


def check_kernel(calls, gather_matmul, sparse_conv_apply, torch):
    """Kernel vs plain on the card; returns the largest |error|."""
    worst = 0.0
    for i, (f, rb, w, b, om) in enumerate(calls):
        for dt in (torch.bfloat16, torch.float32):
            out = gather_matmul(f, rb.idx, rb.valid, w, b, om, dt)
            ref = sparse_conv_apply(f, rb, w, b, om, dt)
            mag = sparse_conv_apply(f.abs(), rb, w.abs(), None, None, dt)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            bad = err > KERNEL_REL_TOL * mag + KERNEL_ABS_TOL
            max_abs = err.max().item()
            rel = max_abs / max(ref.abs().max().item(), 1e-30)
            V, K = rb.idx.shape
            say(f"  conv {i:2d} V={V:5d} K={K:2d} Cin={f.shape[1]:2d} "
                f"Cout={w.shape[2]:2d} {str(dt)[6:]:8s} max_abs={max_abs:.3e}"
                f" max_rel={rel:.3e}")
            if bad.any() or not torch.isfinite(out).all():
                fail(f"kernel disagrees with the plain version at conv {i} "
                     f"({dt}): max_abs {max_abs}")
            worst = max(worst, max_abs)
    return worst


def edge_case(call, torch):
    """All-invalid rows, masked rows, a ragged V, and NaN feature rows
    that only invalid taps point at."""
    f, rb, w, b, om = call
    V = rb.idx.shape[0] - 37
    valid = rb.valid[:V].clone()
    valid[::7] = False                                # all-invalid rows
    om = om[:V].clone()
    om[::5] = False                                   # masked rows
    nan_row = f.shape[0]
    f = torch.cat([f, torch.full_like(f[:1], float("nan"))])
    idx = torch.where(valid, rb.idx[:V], nan_row).to(torch.int32)
    return f, type(rb)(idx.contiguous(), valid), w, b, om


def median_ms(fn, n, torch):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def event_us(fn, n, torch):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        fn()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n * 1e3


def turns_us(named, n, torch):
    """Mean µs per call of each (name, fn), timed in turns: the list in
    order, then in reverse."""
    us = {}
    for name, fn in named + named[::-1]:
        us.setdefault(name, []).append(event_us(fn, n, torch))
    return {name: statistics.mean(v) for name, v in us.items()}


def graph_us(named, n, torch, reps=5):
    """Device µs per call of each (name, fn): ``n`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events, in turns
    (the list in order, then reversed).  A replay runs the launches back
    to back, so the host's launch rate does not enter the time."""
    graphs = {}
    side = torch.cuda.Stream()
    for name, fn in named:
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):                 # warm-up
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        graphs[name] = graph
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    us = {}
    for name, _ in named + named[::-1]:
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            graphs[name].replay()
        end.record()
        torch.cuda.synchronize()
        us.setdefault(name, []).append(
            start.elapsed_time(end) / (n * reps) * 1e3)
    del graphs
    return {name: statistics.mean(v) for name, v in us.items()}


# the C entry points of each kernel library, as its wrapper loads them
ENTRY_POINTS = {
    "gather_matmul": ("gather_matmul_launch", "gather_matmul_max_channels",
                      "gather_matmul_shared_bytes"),
    "band_conv": ("band_matmul_launch", "band_gather_launch",
                  "band_gather_fused_launch", "band_matmul_max_channels"),
    "row_gather": ("row_gather_launch", "row_gather_fused_launch"),
    "nn_search": ("nn_search_launch",)}


def load_parent_libraries(parent, _build, dma_gather, bc, chamfer):
    """Build the four kernel sources of another checkout (``parent``)
    and load them with this checkout's C signatures.  Returns
    ``routed(*names)``, a context manager inside which the named
    libraries' wrappers launch the parent's kernels; with no names, every
    library whose parent build has all of this checkout's entry points
    (the parent's ``row_gather.cu`` or ``band_conv.cu`` may lack the
    fused one: its three-pass im2col is then routed by name)."""
    out_dir = os.path.join(REPO, "build", "parent_kernels")
    os.makedirs(out_dir, exist_ok=True)
    loaders = {"gather_matmul": (dma_gather, "_library"),
               "band_conv": (bc, "_library"),
               "row_gather": (dma_gather, "_row_gather_library"),
               "nn_search": (chamfer, "_library")}

    def build(name):
        src = os.path.join(parent, "rslo_tpu_torch", "csrc", f"{name}.cu")
        lib = os.path.join(out_dir, f"lib{name}.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                               src], capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            fail(f"nvcc failed on the parent's {src}:\n{proc.stderr}")
        return lib

    with ThreadPoolExecutor(len(loaders)) as pool:
        paths = dict(zip(loaders, pool.map(build, loaders)))
    libs, complete, missing = {}, [], []
    for name, path in paths.items():
        module, attr = loaders[name]
        ours = getattr(module, attr)()
        lib = ctypes.CDLL(path)
        for fn in ENTRY_POINTS[name]:
            if not hasattr(lib, fn):
                missing.append(f"{name}.{fn}")
                continue
            getattr(lib, fn).argtypes = getattr(ours, fn).argtypes
            getattr(lib, fn).restype = getattr(ours, fn).restype
        if not any(m.startswith(f"{name}.") for m in missing):
            complete.append(name)
        libs[name] = lib
    say(f"[build] the parent's {', '.join(loaders)} from {parent}; "
        f"missing there: {', '.join(missing) or 'nothing'}")

    @contextlib.contextmanager
    def routed(*names):
        """The named wrappers launch the parent's kernels inside the
        block (default: every complete library)."""
        names = names or tuple(complete)
        saved = {n: getattr(*loaders[n]) for n in names}
        for n in names:
            setattr(*loaders[n], lambda lib=libs[n]: lib)
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(*loaders[n], fn)
    return routed


def gemm_bound(inputs, out_rows, cin, cout, pairs):
    """``bound_ms`` of a gather-GEMM: its inputs read once, its (out_rows,
    cout) f32 output written once, 2 * cin * cout operations per valid
    pair (bf16 tensor-core rate)."""
    return bound_ms(nbytes(*inputs) + out_rows * cout * 4,
                    2.0 * pairs * cin * cout)


def time_convs(label, cases, torch, parent=None, libs=()):
    """Device µs per call (``graph_us``, 20 calls a graph) of each
    (desc, fn, bound) in ``cases``, and with ``parent`` (the context of
    ``load_parent_libraries``) the kernel of the parent's libraries
    ``libs`` in turns.  Prints a line per conv and the frame sum; returns
    the frame sum in ms."""
    total = {"new": 0.0, "parent": 0.0}
    for desc, fn, bnd in cases:
        named = [("new", fn)]
        if parent is not None:
            def on_parent(fn=fn):
                with parent(*libs):
                    return fn()
            named = [("parent", on_parent)] + named
        us = graph_us(named, 20, torch)
        for name, t in us.items():
            total[name] += t / 1e3
        old = ("" if parent is None else
               f", parent {us['parent']:8.2f} us ({us['parent'] / us['new']:.2f}x)")
        say(f"  {label} {desc}: {us['new']:8.2f} us{old}; bound "
            f"{bnd[0] * 1e3:7.2f} us ({bnd[1]})")
    old = "" if parent is None else f", parent {total['parent']:.4f} ms"
    say(f"[convs] {label}: frame sum {total['new']:.4f} ms over {len(cases)} "
        f"convs{old}")
    return total["new"]


def profile_device(calls, torch):
    """``torch.profiler`` over the calls: device ms and device ops per
    call, and the device ops with the most device time (the profiler's
    own host cost makes its wall time no measure of a call).  Returns
    None when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        return None
    by_name = {}
    for e in ops:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    n_calls = len(calls)
    device_ms = sum(us for us, _ in by_name.values()) / 1e3 / n_calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(device_ms=device_ms,
                ops=len(ops) / n_calls,
                top=[(name[:60], us / 1e3 / n_calls, n / n_calls)
                     for name, (us, n) in top])


def train_batches(vcfg_points, seq_length, n_windows, seed, np):
    """3-frame windows of synthetic 100k-point scans padded to
    ``max_points``, with the ground-truth pair motions."""
    from rslo_tpu_torch.geometry import np_compose_pose
    from rslo_tpu_torch.utils.synthetic import synth_sequence
    frames, gts = synth_sequence(seed=seed, n_frames=seq_length + n_windows
                                 - 1, n_points=N_POINTS)
    out = []
    for w in range(n_windows):
        pts = np.zeros((seq_length, vcfg_points, 7), np.float32)
        mask = np.zeros((seq_length, vcfg_points), bool)
        for t in range(seq_length):
            pts[t, :N_POINTS] = frames[w + t]
            mask[t, :N_POINTS] = True
        odom = []
        for i in range(seq_length):
            for j in range(i + 1, seq_length):
                p = gts[w + i]
                for k in range(i + 1, j):
                    p = np_compose_pose(p, gts[w + k])
                odom.append(p)
        out.append({"points": pts, "point_mask": mask,
                    "odometry": np.stack(odom).astype(np.float32)})
    return out


def pillar_config(PipelineCfg):
    """The configuration of every committed accuracy result:
    ``PipelineCfg()`` with the overrides of
    ``scripts/accuracy_proxy.py::base_cfg`` (the pillar middle; skip 2
    with random skip, pose interpolation 0.5, yaw augmentation pi,
    65536 points with int16 transfer; icp_iter 6), then, for this run,
    ``loss.warmup_steps`` 1 (steps 0 and 1 warm up) and
    ``train.steps_per_eval`` 2."""
    cfg = PipelineCfg()
    return cfg.replace(
        middle=dataclasses.replace(cfg.middle, name="PillarMiddleCov"),
        data=dataclasses.replace(
            cfg.data, skip=2, random_skip=True, pose_interp_ratio=0.5,
            yaw_aug_rad=math.pi, max_points=65536, quantize_transfer=True),
        loss=dataclasses.replace(cfg.loss, icp_iter=6, warmup_steps=1),
        train=dataclasses.replace(cfg.train, steps_per_eval=2))


def pillar_flops(middle):
    """(encoder, decoder) FLOPs of one frame's pillar convs (2 x MACs),
    from the module's widths, strides and grid."""
    _, h, w = middle.sparse_shape
    ny, nx = h, w
    enc = 0
    for conv in middle._encoder:
        c = conv.Conv_0
        s = c.stride[0]
        h, w = -(-h // s), -(-w // s)
        enc += 2 * h * w * c.out_channels * c.in_channels * 9
    dec = sum(2 * ny * nx * m.Conv_0.out_channels * m.Conv_0.in_channels * 9
              for m in (middle.Conv2dBNRelu_10, middle.Conv2dBNRelu_11))
    return enc, dec


class StepRecorder:
    """Stands in for ``train.loop.train_step`` while a train verb runs:
    each step's launches (the counts' change across it), its warmup
    flag, its host ms (synchronized on both sides) and the first batch
    it was given."""

    def __init__(self, loop, counts, torch):
        self.loop, self.counts, self.torch = loop, counts, torch
        self.step = loop.train_step
        self.records, self.batch = [], None

    def __call__(self, state, batch, *args, warmup, **kw):
        torch = self.torch
        if self.batch is None:
            self.batch = batch
        torch.cuda.synchronize()
        before = self.counts()
        t0 = time.perf_counter()
        out = self.step(state, batch, *args, warmup=warmup, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = self.counts()
        self.records.append((warmup, {k: after[k] - before[k]
                                      for k in after}, ms))
        return out

    def __enter__(self):
        self.loop.train_step = self
        return self

    def __exit__(self, *exc):
        self.loop.train_step = self.step


def predicted_launches(ops, cfg, warmup, grad_ops=None, levels=1):
    """Kernel launches of one train step, from the ops of one frame's
    convs: a conv through a raw rulebook runs ``gather_matmul`` forward
    and ``row_gather`` for its d_W; a band plan runs ``band_matmul``
    forward, and for its d_W ``band_gather`` if it is a self-transpose
    (submanifold) plan, else ``row_gather``.  Every conv but the first
    (whose input needs no gradient) runs one d_features kernel:
    ``band_matmul_dgrad`` for a self-transpose plan, else
    ``gather_matmul_dgrad``.  Only the first ``grad_ops`` convs (all by
    default) run a backward: the ones the loss reaches.  Each frame of
    the window repeats that; each ICP round runs one ``nn_search`` for
    all pairs, once per consistency level (``levels``: 3 under
    ``multi_level_odom`` at the shipped decoder)."""
    want = dict.fromkeys(("gather_matmul", "gather_matmul_dgrad",
                          "row_gather", "band_matmul", "band_matmul_dgrad",
                          "band_gather"), 0)
    L = cfg.data.seq_length
    for i, op in enumerate(ops):
        st = op.plan is not None and op.plan.self_transpose
        want["gather_matmul" if op.plan is None else "band_matmul"] += L
        if grad_ops is not None and i >= grad_ops:
            continue
        want["band_gather" if st else "row_gather"] += L
        if i > 0:
            want["band_matmul_dgrad" if st else "gather_matmul_dgrad"] += L
    want["nn_search"] = levels * (cfg.loss.warmup_icp_iter if warmup
                                  else cfg.loss.icp_iter)
    return want


def check_nn_search(torch, nn_search, nn_search_plain, src, sm, tgt, tm):
    """Kernel vs plain: both outputs bit-equal."""
    d, i = nn_search(src, sm, tgt, tm)
    pd, pi = nn_search_plain(src, sm, tgt, tm)
    torch.cuda.synchronize()
    bad_i = int((i != pi).sum())
    bad_d = int((d.view(torch.int32) != pd.view(torch.int32)).sum())
    if bad_i or bad_d:
        fail(f"nn_search != plain at {tuple(src.shape)} x "
             f"{tuple(tgt.shape)}: {bad_i} indices, {bad_d} distances")
    return d, i


def band_apply_plain(bc, torch, f, plan, w, b, om, dt):
    """``band_conv_apply`` with B4's plain version in place of the
    kernel: the reference the band kernels are held to, forward and
    (through torch autograd) backward."""
    f_pad = bc.pad_rows(f, plan.v_in)
    out = bc.band_conv_plain(f_pad, w, plan.base, plan.sel, dt)
    out = bc.overflow_add_out(out, f_pad, w, plan)[:plan.v_out] + b
    return torch.where(om[:, None], out, 0.0)


def check_backward(calls, torch, conv_kernel, conv_plain, sparse_conv_dgrad,
                   dt_name, rel):
    """The autograd conv ``conv_kernel(f, op, w, b, mask, dtype)``
    (kernels) against torch autograd through ``conv_plain`` (the plain
    conv), for d_features, d_W (|err| <= rel * sum|terms| + ABS) and
    d_bias; returns the largest d_features |error|."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dt_name]
    gen = torch.Generator(device=calls[0][0].device).manual_seed(SEED)
    worst = 0.0
    for n, (f, op, w, b, om) in enumerate(calls):
        V, K = op.rb.idx.shape
        ct = torch.randn(V, w.shape[2], device=f.device, generator=gen)
        grads = []
        for conv in (conv_kernel, conv_plain):
            fi = f.clone().requires_grad_(n > 0)
            wi = w.clone().requires_grad_()
            bi = b.clone().requires_grad_()
            conv(fi, op, wi, bi, om, dt).backward(ct)
            grads.append((fi.grad, wi.grad, bi.grad))
        (kf, kw, kb), (pf, pw, pb) = grads
        ctm = torch.where(om[:, None], ct, 0.0).abs()
        wa = w.abs().flip(0) if op.flip_taps else w.abs()
        g = f.abs()[op.rb.idx.reshape(-1).long()].reshape(V, K, -1)
        g = torch.where(op.rb.valid[..., None], g, 0.0).reshape(V, -1)
        mag_w = (g.t() @ ctm).reshape(w.shape)
        checks = [("d_W", kw, pw, mag_w), ("d_bias", kb, pb, ctm.sum(0))]
        if n > 0:
            mag_f = sparse_conv_dgrad(ctm, op.rb_t,
                                      wa.transpose(1, 2).contiguous())
            checks.append(("d_features", kf, pf, mag_f))
        torch.cuda.synchronize()
        line = []
        for what, k, p, mag in checks:
            err = (k - p).abs()
            bound = (rel if what != "d_bias" else KERNEL_REL_TOL) * mag \
                + KERNEL_ABS_TOL
            if not torch.isfinite(k).all() or (err > bound).any():
                fail(f"backward {what} of conv {n} ({dt_name}) != autograd "
                     f"through the plain conv: max |err| "
                     f"{err.max().item():.3e}")
            if what == "d_features":
                worst = max(worst, err.max().item())
            line.append(f"{what} {err.max().item():.2e}")
        say(f"  conv {n:2d} V={V:5d} K={K:2d} {dt_name:4s} max |err|: "
            f"{', '.join(line)}")
    return worst


def bound_ms(n_bytes, flops=0.0, dtype="bf16"):
    """The least time the card could take: the larger of the bytes over
    HBM's rate and the operations over the peak rate of their type.
    Returns (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def band_pairs(plan):
    """Number of in-window (row, tap) pairs of a plan."""
    return int((plan.sel >= 0).sum())


def bits(x, torch):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def check_band_kernels(cases, bc, torch):
    """B4 against its plain version (|err| <= REL * sum|g*w| + ABS) and
    B5 bit-equal to its plain version, in bf16 and f32, for each
    (label, f_pad, w, plan); returns the largest B4 |error|."""
    worst = 0.0
    for label, f_pad, w, plan in cases:
        for dt in (torch.bfloat16, torch.float32):
            out = bc.band_matmul(f_pad, w, plan.base, plan.sel, dt)
            ref = bc.band_conv_plain(f_pad, w, plan.base, plan.sel, dt)
            mag = bc.band_conv_plain(f_pad.abs(), w.abs(), plan.base,
                                     plan.sel, dt)
            g = bc.band_gather(f_pad, plan.base, plan.sel, dt)
            g_ref = bc.band_gather_plain(f_pad, plan.base, plan.sel, dt)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            max_abs = err.max().item()
            nB, K, B = plan.sel.shape
            say(f"  {label} nB={nB:3d} K={K:2d} B={B} W={plan.window:4d} "
                f"Cin={f_pad.shape[1]:2d} Cout={w.shape[2]:2d} "
                f"{str(dt)[6:]:8s} B4 max_abs={max_abs:.3e}, B5 bit-equal")
            if ((err > KERNEL_REL_TOL * mag + KERNEL_ABS_TOL).any() or
                    not torch.isfinite(out).all()):
                fail(f"band_matmul disagrees with band_conv_plain at {label} "
                     f"({dt}): max_abs {max_abs}")
            if g.dtype != g_ref.dtype or not torch.equal(bits(g, torch),
                                                         bits(g_ref, torch)):
                fail(f"band_gather != band_gather_plain at {label} ({dt})")
            worst = max(worst, max_abs)
    return worst


def band_edge_cases(rb_call, plan, bc, sc, torch):
    """(label, f_pad, w, plan) edge cases at the L0 subm conv: an
    overflow-heavy tiny-window plan, a plan block of 100 rows (B4's
    64-row tiles straddle plan blocks), all-invalid sel, a ragged V, and
    NaN rows that only sel = -1 would point at.  Also holds the whole
    overflow-heavy conv (B4 + the f32 overflow epilogue) against the
    rulebook conv in f32."""
    f, rb, w, b, om = rb_call
    V = rb.idx.shape[0]
    n_valid = int(rb.valid.sum())
    tiny = bc.build_band_index(rb, V, window=16, ov_capacity=n_valid,
                               self_transpose=True)
    if bool(bc.overflow_saturated(tiny)):
        fail("the tiny-window plan saturated its overflow capacity")
    full = bc.band_conv_apply(f, tiny, w, b, om, torch.float32)
    ref = sc.sparse_conv_apply(f, rb, w, b, om, torch.float32)
    mag = sc.sparse_conv_apply(f.abs(), rb, w.abs(), None, None,
                               torch.float32)
    torch.cuda.synchronize()
    err = (full - ref).abs()
    say(f"  overflow-heavy plan (W=16): {int(tiny.ov_count)} of {n_valid} "
        f"pairs overflow; whole conv vs rulebook conv, f32: max |err| "
        f"{err.max().item():.3e}")
    if (err > KERNEL_REL_TOL * mag + KERNEL_ABS_TOL).any():
        fail("the overflow-heavy band conv != the rulebook conv in f32")
    f_pad = bc.pad_rows(f, plan.v_in)
    none = plan._replace(sel=torch.full_like(plan.sel, -1))
    out = bc.band_matmul(f_pad, w, none.base, none.sel)
    g = bc.band_gather(f_pad, none.base, none.sel)
    torch.cuda.synchronize()
    if out.abs().max().item() != 0 or g.float().abs().max().item() != 0:
        fail("all-invalid sel must give zeros")
    ragged_rb = type(rb)(rb.idx[:V - 37].contiguous(),
                         rb.valid[:V - 37].contiguous())
    ragged = bc.build_band_index(ragged_rb, V, self_transpose=True)
    used = torch.zeros(f_pad.shape[0], dtype=torch.bool, device=f.device)
    src = (ragged.base[:, :, None] + ragged.sel)[ragged.sel >= 0]
    used[src.long()] = True
    f_nan = torch.where(used[:, None], f_pad, float("nan"))
    say(f"  edge cases: all-invalid sel gives zeros; ragged V={V - 37}; "
        f"{int((~used).sum())} NaN rows that only sel = -1 would reach")
    odd = bc.build_band_index(rb, V, block=100, ov_capacity=n_valid,
                              self_transpose=True)
    return [("tiny window", f_pad, w, tiny),
            ("block 100", bc.pad_rows(f, odd.v_in), w, odd),
            ("ragged V, NaN rows", f_nan, w, ragged)]


def band_gather_cases(band_calls, bc, torch):
    """(label, f_pad, plan) cases of B5 in both modes: the submanifold
    plans of a train frame and, at its L0 conv (16 channels), an
    overflow-heavy tiny-window plan, a saturated plan, all-invalid sel,
    NaN rows that only sel = -1 would reach (every 5th row's taps made
    invalid), -0.0 rows, and features of 7, 16, 32 and 64 channels on the
    tiny-window plan, each also as a view 4 bytes past an aligned address
    (16 channels also 8 bytes past).  Also checks that a -0.0 row comes
    out +0.0 at an overflow slot of the fused mode (added onto a +0.0)
    and -0.0 in the window."""
    cases = [(f"conv {i:2d}", bc.pad_rows(f, op.plan.v_in).contiguous(),
              op.plan) for i, (f, op, *_) in enumerate(band_calls)
             if op.plan.self_transpose]
    f, op = band_calls[1][:2]
    rb, plan = op.rb, op.plan
    V = rb.idx.shape[0]
    dev = f.device
    n_valid = int(rb.valid.sum())
    tiny = bc.build_band_index(rb, V, window=16, ov_capacity=n_valid,
                               self_transpose=True)
    sat = bc.build_band_index(rb, V, window=16,
                              ov_capacity=max(1, int(tiny.ov_count) // 4),
                              self_transpose=True)
    if bool(bc.overflow_saturated(tiny)) or not bool(
            bc.overflow_saturated(sat)):
        fail("B5 cases: the tiny-window plan must keep every overflow pair "
             "and the saturated one drop some")
    ft = bc.pad_rows(f, tiny.v_in).contiguous()
    hidden = torch.zeros(V, dtype=torch.bool, device=dev)
    hidden[::5] = True
    cut = type(rb)(rb.idx, rb.valid & ~hidden[rb.idx.long()])
    hplan = bc.build_band_index(cut, V, window=16, ov_capacity=n_valid,
                                self_transpose=True)
    fh = bc.pad_rows(f, hplan.v_in)
    used = torch.zeros(fh.shape[0], dtype=torch.bool, device=dev)
    used[(hplan.base[:, :, None] + hplan.sel)[hplan.sel >= 0].long()] = True
    Vp = hplan.sel.shape[0] * hplan.sel.shape[2]
    used[hplan.ov_in[hplan.ov_out < Vp].long()] = True
    if used[:V][hidden].any():
        fail("B5 cases: a row whose taps are all invalid is read")
    f_nan = torch.where(used[:, None], fh, float("nan"))
    f_neg = ft.clone()
    f_neg[::3] = -0.0
    cases += [
        ("L0 tiny window", ft, tiny), ("L0 saturated", ft, sat),
        ("L0 all-invalid sel", bc.pad_rows(f, plan.v_in).contiguous(),
         plan._replace(sel=torch.full_like(plan.sel, -1))),
        (f"L0 NaN rows ({int((~used).sum())})", f_nan, hplan),
        ("L0 -0.0 rows", f_neg, tiny)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = ft.shape[0]
    for C in (7, 16, 32, 64):
        fc = torch.randn(n, C, generator=gen, device=dev)
        cases.append((f"L0 tiny window, Cin {C}", fc, tiny))
        for off in ((1, 2) if C == 16 else (1,)):
            buf = torch.empty(n * C + off, device=dev)
            view = buf[off:].view(n, C)
            view.copy_(fc)
            cases.append((f"L0 tiny window, Cin {C}, {4 * off} bytes past "
                          f"alignment", view, tiny))
    # -0.0: +0.0 at the fused mode's overflow slots, -0.0 in the window
    nB, K, B = tiny.sel.shape
    keep = tiny.ov_out < nB * B
    neg_ov = keep & (tiny.ov_in % 3 == 0)
    sel = tiny.sel.permute(0, 2, 1)
    src = tiny.base[:, None, :] + sel
    neg_win = ((sel >= 0) & (src % 3 == 0)).reshape(nB * B, K)
    for dt in (torch.bfloat16, torch.float32):
        dw = bc.band_gather(f_neg, tiny.base, tiny.sel, dt, overflow=(
            tiny.ov_out, tiny.ov_in, tiny.ov_tap))
        b32 = bits(dw, torch).reshape(nB * B, K, -1)
        at_ov = b32[tiny.ov_out[neg_ov].long(), tiny.ov_tap[neg_ov].long()]
        if not (at_ov == 0).all() or not (
                b32[neg_win] == -2 ** 31).all():
            fail(f"band_gather fused ({dt}): -0.0 must come out +0.0 at an "
                 f"overflow slot and -0.0 in the window")
    say(f"  -0.0 rows: {int(neg_ov.sum())} overflow slots +0.0 and "
        f"{int(neg_win.sum())} window slots -0.0, bf16 and f32")
    return cases


def check_band_gather(cases, bc, torch):
    """B5 bit-equal to its plain versions, bf16 and f32, at each (label,
    f_pad, plan): the plain contract to ``band_gather_plain`` and the
    fused d_W mode to ``band_gather_dw_plain`` (the three-pass chain it
    replaces: B5's im2col, ``overflow_add_g``, ``.float()``)."""
    for label, f_pad, plan in cases:
        ov = (plan.ov_out, plan.ov_in, plan.ov_tap)
        for dt in (torch.bfloat16, torch.float32):
            g = bc.band_gather(f_pad, plan.base, plan.sel, dt)
            g_ref = bc.band_gather_plain(f_pad, plan.base, plan.sel, dt)
            dw = bc.band_gather(f_pad, plan.base, plan.sel, dt, overflow=ov)
            dw_ref = bc.band_gather_dw_plain(f_pad, plan.base, plan.sel, dt,
                                             ov)
            torch.cuda.synchronize()
            if g.dtype != dt or not torch.equal(bits(g, torch),
                                                bits(g_ref, torch)):
                fail(f"band_gather != band_gather_plain at {label} ({dt})")
            if dw.dtype != torch.float32 or not torch.equal(
                    bits(dw, torch), bits(dw_ref, torch)):
                fail(f"band_gather fused != band_gather_dw_plain at {label} "
                     f"({dt})")
        nB, K, B = plan.sel.shape
        Vp = nB * B
        say(f"  {label}: nB={nB:3d} K={K:2d} B={B} W={plan.window:4d} "
            f"Cin={f_pad.shape[1]:2d} ({f_pad.data_ptr() % 16} bytes past "
            f"16), {int((plan.ov_out < Vp).sum())} overflow pairs of "
            f"{int(plan.ov_count)}: both modes bit-equal, bf16 and f32")


@contextlib.contextmanager
def three_pass_band_dw(bc, route=contextlib.nullcontext):
    """Inside the block the band backward builds its d_W operand as the
    parent did: ``band_gather``'s plain contract (the kernel of the
    library that ``route()`` routes in), then ``overflow_add_g`` and
    ``.float()``, three passes over the im2col.  The wrapper counts its
    launches on the module's ``band_gather``, the stand-in inside the
    block; the count goes back to the wrapper after it."""
    fused = bc.band_gather

    def three_pass(f_pad, base, sel, compute_dtype, overflow=None):
        g = fused(f_pad, base, sel, compute_dtype)
        if overflow is None:
            return g
        return bc.overflow_add_g(g, f_pad, *overflow).float()
    three_pass.launches = fused.launches
    bc.band_gather = three_pass
    try:
        with route():
            yield
    finally:
        bc.band_gather = fused
        fused.launches = three_pass.launches


DENSE_SIDE = 32   # the dense case: a solid cube of DENSE_SIDE^3 voxels
DENSE_C = 64


def dense_case(bc, sc, torch, dev):
    """A solid cube of active voxels (nearly all 27 taps valid per row),
    its submanifold rulebook and band plan, and 64 -> 64 weights.
    Returns a dict of the operands."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = DENSE_SIDE
    r = torch.arange(n, dtype=torch.int32, device=dev)
    coords = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                         -1).reshape(-1, 3)
    V = coords.shape[0]
    level = sc.with_slot_map(sc.level_from_coords(
        coords, torch.ones(V, dtype=torch.bool, device=dev), (n, n, n)))
    rb = sc.build_submanifold_index(level)
    plan = bc.build_band_index(rb, V, self_transpose=True)
    if int(plan.ov_count) != 0:
        fail(f"the dense cube's band plan overflows ({int(plan.ov_count)} "
             f"pairs): B4 would not cover every pair")
    C = DENSE_C
    f = torch.randn(V, C, device=dev, generator=gen)
    w = torch.randn(27, C, C, device=dev, generator=gen) / math.sqrt(27 * C)
    b = torch.randn(C, device=dev, generator=gen)
    om = torch.rand(V, device=dev, generator=gen) < 0.9
    ct = torch.randn(V, C, device=dev, generator=gen)
    say(f"[dense] cube of {n}^3 = {V} voxels, {C} -> {C}: "
        f"{int(rb.valid.sum()) / V:.2f} valid taps per row of 27; band plan "
        f"(block {plan.sel.shape[2]}, window {plan.window}) with no overflow")
    return dict(f=f, rb=rb, w=w, b=b, om=om, ct=ct, plan=plan,
                f_pad=bc.pad_rows(f, plan.v_in),
                ct_pad=bc.pad_rows(ct, plan.v_in))


def check_dgrad(label, ct, rb_t, w_t, gather_matmul_dgrad,
                sparse_conv_dgrad, torch):
    """B1's feature-gradient mode against ``sparse_conv_dgrad``, bf16 and
    f32: |err| <= BWD_REL_TOL * sum|terms| + ABS (w_t rounded to the
    compute dtype, as the backward passes it)."""
    for dt_name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        wr = w_t.to(dt).float() if dt == torch.bfloat16 else w_t
        out = gather_matmul_dgrad(ct, rb_t.idx, rb_t.valid, wr, dt)
        ref = sparse_conv_dgrad(ct, rb_t, wr, dt)
        mag = sparse_conv_dgrad(ct.abs(), rb_t, wr.abs())
        torch.cuda.synchronize()
        err = (out - ref).abs()
        say(f"  {label} B1 dgrad {dt_name:4s} max_abs={err.max().item():.3e}"
            f", {int((err > 0).sum())} of {err.numel()} entries differ")
        if (not torch.isfinite(out).all() or
                (err > BWD_REL_TOL[dt_name] * mag + KERNEL_ABS_TOL).any()):
            fail(f"gather_matmul_dgrad != sparse_conv_dgrad at {label} "
                 f"({dt_name}): max |err| {err.max().item():.3e}")


def check_dense(d, bc, gather_matmul, gather_matmul_dgrad,
                sparse_conv_apply, sparse_conv_dgrad, torch):
    """B1 and B4, forward and feature gradient, bf16 and f32, against
    their plain versions on the dense cube; B4's feature gradient is B4
    itself (the forward's arithmetic), held to the forward's tolerance.
    Returns the largest forward |error| of B1 and of B4."""
    b1 = check_kernel([(d["f"], d["rb"], d["w"], d["b"], d["om"])],
                      gather_matmul, sparse_conv_apply, torch)
    w_t = d["w"].flip(0).transpose(1, 2).contiguous()
    check_dgrad("dense cube", d["ct"], d["rb"], w_t, gather_matmul_dgrad,
                sparse_conv_dgrad, torch)
    b4 = check_band_kernels([("dense cube", d["f_pad"], d["w"], d["plan"]),
                             ("dense cube, dgrad", d["ct_pad"], w_t,
                              d["plan"])], bc, torch)
    return b1, b4


def overflow_audit(label, geo, band_overflow_counts, share=None):
    """Print every plan's overflow count against its capacity; fail above
    ``share`` of the capacity when a share is given.  Returns the names
    of the saturated plans (count above capacity: pairs were dropped and
    the conv is inexact)."""
    counts = band_overflow_counts(geo)
    if len(counts) != 10:
        fail(f"expected 10 band plans, got {len(counts)}")
    line, saturated = [], []
    for name, (cnt, cap) in counts.items():
        c = int(cnt)
        line.append(f"{name} {c}")
        if c > cap:
            saturated.append(name)
        if share is not None and c > cap * share:
            fail(f"band plan {name} of {label}: {c} overflow pairs vs "
                 f"capacity {cap}: the windows no longer cover the geometry")
    say(f"[band] overflow audit, {label} (pairs, capacity "
        f"{counts['sub0'][1]}): {', '.join(line)}"
        f"{'; SATURATED: ' + ', '.join(saturated) if saturated else ''}")
    return saturated


@contextlib.contextmanager
def recorded_eval_steps(Trainer, counts):
    """``Trainer.eval_fn`` patched while the block runs: each eval step's
    launches (the counts' change across it), its output and, for the
    first step, its batch, appended to the list it yields."""
    steps = []
    eval_fn = Trainer.eval_fn

    def recording_eval_fn(self, with_cov=False):
        step = eval_fn(self, with_cov)

        def run(batch):
            before = counts()
            out = step(batch)
            after = counts()
            steps.append(({k: after[k] - before[k] for k in after}, out,
                          batch if not steps else None))
            return out
        return run
    Trainer.eval_fn = recording_eval_fn
    try:
        yield steps
    finally:
        Trainer.eval_fn = eval_fn


def evaluate_and_check(engine, model_dir, kernel, cfg, cli, Trainer, counted,
                       reset_counts, counts, prepare_example, vcfg, dev,
                       smi_line, np, torch, ckpt_step=None):
    """Phase 14 on one engine (phase 17: the pillar middle, whose
    ``kernel`` is None: it launches none): the CLI's evaluate verb, in
    this process and with its default device, on ``model_dir``'s latest
    checkpoint or ``--ckpt_step ckpt_step``; every eval step is recorded
    (its launches, and window 0's odometry and batch).  Returns the
    launches of the whole run."""
    windows = EVAL_WINDOWS[engine]
    extra = [] if ckpt_step is None else ["--ckpt_step", str(ckpt_step)]
    cfg_path = os.path.join(model_dir, "eval_config.json")
    with open(cfg_path, "w") as fh:
        fh.write(cfg.to_json())
    reset_counts()
    t0 = time.perf_counter()
    with recorded_eval_steps(Trainer, counts) as steps:
        cli.main(["evaluate", "--config", cfg_path, "--model_dir", model_dir,
                  "--synthetic", "--max_windows", str(windows)] + extra)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    total = counts()
    with open(os.path.join(model_dir, "eval_results.json")) as fh:
        res = json.load(fh)
    keys = {k: list(v) for k, v in res.items()}
    if keys != EVAL_KEYS:
        fail(f"evaluate {engine}: eval_results.json keys {keys} != "
             f"{EVAL_KEYS}")
    if res["_meta"]["windows"] != windows or len(steps) != windows:
        fail(f"evaluate {engine}: {res['_meta']['windows']} windows in the "
             f"results, {len(steps)} eval steps, expected {windows}")
    frame = {f"{s_}/{k}": res[s_][k] for s_ in ("seq_00", "avg")
             for k in ("frame_t_err_m", "frame_q_err_deg")}
    if not all(math.isfinite(v) for v in frame.values()):
        fail(f"evaluate {engine}: non-finite frame-level metrics {frame}")
    want = dict.fromkeys(counted, 0)
    if kernel is not None:
        want[kernel] = 2 * ENCODER_CONVS
    bad = [i for i, (c, _, _) in enumerate(steps) if c != want]
    if bad:
        fail(f"evaluate {engine}: window {bad[0]} launched "
             f"{steps[bad[0]][0]}, expected {want}")
    if total != {k: n * windows for k, n in want.items()}:
        fail(f"evaluate {engine}: the run launched {total}, expected "
             f"{windows} x {want}")
    # window 0 against the checkpoint's two-frame forward (the
    # covariance decoder on) on the same collated points
    tr = Trainer(cfg, model_dir, dev)
    if ckpt_step == "best":
        with open(os.path.join(model_dir, "best_ckpt.json")) as fh:
            ckpt_step = json.load(fh)["step"]
    tr.init_state(ckpt_step=ckpt_step)
    batch = steps[0][2]
    ex = prepare_example(batch["points"][0].to(dev),
                         batch["point_mask"][0].to(dev), vcfg,
                         mean_mode=True)
    with torch.no_grad():
        two = tr.net.eval()(ex)["odometry"].cpu().numpy()
    got = steps[0][1][0].cpu().numpy()
    say(f"[evaluate {engine}] window 0 odometry "
        f"{np.array2string(got[0], precision=6, max_line_width=200)} vs "
        f"the two-frame forward "
        f"{np.array2string(two[0], precision=6, max_line_width=200)}; "
        f"max |diff| "
        f"{np.abs(got - two).max():.3e}")
    if got.shape != two.shape or not np.allclose(got, two, **POSE_TOL):
        fail(f"evaluate {engine}: window 0 != the two-frame forward")
    # the eval step alone on window 0's batch, as run_eval calls it
    # (the batch already collated; ends in the one copy back); and its
    # device work with and without the covariance decoder
    step = tr.eval_fn()
    step_ms = median_ms(lambda: step(batch).cpu(), 10, torch)
    step_cov = tr.eval_fn(with_cov=True)
    for what, fn in (("covariance decoder skipped", step),
                     ("covariance decoder on", step_cov)):
        prof = profile_device([lambda: fn(batch)] * 4, torch)
        if prof is None:
            say(f"[profile] evaluate {engine}: the trace holds no device "
                f"events")
            break
        say(f"[profile] evaluate {engine}, eval step, {what}: "
            f"{prof['device_ms']:.3f} ms/window of device work in "
            f"{prof['ops']:.0f} device ops, against "
            f"{step_ms:.3f} ms/window of host clock")
    meta = res["_meta"]
    ms_window = meta["elapsed_s"] / max(windows - 1, 1) * 1e3
    say(f"[evaluate {engine}] {windows} windows, " + (
        "no kernel launched" if kernel is None else
        f"{want[kernel]} {kernel} launches each and no other kernel")
        + "; frame-level errors "
        f"{res['avg']['frame_t_err_m']:.4f} m, "
        f"{res['avg']['frame_q_err_deg']:.4f} deg")
    say(f"[time] evaluate {engine}: {meta['frames_per_s']:.3f} frames/s, "
        f"{ms_window:.3f} ms/window after the warm-up window (run_eval's "
        f"clock); the eval step alone {step_ms:.3f} ms/window (median of "
        f"10, host clock); the whole CLI run {run_s:.2f} s; {smi_line}")
    tr.logger.close()
    return total


def pillar_and_verb_phases(pcfg, train_config, rb_ops, frames, dev,
                           smi_line, counted, reset_counts, counts, evaluate,
                           np, torch, shapes=(PILLAR_IMAGE, PILLAR_BEV)):
    """Phases 15-18: the pillar configuration ``pcfg`` streamed, trained
    through the CLI's train verb in two legs and evaluated at its best
    checkpoint; then the train verb on ``train_config`` warm-started
    from the pillar run.  ``evaluate(engine, model_dir, kernel, cfg,
    vcfg=, ckpt_step=)`` is phase 14's ``evaluate_and_check``.  Returns
    each path's launches by kernel."""
    from rslo_tpu_torch import cli
    from rslo_tpu_torch.config.schema import PipelineCfg
    from rslo_tpu_torch.data.prepare import prepare_example, voxelizer_config
    from rslo_tpu_torch.eval.streaming import StreamingOdometry
    from rslo_tpu_torch.geometry import np_compose_pose
    from rslo_tpu_torch.models.net import OdomNet
    from rslo_tpu_torch.train import loop as train_loop
    from rslo_tpu_torch.train.checkpoint import CheckpointManager
    from rslo_tpu_torch.train.loop import Trainer
    from rslo_tpu_torch.train.step import train_step
    # -- 15. the pillar configuration: shapes, work and streaming ----------
    pvcfg = voxelizer_config(pcfg)
    pnet = OdomNet(pcfg, torch.Generator().manual_seed(SEED)).to(dev).eval()

    def pillar_example(scans):
        pts = torch.as_tensor(np.stack(scans), device=dev)
        return prepare_example(pts, torch.ones(pts.shape[:2], dtype=bool,
                                               device=dev),
                               pvcfg, mean_mode=True)

    with torch.no_grad():
        ex = pillar_example(frames[:1])
        fargs = (ex["voxel_features"][0], ex["coords"][0],
                 ex["voxel_mask"][0])
        img_shape = tuple(pnet.middle.pillar_image(*fargs).shape)
        bev_shape = tuple(pnet.frame_features(*fargs, with_cov=False)[0]
                          .shape)
    if (img_shape, bev_shape) != shapes:
        fail(f"pillar: image {img_shape}, BEV {bev_shape}; expected "
             f"{shapes}")
    enc_flops, dec_flops = pillar_flops(pnet.middle)
    c0, c1, c2, _ = pcfg.middle.channels
    concat_mb = img_shape[0] * img_shape[1] * (2 * c1 + 2 * c2) * 2 / 1e6
    say(f"[pillar] image {img_shape}, BEV {bev_shape}; a frame's convs: "
        f"encoder {enc_flops / 1e9:.1f} GFLOP, with the decoder "
        f"{(enc_flops + dec_flops) / 1e9:.1f} GFLOP (bounds at "
        f"{PEAK_FLOPS['bf16'] / 1e12:.0f} TFLOP/s bf16: "
        f"{bound_ms(0, enc_flops)[0]:.3f} / "
        f"{bound_ms(0, enc_flops + dec_flops)[0]:.3f} ms); a 3-frame train "
        f"step {3 * 3 * (enc_flops + dec_flops) / 1e12:.2f} TFLOP in the "
        f"middle (forward + 2x backward); the decoder's full-resolution "
        f"concat {2 * c1 + 2 * c2} channels, {concat_mb:.0f} MB bf16")
    pstream = StreamingOdometry(pnet, pcfg, dev)
    reset_counts()
    for scan in frames:
        pstream.push(scan)
    torch.cuda.synchronize()
    pillar_stream_launches = counts()
    poses = np.stack(pstream.trajectory)
    say(f"[pillar stream] {N_SCANS} scans, launches "
        f"{pillar_stream_launches}; last pose "
        f"{np.array2string(poses[-1], precision=5)}")
    if any(pillar_stream_launches.values()):
        fail(f"pillar stream: a kernel launched: {pillar_stream_launches}")
    if poses.shape != (N_SCANS, 7) or not np.isfinite(poses).all():
        fail(f"pillar stream: bad trajectory {poses.shape}: {poses}")
    with torch.no_grad():
        two = pnet(pillar_example(frames[:2]))["odometry"][0].cpu().numpy()
    expect = np_compose_pose(poses[0][None], two[None])[0]
    say(f"[pillar stream] pose after scan 2 "
        f"{np.array2string(poses[1], precision=6)} vs two-frame forward "
        f"{np.array2string(expect, precision=6)}; max |diff| "
        f"{np.abs(poses[1] - expect).max():.3e}")
    if not np.allclose(poses[1], expect, **POSE_TOL):
        fail("pillar stream: pose after scan 2 != two-frame forward")
    pstream = StreamingOdometry(pnet, pcfg, dev)
    for scan in frames[:3]:                   # warm-up
        pstream.push(scan)
    scans = iter(frames * 3)
    pillar_stream_ms = median_ms(lambda: pstream.push(next(scans)), 20,
                                 torch)
    prof = profile_device([lambda scan=scan: pstream.push(scan)
                           for scan in frames[3:7]], torch)
    say(f"[time] pillar streaming {pillar_stream_ms:.3f} ms/scan "
        f"({1e3 / pillar_stream_ms:.2f} scans/s), median of 20 after "
        f"warm-up; {smi_line}")
    if prof is not None:
        say(f"[profile] pillar streaming, torch.profiler over 4 pushes: "
            f"{prof['device_ms']:.3f} ms/scan of device work in "
            f"{prof['ops']:.0f} device ops; against the "
            f"{pillar_stream_ms:.3f} ms/scan measured above, the device "
            f"idles {1 - prof['device_ms'] / pillar_stream_ms:.1%}")
        for name, ms, n in prof["top"]:
            say(f"  {ms:8.3f} ms/scan  {n:6.1f} ops/scan  {name}")
    else:
        say("[profile] pillar streaming: the trace holds no device events")
    del pstream, pnet

    # -- 16. the pillar train verb: two legs with the periodic eval --------
    shutil.rmtree(PILLAR_DIR, ignore_errors=True)
    os.makedirs(PILLAR_DIR)
    pcfg_path = os.path.join(PILLAR_DIR, "pillar_config.json")
    with open(pcfg_path, "w") as fh:
        fh.write(pcfg.to_json())
    pdir = os.path.join(PILLAR_DIR, "model")
    argv = ["train", "--config", pcfg_path, "--model_dir", pdir,
            "--synthetic", "--steps", str(PILLAR_STEPS)]
    reset_counts()
    t0 = time.perf_counter()
    with StepRecorder(train_loop, counts, torch) as rec:
        legs = [cli.main(argv + ["--leg_until", str(PILLAR_LEG)]).step,
                cli.main(argv).step]
    torch.cuda.synchronize()
    verb_s = time.perf_counter() - t0
    pillar_train_launches = counts()
    if legs != [PILLAR_LEG, PILLAR_STEPS] or len(rec.records) != \
            PILLAR_STEPS:
        fail(f"pillar train verb: legs ended at {legs}, "
             f"{len(rec.records)} steps recorded")
    for k, (warm, got, ms) in enumerate(rec.records):
        want = dict.fromkeys(counted, 0)
        want["nn_search"] = (pcfg.loss.warmup_icp_iter if warm
                             else pcfg.loss.icp_iter)
        say(f"[pillar train] step {k} ({'warmup' if warm else 'post-warmup'}"
            f"): {ms:.3f} ms (host clock, synchronized), launches {got}")
        if warm != (k <= pcfg.loss.warmup_steps) or got != want:
            fail(f"pillar train step {k}: warmup {warm}, launches {got}; "
                 f"predicted {want}")
    in_steps = {k: sum(c[k] for _, c, _ in rec.records) for k in counted}
    if in_steps != pillar_train_launches:
        fail(f"pillar train verb: launches outside the steps (the eval "
             f"hook): {pillar_train_launches} against {in_steps}")
    with open(os.path.join(pdir, "log.json.lst")) as fh:
        evals = [json.loads(line)["step"] for line in fh
                 if "eval/frame_t_err_m" in line]
    with open(os.path.join(pdir, "best_ckpt.json")) as fh:
        best = json.load(fh)
    kept = sorted(os.listdir(os.path.join(pdir, "ckpt_best")))
    with open(os.path.join(pdir, "log.txt")) as fh:
        resumed = f"restored checkpoint at step {PILLAR_LEG}" in fh.read()
    say(f"[pillar train] the verb in two legs ({' -> '.join(map(str, legs))}"
        f", resumed: {resumed}) in {verb_s:.2f} s; the eval hook at steps "
        f"{evals}; best_ckpt.json step {best['step']} "
        f"({best['metric_name']} {best['metric']:.4f}), ckpt_best/ {kept}")
    if evals != list(range(2, PILLAR_STEPS + 1, 2)) or not resumed or \
            kept != [f"step_{best['step']}.pt"]:
        fail("pillar train verb: eval hook, best checkpoint or resume "
             "missing")
    ptr = Trainer(pcfg, pdir, dev)
    pst = ptr.init_state()
    pbatch = rec.batch
    torch.cuda.synchronize()
    live_mib = torch.cuda.memory_allocated(dev) / 2 ** 20
    torch.cuda.reset_peak_memory_stats(dev)
    pillar_step_ms = {}
    for warm in (True, False):
        train_step(pst, pbatch, pcfg, ptr.optimizer, warmup=warm)  # warm-up
        pillar_step_ms[warm] = median_ms(lambda: train_step(
            pst, pbatch, pcfg, ptr.optimizer, warmup=warm), 5, torch)
    pillar_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    say(f"[time] pillar train step, full width, 3 frames: warmup "
        f"{pillar_step_ms[True]:.3f} ms, post-warmup "
        f"{pillar_step_ms[False]:.3f} ms (median of 5 after one warm-up "
        f"step each); peak device memory {pillar_peak:.1f} MiB, "
        f"{pillar_peak - live_mib:.1f} MiB above the {live_mib:.1f} MiB "
        f"live before the steps; {smi_line}")
    prof = profile_device([lambda: train_step(pst, pbatch, pcfg,
                                              ptr.optimizer, warmup=False)],
                          torch)
    if prof is not None:
        say(f"[profile] pillar train step, post-warmup: "
            f"{prof['device_ms']:.3f} ms of device work in "
            f"{prof['ops']:.0f} device ops; against "
            f"{pillar_step_ms[False]:.3f} ms a step the device idles "
            f"{1 - prof['device_ms'] / pillar_step_ms[False]:.1%}")
        for name, ms, n in prof["top"]:
            say(f"  {ms:8.3f} ms/step  {n:6.1f} ops/step  {name}")
    ptr.logger.close()
    del ptr, pst

    # -- 17. evaluate --ckpt_step best on the pillar run -------------------
    pillar_eval_launches = evaluate("pillar", pdir, None, pcfg, vcfg=pvcfg,
                                    ckpt_step="best")

    # -- 18. the train verb on the shipped config, warm-started -----------
    with open(train_config) as fh:
        scfg = PipelineCfg.from_json(fh.read())
    shutil.rmtree(VERB_DIR, ignore_errors=True)
    fresh = Trainer(scfg, os.path.join(VERB_DIR, "fresh"), dev)
    seeded = {k: v.cpu().clone()
              for k, v in fresh.init_state().model.state_dict().items()}
    fresh.logger.close()
    del fresh
    start = {}
    fit = Trainer.fit

    def recording_fit(self, batches_, state_, **kw):
        start["model"] = {k: v.cpu().clone()
                          for k, v in state_.model.state_dict().items()}
        start["alphas"] = {k: v.detach().cpu().clone()
                           for k, v in state_.alphas.items()}
        return fit(self, batches_, state_, **kw)

    Trainer.fit = recording_fit
    reset_counts()
    t0 = time.perf_counter()
    try:
        with StepRecorder(train_loop, counts, torch) as vrec:
            vstate = cli.main([
                "train", "--config", train_config, "--model_dir",
                os.path.join(VERB_DIR, "model"), "--synthetic", "--steps",
                str(VERB_STEPS), "--pretrained", pdir,
                "--pretrained_include", "bev_net"])
    finally:
        Trainer.fit = fit
    torch.cuda.synchronize()
    verb_s = time.perf_counter() - t0
    verb_launches = counts()
    raw = CheckpointManager.restore_raw_from(pdir)
    bev_keys = [k for k in start["model"] if k.startswith("bev_net.")]
    mid_keys = [k for k in start["model"] if k.startswith("middle.")]
    moved = [k for k in bev_keys
             if not torch.equal(start["model"][k], raw["model"][k].cpu())]
    reinit = [k for k in mid_keys
              if not torch.equal(start["model"][k], seeded[k])]
    alphas = [k for k, v in raw["alphas"].items()
              if not torch.equal(start["alphas"][k], v.cpu())]
    say(f"[train verb] {os.path.basename(train_config)} warm-started from "
        f"the pillar "
        f"run (--pretrained_include bev_net): at step 0 "
        f"{len(bev_keys) - len(moved)} of {len(bev_keys)} bev_net tensors "
        f"equal the pillar checkpoint's, {len(mid_keys) - len(reinit)} of "
        f"{len(mid_keys)} middle tensors keep the seeded init, "
        f"{len(raw['alphas']) - len(alphas)} of {len(raw['alphas'])} "
        f"alphas carried")
    if moved or reinit or alphas or not bev_keys or not mid_keys:
        fail(f"train verb warm start: bev_net {moved[:3]}, middle "
             f"{reinit[:3]}, alphas {alphas}")
    if vstate.step != VERB_STEPS or len(vrec.records) != VERB_STEPS:
        fail(f"train verb: ended at {vstate.step}, {len(vrec.records)} "
             f"steps recorded")
    for k, (warm, got, ms) in enumerate(vrec.records):
        want = predicted_launches(rb_ops, scfg, warm)
        say(f"[train verb] step {k} ({'warmup' if warm else 'post-warmup'}"
            f"): {ms:.3f} ms (host clock, synchronized), launches {got}")
        if warm != (k <= scfg.loss.warmup_steps) or got != want:
            fail(f"train verb step {k}: launches {got}, predicted {want}")
    if {k: sum(c[k] for _, c, _ in vrec.records) for k in counted} != \
            verb_launches:
        fail(f"train verb: launches outside the steps: {verb_launches}")
    say(f"[train verb] {VERB_STEPS} steps through cli.main in {verb_s:.2f} s "
        f"(model init, loader and first step included); {smi_line}")
    shutil.rmtree(PILLAR_DIR, ignore_errors=True)
    shutil.rmtree(VERB_DIR, ignore_errors=True)
    return {"pillar_stream_launches": pillar_stream_launches,
            "pillar_train_launches": pillar_train_launches,
            "pillar_eval_launches": pillar_eval_launches,
            "train_verb_launches": verb_launches}


class Timed:
    """Stands in for ``module.name`` while a run goes: each call's host
    ms (synchronized on both sides), its arguments and its result."""

    def __init__(self, module, name, torch):
        self.module, self.name, self.torch = module, name, torch
        self.fn = getattr(module, name)
        self.calls = []

    def __call__(self, *args, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        self.torch.cuda.synchronize()
        self.calls.append(((time.perf_counter() - t0) * 1e3, args, kw, out))
        return out

    def ms(self):
        return [c[0] for c in self.calls]

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def pose_diff(got, want, np):
    """Max |translation| difference and max quaternion difference (up to
    sign) of two (N, 7) trajectories."""
    dq = np.minimum(np.abs(got[:, 3:] - want[:, 3:]).max(-1),
                    np.abs(got[:, 3:] + want[:, 3:]).max(-1))
    return float(np.abs(got[:, :3] - want[:, :3]).max()), float(dq.max())


def local_cloud(world, pose, n_keep, np, quat_to_matrix_np):
    """The n_keep world points nearest a sensor pose (in xy), in its
    frame (tests/test_loop_closure.py::local_cloud)."""
    loc = (world[:, :3] - pose[:3]) @ quat_to_matrix_np(pose[3:])
    idx = np.argsort(np.linalg.norm(loc[:, :2], axis=1))[:n_keep]
    return loc[idx].astype(np.float32)


def loop_circuit(np, n_poses=LOOP_POSES, n_keep=LOOP_CLOUD, world=LOOP_WORLD):
    """tests/test_loop_closure.py's closed circuit: a circle of radius 15
    m whose last pose revisits the first, clouds cropped from one
    synthetic world, odometry with a 0.006 rad yaw drift a step.
    Returns (ground truth (N, 7), clouds, drifted odometry)."""
    from rslo_tpu_torch.geometry.transforms import (
        np_compose_pose, np_invert_pose, quat_to_matrix_np)
    from rslo_tpu_torch.utils.synthetic import synth_cloud

    def yaw_pose(yaw, t=(0.0, 0.0, 0.0)):
        return np.array([t[0], t[1], t[2], np.cos(yaw / 2), 0, 0,
                         np.sin(yaw / 2)], np.float32)

    pts = synth_cloud(np.random.default_rng(world["seed"]),
                      n_points=world["n_points"], extent=world["extent"])
    gt = []
    for k in range(n_poses):
        ang = 2 * np.pi * k / (n_poses - 1)
        gt.append(yaw_pose(ang + np.pi / 2, (15.0 * np.cos(ang) - 15.0,
                                             15.0 * np.sin(ang), 0.0)))
    gt = np.stack(gt)
    clouds = [local_cloud(pts, p, n_keep, np, quat_to_matrix_np)
              for p in gt]
    odoms = np_compose_pose(np_invert_pose(gt[:-1]), gt[1:])
    odoms = np_compose_pose(odoms, np.tile(yaw_pose(0.006),
                                           (n_poses - 1, 1)))
    return gt, clouds, odoms


def pgo_windows(n_poses, kw):
    """The pose-graph windows ``fuse_window_odometry`` covers for
    ``n_poses`` poses (its ``window``/``overlap`` in ``kw``)."""
    step = kw.get("window", 64) - kw.get("overlap", 16)
    return len(range(0, n_poses - 1, step))


def time_solve(label, fn, smi_line, torch):
    """Host ms (median of 3 after a warm-up call, synchronized) and the
    device ms and ops of one call (torch.profiler)."""
    fn()
    ms = median_ms(fn, 3, torch)
    prof = profile_device([fn], torch)
    if prof is None:
        say(f"[time] {label}: {ms:.3f} ms (host clock, median of 3); the "
            f"trace holds no device events; {smi_line}")
        return
    say(f"[time] {label}: {ms:.3f} ms (host clock, median of 3), "
        f"{prof['device_ms']:.3f} ms of device work in {prof['ops']:.0f} "
        f"device ops, the device idle "
        f"{1 - prof['device_ms'] / ms:.1%}; {smi_line}")
    for name, dms, n in prof["top"][:5]:
        say(f"  {dms:8.3f} ms  {n:6.1f} ops  {name}")


def refined_phases(cfg, model_dir, cli, Trainer, counted, reset_counts,
                   counts, dev, smi_line, np, torch, runs=REFINE_RUNS,
                   circuit=loop_circuit):
    """Phases 19-20: the CLI's evaluate verb with ``--refine``,
    ``--refine_ba`` and ``--refine_loops`` at ``cfg`` from
    ``model_dir``'s latest checkpoint; then the pose graph, BA and loop
    closing on the card against the CPU, the pose graph with TF32 on.
    ``circuit(np)`` makes phase 20's loop (``loop_circuit``).  Returns
    each path's launches by kernel."""
    from rslo_tpu_torch.eval import runner
    from rslo_tpu_torch.geometry.transforms import odom_to_abs_pose
    from rslo_tpu_torch.ops.chamfer import nn_search, nn_search_plain
    from rslo_tpu_torch.pgo import ba_bridge, loop_closure
    from rslo_tpu_torch.pgo.ba_bridge import (refine_window_ba,
                                              window_ba_problem)
    from rslo_tpu_torch.pgo.loop_closure import close_loops
    from rslo_tpu_torch.pgo.refine import (
        calibrate_pair_info, duplicate_pair_variance, fuse_window_odometry,
        window_pairs_to_edges)
    # -- 19. the refined evaluate verb ---------------------------------------
    cfg_path = os.path.join(model_dir, "refine_config.json")
    with open(cfg_path, "w") as fh:
        fh.write(cfg.to_json())
    launches, recorded = {}, {}
    for flag, windows, extra in runs:
        reset_counts()
        t0 = time.perf_counter()
        with recorded_eval_steps(Trainer, counts) as steps, \
                Timed(runner, "fuse_window_odometry", torch) as fuse, \
                Timed(runner, "window_pairs_to_edges", torch) as pairs, \
                Timed(runner, "refine_window_ba", torch) as ba, \
                Timed(ba_bridge, "solve_ba", torch) as solve, \
                Timed(runner, "close_loops", torch) as loops, \
                Timed(loop_closure, "icp_align", torch) as icp:
            cli.main(["evaluate", "--config", cfg_path, "--model_dir",
                      model_dir, "--synthetic", "--max_windows",
                      str(windows), flag, *extra])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        total = counts()
        with open(os.path.join(model_dir, "eval_results.json")) as fh:
            res = json.load(fh)
        want_keys = dict(REFINED_KEYS)
        if flag == "--refine_loops":
            want_keys["seq_00"] = want_keys["seq_00"] + LOOP_KEYS
        keys = {k: list(v) for k, v in res.items()}
        if keys != want_keys:
            fail(f"evaluate {flag}: eval_results.json keys {keys} != "
                 f"{want_keys}")
        if res["_meta"]["windows"] != windows or len(steps) != windows:
            fail(f"evaluate {flag}: {res['_meta']['windows']} windows in "
                 f"the results, {len(steps)} eval steps, expected {windows}")
        seq = res["seq_00"]
        metrics = {f"{v}/{k}": seq[v][k] for v in want_keys["seq_00"][:3]
                   if v in ("refined", "chained", "loop_closed")
                   for k in ("t_rel_pct", "r_rel_deg_per_100m",
                             "ate_rmse_m")}
        if not all(math.isfinite(x) for x in metrics.values()):
            fail(f"evaluate {flag}: non-finite metrics {metrics}")
        convs = ALL_CONVS if flag == "--refine_ba" else ENCODER_CONVS
        want = dict.fromkeys(counted, 0)
        want["gather_matmul"] = REFINE_FRAMES * convs
        bad = [i for i, (c, _, _) in enumerate(steps) if c != want]
        if bad:
            fail(f"evaluate {flag}: window {bad[0]} launched "
                 f"{steps[bad[0]][0]}, expected {want}")
        want_total = {k: n * windows for k, n in want.items()}
        if flag == "--refine_loops":
            want_total["nn_search"] = ICP_ITERS * len(icp.calls)
            if not 1 <= len(icp.calls) == seq["n_loops"]:
                fail(f"evaluate {flag}: {len(icp.calls)} ICP runs for "
                     f"{seq['n_loops']} loop candidates (at least 1)")
        if total != want_total:
            fail(f"evaluate {flag}: the run launched {total}, expected "
                 f"{want_total}")
        launches[flag] = total
        elapsed = res["_meta"]["elapsed_s"]
        say(f"[evaluate {flag}] {windows} windows, {want['gather_matmul']} "
            f"gather_matmul launches each"
            + (f", {total['nn_search']} nn_search launches in "
               f"{len(icp.calls)} ICP runs ({seq['n_loops']} candidates, "
               f"{seq['loop_keyframes']} keyframes)"
               if flag == "--refine_loops" else "")
            + "; " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
        say(f"[time] evaluate {flag}: {windows / elapsed:.3f} windows/s, "
            f"{elapsed / windows * 1e3:.3f} ms/window (run_eval_refined's "
            f"clock over the window loop, BA included); the whole CLI run "
            f"{run_s:.2f} s; {smi_line}")
        say(f"[time] evaluate {flag}: pose-graph fusion "
            f"{', '.join(f'{m:.3f}' for m in fuse.ms())} ms a sequence ("
            + ", ".join(f"{c[1][2]} poses, {pgo_windows(c[1][2], c[2])} "
                        f"windows" for c in fuse.calls) + ")"
            + (f"; BA {statistics.median(ba.ms()):.3f} ms a window "
               f"(median of {len(ba.calls)}; the solve alone "
               f"{statistics.median(solve.ms()):.3f})" if ba.calls else "")
            + (f"; loop closing {', '.join(f'{m:.3f}' for m in loops.ms())}"
               f" ms (ICP {statistics.median(icp.ms()):.3f} ms a candidate)"
               if icp.calls else
               f"; loop closing {', '.join(f'{m:.3f}' for m in loops.ms())}"
               f" ms" if loops.calls else ""))
        recorded[flag] = dict(pairs=pairs.calls, fuse=fuse.calls,
                              ba=ba.calls)

    # -- 20. refinement on the card against the CPU ---------------------------
    # the runner's fusion inputs for the --refine predictions (its first
    # window_pairs_to_edges call; the second takes the ground truth),
    # repeated FUSE_TILES times
    _, (starts, offsets, preds), _, _ = recorded["--refine"]["pairs"][0]
    span = max(starts) + 1
    starts = [s + r * span for r in range(FUSE_TILES) for s in starts]
    preds = np.concatenate([preds] * FUSE_TILES)
    edges, motions, weights = window_pairs_to_edges(starts, offsets, preds)
    info = calibrate_pair_info(edges, motions, weights, dup_var=(
        duplicate_pair_variance(starts, offsets, preds)))
    args = (edges, motions, max(starts) + REFINE_FRAMES, weights)
    kw = {k: v for k, v in recorded["--refine"]["fuse"][0][2].items()
          if k != "device"}
    kw["pair_info"] = info

    def fuse(device):
        return fuse_window_odometry(*args, device=device, **kw)

    card, again, cpu = fuse(dev), fuse(dev), fuse("cpu")
    dt, dq = pose_diff(card, cpu, np)
    say(f"[pgo] fuse_window_odometry (window {kw['window']}, overlap "
        f"{kw['overlap']}, iters {kw['iters']}) on phase 19's --refine "
        f"predictions repeated {FUSE_TILES} times: {len(args[0])} edges, "
        f"{args[2]} poses in "
        f"{pgo_windows(args[2], kw)} windows; card vs CPU max "
        f"|dt| {dt:.3e} m (<= {PGO_T_TOL:g}), |dq| {dq:.3e} (<= "
        f"{PGO_Q_TOL:g}); a second card solve bit-equal: "
        f"{np.array_equal(card, again)}")
    if dt > PGO_T_TOL or dq > PGO_Q_TOL or not np.isfinite(card).all():
        fail("pose graph: the card's refined poses differ from the CPU's")
    if not np.array_equal(card, again):
        fail("pose graph: two card solves differ")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = fuse(dev)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    say(f"[pgo] TF32 on globally: refined poses bit-equal to TF32 off: "
        f"{np.array_equal(tf32, card)}")
    if not np.array_equal(tf32, card):
        fail("pose graph: TF32 on globally changed the refined poses")
    time_solve(f"pose-graph fusion, {args[2]} poses in "
               f"{pgo_windows(args[2], kw)} windows, on the card",
               lambda: fuse(dev), smi_line, torch)

    _, args, kw, _ = recorded["--refine_ba"]["ba"][0]
    kw = {k: v for k, v in kw.items() if k != "device"}
    odoms = np.zeros((REFINE_FRAMES, 7), np.float32)
    odoms[:, 3] = 1.0
    odoms[1:] = args[1]
    problem = window_ba_problem(args[0], odom_to_abs_pose(odoms),
                                kw.get("point_weights"), device="cpu")
    card = refine_window_ba(*args, device=dev, **kw)
    cpu = refine_window_ba(*args, device="cpu", **kw)
    dt, dq = pose_diff(card, cpu, np)
    say(f"[ba] refine_window_ba on window 0's network voxel points with "
        f"cov_sqrt_info weights: {[len(p) for p in args[0]]} points a "
        f"frame, {len(problem.landmarks)} landmarks, "
        f"{len(problem.obs_pose)} observations; card vs "
        f"CPU max |dt| {dt:.3e} m, |dq| {dq:.3e} (<= {BA_TOL:g})")
    if dt > BA_TOL or dq > BA_TOL or not np.isfinite(card).all():
        fail("BA: the card's window poses differ from the CPU's")
    time_solve(f"BA, one window ({len(problem.landmarks)} landmarks), on "
               f"the card", lambda: refine_window_ba(*args, device=dev,
                                                     **kw), smi_line, torch)

    gt, clouds, odoms = circuit(np)
    kw = dict(min_separation=15, score_threshold=0.85, loop_info=50.0)
    with Timed(loop_closure, "icp_align", torch) as icp, \
            Timed(loop_closure, "nn_search", torch) as searches:
        reset_counts()
        poses, cands = close_loops(odoms, clouds, device=dev, **kw)
        torch.cuda.synchronize()
        circuit_launches = counts()
    want = dict.fromkeys(counted, 0)
    want["nn_search"] = ICP_ITERS * len(icp.calls)
    chain = odom_to_abs_pose(np.concatenate(
        [[[0, 0, 0, 1, 0, 0, 0]], odoms]).astype(np.float32))
    e_chain = float(np.linalg.norm(chain[-1, :3] - gt[-1, :3]))
    e_opt = float(np.linalg.norm(poses[-1, :3] - gt[-1, :3]))
    cpu, cpu_cands = close_loops(odoms, clouds, device="cpu", **kw)
    dt, dq = pose_diff(poses, cpu, np)
    say(f"[loops] close_loops on a {len(gt)}-pose circuit, clouds of "
        f"{len(clouds[0])} points: loops {cands.pairs.tolist()} (scores "
        f"{np.round(cands.scores, 4).tolist()}), {len(icp.calls)} ICP runs, "
        f"launches {circuit_launches}; endpoint error {e_opt:.4f} m against "
        f"the drifted chain's {e_chain:.4f}; card vs CPU max |dt| "
        f"{dt:.3e} m, |dq| {dq:.3e}, the same loops: "
        f"{np.array_equal(cands.pairs, cpu_cands.pairs)}")
    if len(cands.pairs) < 1 or len(icp.calls) != len(cands.pairs):
        fail(f"loop closing: {len(cands.pairs)} loops, {len(icp.calls)} ICP "
             f"runs")
    if circuit_launches != want:
        fail(f"loop closing: launches {circuit_launches}, expected {want}")
    if not e_opt < 0.5 * e_chain:
        fail(f"loop closing: endpoint error {e_opt} not below half the "
             f"chain's {e_chain}")
    if (dt > PGO_T_TOL or dq > PGO_Q_TOL or
            not np.array_equal(cands.pairs, cpu_cands.pairs)):
        fail("loop closing: the card's poses differ from the CPU's")
    # B3 against its plain version at ICP's calls: the inputs of each
    # ICP iteration of the run above, then the loop's two clouds, all
    # points valid and with every 7th masked on both sides
    for _, call_args, call_kw, _ in searches.calls:
        check_nn_search(torch, nn_search, nn_search_plain, *call_args,
                        **call_kw)
    src = torch.as_tensor(clouds[0], device=dev)[None]
    tgt = torch.as_tensor(clouds[-1], device=dev)[None]
    msk = torch.ones(src.shape[:2], dtype=torch.bool, device=dev)
    sparse = msk.clone()
    sparse[:, ::7] = False
    check_nn_search(torch, nn_search, nn_search_plain, src, msk, tgt, msk)
    check_nn_search(torch, nn_search, nn_search_plain, src, sparse, tgt,
                    sparse)
    say(f"[loops] nn_search bit-equal to nn_search_plain (distances and "
        f"indices) on the {len(searches.calls)} ICP calls' inputs and at "
        f"1 x {src.shape[1]} x {tgt.shape[1]} with all points valid and "
        f"with every 7th masked")
    time_solve(f"loop closing, {len(gt)} poses, on the card",
               lambda: close_loops(odoms, clouds, device=dev, **kw),
               smi_line, torch)
    us = graph_us([("kernel", lambda: nn_search(src, msk, tgt, msk)),
                   ("plain", lambda: nn_search_plain(src, msk, tgt, msk))],
                  20, torch)
    n_pairs = src.shape[1] * tgt.shape[1]
    bound = bound_ms(nbytes(src, msk, tgt, msk) + src.shape[1] * 8,
                     9.0 * n_pairs, "f32")
    say(f"[time] nn_search at ICP's call, 1 x {src.shape[1]} x "
        f"{tgt.shape[1]}: kernel {us['kernel']:.2f} us/call, plain "
        f"{us['plain']:.2f} us/call (device time, in turns); bound "
        f"{bound[0] * 1e3:.2f} us ({bound[1]}); {smi_line}")
    return {"refine_launches": launches["--refine"],
            "refine_ba_launches": launches["--refine_ba"],
            "refine_loops_launches": launches["--refine_loops"],
            "loop_circuit_launches": circuit_launches}



def memory_reader(store, np):
    """A class with ``data/hdf5_store.py::SequenceReader``'s contract
    (``n_frames``, ``frame(i, cross_normals)``) over ``store``: {seq:
    (records, poses (n, 3, 4), Tr (3, 4))}, each record as
    ``build_frame_record`` makes it, where the card's machine has no
    h5py to write and read a store with."""
    class MemoryReader:
        def __init__(self, path, seq):
            self.path, self.seq = path, seq
            self.records, self.poses, self.Tr = store[seq]
            self.n_frames = len(self.records)

        def frame(self, i, cross_normals=False):
            rec = self.records[i]
            cols = [rec["lidar_points"], rec["lidar_normals"]]
            if cross_normals and "lidar_cross_normals" in rec:
                cols.insert(1, rec["lidar_cross_normals"])
            out = {"points": np.concatenate(cols, axis=1),
                   "pose": self.poses[i], "Tr": self.Tr}
            out.update((k, v) for k, v in rec.items()
                       if k.startswith("hier_"))
            return out
    return MemoryReader


def data_build_phases(cfg, tcfg, rb_ops, cli, Trainer, counted, reset_counts,
                      counts, dev, smi_line, np, torch, seqs=WORLD_SEQS,
                      beams=WORLD_BEAMS, world_kwargs=None):
    """Phase 21: the data build and the input variants it feeds.  The
    raycast world's KITTI tree (``seqs`` at ``beams``), every frame's
    store record by ``build_frame_record`` (the native normals), read
    through ``memory_reader``; 2 steps of ``Trainer.fit`` at ``tcfg``
    on the hier clouds and 2 with the cross-normal VFE; the point-stack
    prepare against the mean path at ``cfg``; and ``run_eval_refined``
    with loop closing on the rendered loop.  ``rb_ops`` are the train
    frame's convs (``predicted_launches``).  Returns each path's
    launches by kernel."""
    from rslo_tpu_torch.data import dataset as dataset_mod
    from rslo_tpu_torch.data import normals
    from rslo_tpu_torch.data.dataset import DATASETS, KittiWindowDataset
    from rslo_tpu_torch.data.hdf5_store import (SequenceReader,
                                                build_frame_record)
    from rslo_tpu_torch.data.kitti_io import (list_frames, read_calib,
                                              read_poses, read_velodyne,
                                              sequence_paths)
    from rslo_tpu_torch.data.loader import DataLoader
    from rslo_tpu_torch.data.prepare import prepare_example, voxelizer_config
    from rslo_tpu_torch.eval import runner
    from rslo_tpu_torch.losses import consistency
    from rslo_tpu_torch.models.vfe import VFES
    from rslo_tpu_torch.ops.chamfer import nn_search, nn_search_plain
    from rslo_tpu_torch.pgo import loop_closure
    from rslo_tpu_torch.train import loop as train_loop
    from rslo_tpu_torch.train.step import train_step
    from rslo_tpu_torch.utils.world import write_kitti_tree
    # -- 21a. render the world; build every frame's record -------------------
    shutil.rmtree(WORLD_DIR, ignore_errors=True)
    tree = os.path.join(WORLD_DIR, "kitti")
    t0 = time.perf_counter()
    write_kitti_tree(tree, seqs, world_seed=SEED, n_beams=beams[0],
                     n_azimuth=beams[1], world_kwargs=world_kwargs)
    n_frames = sum(n for n, _, _ in seqs.values())
    render_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    t0 = time.perf_counter()
    normals.build()
    say(f"[data] native/prep.cpp built with g++ into "
        f"{os.path.relpath(normals.library_path(), REPO)} in "
        f"{time.perf_counter() - t0:.2f} s (or found built)")
    sizes = tcfg.data.downsample_voxel_sizes[:1]
    store, n_points, record_ms = {}, [], []
    with Timed(normals, "estimate_normals", torch) as est:
        for seq in seqs:
            velo, seq_dir, pose_file = sequence_paths(tree, seq)
            records = []
            for fr in list_frames(velo):
                pts = read_velodyne(fr)
                t0 = time.perf_counter()
                records.append(build_frame_record(
                    pts, sizes, cross_normal_radius=CROSS_NORMAL_RADIUS))
                record_ms.append((time.perf_counter() - t0) * 1e3)
                n_points.append(len(pts))
            store[seq] = (records, read_poses(pose_file),
                          read_calib(seq_dir)["Tr"])
    hier_key = f"hier_lidar_points_normals_{sizes[0]}"
    n_hier = [len(r[hier_key]) for recs, _, _ in store.values()
              for r in recs]
    spec = ", ".join(f"seq {s:02d}: {n} {pat} at {v} m/s"
                     for s, (n, pat, v) in seqs.items())
    say(f"[data] rendered {n_frames} frames at {beams[0]} x {beams[1]} "
        f"beams ({spec}): "
        f"{statistics.mean(n_points):.0f} points a scan ({min(n_points)}-"
        f"{max(n_points)}), {render_ms:.1f} ms a frame (host); records: "
        f"normals at 0.6 m and {CROSS_NORMAL_RADIUS} m "
        f"{statistics.mean(est.ms()):.1f} ms a call (host, {len(est.calls)} "
        f"calls), hier clouds at {sizes[0]} m {statistics.mean(n_hier):.0f} "
        f"points, build_frame_record {statistics.mean(record_ms):.1f} ms a "
        f"frame (host); {smi_line}")
    bad = [k for recs, _, _ in store.values() for r in recs
           for k, v in r.items() if not np.isfinite(v).all()]
    if bad or min(n_points) < 1000:
        fail(f"data build: non-finite records {bad[:3]} or empty scans")
    Reader = memory_reader(store, np)
    if importlib.util.find_spec("h5py") is None:
        say("[data] h5py is not installed: the create_hdf5 verb's file "
            "write is not driven here (tests/test_torch_store.py holds it "
            "byte-equal to the JAX package's on the CPU); the records "
            "above are the verb's, by its own build_frame_record")
    else:
        h5 = os.path.join(WORLD_DIR, "all.h5")
        cli.main(["create_hdf5", "--kitti_root", tree, "--out", h5,
                  "--sequences", ",".join(str(s) for s in seqs),
                  "--cross_normal_radius", str(CROSS_NORMAL_RADIUS)])
        for seq in seqs:
            got, want = SequenceReader(h5, seq), Reader(None, seq)
            for i in range(want.n_frames):
                for cross in (False, True):
                    a, b = got.frame(i, cross), want.frame(i, cross)
                    if sorted(a) != sorted(b) or not all(
                            np.array_equal(a[k], b[k]) for k in a):
                        fail(f"create_hdf5: seq {seq} frame {i} differs "
                             f"from its in-memory record")
        say("[data] the create_hdf5 verb's store equals the in-memory "
            "records, frame by frame")

    def windows(cls, data_cfg, *args, **kw):
        saved = dataset_mod.SequenceReader
        dataset_mod.SequenceReader = Reader
        try:
            return cls(data_cfg, *args, **kw)
        finally:
            dataset_mod.SequenceReader = saved

    # -- 21b. training on the hier clouds and with the cross-normal VFE ------
    curve = [s for s, (_, pat, _) in seqs.items() if pat == "curve"]
    runs = {
        "hier": tcfg.replace(
            data=dataclasses.replace(tcfg.data, load_hier_points=True,
                                     train_sequences=tuple(curve)),
            loss=dataclasses.replace(tcfg.loss, use_hier_points=True,
                                     warmup_steps=0)),
        "crossnorm": tcfg.replace(
            data=dataclasses.replace(tcfg.data,
                                     dataset="kitti_crossnorm_hdf5",
                                     train_sequences=tuple(curve)),
            vfe=dataclasses.replace(tcfg.vfe,
                                    name="SimpleVoxelXYZINormalNormalGT",
                                    num_input_features=10),
            loss=dataclasses.replace(tcfg.loss, warmup_steps=0))}
    launches = {}
    for mode, cfg_ in runs.items():
        # the hier-cloud consistency takes no covariances: the loss
        # leaves the covariance decoder's convs out of the backward
        grad_ops = ENCODER_CONVS if mode == "hier" else None
        run_dir = os.path.join(WORLD_DIR, mode)
        trainer = Trainer(cfg_, run_dir, dev)
        state = trainer.init_state()
        before = {k: v.detach().clone()
                  for k, v in state.model.state_dict().items()}
        dataset = windows(DATASETS[cfg_.data.dataset], cfg_.data, "train")
        loader = DataLoader(dataset, cfg_.data, 1, DATA_STEPS, train=True,
                            seed=cfg_.train.seed)
        reset_counts()
        try:
            with StepRecorder(train_loop, counts, torch) as rec, \
                    Timed(consistency, "nn_search", torch) as searches:
                state = trainer.fit(({k: v[0] for k, v in b.items()
                                      if k != "meta"} for b in loader),
                                    state, max_steps=DATA_STEPS)
        finally:
            loader.close()
        torch.cuda.synchronize()
        total = counts()
        keys = sorted(rec.batch)
        say(f"[train {mode}] {len(dataset)} windows of seq "
            f"{curve[0]:02d}, batch {keys}, points "
            f"{tuple(rec.batch['points'].shape)}")
        if mode == "hier" and "hier_points" not in rec.batch:
            fail("hier training: the batch carries no hier clouds")
        if state.step != DATA_STEPS or len(rec.records) != DATA_STEPS:
            fail(f"{mode} training: ended at {state.step}, "
                 f"{len(rec.records)} steps recorded")
        for k, (warm, got, ms) in enumerate(rec.records):
            want = predicted_launches(rb_ops, cfg_, warm, grad_ops)
            kind = "warmup" if warm else "post-warmup"
            say(f"[train {mode}] step {k} ({kind}): {ms:.3f} ms (host "
                f"clock, synchronized, the first step's set-up included), "
                f"launches {got}")
            if warm != (k <= cfg_.loss.warmup_steps) or got != want:
                fail(f"{mode} training step {k}: launches {got}, predicted "
                     f"{want}")
        launches[mode] = {k: sum(c[k] for _, c, _ in rec.records)
                          for k in counted}
        if launches[mode] != total:
            fail(f"{mode} training: launches outside the steps: {total}")
        for step_i, row in trainer.history:
            say(f"[train {mode}] step {step_i}: loss {row['loss']:.5f} "
                f"consistency {row['consistency_loss']:.5f} grad_norm "
                f"{row['grad_norm']:.4f}")
            if not all(math.isfinite(v) for v in row.values()):
                fail(f"{mode} training step {step_i}: non-finite metrics")
        if len(trainer.history) != DATA_STEPS:
            fail(f"{mode} training: {len(trainer.history)} logged steps")
        after = state.model.state_dict()
        same = {k for k, v in before.items() if torch.equal(v, after[k])}
        mid = state.model.middle
        decoder = {id(t) for m in (mid._convs[ENCODER_CONVS:] +
                                   mid._norms[mid._n_enc_norms:])
                   for t in list(m.parameters()) + list(m.buffers())}
        dec_names = {k for k, t in state.model.state_dict(
            keep_vars=True).items() if id(t) in decoder}
        say(f"[train {mode}] {len(after) - len(same)} of {len(after)} "
            f"tensors changed; unchanged: {len(same)}, all in the "
            f"covariance decoder: {same <= dec_names}")
        if same and (grad_ops is None or not same <= dec_names):
            fail(f"{mode} training left tensors unchanged: "
                 f"{sorted(same)[:5]}")
        # B3 on the inputs of the run's first association
        check_nn_search(torch, nn_search, nn_search_plain,
                        *searches.calls[0][1], **searches.calls[0][2])
        src = searches.calls[0][1][0]
        say(f"[train {mode}] nn_search bit-equal to nn_search_plain "
            f"(distances and indices) on the first association's inputs, "
            f"{tuple(src.shape[:2])} x {searches.calls[0][1][2].shape[1]}")
        batch = rec.batch
        torch.cuda.synchronize()
        live_mib = torch.cuda.memory_allocated(dev) / 2 ** 20
        torch.cuda.reset_peak_memory_stats(dev)
        step_ms = {}
        for warm in (True, False):
            train_step(state, batch, cfg_, trainer.optimizer, warmup=warm)
            step_ms[warm] = median_ms(lambda: train_step(
                state, batch, cfg_, trainer.optimizer, warmup=warm), 3, torch)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        say(f"[time] train step, {mode}, full width, 3 frames: warmup "
            f"{step_ms[True]:.3f} ms, post-warmup {step_ms[False]:.3f} ms "
            f"(median of 3 after one warm-up step each); peak device memory "
            f"{peak:.1f} MiB, {peak - live_mib:.1f} MiB above the "
            f"{live_mib:.1f} MiB live before the steps; {smi_line}")
        trainer.logger.close()
        del trainer, state, batch, rec, searches
        shutil.rmtree(run_dir, ignore_errors=True)

    # -- 21c. the point stacks against the mean path, at the eval config ----
    loop = [s for s, (_, pat, _) in seqs.items() if pat != "curve"][0]
    vcfg = voxelizer_config(cfg)
    scan = torch.as_tensor(Reader(None, loop).frame(0)["points"],
                           device=dev)[None]
    smask = torch.ones(scan.shape[:2], dtype=torch.bool, device=dev)
    vfe = VFES["SimpleVoxelXYZINormal"]

    def stack_path():
        ex = prepare_example(scan, smask, vcfg)
        return ex, vfe(ex["voxels"][0], ex["num_points"][0],
                       cfg.vfe.num_input_features)

    def mean_path():
        return prepare_example(scan, smask, vcfg, mean_mode=True)

    with torch.no_grad():
        ex, feats = stack_path()
        mean = mean_path()
        same = [torch.equal(feats, mean["voxel_features"][0])] + [
            torch.equal(ex[k], mean[k]) for k in ("coords", "num_points",
                                                  "voxel_mask")]
        say(f"[prepare] one rendered scan at the eval config: "
            f"{int(mean['voxel_mask'].sum())} voxels; the point stacks "
            f"{tuple(ex['voxels'].shape)} with SimpleVoxelXYZINormal "
            f"bit-equal to the mean path: features {same[0]}, coords, "
            f"counts and masks {all(same[1:])}")
        if not all(same):
            fail("the point-stack path with the mean VFE != the mean path")
        ms = {name: event_us(fn, 10, torch) / 1e3
              for name, fn in (("stack", stack_path), ("mean", mean_path))}
        profs = {name: profile_device([fn], torch)
                 for name, fn in (("stack", stack_path), ("mean", mean_path))}
    say(f"[time] prepare a frame at the eval config: the point stacks + "
        f"VFE {ms['stack']:.3f} ms, the mean path {ms['mean']:.3f} ms "
        f"(CUDA events over 10 back-to-back calls)" + "".join(
            f"; {name}: {p['device_ms']:.3f} ms of device work in "
            f"{p['ops']:.0f} device ops" for name, p in profs.items()
            if p is not None) + f"; {smi_line}")

    # -- 21d. loop closing on the rendered revisit --------------------------
    ecfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                val_sequences=(loop,)))
    dataset = windows(KittiWindowDataset, ecfg.data, "val",
                      seq_length=REFINE_FRAMES)
    tr = Trainer(ecfg, os.path.join(WORLD_DIR, "loops"), dev)
    tr.init_state()
    reset_counts()
    t0 = time.perf_counter()
    with Timed(runner, "close_loops", torch) as loops, \
            Timed(loop_closure, "icp_align", torch) as icp:
        res = runner.run_eval_refined(
            tr.eval_fn(), dataset, ecfg, tr.logger, use_loops=True,
            loop_min_separation=LOOP_SEPARATION)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    total = counts()
    tr.logger.close()
    seq = res[f"seq_{loop:02d}"]
    n_win = res["_meta"]["windows"]
    metrics = {f"{v}/t_rel_pct": seq[v]["t_rel_pct"]
               for v in ("chained", "refined", "loop_closed")}
    want = dict.fromkeys(counted, 0)
    want["gather_matmul"] = n_win * REFINE_FRAMES * ENCODER_CONVS
    want["nn_search"] = ICP_ITERS * len(icp.calls)
    say(f"[loops] run_eval_refined on the rendered loop (seq {loop:02d}, "
        f"{n_win} windows, {seq['loop_keyframes']} keyframes), "
        f"min separation {LOOP_SEPARATION}, the default score threshold "
        f"0.8: {seq['n_loops']} loops, {len(icp.calls)} ICP runs, launches "
        f"{total}; " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    if not 1 <= len(icp.calls) == seq["n_loops"]:
        fail(f"loop closing on the rendered loop: {seq['n_loops']} loops, "
             f"{len(icp.calls)} ICP runs (at least 1)")
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"loop closing on the rendered loop: non-finite {metrics}")
    if total != want:
        fail(f"loop closing on the rendered loop: launches {total}, "
             f"expected {want}")
    say(f"[time] refined eval with loop closing on the rendered loop: "
        f"{n_win / res['_meta']['elapsed_s']:.3f} windows/s "
        f"(run_eval_refined's clock over the window loop), loop closing "
        f"{', '.join(f'{m:.3f}' for m in loops.ms())} ms (ICP "
        f"{statistics.median(icp.ms()):.3f} ms a candidate); the whole run "
        f"{run_s:.2f} s; {smi_line}")
    shutil.rmtree(WORLD_DIR, ignore_errors=True)
    return {"hier_train_launches": launches["hier"],
            "crossnorm_train_launches": launches["crossnorm"],
            "world_loop_launches": total}


def option_levels(odom):
    """The consistency loop's levels a step: one per pyramid level under
    ``multi_level_odom`` (the deep-supervision levels and the main
    one), else one."""
    if not (odom.multi_level_odom and odom.dense_predict):
        return 1
    return (len(odom.upsample_strides) if odom.use_deep_supervision
            else 1)


def option_configs(PipelineCfg, overrides, train_config=TRAIN_CONFIG,
                   eval_config=CONFIG):
    """(train, eval) configs of one phase-22 run: the shipped configs
    with the ``odom`` overrides; for training ``loss.warmup_steps`` 1
    and ``train.display_step`` 1, and the FC head at dropout 0 (the
    schema's 0.1 has no rng in train mode, in JAX too)."""
    with open(train_config) as fh:
        tcfg = PipelineCfg.from_json(fh.read())
    with open(eval_config) as fh:
        ecfg = PipelineCfg.from_json(fh.read())
    t_odom = dict(overrides, **({"dropout": 0.0}
                                if overrides.get("dense_predict") is False
                                else {}))
    tcfg = tcfg.replace(
        odom=dataclasses.replace(tcfg.odom, **t_odom),
        loss=dataclasses.replace(tcfg.loss,
                                 warmup_steps=SMOKE_WARMUP_STEPS),
        train=dataclasses.replace(tcfg.train, display_step=1))
    ecfg = ecfg.replace(odom=dataclasses.replace(ecfg.odom, **overrides))
    return tcfg, ecfg


def option_phases(rb_ops, frames, cli, Trainer, counted, reset_counts,
                  counts, evaluate, dev, smi_line, np, torch,
                  runs=OPTION_RUNS, train_config=TRAIN_CONFIG,
                  eval_config=CONFIG, pair_hw=OPTION_PAIR_HW,
                  dense_grids=None):
    """Phase 22: every BEV-net option of the schema and DenseMiddleCov.
    Each of ``runs`` (name, odom overrides, train steps, eval windows)
    trains through the CLI's train verb at ``option_configs``' train
    config (each step's launches against ``predicted_launches``, B3
    once a level), times a post-warmup step (peak memory), evaluates
    its checkpoint through the evaluate verb (``evaluate(name,
    model_dir, kernel, cfg)``, phase 14's checks) where it has eval
    windows, and streams the scans from it at the eval config; the FC
    head's train step at the schema's dropout raises.  Then each run's
    BEV net, f32, on one (1, H, W, 256) pair input (``pair_hw``), card
    against CPU; and DenseMiddleCov at the train config's grid (or
    ``dense_grids[0]``): one forward and backward on a scan's voxel
    features, then card against CPU in f32 at a small grid
    (``dense_grids[1]``).  Returns each path's launches by kernel."""
    from rslo_tpu_torch.config.schema import PipelineCfg, grid_size
    from rslo_tpu_torch.data.prepare import prepare_example, voxelizer_config
    from rslo_tpu_torch.eval.streaming import StreamingOdometry
    from rslo_tpu_torch.geometry import np_compose_pose
    from rslo_tpu_torch.models.bev_net import DropoutRngError
    from rslo_tpu_torch.models.middle_dense import DenseMiddleCov
    from rslo_tpu_torch.models.net import OdomNet
    from rslo_tpu_torch.train import loop as train_loop
    from rslo_tpu_torch.train.step import train_step
    shutil.rmtree(OPTIONS_DIR, ignore_errors=True)
    os.makedirs(OPTIONS_DIR)
    launches = {}
    bev_nets = []
    for name, overrides, n_steps, windows in runs:
        tcfg, ecfg = option_configs(PipelineCfg, overrides, train_config,
                                    eval_config)
        run_dir = os.path.join(OPTIONS_DIR, name)
        cfg_path = os.path.join(OPTIONS_DIR, f"{name}_train.json")
        with open(cfg_path, "w") as fh:
            fh.write(tcfg.to_json())
        levels = option_levels(tcfg.odom)
        # -- 22a. the train verb ------------------------------------------
        reset_counts()
        t0 = time.perf_counter()
        with StepRecorder(train_loop, counts, torch) as rec:
            state = cli.main(["train", "--config", cfg_path, "--model_dir",
                              run_dir, "--synthetic", "--steps",
                              str(n_steps)])
        torch.cuda.synchronize()
        verb_s = time.perf_counter() - t0
        launches[f"{name}_train_launches"] = total = counts()
        if state.step != n_steps or len(rec.records) != n_steps:
            fail(f"{name}: the train verb ended at {state.step}, "
                 f"{len(rec.records)} steps recorded")
        for k, (warm, got, ms) in enumerate(rec.records):
            want = predicted_launches(rb_ops, tcfg, warm, levels=levels)
            say(f"[{name} train] step {k} "
                f"({'warmup' if warm else 'post-warmup'}): {ms:.3f} ms "
                f"(host clock, synchronized), launches {got}")
            if warm != (k <= tcfg.loss.warmup_steps) or got != want:
                fail(f"{name} train step {k}: launches {got}, predicted "
                     f"{want} ({levels} consistency levels)")
        if {k: sum(c[k] for _, c, _ in rec.records) for k in counted} != \
                total:
            fail(f"{name} train verb: launches outside the steps: {total}")
        # a post-warmup step at the trained weights: time, peak memory
        tr = Trainer(tcfg, run_dir, dev)
        st = tr.init_state()
        torch.cuda.synchronize()
        live_mib = torch.cuda.memory_allocated(dev) / 2 ** 20
        torch.cuda.reset_peak_memory_stats(dev)
        train_step(st, rec.batch, tcfg, tr.optimizer, warmup=False)
        step_ms = median_ms(lambda: train_step(
            st, rec.batch, tcfg, tr.optimizer, warmup=False), 3, torch)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        say(f"[time] {name} train step, full width, 3 frames, post-warmup: "
            f"{step_ms:.3f} ms (median of 3 after one warm-up step, host "
            f"clock); peak device memory {peak:.1f} MiB "
            f"({peak - live_mib:.1f} MiB above the {live_mib:.1f} live); "
            f"the verb's {n_steps} steps in {verb_s:.2f} s; {smi_line}")
        tr.logger.close()
        del tr, st
        if overrides.get("dense_predict") is False:
            # the FC head at the schema's dropout in train mode: no rng
            dcfg = tcfg.replace(odom=dataclasses.replace(
                tcfg.odom, dropout=ecfg.odom.dropout))
            tr = Trainer(dcfg, run_dir, dev)
            st = tr.init_state()
            try:
                train_step(st, rec.batch, dcfg, tr.optimizer, warmup=False)
            except DropoutRngError as e:
                say(f"[{name}] a train step at dropout "
                    f"{dcfg.odom.dropout} raises, as in JAX: {e}")
            else:
                fail(f"{name}: a train step at dropout "
                     f"{dcfg.odom.dropout} ran")
            finally:
                tr.logger.close()
            del tr, st
        # -- 22b. the evaluate verb -----------------------------------------
        if windows:
            launches[f"{name}_eval_launches"] = evaluate(
                name, run_dir, "gather_matmul", ecfg)
        # -- 22c. streaming from the checkpoint ---------------------------
        tr = Trainer(ecfg, run_dir, dev)
        net = tr.init_state().model.eval()
        tr.logger.close()
        stream = StreamingOdometry(net, ecfg, dev)
        reset_counts()
        for scan in frames:
            stream.push(scan)
        torch.cuda.synchronize()
        launches[f"{name}_stream_launches"] = got = counts()
        poses = np.stack(stream.trajectory)
        want = dict.fromkeys(counted, 0)
        want["gather_matmul"] = ENCODER_CONVS * len(frames)
        say(f"[{name} stream] {len(frames)} scans, launches {got}; last "
            f"pose {np.array2string(poses[-1], precision=5)}")
        if got != want:
            fail(f"{name} stream: launches {got} != {want}")
        if poses.shape != (len(frames), 7) or not np.isfinite(poses).all():
            fail(f"{name} stream: bad trajectory {poses.shape}: {poses}")
        pts = torch.as_tensor(np.stack(frames[:2]), device=dev)
        ex = prepare_example(pts, torch.ones(pts.shape[:2], dtype=bool,
                                             device=dev),
                             voxelizer_config(ecfg), mean_mode=True)
        with torch.no_grad():
            two = net(ex)["odometry"][0].cpu().numpy()
        expect = np_compose_pose(poses[0][None], two[None])[0]
        say(f"[{name} stream] pose after scan 2 "
            f"{np.array2string(poses[1], precision=6)} vs two-frame forward "
            f"{np.array2string(expect, precision=6)}; max |diff| "
            f"{np.abs(poses[1] - expect).max():.3e}")
        if not np.allclose(poses[1], expect, **POSE_TOL):
            fail(f"{name} stream: pose after scan 2 != two-frame forward")
        stream = StreamingOdometry(net, ecfg, dev)
        for scan in frames[:3]:                     # warm-up
            stream.push(scan)
        scans = iter(frames * 3)
        stream_ms = median_ms(lambda: stream.push(next(scans)), 10, torch)
        say(f"[time] {name} streaming {stream_ms:.3f} ms/scan "
            f"({1e3 / stream_ms:.2f} scans/s), median of 10 after warm-up; "
            f"{smi_line}")
        bev_nets.append((name, ecfg))
        del net, stream
        shutil.rmtree(run_dir, ignore_errors=True)

    # -- 22d. each variant's BEV net, f32, card against CPU -----------------
    rng = np.random.default_rng(SEED)
    for name, ecfg in bev_nets:
        cfg32 = ecfg.replace(odom=dataclasses.replace(ecfg.odom,
                                                      compute_dtype="fp32"))
        gen = torch.Generator().manual_seed(SEED)
        bev = OdomNet(cfg32, gen).bev_net
        randomize_bn(bev, gen)
        x = rng.normal(size=(1,) + tuple(pair_hw) +
                       (2 * cfg32.odom.num_input_features,))
        x[:, rng.random(tuple(pair_hw)) < 0.4] = 0.0
        x = torch.as_tensor(x.astype(np.float32))
        with torch.no_grad():
            cpu_out = bev.eval()(x)
            card_out = bev.to(dev)(x.to(dev))
        pairs = [(k, card_out[k], cpu_out[k]) for k in
                 ("odometry", "tq_map", "t_conf", "q_conf")]
        pairs += [(f"pyramid[{i}].{part}", a[j], b[j])
                  for i, (a, b) in enumerate(zip(card_out["pyramid"],
                                                 cpu_out["pyramid"]))
                  for j, part in enumerate(("map", "mask"))]
        pairs += [(f"odometry_levels[{i}]", a, b) for i, (a, b) in enumerate(
            zip(card_out.get("odometry_levels", []),
                cpu_out.get("odometry_levels", [])))]
        worst = []
        for key, a, b in pairs:
            a, b = a.cpu().numpy(), b.numpy()
            if a.shape != b.shape:
                fail(f"{name}: the f32 BEV net's {key} has the shape "
                     f"{a.shape} on the card, {b.shape} on the CPU")
            err, top = np.abs(a - b), np.abs(b).max()
            worst.append(f"{key} {err.max():.2e} (max |cpu| {top:.2e})")
            if not (err <= BEV_CPU_TOL * (np.abs(b) + min(1.0, top))).all():
                fail(f"{name}: the f32 BEV net's {key} on the card != the "
                     f"CPU's (max |diff| {err.max():.3e}, max |cpu| "
                     f"{top:.3e}, tolerance {BEV_CPU_TOL} * (|cpu| + "
                     f"min(1, max |cpu|)))")
        say(f"[cpu-ref] {name} BEV net, f32, one {tuple(x.shape)} pair: "
            f"card vs CPU within {BEV_CPU_TOL} * (|cpu| + min(1, max "
            f"|cpu|)); max |diff| " + ", ".join(worst))
        del bev

    # -- 22e. DenseMiddleCov: the shipped grid on the card; card vs CPU ------
    tcfg, _ = option_configs(PipelineCfg, {}, train_config, eval_config)
    nx, ny, nz = grid_size(tcfg.voxelizer)
    full, small = dense_grids or ((nz + 1, ny, nx), DENSE_GRID_SMALL)
    ex = prepare_example(torch.as_tensor(frames[0][None], device=dev),
                         torch.ones((1, len(frames[0])), dtype=bool,
                                    device=dev),
                         voxelizer_config(tcfg), mean_mode=True)
    fargs = (ex["voxel_features"][0], ex["coords"][0], ex["voxel_mask"][0])
    dense = DenseMiddleCov(tcfg.middle, full)
    dense.reset_parameters(torch.Generator().manual_seed(SEED))
    dense = dense.to(dev).train()

    def fwd_bwd():
        bev, cov = dense(*fargs)
        loss = bev.square().mean() + cov.square().mean()
        loss.backward()
        return bev, cov, loss

    torch.cuda.synchronize()
    live_mib = torch.cuda.memory_allocated(dev) / 2 ** 20
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    bev, cov, loss = fwd_bwd()                              # warm-up
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    if any(counts().values()):
        fail(f"DenseMiddleCov launched a kernel of B1-B5: {counts()}")
    grads_ok = all(torch.isfinite(p.grad).all() for p in dense.parameters())
    n_vox = int(fargs[2].sum())
    if not (torch.isfinite(bev).all() and torch.isfinite(cov).all() and
            grads_ok and math.isfinite(float(loss.detach()))):
        fail("DenseMiddleCov: non-finite output or gradient at the "
             "shipped grid")
    train_ms = event_us(fwd_bwd, 3, torch) / 1e3
    with torch.no_grad():
        dense.eval()
        eval_ms = event_us(lambda: dense(*fargs), 3, torch) / 1e3
    say(f"[dense middle] DenseMiddleCov at the grid {full} (nz+1, ny, nx), "
        f"channels {tuple(tcfg.middle.channels)}, {n_vox} voxels of one "
        f"scan: BEV {tuple(bev.shape)}, cov {tuple(cov.shape)}; finite "
        f"outputs and gradients; forward + backward {train_ms:.3f} ms, "
        f"eval forward {eval_ms:.3f} ms (CUDA events, each the mean of 3 "
        f"calls after 3 warm-up calls); "
        f"peak device memory {peak:.1f} MiB ({peak - live_mib:.1f} above "
        f"the {live_mib:.1f} live); no kernel of B1-B5 (cuDNN conv3d); "
        f"{smi_line}")
    del dense, bev, cov, loss
    torch.cuda.empty_cache()
    # the scan's voxels in a window of the small grid's size around the
    # sensor (the middle of the full grid), moved to the window's origin
    origin = torch.tensor([0, (full[1] - small[1]) // 2,
                           (full[2] - small[2]) // 2], device=dev)
    rel = fargs[1] - origin
    keep = fargs[2] & (rel[:, 1] >= 0) & (rel[:, 1] < small[1]) & \
        (rel[:, 2] >= 0) & (rel[:, 2] < small[2])
    sargs = (fargs[0][keep], rel[keep].to(fargs[1].dtype), fargs[2][keep])
    if not int(keep.sum()):
        fail(f"DenseMiddleCov: no voxel of the scan in the {small} window")
    outs = {}
    for where in (torch.device("cpu"), dev):
        small_net = DenseMiddleCov(tcfg.middle, small, torch.float32)
        small_net.reset_parameters(torch.Generator().manual_seed(SEED))
        randomize_bn(small_net, torch.Generator().manual_seed(SEED))
        small_net = small_net.to(where).train()
        bev, cov = small_net(*(a.to(where) for a in sargs))
        (bev.square().mean() + cov.square().mean()).backward()
        outs[where.type] = {"bev": bev.detach(), "cov": cov.detach(), **{
            n: p.grad for n, p in small_net.named_parameters()}}
    # the bias of a conv that a train-mode BN follows has a zero gradient
    # in exact arithmetic: on each side it is f32 noise, held below
    # DENSE_ZERO_GRAD of the largest gradient of all
    layers = [n for n, _ in small_net.named_children()]
    bn_fed = {f"{a}.bias" for a, b in zip(layers, layers[1:])
              if b.startswith("DenseMaskedBN")}
    top = max(float(g.abs().max()) for k, g in outs["cpu"].items()
              if k not in ("bev", "cov"))
    worst = zero = 0.0
    for key, b in outs["cpu"].items():
        a = outs[dev.type][key].cpu()
        if key in bn_fed:
            zero = max(zero, float(a.abs().max()), float(b.abs().max()))
            continue
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        worst = max(worst, err / max(scale, 1e-30))
        if not err <= DENSE_CPU_TOL * scale:
            fail(f"DenseMiddleCov f32 at {small}: {key} card vs CPU max "
                 f"|diff| {err:.3e} > {DENSE_CPU_TOL} * {scale:.3e}")
    if not zero <= DENSE_ZERO_GRAD * top:
        fail(f"DenseMiddleCov f32 at {small}: a BN-fed conv bias has a "
             f"gradient of {zero:.3e} (> {DENSE_ZERO_GRAD} * {top:.3e})")
    say(f"[cpu-ref] DenseMiddleCov f32 at the grid {small}, "
        f"{int(sargs[2].sum())} voxels, train mode: BEV, cov and "
        f"{len(outs['cpu']) - 2 - len(bn_fed)} gradients card vs CPU, the "
        f"worst max |diff| / max |cpu| {worst:.3e} (<= {DENSE_CPU_TOL}); "
        f"the {len(bn_fed)} BN-fed conv biases' gradients at most "
        f"{zero:.3e} on either side, {zero / top:.2e} of the largest "
        f"gradient (<= {DENSE_ZERO_GRAD})")
    shutil.rmtree(OPTIONS_DIR, ignore_errors=True)
    return launches


# -- phase 23: data-parallel training and evaluation ------------------------

def free_port():
    """A free TCP port on this host for a rendezvous on localhost."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tiny_config(PipelineCfg):
    """tests/test_model.py's tiny config in float32 with ``sync_bn`` in
    the sparse middle's encoder and no BN in the BEV net, weight decay 10
    and 40 steps: tests/test_torch_dp_train.py's ``dp_cfg`` (which holds
    this against it), in the port's schema."""
    cfg = PipelineCfg()
    rep = dataclasses.replace
    return cfg.replace(
        voxelizer=rep(cfg.voxelizer,
                      point_cloud_range=(-6.4, -6.4, -0.8, 6.4, 6.4, 0.8),
                      voxel_size=(0.1, 0.1, 0.04), max_points_per_voxel=4,
                      max_voxels=2048),
        middle=rep(cfg.middle, level_capacities=(2048, 2048, 1024, 512),
                   channels=(8, 8, 16, 16), bn_type="sync_bn",
                   conv_dtype="f32"),
        odom=rep(cfg.odom, num_input_features=32, layer_nums=(1, 1, 1),
                 num_filters=(16, 16, 32), num_upsample_filters=(16, 16, 16),
                 bn_type="none", compute_dtype="fp32"),
        loss=rep(cfg.loss, max_loss_points=2048),
        optimizer=rep(cfg.optimizer, weight_decay=10.0),
        train=rep(cfg.train, steps=40))


def tiny_batches(np, L=3, n=4000, steps=DP_STEPS, ranks=DP_RANKS):
    """steps x ranks 3-frame windows at the tiny config's range (the same
    base cloud shifted a little a frame, as tests/torch_port_helpers.py's
    ``tiny_scans``), with small pair motions."""
    out = []
    for k in range(steps * ranks):
        rng = np.random.default_rng(40 + k)
        base = rng.uniform(-6, 6, size=(n, 2)).astype(np.float32)
        scans = []
        for t in range(L):
            scans.append(np.concatenate(
                [base + t * 0.05, rng.uniform(-0.7, 0.7, (n, 1)),
                 rng.uniform(0, 1, (n, 1)), rng.normal(size=(n, 3))],
                axis=1).astype(np.float32))
        odom = np.zeros((L * (L - 1) // 2, 7), np.float32)
        odom[:, :3] = rng.normal(0, 0.05, (len(odom), 3))
        odom[:, 3] = 1.0
        out.append({"points": np.stack(scans),
                    "point_mask": np.ones((L, n), bool), "odometry": odom})
    return out


def dp_fuse_inputs(np):
    """Pair motions of a KITTI val sequence's length (DP_FUSE_POSES
    poses, 1 m a frame with a slight yaw) from noisy 3-frame windows:
    (edges, motions, n_poses, weights) for ``fuse_windows_sharded``."""
    from rslo_tpu_torch.geometry.transforms import (np_calc_vo,
                                                    np_compose_pose,
                                                    odom_to_abs_pose)
    from rslo_tpu_torch.pgo.refine import window_pairs_to_edges
    n = DP_FUSE_POSES
    odoms = np.zeros((n, 7), np.float32)
    odoms[:, 3] = 1.0
    odoms[1:, 0] = 1.0
    odoms[1:, 6] = 0.01
    odoms[1:, 3] = np.sqrt(1 - 0.01 ** 2)
    gt = odom_to_abs_pose(odoms)
    rng = np.random.default_rng(SEED + 23)
    offsets = [(0, 1), (0, 2), (1, 2)]
    starts = list(range(0, n - 2))
    preds = np.zeros((len(starts), 3, 7), np.float32)
    for w, s in enumerate(starts):
        for p, (i, j) in enumerate(offsets):
            m = np_calc_vo(gt[s + i][None], gt[s + j][None])[0]
            m[:3] += rng.normal(0, 0.03, 3)
            h = rng.normal(0, 0.0015, 3)
            dq = np.concatenate([[np.sqrt(1 - np.sum(h * h))], h])
            m = np_compose_pose(m[None], np.concatenate(
                [[0, 0, 0], dq])[None])[0]
            preds[w, p] = m
    E, M, W = window_pairs_to_edges(starts, offsets, preds)
    return E, M, n, W


def dp_ba_problem(np, ranks=DP_RANKS):
    """A window BA of DP_BA_POSES poses along x and DP_BA_LANDMARKS
    landmarks, every landmark seen from every pose with 1 cm noise, the
    poses and landmarks perturbed (tests/test_ba.py's problem at the
    runner's ba_points), observations grouped by landmark: (the whole
    problem, each rank's shard with ``obs_lm`` local to it) as numpy
    fields of ``BAProblem``."""
    from rslo_tpu_torch.geometry.transforms import (np_compose_pose,
                                                    np_invert_pose,
                                                    quat_to_matrix_np)
    W, K = DP_BA_POSES, DP_BA_LANDMARKS
    rng = np.random.default_rng(SEED + 24)
    step = np.array([1.0, 0.02, 0.0, np.cos(0.01), 0, 0, np.sin(0.01)],
                    np.float32)
    poses = [np.array([0, 0, 0, 1, 0, 0, 0], np.float32)]
    for _ in range(W - 1):
        poses.append(np_compose_pose(poses[-1][None], step[None])[0])
    gt = np.stack(poses).astype(np.float32)
    lms = rng.uniform(-5, 10, size=(K, 3)).astype(np.float32)
    lms[:, 0] += 2.0
    obs_x = np.zeros((K, W, 3), np.float32)
    for i in range(W):
        inv = np_invert_pose(gt[i])
        obs_x[:, i] = lms @ quat_to_matrix_np(inv[3:]).T + inv[:3]
    obs_x += rng.normal(0, 0.01, obs_x.shape).astype(np.float32)
    poses0 = gt.copy()
    poses0[1:, :3] += rng.normal(0, 0.1, (W - 1, 3))
    lms0 = (lms + rng.normal(0, 0.1, lms.shape)).astype(np.float32)
    obs_p = np.tile(np.arange(W, dtype=np.int32), K)          # lm-major
    obs_l = np.repeat(np.arange(K, dtype=np.int32), W)
    anchor = np.zeros(W, bool)
    anchor[0] = True
    whole = (poses0, lms0, obs_p, obs_l, obs_x.reshape(-1, 3),
             np.ones(K * W, np.float32), anchor)
    per = K // ranks
    shards = []
    for r in range(ranks):
        o = slice(r * per * W, (r + 1) * per * W)
        shards.append((poses0, lms0[r * per:(r + 1) * per], obs_p[o],
                       obs_l[o] - r * per, whole[4][o], whole[5][o],
                       anchor))
    return whole, shards


def replicas_equal(tensors, mesh, torch):
    """True iff every rank holds the same bits in ``tensors`` (the
    elementwise max and min of their 32-bit words over the ranks
    agree)."""
    import torch.distributed as dist
    words = torch.cat([t.detach().float().reshape(-1).view(torch.int32)
                       for t in tensors])
    hi, lo = words.clone(), words.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(torch.equal(hi, lo))


def param_gap(got, want, lr_sum, np):
    """Two runs' parameters after Adam steps: (the largest |difference|,
    the share of entries beyond DP_PARAM_ATOL).  Held as at most 2 x
    sum(lr) (Adam moves an entry by ~lr a step, so two runs whose
    gradient differs in sign at an entry part by up to 2 lr a step) and
    fewer than 2% of the entries beyond DP_PARAM_ATOL
    (tests/test_torch_train_step.py's rule)."""
    worst, loose, total = 0.0, 0, 0
    for k, v in want.items():
        d = np.abs(np.asarray(got[k], np.float64) - np.asarray(v, np.float64))
        worst = max(worst, float(d.max()))
        loose += int(np.sum(d > DP_PARAM_ATOL))
        total += d.size
    return (worst, loose / total,
            worst <= 2 * lr_sum * (1 + 1e-3) and loose < 0.02 * total)


def dp_rank(spec_path):
    """One rank of phase 23b-c, in its own process: joins the gloo group
    on the card, runs its share and writes its results (see
    ``data_parallel_phases``)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from rslo_tpu_torch import cli
    from rslo_tpu_torch.config.schema import PipelineCfg
    from rslo_tpu_torch.eval.runner import run_eval
    from rslo_tpu_torch.models.net import OdomNet
    from rslo_tpu_torch.ops import _build
    from rslo_tpu_torch.pgo.ba import BAProblem, solve_ba_sharded
    from rslo_tpu_torch.pgo.sharded import fuse_windows_sharded
    from rslo_tpu_torch.train import loop as train_loop
    from rslo_tpu_torch.train.distributed import (DataMesh, global_data_mesh,
                                                  initialize_multihost)
    from rslo_tpu_torch.train.loop import Trainer, make_optimizer
    from rslo_tpu_torch.train.state import TrainState
    from rslo_tpu_torch.train.step import train_step

    spec = torch.load(spec_path, weights_only=False)
    rank, dev = spec["rank"], torch.device(spec["device"])
    if dev.type != "cuda":      # a rehearsal of this phase on the CPU
        torch.cuda.synchronize = lambda *a: None
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(4)
    counted = rank_kernels(_build, rank)

    def counts():
        return {k: fn.launches for k, fn in counted.items()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    initialize_multihost(spec["rdv"], spec["world"], rank, device=dev,
                         backend="gloo")
    mesh = global_data_mesh(dev)
    out = {"rank": rank}
    try:
        # -- 23b. Trainer.fit at full width, each rank its own windows ----
        tcfg = PipelineCfg.from_json(spec["train_config"])
        batches = torch.load(spec["batches"], weights_only=False)
        mine = [batches[s * mesh.size + rank] for s in range(DP_STEPS)]
        trainer = Trainer(tcfg, spec["model_dir"], mesh=mesh)
        state = trainer.init_state()
        equal = []

        class Recorder(StepRecorder):
            def __call__(self, state_, batch, *args, **kw):
                res = super().__call__(state_, batch, *args, **kw)
                equal.append(replicas_equal(
                    [*state_.model.state_dict().values(),
                     *state_.alphas.values()], mesh, torch))
                return res

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        before = counts()
        with Recorder(train_loop, counts, torch) as rec:
            state = trainer.fit(iter(mine), state, max_steps=DP_STEPS)
        sync()
        after = counts()
        out["fit"] = dict(
            records=rec.records, equal=equal, history=trainer.history,
            launches={k: after[k] - before[k] for k in after},
            peak_mib=(torch.cuda.max_memory_allocated() / 2 ** 20
                      if dev.type == "cuda" else 0.0))
        # -- run_eval over the ranks on the synthetic val split -----------
        ds = cli._synthetic_dataset(tcfg, "val", n_windows=DP_EVAL_WINDOWS)
        step, preds = trainer.eval_fn(), []

        def recorded(batch):
            o = step(batch)
            preds.append(o)
            return o

        before = counts()
        res = run_eval(recorded, ds, tcfg, None, mesh=mesh)
        sync()
        after = counts()
        out["eval"] = dict(results=res, preds=[p.cpu().numpy()
                                               for p in preds],
                           launches={k: after[k] - before[k]
                                     for k in after})
        trainer.logger.close()
        # -- the sharded pose graph and BA --------------------------------
        E, M, n, wts = dp_fuse_inputs(np)
        sync()
        t0 = time.perf_counter()
        fused = fuse_windows_sharded(E, M, n, wts, mesh=mesh, **DP_FUSE)
        sync()
        out["fuse"] = dict(poses=fused, ms=(time.perf_counter() - t0) * 1e3)
        _, shards = dp_ba_problem(np)
        prob = BAProblem(*(torch.as_tensor(a, device=dev)
                           for a in shards[rank]))
        sync()
        t0 = time.perf_counter()
        poses, lms, cost = solve_ba_sharded(prob, mesh, iters=DP_BA_ITERS)
        sync()
        out["ba"] = dict(poses=poses.cpu().numpy(), landmarks=lms.cpu().numpy(),
                         cost=float(cost),
                         ms=(time.perf_counter() - t0) * 1e3)
        # -- 23c. the tiny config: the card, then the CPU, same group -----
        tiny = tiny_config(PipelineCfg)
        tb = tiny_batches(np)
        out["tiny"] = {}
        for where, m in (("card", mesh),
                         ("cpu", DataMesh(mesh.group, rank, mesh.size,
                                          torch.device("cpu")))):
            net = OdomNet(tiny, torch.Generator().manual_seed(0))
            net = net.to(m.device).train()
            opt = make_optimizer(tiny, net)
            st = TrainState.create(net, opt, {"rot": -2.5, "trans": 0.0})
            steps = []
            for s in range(DP_STEPS):
                b = {k: torch.as_tensor(v, device=m.device)
                     for k, v in tb[s * mesh.size + rank].items()}
                st, metrics = train_step(st, b, tiny, opt, warmup=False,
                                         mesh=m)
                steps.append(dict(
                    metrics={k: float(v) for k, v in metrics.items()},
                    equal=replicas_equal(
                        [*st.model.state_dict().values(),
                         *st.alphas.values()], m, torch)))
            steps[-1]["params"] = {k: v.detach().cpu().numpy()
                                   for k, v in st.trainable().items()}
            out["tiny"][where] = steps
    finally:
        dist.destroy_process_group()
    torch.save(out, spec["out"])


def run_dp_ranks(specs, torch, entry="dp_rank", phase="phase 23"):
    """Start one process a spec (``entry``: ``dp_rank`` or
    ``split_rank``), wait for all (DP_TIMEOUT_S) and return their
    results; a rank that fails or hangs fails the run, and every rank is
    stopped first."""
    procs = []
    for spec in specs:
        path = spec["out"] + ".spec"
        torch.save(spec, path)
        code = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
                "chip_smoke.%s(%r)" % (REPO, entry, path))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        fail(f"{phase}: the ranks did not finish within {DP_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log, spec in zip(procs, logs, specs):
        if p.returncode != 0:
            fail(f"{phase}: rank {spec['rank']} exited {p.returncode}:\n"
                 f"{log[-4000:]}")
    return [torch.load(s["out"], weights_only=False) for s in specs]


def data_parallel_phases(tcfg, batches, history, rb_ops, cli, Trainer,
                         counted, reset_counts, counts, dev, smi_line, np,
                         torch, backend="nccl"):
    """Phase 23: data-parallel training and evaluation
    (``train/distributed.py``), on the one card.  (a) The train verb at
    ``tcfg`` (phase 10's config) under torchrun's environment at world
    size 1, so on a ``backend`` (NCCL) group, fed phase 10's batches:
    each step's loss and ``grad_norm`` against phase 10's, its launches
    against ``predicted_launches``, and the parameters after
    DP_STEPS steps against a one-card ``Trainer.fit`` on the same
    batches; then that trainer's post-warmup step timed with and without
    the group, in turns.  (b) DP_RANKS ranks on the card over gloo (``dp_rank``):
    ``Trainer.fit`` for DP_STEPS steps on phase 10's batches, one a
    rank a step (finite losses, replicas bit-equal after each step, each
    rank's launches a step those of (a)); ``run_eval`` on
    DP_EVAL_WINDOWS windows, each window's odometry against the one-card
    run of rank 0's checkpoint; ``fuse_windows_sharded`` and
    ``solve_ba_sharded`` against their one-process runs.  (c) The same
    ranks at ``tiny_config``: DP_STEPS data-parallel steps on the card
    against the same on the CPU.  Returns the launches of (a) and of
    rank 0's fit in (b)."""
    import torch.distributed as dist
    from rslo_tpu_torch.data import loader as data_loader
    from rslo_tpu_torch.eval.runner import run_eval
    from rslo_tpu_torch.pgo.ba import BAProblem, solve_ba_sharded
    from rslo_tpu_torch.pgo.sharded import fuse_windows_sharded
    from rslo_tpu_torch.train import loop as train_loop
    from rslo_tpu_torch.train.distributed import (global_data_mesh,
                                                  initialize_multihost)
    from rslo_tpu_torch.train.optim import onecycle_lr
    from rslo_tpu_torch.train.step import train_step
    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    lr = onecycle_lr(tcfg.optimizer, tcfg.train.steps)
    lr_sum = sum(float(lr(i)) for i in range(DP_STEPS))

    # -- 23a. the train verb on an NCCL group of one rank -------------------
    cfg_path = os.path.join(DP_DIR, "train_config.json")
    with open(cfg_path, "w") as fh:
        fh.write(tcfg.to_json())

    class PhaseTenBatches:
        """Stands in for ``data.loader.DataLoader`` in the verb: phase
        10's batches, ``device_batch`` windows a batch."""

        def __init__(self, dataset, cfg, device_batch, total_steps, *,
                     train=True, seed=0, last_iter=-1, num_workers=None):
            self.d, self.pos = device_batch, (last_iter + 1) * device_batch

        def __iter__(self):
            while self.pos + self.d <= len(batches):
                rows = batches[self.pos:self.pos + self.d]
                self.pos += self.d
                b = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
                yield dict(b, meta=[(-1, ())] * self.d)

        def close(self):
            pass

    env = dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    saved_env = {k: os.environ.get(k) for k in env}
    seen, fit, loader_cls = {}, Trainer.fit, data_loader.DataLoader

    def recording_fit(self, *a, **kw):
        seen["trainer"] = self
        seen["backend"] = dist.get_backend(self.mesh.group)
        seen["size"] = self.mesh.size
        return fit(self, *a, **kw)

    os.environ.update(env)
    Trainer.fit, data_loader.DataLoader = recording_fit, PhaseTenBatches
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        with StepRecorder(train_loop, counts, torch) as rec:
            vstate = cli.main(["train", "--config", cfg_path, "--model_dir",
                               os.path.join(DP_DIR, "nccl"), "--synthetic",
                               "--steps", str(tcfg.train.steps),
                               "--leg_until", str(DP_STEPS)])
    finally:
        Trainer.fit, data_loader.DataLoader = fit, loader_cls
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.synchronize()
    nccl_launches = counts()
    nccl_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if dist.is_initialized():
        fail("23a: the train verb left its process group")
    if seen.get("backend") != backend or seen.get("size") != 1:
        fail(f"23a: the verb trained on a {seen.get('backend')} group of "
             f"{seen.get('size')} ranks, expected {backend} at world 1")
    if vstate.step != DP_STEPS or len(rec.records) != DP_STEPS:
        fail(f"23a: the verb ended at step {vstate.step}, "
             f"{len(rec.records)} steps recorded")
    want_steps = []
    for k, (warm, got, ms) in enumerate(rec.records):
        want = predicted_launches(rb_ops, tcfg, warm)
        want_steps.append(want)
        row, ref = seen["trainer"].history[k][1], history[k][1]
        say(f"[dp nccl] step {k} ({'warmup' if warm else 'post-warmup'}): "
            f"loss {row['loss']:.6f} (phase 10 {ref['loss']:.6f}), "
            f"grad_norm {row['grad_norm']:.5f} ({ref['grad_norm']:.5f}), "
            f"{ms:.3f} ms (host clock, synchronized), launches {got}")
        if got != want:
            fail(f"23a step {k}: launches {got}, predicted {want}")
        for key in ("loss", "grad_norm"):
            if not np.allclose(row[key], ref[key], **TRAIN_LOSS_TOL):
                fail(f"23a step {k}: {key} {row[key]} != phase 10's "
                     f"{ref[key]} within {TRAIN_LOSS_TOL}")
    if {k: sum(c[k] for _, c, _ in rec.records) for k in counted} != \
            nccl_launches:
        fail(f"23a: launches outside the steps: {nccl_launches}")
    one = Trainer(tcfg, os.path.join(DP_DIR, "one"), dev)
    ostate = one.fit(iter(batches[:DP_STEPS]), one.init_state(),
                     max_steps=DP_STEPS)
    one.logger.close()
    worst, share, ok = param_gap(
        {k: v.detach().cpu().numpy() for k, v in vstate.trainable().items()},
        {k: v.detach().cpu().numpy() for k, v in ostate.trainable().items()},
        lr_sum, np)
    say(f"[dp nccl] after {DP_STEPS} steps the verb's parameters vs a "
        f"one-card Trainer.fit on the same batches: max |diff| {worst:.3e} "
        f"(2 x sum(lr) = {2 * lr_sum:.3e}), {share:.4%} of the entries "
        f"beyond {DP_PARAM_ATOL}; peak memory {nccl_peak:.1f} MiB; "
        f"{smi_line}")
    if not ok:
        fail("23a: the verb's parameters left the one-card run's bound")
    # the post-warmup step with and without the group of one rank, in
    # turns, on the one-card trainer: what the collectives cost there
    env["MASTER_PORT"] = str(free_port())
    os.environ.update(env)
    try:
        initialize_multihost(device=dev, backend=backend)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    mesh1 = global_data_mesh(dev)
    gbatch = {k: torch.as_tensor(v, device=dev) for k, v in
              batches[DP_STEPS].items()}

    def one_step(m):
        train_step(ostate, gbatch, tcfg, one.optimizer, warmup=False,
                   mesh=m)

    one_step(None)
    one_step(mesh1)
    turns = {"none": [], backend: []}
    for _ in range(3):
        for name, m in (("none", None), (backend, mesh1), (backend, mesh1),
                        ("none", None)):
            turns[name].append(median_ms(lambda: one_step(m), 1, torch))
    prof = {name: profile_device([lambda: one_step(m)], torch)
            for name, m in (("none", None), (backend, mesh1))}
    dist.destroy_process_group()
    say(f"[dp nccl] post-warmup step, one card, in turns (median of 6 "
        f"each): without a group {statistics.median(turns['none']):.3f} "
        f"ms, on the {backend} group of one rank "
        f"{statistics.median(turns[backend]):.3f} ms (host clock, "
        f"synchronized)" + "".join(
            f"; {name}: {p['device_ms']:.3f} ms of device work in "
            f"{p['ops']:.0f} device ops" for name, p in prof.items()
            if p is not None) + f"; {smi_line}")
    del one, ostate, vstate, seen, gbatch

    # -- 23b-c. two ranks on the card over gloo ------------------------------
    bpath = os.path.join(DP_DIR, "batches.pt")
    torch.save(batches[:DP_STEPS * DP_RANKS], bpath)
    rdv = f"file://{os.path.join(DP_DIR, 'rendezvous')}"
    t0 = time.perf_counter()
    ranks = run_dp_ranks([dict(
        rank=r, world=DP_RANKS, rdv=rdv, device=str(dev), batches=bpath,
        train_config=tcfg.to_json(), model_dir=os.path.join(DP_DIR, "gloo"),
        out=os.path.join(DP_DIR, f"rank{r}.pt")) for r in range(DP_RANKS)],
        torch)
    say(f"[dp gloo] {DP_RANKS} ranks on the one card: "
        f"{time.perf_counter() - t0:.1f} s, process start and library "
        f"loads included")
    for r, res in enumerate(ranks):
        fit_ = res["fit"]
        for k, (warm, got, ms) in enumerate(fit_["records"]):
            row = fit_["history"][k][1]
            say(f"[dp gloo] rank {r} step {k}: loss {row['loss']:.6f}, "
                f"grad_norm {row['grad_norm']:.5f}, {ms:.3f} ms a step "
                f"(host clock; gloo stages every all-reduce through the "
                f"host), launches {got}; replicas bit-equal "
                f"{fit_['equal'][k]}")
            if got != want_steps[k]:
                fail(f"23b rank {r} step {k}: launches {got}, 23a's "
                     f"{want_steps[k]}")
            if not all(math.isfinite(v) for v in row.values()):
                fail(f"23b rank {r} step {k}: non-finite metrics {row}")
        if not all(fit_["equal"]) or len(fit_["equal"]) != DP_STEPS:
            fail(f"23b rank {r}: replicas not bit-equal after each step: "
                 f"{fit_['equal']}")
        say(f"[dp gloo] rank {r}: peak memory {fit_['peak_mib']:.1f} MiB "
            f"(two ranks share the card); {smi_line}")
    for (_, a), (_, b) in zip(ranks[0]["fit"]["history"],
                              ranks[1]["fit"]["history"]):
        a, b = ({k: v for k, v in row.items() if k != "steptime_ms"}
                for row in (a, b))
        if a != b:
            fail(f"23b: the ranks' averaged metrics differ: {a} vs {b}")
    # run_eval: each window's odometry against one card on rank 0's
    # checkpoint
    tr = Trainer(tcfg, os.path.join(DP_DIR, "gloo"), dev)
    tr.init_state()
    step, one_preds = tr.eval_fn(), []

    def recorded(batch):
        o = step(batch)
        one_preds.append(o)
        return o

    res_one = run_eval(recorded, cli._synthetic_dataset(
        tcfg, "val", n_windows=DP_EVAL_WINDOWS), tcfg, None)
    tr.logger.close()
    one_preds = [p.cpu().numpy() for p in one_preds]
    worst, bitwise = 0.0, True
    for r, res in enumerate(ranks):
        want = dict.fromkeys(counted, 0)
        n_mine = len(res["eval"]["preds"])
        want["gather_matmul"] = n_mine * 2 * ENCODER_CONVS
        if res["eval"]["launches"] != want:
            fail(f"23b rank {r}: run_eval launched "
                 f"{res['eval']['launches']}, expected {want}")
        for j, p in enumerate(res["eval"]["preds"]):
            w = min(j * DP_RANKS + r, DP_EVAL_WINDOWS - 1)
            d = float(np.abs(p - one_preds[w]).max())
            worst, bitwise = max(worst, d), bitwise and d == 0.0
            if not np.allclose(p, one_preds[w], **POSE_TOL):
                fail(f"23b rank {r}: window {w} odometry off the one-card "
                     f"run by {d:.3e}")
        got = {k: v for k, v in res["eval"]["results"].items()
               if k != "_meta"}
        ref = {k: v for k, v in res_one.items() if k != "_meta"}
        if json.dumps(got, sort_keys=True) != json.dumps(ref,
                                                         sort_keys=True) \
                and bitwise:
            fail(f"23b rank {r}: run_eval's metrics differ from one card's "
                 f"on bit-equal odometry")
    fps = [res["eval"]["results"]["_meta"]["frames_per_s"] for res in ranks]
    say(f"[dp gloo] run_eval over {DP_RANKS} ranks, {DP_EVAL_WINDOWS} "
        f"windows: every window's odometry within {POSE_TOL} of one card's "
        f"(max |diff| {worst:.3e}, bit-equal {bitwise}); frames/s "
        f"{fps} (rank 0's run_eval clock) against one card's "
        f"{res_one['_meta']['frames_per_s']:.3f}; {smi_line}")
    # the sharded pose graph and BA against one process
    E, M, n, wts = dp_fuse_inputs(np)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused_one = fuse_windows_sharded(E, M, n, wts, device=dev, **DP_FUSE)
    torch.cuda.synchronize()
    fuse_ms = (time.perf_counter() - t0) * 1e3
    whole, _ = dp_ba_problem(np)
    ba_one = solve_ba_sharded(BAProblem(*(torch.as_tensor(a, device=dev)
                                          for a in whole)), None,
                              iters=DP_BA_ITERS)
    if not np.array_equal(ranks[0]["fuse"]["poses"],
                          ranks[1]["fuse"]["poses"]):
        fail("23b: the ranks' fused trajectories differ")
    got = ranks[0]["fuse"]["poses"]
    dt, dq = pose_diff(got, fused_one, np)
    ok = (np.allclose(got[:, :3], fused_one[:, :3], **DP_FUSE_TOL) and
          dq <= DP_FUSE_Q_TOL)
    say(f"[dp gloo] fuse_windows_sharded, {n} poses in "
        f"{pgo_windows(n, DP_FUSE)} windows of "
        f"{DP_FUSE['window']}: {DP_RANKS} ranks vs one process max |dt| "
        f"{dt:.3e} m, |dq| {dq:.3e}; {ranks[0]['fuse']['ms']:.1f} ms "
        f"(rank 0, host clock, the gather host-staged) vs "
        f"{fuse_ms:.1f} ms on one card; {smi_line}")
    if not ok:
        fail(f"23b: fuse_windows_sharded off the one-process run beyond "
             f"{DP_FUSE_TOL} / {DP_FUSE_Q_TOL}")
    bp, bl = ranks[0]["ba"]["poses"], ranks[0]["ba"]["landmarks"]
    for k in ("poses", "landmarks"):
        if not np.array_equal(ranks[0]["ba"][k], ranks[1]["ba"][k]):
            fail(f"23b: the ranks' BA {k} differ")
    dpose = float(np.abs(bp - ba_one[0].cpu().numpy()).max())
    dlm = float(np.abs(bl - ba_one[1].cpu().numpy()).max())
    say(f"[dp gloo] solve_ba_sharded, {DP_BA_POSES} poses and "
        f"{DP_BA_LANDMARKS} landmarks in {DP_RANKS} shards: max |diff| vs "
        f"one process poses {dpose:.3e}, landmarks {dlm:.3e}; "
        f"{ranks[0]['ba']['ms']:.1f} ms (rank 0, host clock); {smi_line}")
    if dpose > BA_TOL or dlm > DP_LM_TOL:
        fail(f"23b: solve_ba_sharded off the one-process run beyond "
             f"{BA_TOL} / {DP_LM_TOL}")
    # -- 23c. the tiny config, the card against the CPU ---------------------
    tiny = tiny_config(type(tcfg))
    tiny_lr = onecycle_lr(tiny.optimizer, tiny.train.steps)
    for r, res in enumerate(ranks):
        card, cpu = res["tiny"]["card"], res["tiny"]["cpu"]
        for k in range(DP_STEPS):
            for where, s in (("card", card[k]), ("cpu", cpu[k])):
                if not s["equal"]:
                    fail(f"23c rank {r} step {k} ({where}): replicas differ")
            for key, v in cpu[k]["metrics"].items():
                if not np.allclose(card[k]["metrics"][key], v,
                                   **TRAIN_LOSS_TOL):
                    fail(f"23c rank {r} step {k}: {key} card "
                         f"{card[k]['metrics'][key]} vs cpu {v}")
        say(f"[dp tiny] rank {r}: {DP_STEPS} data-parallel steps at the "
            f"tiny config, card vs CPU: loss "
            f"{card[-1]['metrics']['loss']:.6f} / "
            f"{cpu[-1]['metrics']['loss']:.6f}, grad_norm "
            f"{card[-1]['metrics']['grad_norm']:.5f} / "
            f"{cpu[-1]['metrics']['grad_norm']:.5f} (held to "
            f"{TRAIN_LOSS_TOL})")
    worst, share, ok = param_gap(ranks[0]["tiny"]["card"][-1]["params"],
                                 ranks[0]["tiny"]["cpu"][-1]["params"],
                                 sum(float(tiny_lr(i))
                                     for i in range(DP_STEPS)), np)
    say(f"[dp tiny] parameters after {DP_STEPS} steps, card vs CPU: max "
        f"|diff| {worst:.3e}, {share:.4%} beyond {DP_PARAM_ATOL}")
    if not ok:
        fail("23c: the card's parameters left the CPU run's bound")
    shutil.rmtree(DP_DIR, ignore_errors=True)
    return {"dp_verb_nccl_launches": nccl_launches,
            "dp_fit_gloo_launches": ranks[0]["fit"]["launches"]}


# -- phase 24: the BEV stage split over ranks; the bench; small modules -----

SPLIT_DIR = os.path.join(REPO, "build", "smoke_split")
SPLIT_RANKS = 4
# (name, grid (space, model), the split axes): SP over 2 (the 2 x 2
# grid's columns), TP over 2 (its rows), SP x TP over 2 x 2, and SP over
# 4 on the shipped 176 columns' uneven 48/48/40/40
SPLIT_LAYOUTS = (("sp2", (2, 2), ("space",)), ("tp2", (2, 2), ("model",)),
                 ("sptp", (2, 2), ("space", "model")),
                 ("sp4", (4, 1), ("space",)))
SPLIT_TIMED = 3            # timed forwards a layout, after the checked one
SPLIT_KEYS = ("odometry", "tq_map", "t_conf", "q_conf", "input_mask")
# each map's max |split - one process| over its max |one process|: cuDNN
# may pick other algorithms at a rank's width, which moves the rounding;
# in bf16 a flipped rounding (2^-8) passes through ~30 conv layers, in
# f32 (TF32 off) one of 2^-24
SPLIT_REL_TOL = {"bf16": 2.0 ** -5, "f32": 1e-4}
# what the bf16 bound must see: the SP4 forward with every rank padding
# its own edges (the split without halos), read by its worst map
NO_HALO = "sp4 without halos"
# the bench verb's B1 launches (rulebook, the schema's default engine):
# bench_middle's first forward and its two chains of 16 (2 frames, 14
# convs without the covariance decoder), bench_streaming's 1 + 4 streams
# of 9 frames; the pillar stages launch none
BENCH_B1 = ENCODER_CONVS * (2 * (1 + 2 * 16) + (1 + 4) * 9)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "middle",
              "sparse_fps", "sparse_engine", "streaming_fps",
              "sparse_streaming_fps"}
VOX_MEAN_TOL = dict(rtol=1e-5, atol=1e-4)   # CUDA's index_add_ order
MEANSHIFT_POINTS = 3000
MEANSHIFT_TOL = dict(rtol=1e-4, atol=1e-4)


def kernel_wrappers():
    """The port's counted kernel wrappers by name (each counts its
    launches in ``.launches``)."""
    from rslo_tpu_torch.ops import band_conv as bc
    from rslo_tpu_torch.ops.chamfer import nn_search
    from rslo_tpu_torch.ops.dma_gather import (gather_matmul,
                                               gather_matmul_dgrad,
                                               row_gather)
    return {"gather_matmul": gather_matmul,
            "gather_matmul_dgrad": gather_matmul_dgrad,
            "row_gather": row_gather, "nn_search": nn_search,
            "band_matmul": bc.band_matmul,
            "band_matmul_dgrad": bc.band_matmul_dgrad,
            "band_gather": bc.band_gather}


def rank_kernels(_build, rank):
    """In a rank process: ``kernel_wrappers()``, with ``_build.build``
    made to load the parent's build and refuse to compile."""
    build = _build.build

    def built_only(name):
        if not _build.library_path(name).exists():
            raise RuntimeError(f"rank {rank}: {name} is not built; the "
                               f"ranks load the parent's build")
        return build(name)

    _build.build = built_only
    return kernel_wrappers()


def split_rank(spec_path):
    """One rank of phase 24a-d, in its own process: joins the gloo group
    on the card, forms the 4 x 1 and 2 x 2 grids, and runs each layout
    of SPLIT_LAYOUTS in each precision: one forward with the launch
    counts set to 0 just before and read just after, then SPLIT_TIMED
    forwards on the host clock (see ``split_phases``)."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from rslo_tpu_torch.config.schema import PipelineCfg
    from rslo_tpu_torch.models.net import OdomNet
    from rslo_tpu_torch.ops import _build
    from rslo_tpu_torch.parallel.spatial import make_spatial_forward
    from rslo_tpu_torch.parallel.tensor import (make_model_forward,
                                                make_spatial_model_forward)
    from rslo_tpu_torch.train.distributed import initialize_multihost
    from rslo_tpu_torch.utils.mesh_axis import grid_mesh

    spec = torch.load(spec_path, weights_only=False)
    rank, dev = spec["rank"], torch.device(spec["device"])
    if dev.type != "cuda":      # a rehearsal of this phase on the CPU
        torch.cuda.synchronize = lambda *a: None
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    counted = rank_kernels(_build, rank)
    makers = {("space",): make_spatial_forward,
              ("model",): make_model_forward,
              ("space", "model"): make_spatial_model_forward}
    initialize_multihost(spec["rdv"], spec["world"], rank, device=dev,
                         backend=spec["backend"])
    out = {}
    try:
        grids = {(4, 1): grid_mesh(4, 1), (2, 2): grid_mesh(2, 2)}
        state = torch.load(spec["state"], weights_only=False)
        ex = {k: v.to(dev) for k, v in
              torch.load(spec["example"], weights_only=False).items()}
        for prec, cfg_json in spec["configs"].items():
            net = OdomNet(PipelineCfg.from_json(cfg_json)).to(dev)
            net.load_state_dict(state)
            for name, grid, axes in SPLIT_LAYOUTS:
                fwd = makers[axes](net, grids[grid])
                for fn in counted.values():
                    fn.launches = 0
                with torch.no_grad():
                    preds = fwd(ex)
                torch.cuda.synchronize()
                launches = {k: fn.launches for k, fn in counted.items()}
                ms = []
                for _ in range(SPLIT_TIMED):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with torch.no_grad():
                        fwd(ex)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                out[prec, name] = dict(
                    maps={k: preds[k].float().cpu().numpy()
                          for k in SPLIT_KEYS},
                    pyramid=[(a.float().cpu().numpy(),
                              b.float().cpu().numpy())
                             for a, b in preds["pyramid"]],
                    launches=launches, ms=ms)
            if prec == "bf16":
                out[prec, NO_HALO] = own_edges_forward(
                    makers[("space",)](net, grids[(4, 1)]), ex, torch)
    finally:
        dist.destroy_process_group()
    torch.save(out, spec["out"])


def own_edges_forward(fwd, ex, torch):
    """``fwd(ex)``'s maps with ``parallel/spatial.py::halo_pad`` made to
    pad each rank's own edges, as if it held the whole map."""
    import torch.nn.functional as F
    from rslo_tpu_torch.parallel import spatial
    halo = spatial.halo_pad
    spatial.halo_pad = lambda x, widths, left, right, value: F.pad(
        x, (left, right), value=value)
    try:
        with torch.no_grad():
            preds = fwd(ex)
    finally:
        spatial.halo_pad = halo
    return {k: preds[k].float().cpu().numpy() for k in SPLIT_KEYS}


def split_forward_phases(cfg, example, reset_counts, counts, dev, smi_line,
                         np, torch, backend="gloo", rank_devices=None):
    """Phase 24a-d: the BEV stage split over SPLIT_RANKS ranks
    (``split_rank``, started after the build, loading it): by default
    over gloo, every rank on ``dev`` (the one card, shared); with
    ``backend="nccl"`` and ``rank_devices`` a card each
    (``scripts/torch_split_cards.py``).  At ``cfg`` (bf16) and its
    float32 twin, with phase 4's seeded weights and ``example`` (two
    scans), each layout's maps and odometry against this process's
    unsplit forward on ``dev`` (SPLIT_REL_TOL) and each rank's launches
    against that forward's; ms a forward per rank.  Returns rank 0's
    bf16 launches of each layout."""
    from rslo_tpu_torch.models.net import OdomNet
    shutil.rmtree(SPLIT_DIR, ignore_errors=True)
    os.makedirs(SPLIT_DIR)
    gen = torch.Generator().manual_seed(SEED)
    net = OdomNet(cfg, gen)
    randomize_bn(net, gen)
    state = {k: v.clone() for k, v in net.state_dict().items()}
    cfg32 = cfg.replace(
        middle=dataclasses.replace(cfg.middle, conv_dtype="f32"),
        odom=dataclasses.replace(cfg.odom, compute_dtype="fp32"))
    configs = {"bf16": cfg, "f32": cfg32}
    refs, ref_ms, ref_launches = {}, {}, {}
    for prec, c in configs.items():
        model = OdomNet(c).to(dev)
        model.load_state_dict(state)
        reset_counts()
        with torch.no_grad():
            preds = model(example)
        torch.cuda.synchronize()
        ref_launches[prec] = counts()
        refs[prec] = {k: preds[k].float().cpu().numpy() for k in SPLIT_KEYS}
        refs[prec]["pyramid"] = [(a.float().cpu().numpy(),
                                  b.float().cpu().numpy())
                                 for a, b in preds["pyramid"]]
        with torch.no_grad():
            ref_ms[prec] = median_ms(lambda: model(example), SPLIT_TIMED,
                                     torch)
        del model
    torch.save(state, os.path.join(SPLIT_DIR, "state.pt"))
    torch.save({k: v.cpu() for k, v in example.items()},
               os.path.join(SPLIT_DIR, "example.pt"))
    rdv = f"file://{os.path.join(SPLIT_DIR, 'rendezvous')}"
    t0 = time.perf_counter()
    ranks = run_dp_ranks([dict(
        rank=r, world=SPLIT_RANKS, rdv=rdv, backend=backend,
        device=str(rank_devices[r] if rank_devices else dev),
        state=os.path.join(SPLIT_DIR, "state.pt"),
        example=os.path.join(SPLIT_DIR, "example.pt"),
        configs={p: c.to_json() for p, c in configs.items()},
        out=os.path.join(SPLIT_DIR, f"rank{r}.pt"))
        for r in range(SPLIT_RANKS)], torch, entry="split_rank",
        phase="phase 24")
    where = (f"{backend} ranks, a card each" if rank_devices else
             f"{backend} ranks on the one card")
    staged = ("host-staged, " if backend == "gloo" else "") + (
        "a card a rank" if rank_devices else
        f"{SPLIT_RANKS} ranks sharing the card")
    say(f"[split] {SPLIT_RANKS} {where}: {time.perf_counter() - t0:.1f} s, "
        f"process start and library loads included")
    launches = {}
    for prec in configs:
        H, W = refs[prec]["tq_map"].shape[1:3]
        say(f"[split] {prec}: the unsplit forward {ref_ms[prec]:.3f} ms "
            f"(median of {SPLIT_TIMED}, this process alone on {dev}, "
            f"host clock), BEV {H} x {W}, launches {ref_launches[prec]}")
        for name, grid, axes in SPLIT_LAYOUTS:
            worst = {}
            for r, res in enumerate(ranks):
                got = res[prec, name]
                if got["launches"] != ref_launches[prec]:
                    fail(f"24 {prec} {name} rank {r}: launches "
                         f"{got['launches']}, the unsplit forward's "
                         f"{ref_launches[prec]}")
                pairs = [(k, got["maps"][k], refs[prec][k])
                         for k in SPLIT_KEYS] + [
                    (f"pyramid{i}{j}", g[j], w[j]) for i, (g, w) in
                    enumerate(zip(got["pyramid"], refs[prec]["pyramid"]))
                    for j in (0, 1)]
                for k, g, w in pairs:
                    if g.shape != w.shape:
                        fail(f"24 {prec} {name} rank {r}: {k} shape "
                             f"{g.shape}, unsplit {w.shape}")
                    rel = float(np.abs(g - w).max()) / max(
                        float(np.abs(w).max()), 1e-30)
                    worst[k] = max(worst.get(k, 0.0), rel)
                    if not rel <= SPLIT_REL_TOL[prec]:
                        fail(f"24 {prec} {name} rank {r}: {k} off the "
                             f"unsplit forward by {rel:.3e} of its largest "
                             f"value (> {SPLIT_REL_TOL[prec]:g})")
            ms = ", ".join(f"{statistics.median(res[prec, name]['ms']):.3f}"
                           for res in ranks)
            maps = ", ".join(f"{k} {v:.2e}" for k, v in worst.items()
                             if not k.startswith("pyramid"))
            pyr = max(v for k, v in worst.items() if k.startswith("pyramid"))
            say(f"[split] {prec} {name} (grid {grid[0]} x {grid[1]}, axes "
                f"{'+'.join(axes)}): per rank {ms} ms a forward (median of "
                f"{SPLIT_TIMED}, host clock, {backend}, {staged}); max "
                f"|diff| / max |unsplit|: {maps}, pyramid {pyr:.2e} (held "
                f"to {SPLIT_REL_TOL[prec]:g}); {smi_line}")
            if prec == "bf16":
                launches[f"split_{name}_launches"] = \
                    ranks[0][prec, name]["launches"]
    rel = {k: max(float(np.abs(res["bf16", NO_HALO][k] - w).max())
                  for res in ranks) / max(float(np.abs(w).max()), 1e-30)
           for k, w in ((k, refs["bf16"][k]) for k in SPLIT_KEYS)}
    say(f"[split] bf16 {NO_HALO}: max |diff| / max |unsplit| "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f" (the bound {SPLIT_REL_TOL['bf16']:g} must sit below the "
          f"largest)")
    if not max(rel.values()) > SPLIT_REL_TOL["bf16"]:
        fail(f"24 bf16: the split without halos stays within the bound "
             f"{SPLIT_REL_TOL['bf16']:g} of the unsplit forward, which "
             f"therefore cannot see a broken halo")
    shutil.rmtree(SPLIT_DIR, ignore_errors=True)
    return launches


def split_phases(cfg, example, bench_main, counted, reset_counts, counts,
                 dev, smi_line, np, torch, vox_points, bench_b1=BENCH_B1):
    """Phase 24.  (a-d) ``split_forward_phases`` over gloo ranks sharing
    the card.  (e) ``bench_main`` (the ``bench`` verb) with
    RSLO_BENCH_STREAMING=1: its JSON line, its keys and its B1 launches
    (``bench_b1``).  (f) ``voxelize_mean`` on ``vox_points``,
    ``mean_shift`` at MEANSHIFT_POINTS points and ``SectionTimer`` on
    the card's tensors, each against the CPU.  Returns the launches of
    each path."""
    import io
    from rslo_tpu_torch.data.prepare import voxelizer_config
    from rslo_tpu_torch.geometry.meanshift import label_modes, mean_shift
    from rslo_tpu_torch.ops.voxelize import voxelize_mean
    from rslo_tpu_torch.utils.timing import SectionTimer
    launches = split_forward_phases(cfg, example, reset_counts, counts, dev,
                                    smi_line, np, torch)

    # -- 24e. the bench verb, streaming included ---------------------------
    saved = os.environ.get("RSLO_BENCH_STREAMING")
    os.environ["RSLO_BENCH_STREAMING"] = "1"
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            bench_main()
    finally:
        if saved is None:
            os.environ.pop("RSLO_BENCH_STREAMING")
        else:
            os.environ["RSLO_BENCH_STREAMING"] = saved
    torch.cuda.synchronize()
    bench_launches = counts()
    line = buf.getvalue().strip().splitlines()[-1]
    say(f"[bench] {smi_line} | {line}")
    say(f"[bench] the bench verb in {time.perf_counter() - t0:.1f} s, "
        f"launches {bench_launches}; {smi_line}")
    rec = json.loads(line)
    if set(rec) != BENCH_KEYS:
        fail(f"24e: the bench's keys {sorted(rec)}, expected "
             f"{sorted(BENCH_KEYS)}")
    if not all(math.isfinite(rec[k]) and rec[k] > 0 for k in
               ("value", "sparse_fps", "streaming_fps",
                "sparse_streaming_fps")):
        fail(f"24e: the bench's rates are not finite and positive: {rec}")
    want = dict.fromkeys(counted, 0)
    want["gather_matmul"] = bench_b1
    if bench_launches != want:
        fail(f"24e: the bench launched {bench_launches}, expected {want}")
    launches["bench_launches"] = bench_launches

    # -- 24f. voxelize_mean, mean_shift and SectionTimer, card vs CPU ------
    vcfg = voxelizer_config(cfg)
    pts = torch.as_tensor(vox_points)
    mask = torch.ones(len(pts), dtype=torch.bool)
    reset_counts()
    vc = voxelize_mean(pts.to(dev), mask.to(dev), vcfg)
    vox_us = event_us(lambda: voxelize_mean(pts.to(dev), mask.to(dev), vcfg),
                      10, torch)
    vh = voxelize_mean(pts, mask, vcfg)
    for k in ("coords", "num_points", "num_voxels", "point_voxel"):
        if not torch.equal(getattr(vc, k).cpu(), getattr(vh, k)):
            fail(f"24f: voxelize_mean's {k} differs card vs CPU")
    fd = float((vc.features.cpu() - vh.features).abs().max())
    if not np.allclose(vc.features.cpu().numpy(), vh.features.numpy(),
                       **VOX_MEAN_TOL):
        fail(f"24f: voxelize_mean's means differ card vs CPU by {fd:.3e}")
    say(f"[a6] voxelize_mean, {len(pts)} points, {int(vh.num_voxels)} "
        f"voxels: integers bit-equal card vs CPU, means max |diff| "
        f"{fd:.3e} (held to {VOX_MEAN_TOL}); {vox_us:.1f} us a call on the "
        f"card (CUDA events, host copies included); {smi_line}")
    rng = np.random.default_rng(SEED)
    centres = rng.uniform(-20, 20, size=(6, 3))
    blob = (centres[rng.integers(0, 6, MEANSHIFT_POINTS)] +
            0.5 * rng.normal(size=(MEANSHIFT_POINTS, 3))).astype(np.float32)
    conf = rng.uniform(0.2, 1.0, MEANSHIFT_POINTS).astype(np.float32)
    bt, ct = torch.as_tensor(blob), torch.as_tensor(conf)
    mh = mean_shift(bt, ct, bandwidth=1.5, iters=10)
    md = mean_shift(bt.to(dev), ct.to(dev), bandwidth=1.5, iters=10)
    ms_us = event_us(lambda: mean_shift(bt.to(dev), ct.to(dev),
                                        bandwidth=1.5, iters=10), 5, torch)
    d = float((md.cpu() - mh).abs().max())
    same = torch.equal(label_modes(md, 0.5).cpu(), label_modes(mh, 0.5))
    if not np.allclose(md.cpu().numpy(), mh.numpy(), **MEANSHIFT_TOL) \
            or not same:
        fail(f"24f: mean_shift card vs CPU: modes max |diff| {d:.3e}, "
             f"labels equal {same}")
    say(f"[a6] mean_shift, {MEANSHIFT_POINTS} points, 10 iterations, "
        f"weighted: modes max |diff| card vs CPU {d:.3e} (held to "
        f"{MEANSHIFT_TOL}), labels equal; {ms_us:.1f} us a call on the card "
        f"(CUDA events); {smi_line}")
    timer = SectionTimer()
    a = torch.ones(2048, 2048, device=dev)
    for _ in range(3):
        with timer.section("matmul", sync_value={"out": [a]}):
            a = a @ a * (1.0 / 2048)
    if dict(timer.count) != {"matmul": 3} or not timer.avg_ms()["matmul"] > 0:
        fail(f"24f: SectionTimer counted {dict(timer.count)}, "
             f"{timer.avg_ms()}")
    say(f"[a6] SectionTimer on card tensors: {timer.report()} (3 sections, "
        f"each synchronized on its value's device)")
    if counts() != dict.fromkeys(counted, 0):
        fail(f"24f: a kernel of B1-B5 launched: {counts()}")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose kernels are timed "
                    "against this one's, in turns")
    opts = ap.parse_args()
    import numpy as np
    import torch

    smi_line = require_card(torch)
    sys.path.insert(0, REPO)
    from rslo_tpu_torch.config.schema import PipelineCfg
    from rslo_tpu_torch.data.prepare import prepare_example, voxelizer_config
    from rslo_tpu_torch.eval.streaming import StreamingOdometry
    from rslo_tpu_torch.geometry import np_compose_pose
    from rslo_tpu_torch.models.middle import band_overflow_counts
    from rslo_tpu_torch.models.net import OdomNet
    from rslo_tpu_torch.ops import _build, chamfer, dma_gather
    from rslo_tpu_torch.ops import band_conv as bc
    from rslo_tpu_torch.ops import sparse_conv as sc
    from rslo_tpu_torch.ops.chamfer import nn_search, nn_search_plain
    from rslo_tpu_torch.ops.dma_gather import (gather_matmul,
                                               gather_matmul_dgrad,
                                               row_gather, sparse_conv)
    from rslo_tpu_torch.ops.sparse_conv import (sparse_conv_apply,
                                                sparse_conv_dgrad)
    from rslo_tpu_torch.train.loop import Trainer, make_optimizer
    from rslo_tpu_torch.train.state import TrainState
    from rslo_tpu_torch.train.step import loss_and_grads, train_step
    from rslo_tpu_torch.utils.synthetic import synth_sequence
    dev = torch.device("cuda", 0)
    counted = kernel_wrappers()

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counted.items()}

    # -- 2. build ---------------------------------------------------------
    build_kernels(_build)
    parent = (load_parent_libraries(opts.parent, _build, dma_gather, bc,
                                    chamfer) if opts.parent else None)
    frame_ms = {}

    def on_parent(name, fn):
        """``fn`` with the parent's ``name`` library routed in."""
        def run():
            with parent(name):
                return fn()
        return run

    def with_parent(name, fn):
        return [] if parent is None else [("parent", on_parent(name, fn))]

    # -- 3. kernel vs plain at the main path's 20 conv calls --------------
    with open(CONFIG) as fh:
        cfg = PipelineCfg.from_json(fh.read())
    gen = torch.Generator().manual_seed(SEED)
    net = OdomNet(cfg, gen)
    randomize_bn(net, gen)
    net = net.to(dev).eval()
    frames, _ = synth_sequence(seed=SEED, n_frames=N_SCANS,
                               n_points=N_POINTS)
    vcfg = voxelizer_config(cfg)

    def scan_example(scan):
        pts = torch.as_tensor(scan, device=dev)
        return prepare_example(pts[None], torch.ones(1, len(scan), dtype=bool,
                                                     device=dev),
                               vcfg, mean_mode=True)

    def encode(model, scan):
        ex = scan_example(scan)
        return model.frame_features(ex["voxel_features"][0],
                                    ex["coords"][0], ex["voxel_mask"][0])

    with torch.no_grad():
        calls = capture_conv_calls(net, lambda: encode(net, frames[0]))
        if len(calls) != 20:
            fail(f"expected 20 sparse convs per frame, saw {len(calls)}")
        calls = [(f, op.rb, w, b, om) for f, op, w, b, om in calls]
        n_vox = int(calls[0][4].sum())
        say(f"[kernel] frame 0: {n_vox} voxels; kernel vs plain, tolerance "
            f"|err| <= {KERNEL_REL_TOL:g} * sum|g*w| + {KERNEL_ABS_TOL:g}")
        worst = check_kernel(calls, gather_matmul, sparse_conv_apply,
                             torch)
        say("[kernel] edge case: all-invalid rows, masked rows, ragged V, "
            "NaN rows behind invalid taps")
        worst = max(worst, check_kernel(
            [edge_case(calls[1], torch)], gather_matmul, sparse_conv_apply,
            torch))
        dense = dense_case(bc, sc, torch, dev)
        dense_b1, dense_b4 = check_dense(dense, bc, gather_matmul,
                                         gather_matmul_dgrad,
                                         sparse_conv_apply,
                                         sparse_conv_dgrad, torch)
        worst = max(worst, dense_b1)

    # -- 4. the serving path: streaming -------------------------------------
    def two_frame(model, device):
        pts = torch.as_tensor(np.stack(frames[:2]), device=device)
        ex = prepare_example(pts, torch.ones(pts.shape[:2], dtype=bool,
                                             device=device),
                             vcfg, mean_mode=True)
        with torch.no_grad():
            return model(ex)

    def stream_and_check(label, model, cfg_, kernel):
        """Stream the scans, the counts set to 0 just before: exactly 14
        launches of ``kernel`` per scan and none of any other, finite
        poses, and the pose after scan 2 equal to the two-frame
        forward."""
        stream = StreamingOdometry(model, cfg_, dev)
        reset_counts()
        for scan in frames:
            stream.push(scan)
        torch.cuda.synchronize()
        got = counts()
        poses = np.stack(stream.trajectory)
        say(f"[{label}] {N_SCANS} scans, launches {got}; last pose "
            f"{np.array2string(poses[-1], precision=5)}")
        want = dict.fromkeys(counted, 0)
        want[kernel] = ENCODER_CONVS * N_SCANS
        if got != want:
            fail(f"{label}: launches {got} != {want}")
        if poses.shape != (N_SCANS, 7) or not np.isfinite(poses).all():
            fail(f"{label}: bad trajectory {poses.shape}: {poses}")
        two = two_frame(model, dev)["odometry"][0].cpu().numpy()
        expect = np_compose_pose(poses[0][None], two[None])[0]
        say(f"[{label}] pose after scan 2 "
            f"{np.array2string(poses[1], precision=6)} vs two-frame forward "
            f"{np.array2string(expect, precision=6)}; max |diff| "
            f"{np.abs(poses[1] - expect).max():.3e}")
        if not np.allclose(poses[1], expect, **POSE_TOL):
            fail(f"{label}: pose after scan 2 != two-frame forward")

    def time_serving(model, cfg_):
        """(ms/scan streaming, median of 20 after 3 warm-up scans; ms of
        the two-frame forward, median of 10)."""
        stream = StreamingOdometry(model, cfg_, dev)
        for scan in frames[:3]:
            stream.push(scan)
        it = iter(frames * 3)
        return (median_ms(lambda: stream.push(next(it)), 20, torch),
                median_ms(lambda: two_frame(model, dev), 10, torch))

    stream_and_check("stream", net, cfg, "gather_matmul")

    # -- 5. timing of the serving path -------------------------------------
    stream_ms, two_ms = time_serving(net, cfg)
    f, rb, w, b, om = calls[1]                # L0 subm, 16 -> 16
    V, K = rb.idx.shape
    gm_bound = bound_ms(
        nbytes(f, rb.idx, rb.valid, w, b, om) + V * w.shape[2] * 4,
        2.0 * int(rb.valid.sum()) * f.shape[1] * w.shape[2])
    bf16 = torch.bfloat16
    with torch.no_grad():
        us = graph_us([
            ("plain", lambda: sparse_conv_apply(f, rb, w, b, om, bf16)),
            ("kernel", lambda: gather_matmul(f, rb.idx, rb.valid, w, b, om,
                                             bf16)),
            ("kernel f32", lambda: gather_matmul(f, rb.idx, rb.valid, w, b,
                                                 om, torch.float32))],
            20, torch)
        k_us, p_us = us["kernel"], us["plain"]

        def b1_host(route=contextlib.nullcontext):
            with route():
                return gather_matmul(f, rb.idx, rb.valid, w, b, om, bf16)
        # launched from the host back to back: the wrapper's cost included
        host = turns_us([("kernel", b1_host)] + (
            [] if parent is None else [("parent", lambda: b1_host(parent))]),
            50, torch)
        say("[convs] B1 forward, bf16, the 20 convs of frame 0 (device "
            "time, CUDA graph of 20 calls; the launch's dynamic shared "
            "memory and cp.async stages)")
        lib = dma_gather._library()

        def smem(V_, K_, cin, cout):
            stages = ctypes.c_int(0)
            n = lib.gather_matmul_shared_bytes(V_, K_, cin, cout,
                                               ctypes.byref(stages))
            return f"{n / 1024:5.1f} KB x{stages.value}"
        frame_ms["gather_matmul"] = time_convs("B1", [
            (f"conv {i:2d} V={rb_.idx.shape[0]:5d} K={rb_.idx.shape[1]:2d} "
             f"{f_.shape[1]:2d}->{w_.shape[2]:2d} "
             f"{smem(*rb_.idx.shape, f_.shape[1], w_.shape[2])}",
             lambda f_=f_, rb_=rb_, w_=w_, b_=b_, om_=om_: gather_matmul(
                 f_, rb_.idx, rb_.valid, w_, b_, om_, bf16),
             gemm_bound((f_, rb_.idx, rb_.valid, w_, b_, om_),
                        rb_.idx.shape[0], f_.shape[1], w_.shape[2],
                        int(rb_.valid.sum())))
            for i, (f_, rb_, w_, b_, om_) in enumerate(calls)], torch, parent,
            ("gather_matmul",))
    say(f"[time] streaming {stream_ms:.3f} ms/scan "
        f"({1e3 / stream_ms:.2f} scans/s), median of 20 after warm-up")
    say(f"[time] two-frame forward {two_ms:.3f} ms, median of 10")
    say(f"[time] L0 subm conv V={V} K={K} Cin={f.shape[1]} "
        f"Cout={w.shape[2]} bf16: gather_matmul {k_us:.2f} us/call (f32 "
        f"mode {us['kernel f32']:.2f}), plain sparse_conv_apply {p_us:.2f} "
        f"us/call (device time, in turns); bound {gm_bound[0] * 1e3:.2f} us "
        f"({gm_bound[1]}); launched from the host, 50 calls back to back: "
        f"gather_matmul {host['kernel']:.2f} us/call" + (
            "" if parent is None else f", parent {host['parent']:.2f}"))
    kernel_rows = {"gather_matmul": dict(
        source="rslo_tpu_torch/csrc/gather_matmul.cu",
        replaces="rslo_tpu/ops/dma_gather.py:132", max_abs_err=worst,
        ms=k_us / 1e3, plain_ms=p_us / 1e3, bound=gm_bound,
        library_ms=None, host_ms=host["kernel"] / 1e3)}

    # -- 6. the band engine, serving ----------------------------------------
    bcfg = cfg.replace(middle=dataclasses.replace(cfg.middle, engine="band"))
    bnet = OdomNet(bcfg)
    bnet.load_state_dict(net.state_dict())
    bnet = bnet.to(dev).eval()
    m = bcfg.middle
    say(f"[band] engine band: block {m.band_block}, windows "
        f"{tuple(m.band_windows)}, min_channels {m.band_min_channels}; the "
        f"rulebook net's weights")
    with torch.no_grad():
        # the JAX package's deployed-shape guard: a frame of
        # max_points points, every plan at most half full
        deployed, _ = synth_sequence(seed=SEED, n_frames=1,
                                     n_points=AUDIT_POINTS)
        ex0 = scan_example(deployed[0])
        overflow_audit(f"deployed-shape frame of {AUDIT_POINTS} points",
                       bnet._middle_geometry(ex0["coords"][0],
                                             ex0["voxel_mask"][0]),
                       band_overflow_counts, OVERFLOW_SHARE)
        # the streamed scans: reported; the scans that the exactness
        # checks below compare (0 and 1) must not be saturated
        for t, scan in enumerate(frames):
            ex_t = scan_example(scan)
            sat = overflow_audit(f"scan {t}", bnet._middle_geometry(
                ex_t["coords"][0], ex_t["voxel_mask"][0]),
                band_overflow_counts)
            if sat and t < 2:
                fail(f"scan {t} saturates band plans {sat}")
        bcalls = capture_conv_calls(bnet, lambda: encode(bnet, frames[0]))
        if len(bcalls) != 20 or any(op.plan is None for _, op, *_ in bcalls):
            fail("the band frame did not run 20 convs through band plans")
        say(f"[band] frame 0: B4 vs plain, |err| <= {KERNEL_REL_TOL:g} * "
            f"sum|g*w| + {KERNEL_ABS_TOL:g}; B5 bit-equal to plain")
        b4_worst = check_band_kernels(
            [(f"conv {i:2d}", bc.pad_rows(f_, op.plan.v_in), w_, op.plan)
             for i, (f_, op, w_, _, _) in enumerate(bcalls)], bc, torch)
        say("[band] edge cases")
        b4_worst = max(b4_worst, dense_b4, check_band_kernels(
            band_edge_cases(calls[1], bcalls[1][1].plan, bc, sc, torch), bc,
            torch))

    stream_and_check("band stream", bnet, bcfg, "band_matmul")
    band_stream_ms, band_two_ms = time_serving(bnet, bcfg)
    f1, op1, w1, _, _ = bcalls[1]             # L0 subm, 16 -> 16
    plan1 = op1.plan
    fp1 = bc.pad_rows(f1, plan1.v_in)
    # B5's PyTorch call: one index_select of the plan's flattened sources
    # from a bf16 copy of the features with a zero row appended (built
    # here, outside the clock), which computes the same bf16 im2col
    src1, valid1 = bc._sources(plan1.base, plan1.sel)
    idx_lib = torch.where(valid1[:, 0], src1, fp1.shape[0])
    f_lib = torch.cat([fp1, fp1.new_zeros(1, fp1.shape[1])]).to(bf16)

    def b5_lib():
        return torch.index_select(f_lib, 0, idx_lib)

    def b5_new():
        return bc.band_gather(fp1, plan1.base, plan1.sel, bf16)
    if not torch.equal(bits(b5_lib().reshape(plan1.sel.shape[0] *
                                             plan1.sel.shape[2], -1), torch),
                       bits(b5_new(), torch)):
        fail("torch.index_select of the plan's sources != band_gather")
    with torch.no_grad():
        us = graph_us([
            ("B4 plain", lambda: bc.band_conv_plain(fp1, w1, plan1.base,
                                                    plan1.sel, bf16)),
            ("B4", lambda: bc.band_matmul(fp1, w1, plan1.base, plan1.sel,
                                          bf16)),
            ("B1", lambda: gather_matmul(f, rb.idx, rb.valid, w, b, om,
                                         bf16)),
            ("B5 plain", lambda: bc.band_gather_plain(fp1, plan1.base,
                                                      plan1.sel, bf16)),
            ("B5", b5_new), ("B5 library", b5_lib)]
            + [(f"B5 {n}", fn) for n, fn in with_parent("band_conv", b5_new)],
            20, torch)
        say("[convs] B4 forward, bf16, the 20 band convs of frame 0")
        frame_ms["band_matmul"] = time_convs("B4", [
            (f"conv {i:2d} nB={op_.plan.sel.shape[0]:3d} "
             f"K={op_.plan.sel.shape[1]:2d} {f_.shape[1]:2d}->{w_.shape[2]:2d}",
             lambda fp_=bc.pad_rows(f_, op_.plan.v_in), w_=w_, p_=op_.plan:
                 bc.band_matmul(fp_, w_, p_.base, p_.sel, bf16),
             gemm_bound((bc.pad_rows(f_, op_.plan.v_in), op_.plan.base,
                         op_.plan.sel, w_), op_.plan.sel.shape[0] *
                        op_.plan.sel.shape[2], f_.shape[1], w_.shape[2],
                        band_pairs(op_.plan)))
            for i, (f_, op_, w_, _, _) in enumerate(bcalls)], torch, parent,
            ("band_conv",))
    nB, K1, B1 = plan1.sel.shape
    cin1, cout1 = w1.shape[1], w1.shape[2]
    b4_bound = bound_ms(nbytes(fp1, plan1.base, plan1.sel, w1) +
                        nB * B1 * cout1 * 4,
                        2.0 * band_pairs(plan1) * cin1 * cout1)
    b5_bound = bound_ms(nbytes(fp1, plan1.base, plan1.sel) +
                        nB * B1 * K1 * cin1 * 2)
    say(f"[time] band streaming {band_stream_ms:.3f} ms/scan "
        f"({1e3 / band_stream_ms:.2f} scans/s), median of 20 after warm-up")
    say(f"[time] band two-frame forward {band_two_ms:.3f} ms, median of 10")
    say(f"[time] L0 subm conv, band plan nB={nB} K={K1} B={B1} "
        f"W={plan1.window} Cin={cin1} Cout={cout1} bf16 "
        f"({band_pairs(plan1)} in-window pairs): band_matmul {us['B4']:.2f} "
        f"us/call, plain band_conv_plain {us['B4 plain']:.2f} us/call, "
        f"gather_matmul (B1) at the same conv {us['B1']:.2f} us/call; "
        f"band_gather {us['B5']:.2f} us/call" + (
            "" if parent is None else
            f", parent {us['B5 parent']:.2f} "
            f"({us['B5 parent'] / us['B5']:.2f}x)")
        + f", plain band_gather_plain {us['B5 plain']:.2f} us/call, "
        f"torch.index_select {us['B5 library']:.2f} us/call (device time, "
        f"in turns); "
        f"bounds B4 {b4_bound[0] * 1e3:.2f} us ({b4_bound[1]}), B5 "
        f"{b5_bound[0] * 1e3:.2f} us ({b5_bound[1]})")
    for engine, model, cfg_, wall_ms in (("rulebook", net, cfg, stream_ms),
                                         ("band", bnet, bcfg,
                                          band_stream_ms)):
        st = StreamingOdometry(model, cfg_, dev)
        for scan in frames[:3]:               # warm-up
            st.push(scan)
        prof = profile_device([lambda scan=scan: st.push(scan)
                               for scan in frames[3:7]], torch)
        if prof is None:
            say(f"[profile] {engine} streaming: the trace holds no device "
                f"events")
            continue
        say(f"[profile] {engine} streaming, torch.profiler over 4 pushes: "
            f"{prof['device_ms']:.3f} ms/scan of device work in "
            f"{prof['ops']:.0f} device ops; against the {wall_ms:.3f} "
            f"ms/scan measured above, the device idles "
            f"{1 - prof['device_ms'] / wall_ms:.1%}")
        for name, ms, n in prof["top"]:
            say(f"  {ms:8.3f} ms/scan  {n:6.1f} ops/scan  {name}")
    kernel_rows["band_matmul"] = dict(
        source="rslo_tpu_torch/csrc/band_conv.cu",
        replaces="rslo_tpu/ops/band_conv.py:222", max_abs_err=b4_worst,
        ms=us["B4"] / 1e3, plain_ms=us["B4 plain"] / 1e3, bound=b4_bound,
        library_ms=None)
    kernel_rows["band_gather"] = dict(
        source="rslo_tpu_torch/csrc/band_conv.cu",
        replaces="rslo_tpu/ops/band_conv.py:282", max_abs_err=0.0,
        ms=us["B5"] / 1e3, plain_ms=us["B5 plain"] / 1e3, bound=b5_bound,
        library_ms=us["B5 library"] / 1e3)

    # -- the train path's config, model and data ----------------------------
    with open(TRAIN_CONFIG) as fh:
        tcfg = PipelineCfg.from_json(fh.read())
    tcfg = tcfg.replace(
        loss=dataclasses.replace(tcfg.loss,
                                 warmup_steps=SMOKE_WARMUP_STEPS),
        train=dataclasses.replace(tcfg.train, display_step=1,
                                  steps_per_eval=TRAIN_STEPS))
    tvcfg = voxelizer_config(tcfg)
    L = tcfg.data.seq_length
    batches = train_batches(tcfg.data.max_points, L, TRAIN_STEPS, SEED + 1,
                            np)
    gpu_batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batches[0].items()}
    ex = prepare_example(gpu_batch["points"], gpu_batch["point_mask"],
                         tvcfg, mean_mode=True)
    V0 = ex["voxel_features"].shape[1]
    stride = max(1, -(-V0 // tcfg.loss.max_loss_points))
    pairs = [(i, j) for i in range(L) for j in range(i + 1, L)]
    loss_pts = ex["voxel_features"][:, ::stride, :3].contiguous()
    loss_mask = ex["voxel_mask"][:, ::stride].contiguous()
    src = torch.stack([loss_pts[i] for i, _ in pairs])
    sm = torch.stack([loss_mask[i] for i, _ in pairs])
    tgt = torch.stack([loss_pts[j] for _, j in pairs])
    tm = torch.stack([loss_mask[j] for _, j in pairs])
    say(f"[train] {L}-frame windows of {N_POINTS} points padded to "
        f"{tcfg.data.max_points}: {int(ex['voxel_mask'][0].sum())} voxels "
        f"in frame 0, loss points {tuple(src.shape[:2])} (stride {stride})")

    # -- 7. B3 nn_search bit-equal to its plain version ---------------------
    d, _ = check_nn_search(torch, nn_search, nn_search_plain, src, sm, tgt,
                           tm)
    say(f"[nn_search] P={src.shape[0]} N={src.shape[1]} M={tgt.shape[1]}: "
        f"dist and idx bit-equal to the plain version; "
        f"{int((d < 1e29).sum())} valid associations")
    half = tgt.shape[1] // 2
    tgt_dup = tgt.clone()
    tgt_dup[:, half:2 * half] = tgt[:, :half]
    tm_dup = tm.clone()
    tm_dup[:, half:2 * half] = tm[:, :half]
    tm_none = tm.clone()
    tm_none[1] = False
    sm_cut = sm.clone()
    sm_cut[:, ::3] = False
    for what, args in (
            ("duplicated tgt rows (ties)", (src, sm, tgt_dup, tm_dup)),
            ("all-invalid tgt in pair 1", (src, sm, tgt, tm_none)),
            ("masked src rows", (src, sm_cut, tgt, tm)),
            ("ragged N 19999, M 17777",
             (src[:, :19999].contiguous(), sm[:, :19999].contiguous(),
              tgt[:, :17777].contiguous(), tm[:, :17777].contiguous()))):
        d, i = check_nn_search(torch, nn_search, nn_search_plain, *args)
        say(f"[nn_search] edge case {what}: bit-equal")
    d, i = nn_search(src, sm, tgt, tm_none)
    if not ((d[1] == float(np.float32(chamfer.BIG))).all() and
            (i[1] == 0).all()):
        fail("nn_search: a pair with no valid tgt must give (BIG, 0)")
    _, i = nn_search(src, sm, tgt_dup, tm_dup)
    if ((i >= half) & (i < 2 * half)).any():
        fail("nn_search: a tie must go to the lowest index")
    # the kernel's own boundaries: every tgt repeated each 997 rows (its
    # copies straddle the 32-tgt chunks, the cluster's tgt shares and,
    # with src points on them, every register slot and src tile); N not
    # a multiple of the 256-point src tile; M below the cluster's 8
    # blocks; M = 0; invalid tgts placed exactly on src points
    Np, Mp = src.shape[1], tgt.shape[1]
    ar_m = torch.arange(Mp, device=dev)
    tgt_per = tgt[:, ar_m % 997].contiguous()
    tm_all = torch.ones_like(tm)
    src_on = src.clone()
    src_on[:, ::2] = tgt_per[:, (torch.arange(0, Np, 2, device=dev) * 7919)
                             % 997]
    tgt_inv = tgt.clone()
    tm_inv = tm.clone()
    k_inv = min(Mp, Np) // 2
    tgt_inv[:, :k_inv] = src[:, 0:2 * k_inv:2]
    tm_inv[:, :k_inv] = False
    for what, args in (
            ("periodic tgt, src on tgt points (ties across chunks, shares "
             "and register blocks)", (src_on, sm, tgt_per, tm_all)),
            ("N 257", (src[:, :257].contiguous(), sm[:, :257].contiguous(),
                       tgt, tm)),
            ("N 1", (src[:, :1].contiguous(), sm[:, :1].contiguous(), tgt,
                     tm)),
            ("M 5", (src, sm, tgt[:, :5].contiguous(),
                     tm_all[:, :5].contiguous())),
            ("M 1", (src, sm, tgt[:, :1].contiguous(),
                     tm_all[:, :1].contiguous())),
            ("M 0", (src, sm, tgt[:, :0].contiguous(),
                     tm[:, :0].contiguous())),
            ("invalid tgts on src points", (src, sm, tgt_inv, tm_inv))):
        d, i = check_nn_search(torch, nn_search, nn_search_plain, *args)
        say(f"[nn_search] edge case {what}: bit-equal")
        if what.startswith("periodic") and (
                (i[:, ::2] >= 997) | (d[:, ::2] != 0))[sm[:, ::2]].any():
            fail("nn_search: a src point on a repeated tgt point must get "
                 "its first copy at distance 0")
        if what == "M 0" and not ((d == float(np.float32(chamfer.BIG))) &
                                  (i == 0)).all():
            fail("nn_search: M = 0 must give (BIG, 0)")
        if what.startswith("invalid") and (
                (i < k_inv) & (d < float(np.float32(chamfer.BIG))))[sm].any():
            fail("nn_search: an invalid tgt on a src point was selected")

    # -- 8. B2 row_gather bit-equal to features[idx]; its fused mode -------
    tnet = OdomNet(tcfg, torch.Generator().manual_seed(SEED)).to(dev)
    tnet.train()
    train_calls = capture_conv_calls(tnet, lambda: tnet.frame_features(
        ex["voxel_features"][0], ex["coords"][0], ex["voxel_mask"][0]))
    if len(train_calls) != 20 or train_calls[0][1].rb_t is None:
        fail("the train-mode frame did not run 20 differentiable convs")
    f0, op0 = train_calls[1][0], train_calls[1][1]    # L0 subm, 16 ch
    idx0 = op0.rb.idx.reshape(-1)
    got = row_gather(f0, idx0)
    want = f0[idx0.long()]
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(
            got.view(torch.int32), want.view(torch.int32)):
        fail("row_gather != features[idx] at the L0 im2col")
    for bad in (-1, f0.shape[0]):
        try:
            row_gather(f0, torch.tensor([0, bad], dtype=torch.int32,
                                        device=dev))
            fail(f"row_gather took the out-of-range index {bad}")
        except IndexError:
            pass
    # every vector width: 4-, 8- and 16-byte rows and lanes, a row of
    # 64 words, an int32 array, and a 16-byte row at a 4-byte offset
    gen8 = torch.Generator(device=dev).manual_seed(SEED)
    ridx = torch.randint(0, 5000, (100003,), generator=gen8, device=dev,
                         dtype=torch.int32)
    widths = []
    for C in (1, 2, 3, 4, 7, 16, 64, 100):
        widths.append((f"C={C}", torch.randn(5000, C, generator=gen8,
                                             device=dev)))
    widths.append(("int32 C=16", torch.randint(-2 ** 31, 2 ** 31 - 1,
                                               (5000, 16), generator=gen8,
                                               device=dev,
                                               dtype=torch.int32)))
    widths.append(("C=16 at a 4-byte offset", torch.randn(
        5000 * 16 + 1, generator=gen8, device=dev)[1:].view(5000, 16)))
    for what, feats in widths:
        if not torch.equal(bits(row_gather(feats, ridx), torch),
                           bits(feats[ridx.long()], torch)):
            fail(f"row_gather != features[idx] at {what}")
    say(f"[row_gather] L0 im2col {tuple(got.shape)} and rows of "
        f"{', '.join(w for w, _ in widths)}: bit-equal to features[idx]; "
        f"out-of-range indices raise")

    def im2col_plain(f_, idx_, valid_, dt):
        """The fused mode's plain version: the composition it replaces."""
        return sc.round_operand(torch.where(
            valid_[:, None], f_[idx_.long()], 0.0), dt)

    fused_cases = []
    for i, (f_, op_, *_) in enumerate(train_calls):
        fused_cases.append((f"conv {i:2d}", f_.contiguous(),
                            op_.rb.idx.reshape(-1),
                            op_.rb.valid.reshape(-1)))
    fl, ol = train_calls[1][0].contiguous(), train_calls[1][1]
    nan_row = fl.shape[0]
    f_nan = torch.cat([fl, torch.full_like(fl[:1], float("nan"))])
    v_l = ol.rb.valid.reshape(-1)
    fused_cases += [
        ("conv  1, all-invalid valid", fl, ol.rb.idx.reshape(-1),
         torch.zeros_like(v_l)),
        ("conv  1, NaN rows behind invalid taps", f_nan,
         torch.where(v_l, ol.rb.idx.reshape(-1), nan_row).to(torch.int32),
         v_l)]
    for what, f_, idx_, valid_ in fused_cases:
        for dt in (bf16, torch.float32):
            got_f = row_gather(f_, idx_, check=False, valid=valid_,
                               compute_dtype=dt)
            want_f = im2col_plain(f_, idx_, valid_, dt)
            if not torch.equal(bits(got_f, torch), bits(want_f, torch)):
                fail(f"fused row_gather != round(where(valid, f[idx], 0)) "
                     f"at {what} ({dt})")
            if "all-invalid" in what and bits(got_f, torch).any():
                fail("fused row_gather: an all-invalid valid must give +0.0")
    del got_f, want_f, fused_cases, f_nan, widths   # phase 11's peak memory
    say(f"[row_gather] fused d_W im2col bit-equal to round_operand("
        f"torch.where(valid, features[idx], 0)) in bf16 and f32 at the 20 "
        f"train convs (conv 0: {train_calls[0][0].shape[1]} channels, "
        f"{train_calls[0][0].shape[1] * 4}-byte rows), an all-invalid "
        f"valid and NaN rows behind invalid taps")

    # -- 9. the sparse conv's backward against autograd ----------------------
    btcfg = tcfg.replace(middle=dataclasses.replace(tcfg.middle,
                                                    engine="band"))
    tbnet = OdomNet(btcfg, torch.Generator().manual_seed(SEED)).to(dev)
    tbnet.train()
    with torch.no_grad():
        # the train windows' frames: reported; window 0, which the
        # band-vs-rulebook train step compares, must not be saturated
        for w_i, batch in enumerate(batches):
            ex_w = prepare_example(
                torch.as_tensor(batch["points"], device=dev),
                torch.as_tensor(batch["point_mask"], device=dev), tvcfg,
                mean_mode=True)
            for t in range(0 if w_i == 0 else L - 1, L):
                sat = overflow_audit(
                    f"train frame {w_i + t}", tbnet._middle_geometry(
                        ex_w["coords"][t], ex_w["voxel_mask"][t]),
                    band_overflow_counts)
                if sat and w_i == 0:
                    fail(f"train frame {t} saturates band plans {sat}")
    band_train_calls = capture_conv_calls(tbnet, lambda: tbnet.frame_features(
        ex["voxel_features"][0], ex["coords"][0], ex["voxel_mask"][0]))
    if (len(band_train_calls) != 20 or
            any(op.plan is None or op.rb_t is None
                for _, op, *_ in band_train_calls)):
        fail("the band train-mode frame did not run 20 differentiable band "
             "convs")
    # B5 in both modes: the fused d_W mode and the plain contract
    say("[band_gather] B5's plain contract and fused d_W mode bit-equal to "
        "their plain versions")
    with torch.no_grad():
        check_band_gather(band_gather_cases(band_train_calls, bc, torch), bc,
                          torch)
    # the band conv's d_W with the fused mode bit-equal to the three-pass
    # chain's (the parent's kernel, or with no parent this checkout's)
    route = ((lambda: parent("band_conv")) if parent is not None
             else contextlib.nullcontext)
    gen9 = torch.Generator(device=dev).manual_seed(SEED)
    n_st = 0
    for f_, op, w_, b_, om_ in band_train_calls:
        if not op.plan.self_transpose:
            continue
        n_st += 1
        ct = torch.randn(op.plan.v_out, w_.shape[2], device=dev,
                         generator=gen9)
        for dt in (bf16, torch.float32):
            grads = []
            for ctx in (contextlib.nullcontext, lambda: three_pass_band_dw(
                    bc, route)):
                wi = w_.clone().requires_grad_()
                with ctx():
                    bc.band_conv(f_, op.plan, wi, b_, om_, dt, op.rb,
                                 op.rb_t).backward(ct)
                grads.append(bits(wi.grad, torch))
            if not torch.equal(*grads):
                fail(f"band d_W with the fused mode != the three-pass chain's "
                     f"({dt})")
    say(f"[band_gather] the band conv's d_W at the {n_st} submanifold plans "
        f"of a train frame, bf16 and f32: bit-equal with the fused mode and "
        f"with the three-pass chain on "
        f"{'the parent' if parent is not None else 'this checkout'}'s "
        f"band_gather")

    engines = {
        "rulebook": (BWD_REL_TOL, train_calls,
                     lambda f_, op, w_, b_, om_, dt: sparse_conv(
                         f_, op.rb, op.rb_t, w_, b_, om_, dt, op.flip_taps),
                     lambda f_, op, w_, b_, om_, dt: sparse_conv_apply(
                         f_, op.rb, w_, b_, om_, dt)),
        "band": (BAND_BWD_REL_TOL, band_train_calls,
                 lambda f_, op, w_, b_, om_, dt: bc.band_conv(
                     f_, op.plan, w_, b_, om_, dt, op.rb, op.rb_t),
                 lambda f_, op, w_, b_, om_, dt: band_apply_plain(
                     bc, torch, f_, op.plan, w_, b_, om_, dt))}
    bwd_worst = {}
    for engine, (tol, eng_calls, conv_kernel, conv_plain) in engines.items():
        for dt_name in ("bf16", "f32"):
            say(f"[backward] {engine} {dt_name}: |err| <= "
                f"{tol[dt_name]:g} * sum|terms| + {KERNEL_ABS_TOL:g} "
                f"(d_bias {KERNEL_REL_TOL:g})")
            bwd_worst[engine, dt_name] = check_backward(
                eng_calls, torch, conv_kernel, conv_plain,
                sparse_conv_dgrad, dt_name, tol[dt_name])

    # -- 10. the train path: Trainer.fit, on each engine ---------------------
    def fit_and_check(engine, cfg_, train_dir, ops):
        """Trainer.fit for TRAIN_STEPS steps: launches per step against
        the prediction, finite metrics, changed tensors, checkpoint
        restore.  Returns (trainer, state, summed launches, the initial
        weights)."""
        shutil.rmtree(train_dir, ignore_errors=True)
        trainer = Trainer(cfg_, train_dir, dev)
        state = trainer.init_state()
        before = {k: v.detach().clone()
                  for k, v in state.model.state_dict().items()}
        per_step = []

        def counted_batches():
            for batch in batches:
                reset_counts()
                yield batch
                per_step.append(counts())     # the step has been launched

        t0 = time.perf_counter()
        state = trainer.fit(counted_batches(), state, max_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        if state.step != TRAIN_STEPS or len(per_step) != TRAIN_STEPS:
            fail(f"{engine}: fit ran {state.step} steps, counted "
                 f"{len(per_step)}")
        for k, c in enumerate(per_step):
            warm = k <= cfg_.loss.warmup_steps
            want = predicted_launches(ops, cfg_, warm)
            say(f"[train {engine}] step {k} "
                f"({'warmup' if warm else 'post-warmup'}): launches {c}")
            if c != want:
                fail(f"{engine} step {k}: launches {c} != predicted {want}")
        for step_i, row in trainer.history:
            bad = [k for k, v in row.items() if not math.isfinite(v)]
            say(f"[train {engine}] step {step_i}: loss {row['loss']:.5f} "
                f"consistency {row['consistency_loss']:.5f} pyramid "
                f"{row['pyramid_loss']:.5f} grad_norm "
                f"{row['grad_norm']:.4f} alpha_rot {row['alpha_rot']:.6f} "
                f"alpha_trans {row['alpha_trans']:.6f}")
            if bad:
                fail(f"{engine} step {step_i}: non-finite metrics {bad}")
        if len(trainer.history) != TRAIN_STEPS:
            fail(f"{engine}: expected {TRAIN_STEPS} logged steps, got "
                 f"{len(trainer.history)}")
        after = state.model.state_dict()
        same = [k for k, v in before.items() if torch.equal(v, after[k])]
        if same:
            fail(f"{engine}: train steps left {len(same)} tensors "
                 f"unchanged: {same[:5]}")
        n_stats = sum(1 for k in after if k.endswith((".mean", ".var")))
        say(f"[train {engine}] Trainer.fit: {TRAIN_STEPS} steps in "
            f"{fit_s:.2f} s (first step included); all "
            f"{len(after) - n_stats} parameters and {n_stats} running "
            f"statistics changed")
        restorer = Trainer(cfg_, train_dir, dev)
        restored = restorer.init_state()
        restorer.logger.close()
        diff = [k for k, v in after.items()
                if not torch.equal(v, restored.model.state_dict()[k])]
        if (diff or restored.step != TRAIN_STEPS or
                restored.opt_state.count != TRAIN_STEPS or
                trainer.ckpt.latest_step() != TRAIN_STEPS):
            fail(f"{engine}: checkpoint restore mismatch: step "
                 f"{restored.step}, {len(diff)} tensors differ")
        say(f"[train {engine}] checkpoint {trainer.ckpt.latest_step()} "
            f"written and restored: step, optimizer count and all tensors "
            f"equal")
        return trainer, state, {k: sum(c[k] for c in per_step)
                                for k in counted}, before

    rb_ops = [op for _, op, *_ in train_calls]
    band_ops = [op for _, op, *_ in band_train_calls]
    for engine, ops, cfg_ in (("rulebook", rb_ops, tcfg),
                              ("band", band_ops, btcfg)):
        for warm in (True, False):
            say(f"[train {engine}] predicted launches per "
                f"{'warmup' if warm else 'post-warmup'} step: "
                f"{predicted_launches(ops, cfg_, warm)}")
    trainer, state, train_launches, initial = fit_and_check(
        "rulebook", tcfg, TRAIN_DIR, rb_ops)
    btrainer, bstate, band_train_launches, _ = fit_and_check(
        "band", btcfg, BAND_TRAIN_DIR, band_ops)

    # -- 11. timing of the train path and the backward kernels ---------------
    step_ms, peak_mib = {}, {}
    for engine, tr, st, cfg_ in (("rulebook", trainer, state, tcfg),
                                 ("band", btrainer, bstate, btcfg)):
        torch.cuda.synchronize()
        live_mib = torch.cuda.memory_allocated(dev) / 2 ** 20
        torch.cuda.reset_peak_memory_stats(dev)
        for warm in (True, False):
            train_step(st, gpu_batch, cfg_, tr.optimizer,
                       warmup=warm)                            # warm-up
            step_ms[engine, warm] = median_ms(lambda: train_step(
                st, gpu_batch, cfg_, tr.optimizer, warmup=warm), 5, torch)
        peak_mib[engine] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        say(f"[time] {engine} train step at kitti_train_ours full width, 3 "
            f"frames: warmup {step_ms[engine, True]:.3f} ms, post-warmup "
            f"{step_ms[engine, False]:.3f} ms (median of 5 after one "
            f"warm-up step each); peak device memory "
            f"{peak_mib[engine]:.1f} MiB, {peak_mib[engine] - live_mib:.1f} "
            f"MiB above the {live_mib:.1f} MiB live before the steps")
    if parent is not None:
        # the band step with the parent's d_W chain (its band_gather
        # kernel, overflow_add_g, .float()) and with this one's, in turns
        band_turns = {}
        for name in ("parent", "new", "new", "parent"):
            ctx = (three_pass_band_dw(bc, lambda: parent("band_conv"))
                   if name == "parent" else contextlib.nullcontext())
            with ctx:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                for warm in (True, False):
                    train_step(bstate, gpu_batch, btcfg, btrainer.optimizer,
                               warmup=warm)                    # warm-up
                    band_turns.setdefault((name, warm), []).append(
                        median_ms(lambda: train_step(
                            bstate, gpu_batch, btcfg, btrainer.optimizer,
                            warmup=warm), 5, torch))
                band_turns.setdefault((name, "peak"), []).append(
                    torch.cuda.max_memory_allocated(dev) / 2 ** 20)
        for name in ("parent", "new"):
            say(f"[time] band train step, {name} d_W chain (turns parent, "
                f"new, new, parent): warmup " + " / ".join(
                    f"{t:.3f}" for t in band_turns[name, True])
                + " ms, post-warmup " + " / ".join(
                    f"{t:.3f}" for t in band_turns[name, False])
                + " ms; peak device memory " + " / ".join(
                    f"{m:.1f}" for m in band_turns[name, "peak"]) + " MiB")
    def nn_new():
        return chamfer._launch(src, sm, tgt, tm)

    def rg_new():
        return dma_gather._launch_row_gather(f0, idx0)
    with torch.no_grad():
        # device time (CUDA graphs) in turns with the parent's kernel;
        # the plain version, ~40 ms a call, in a graph of 2 calls
        nn = graph_us([("kernel", nn_new)] + with_parent("nn_search", nn_new),
                      10, torch)
        nn.update(graph_us([("plain", lambda: nn_search_plain(
            src, sm, tgt, tm))], 2, torch, reps=2))
        rg = graph_us([
            ("plain", lambda: f0[idx0]), ("kernel", rg_new),
            ("library", lambda: torch.index_select(f0, 0, idx0))]
            + with_parent("row_gather", rg_new), 20, torch)
    # launched from the host back to back: the wrapper's cost included
    nn_host = turns_us([("kernel", nn_new)] + with_parent("nn_search",
                                                          nn_new), 10, torch)
    rg_host = turns_us([("kernel", rg_new)] + with_parent("row_gather",
                                                          rg_new), 50, torch)
    ct0 = torch.randn(V0, f0.shape[1], device=dev)
    w_t = train_calls[1][2].to(torch.bfloat16).float().flip(0)
    w_t = w_t.transpose(1, 2).contiguous()
    bop0 = band_train_calls[1][1]                     # L0 subm band plan
    bw_t = band_train_calls[1][2].flip(0).transpose(1, 2).contiguous()
    ct_pad = bc.pad_rows(ct0, bop0.plan.v_in)
    with torch.no_grad():
        us = graph_us([
            ("B1 dgrad plain", lambda: sparse_conv_dgrad(
                ct0, op0.rb_t, w_t, bf16)),
            ("B1 dgrad", lambda: gather_matmul_dgrad(
                ct0, op0.rb_t.idx, op0.rb_t.valid, w_t, bf16)),
            ("B4 dgrad plain", lambda: bc.band_conv_plain(
                ct_pad, bw_t, bop0.plan.base, bop0.plan.sel, bf16)),
            ("B4 dgrad", lambda: bc.band_matmul_dgrad(
                ct_pad, bw_t, bop0.plan.base, bop0.plan.sel, bf16))],
            20, torch)
        dg_k, dg_p = us["B1 dgrad"], us["B1 dgrad plain"]
        bd_k, bd_p = us["B4 dgrad"], us["B4 dgrad plain"]
        say("[convs] B1 feature gradient, bf16, the 19 backward convs of a "
            "train frame (over the transposed rulebooks)")
        cases = []
        for i, (f_, op_, w_, _, _) in enumerate(train_calls):
            if i == 0:
                continue                  # its input needs no gradient
            wt_ = w_.to(bf16).float()
            wt_ = (wt_.flip(0) if op_.flip_taps else wt_)
            wt_ = wt_.transpose(1, 2).contiguous()
            ct_ = torch.randn(op_.rb.idx.shape[0], w_.shape[2], device=dev)
            rbt = op_.rb_t
            cases.append((
                f"conv {i:2d} Vin={rbt.idx.shape[0]:5d} K={rbt.idx.shape[1]:2d}"
                f" {w_.shape[2]:2d}->{w_.shape[1]:2d}",
                lambda ct_=ct_, rbt=rbt, wt_=wt_: gather_matmul_dgrad(
                    ct_, rbt.idx, rbt.valid, wt_, bf16),
                gemm_bound((ct_, rbt.idx, rbt.valid, wt_), rbt.idx.shape[0],
                           w_.shape[2], w_.shape[1], int(rbt.valid.sum()))))
        frame_ms["gather_matmul_dgrad"] = time_convs(
            "B1 dgrad", cases, torch, parent, ("gather_matmul",))
        say("[convs] B4 feature gradient, bf16, the submanifold band plans "
            "of a train frame")
        cases = []
        for i, (f_, op_, w_, _, _) in enumerate(band_train_calls):
            if i == 0 or not op_.plan.self_transpose:
                continue
            p_ = op_.plan
            wt_ = w_.flip(0).transpose(1, 2).contiguous()
            ctp = bc.pad_rows(torch.randn(p_.v_out, w_.shape[2], device=dev),
                              p_.v_in)
            cases.append((
                f"conv {i:2d} nB={p_.sel.shape[0]:3d} K={p_.sel.shape[1]:2d} "
                f"{w_.shape[2]:2d}->{w_.shape[1]:2d}",
                lambda ctp=ctp, wt_=wt_, p_=p_: bc.band_matmul_dgrad(
                    ctp, wt_, p_.base, p_.sel, bf16),
                gemm_bound((ctp, p_.base, p_.sel, wt_),
                           p_.sel.shape[0] * p_.sel.shape[2], w_.shape[2],
                           w_.shape[1], band_pairs(p_))))
        frame_ms["band_matmul_dgrad"] = time_convs(
            "B4 dgrad", cases, torch, parent, ("band_conv",))
        say("[convs] d_W im2col, bf16, the 20 train convs: the fused "
            "row_gather against row_gather + torch.where + round_operand "
            "(three passes, as the parent's sparse_conv_grads ran them)"
            + ("" if parent is None else
               ", with this checkout's and with the parent's row_gather"))
        im2col = {}
        for i, (f_, op_, *_) in enumerate(train_calls):
            f_ = f_.contiguous()
            idx_, val_ = op_.rb.idx.reshape(-1), op_.rb.valid.reshape(-1)

            def three_pass(f_=f_, idx_=idx_, val_=val_):
                g = dma_gather._launch_row_gather(f_, idx_)
                return sc.round_operand(torch.where(val_[:, None], g, 0.0),
                                        bf16)
            us = graph_us([
                ("three-pass", three_pass),
                ("fused", lambda f_=f_, idx_=idx_, val_=val_: row_gather(
                    f_, idx_, check=False, valid=val_, compute_dtype=bf16))]
                + with_parent("row_gather", three_pass), 20, torch)
            for k, v in us.items():
                im2col[k] = im2col.get(k, 0.0) + v / 1e3
            bnd = bound_ms(nbytes(f_, idx_, val_) +
                           idx_.numel() * f_.shape[1] * 4)
            V_, K_ = op_.rb.idx.shape
            say(f"  im2col conv {i:2d} V={V_:5d} K={K_:2d} Cin={f_.shape[1]:2d}"
                f" ({float(val_.float().mean()):.3f} of taps valid): fused "
                f"{us['fused']:8.2f} us, three-pass {us['three-pass']:8.2f} "
                f"us ({us['three-pass'] / us['fused']:.2f}x)" + (
                    "" if parent is None else
                    f", parent three-pass {us['parent']:8.2f} us "
                    f"({us['parent'] / us['fused']:.2f}x)")
                + f"; bound {bnd[0] * 1e3:7.2f} us ({bnd[1]})")
        frame_ms["row_gather"] = im2col["fused"]
        say(f"[convs] d_W im2col: frame sum fused {im2col['fused']:.4f} ms, "
            f"three-pass {im2col['three-pass']:.4f} ms" + (
                "" if parent is None else
                f", parent three-pass {im2col['parent']:.4f} ms "
                f"({im2col['fused'] / im2col['parent']:.3f} of it)")
            + " over 20 convs")
        say("[convs] band d_W operand, bf16, the submanifold plans of a "
            "train frame: band_gather's fused mode against band_gather + "
            "overflow_add_g + .float() (three passes, as the parent's "
            "backward ran them)" + ("" if parent is None else
                                    ", with this checkout's and with the "
                                    "parent's band_gather"))
        dw_sum, faster = {}, 0
        for i, (f_, op_, *_) in enumerate(band_train_calls):
            p_ = op_.plan
            if not p_.self_transpose:
                continue
            fp_ = bc.pad_rows(f_, p_.v_in).contiguous()
            ov_ = (p_.ov_out, p_.ov_in, p_.ov_tap)

            def chain(fp_=fp_, p_=p_, ov_=ov_):
                g = bc.band_gather(fp_, p_.base, p_.sel, bf16)
                return bc.overflow_add_g(g, fp_, *ov_).float()
            us = graph_us([
                ("three-pass", chain),
                ("fused", lambda fp_=fp_, p_=p_, ov_=ov_: bc.band_gather(
                    fp_, p_.base, p_.sel, bf16, overflow=ov_))]
                + with_parent("band_conv", chain), 20, torch)
            for k, v in us.items():
                dw_sum[k] = dw_sum.get(k, 0.0) + v / 1e3
            faster += us["fused"] < us.get("parent", us["three-pass"])
            nB_, K_, B_ = p_.sel.shape
            bnd = bound_ms(nbytes(fp_, p_.base, p_.sel, *ov_) +
                           nB_ * B_ * K_ * fp_.shape[1] * 4)
            say(f"  d_W operand conv {i:2d} nB={nB_:3d} K={K_:2d} "
                f"Cin={fp_.shape[1]:2d} ({int(p_.ov_count)} overflow "
                f"pairs): fused {us['fused']:8.2f} us, three-pass "
                f"{us['three-pass']:8.2f} us "
                f"({us['three-pass'] / us['fused']:.2f}x)" + (
                    "" if parent is None else
                    f", parent three-pass {us['parent']:8.2f} us "
                    f"({us['parent'] / us['fused']:.2f}x)")
                + f"; bound {bnd[0] * 1e3:7.2f} us ({bnd[1]})")
        frame_ms["band_gather"] = dw_sum["fused"]
        say(f"[convs] band d_W operand: frame sum fused "
            f"{dw_sum['fused']:.4f} ms, three-pass "
            f"{dw_sum['three-pass']:.4f} ms" + (
                "" if parent is None else
                f", parent three-pass {dw_sum['parent']:.4f} ms "
                f"({dw_sum['fused'] / dw_sum['parent']:.3f} of it)")
            + f"; the fused mode faster at {faster} of {n_st} plans")
        d = dense
        dw_t = d["w"].flip(0).transpose(1, 2).contiguous()
        dwr_t = dw_t.to(bf16).float()
        V_d, C_d = d["f"].shape
        pairs_d = int(d["rb"].valid.sum())
        say(f"[convs] the dense cube, {V_d} rows, {C_d} -> {C_d}")
        time_convs("dense", [
            ("B1 bf16", lambda: gather_matmul(
                d["f"], d["rb"].idx, d["rb"].valid, d["w"], d["b"], d["om"],
                bf16), gemm_bound((d["f"], d["rb"].idx, d["rb"].valid,
                                   d["w"], d["b"], d["om"]), V_d, C_d, C_d,
                                  pairs_d)),
            ("B1 f32", lambda: gather_matmul(
                d["f"], d["rb"].idx, d["rb"].valid, d["w"], d["b"], d["om"],
                torch.float32), bound_ms(nbytes(
                    d["f"], d["rb"].idx, d["rb"].valid, d["w"], d["b"],
                    d["om"]) + V_d * C_d * 4, 2.0 * pairs_d * C_d * C_d,
                    "f32")),
            ("B1 dgrad bf16", lambda: gather_matmul_dgrad(
                d["ct"], d["rb"].idx, d["rb"].valid, dwr_t, bf16),
             gemm_bound((d["ct"], d["rb"].idx, d["rb"].valid, dwr_t), V_d,
                        C_d, C_d, pairs_d)),
            ("B4 bf16", lambda: bc.band_matmul(
                d["f_pad"], d["w"], d["plan"].base, d["plan"].sel, bf16),
             gemm_bound((d["f_pad"], d["plan"].base, d["plan"].sel, d["w"]),
                        V_d, C_d, C_d, band_pairs(d["plan"]))),
            ("B4 dgrad bf16", lambda: bc.band_matmul_dgrad(
                d["ct_pad"], dw_t, d["plan"].base, d["plan"].sel, bf16),
             gemm_bound((d["ct_pad"], d["plan"].base, d["plan"].sel, dw_t),
                        V_d, C_d, C_d, band_pairs(d["plan"])))],
            torch, parent, ("gather_matmul", "band_conv"))
    n_pairs = sum(int(sm[p].sum()) * int(tm[p].sum())
                  for p in range(src.shape[0]))
    nn_bound = bound_ms(nbytes(src, sm, tgt, tm) + src.shape[0] *
                        src.shape[1] * 8, 9.0 * n_pairs, "f32")
    rg_bound = bound_ms(nbytes(f0, idx0) + nbytes(got))
    dg_bound = bound_ms(
        nbytes(ct0, op0.rb_t.idx, op0.rb_t.valid, w_t) + nbytes(f0),
        2.0 * int(op0.rb_t.valid.sum()) * w_t.shape[1] * w_t.shape[2])
    bnB, _, bB = bop0.plan.sel.shape
    bd_bound = bound_ms(
        nbytes(ct_pad, bop0.plan.base, bop0.plan.sel, bw_t) +
        bnB * bB * bw_t.shape[2] * 4,
        2.0 * band_pairs(bop0.plan) * bw_t.shape[1] * bw_t.shape[2])
    # the distances' 8 rounded ops (3 sub, 3 mul, 2 add) may not fuse, so
    # they issue one by one: the half-rate floor beside the bound
    nn_floor = 8.0 * n_pairs / (PEAK_FLOPS["f32"] / 2) * 1e3
    say(f"[time] nn_search P={src.shape[0]} N={src.shape[1]} "
        f"M={tgt.shape[1]}: kernel {nn['kernel']:.2f} us/call" + (
            "" if parent is None else
            f", parent {nn['parent']:.2f} ({nn['parent'] / nn['kernel']:.2f}x)")
        + f", plain {nn['plain']:.2f} us/call (device time, in turns); "
        f"launched from the host: kernel {nn_host['kernel']:.2f} us/call" + (
            "" if parent is None else f", parent {nn_host['parent']:.2f}")
        + f"; bound {nn_bound[0] * 1e3:.2f} us ({nn_bound[1]}, {n_pairs} "
        f"valid pairs), unfused-op floor {nn_floor * 1e3:.2f} us")
    say(f"[time] row_gather L0 im2col {tuple(got.shape)}: kernel "
        f"{rg['kernel']:.2f} us/call" + (
            "" if parent is None else
            f", parent {rg['parent']:.2f} ({rg['parent'] / rg['kernel']:.2f}x)")
        + f", plain features[idx] {rg['plain']:.2f} us/call, "
        f"torch.index_select {rg['library']:.2f} us/call (device time, in "
        f"turns); launched from the host: kernel {rg_host['kernel']:.2f} "
        f"us/call" + ("" if parent is None else
                      f", parent {rg_host['parent']:.2f}")
        + f"; bound {rg_bound[0] * 1e3:.2f} us ({rg_bound[1]})")
    say(f"[time] gather_matmul_dgrad L0 subm V={V0} Cout=16 -> Cin=16 "
        f"bf16: kernel {dg_k:.2f} us/call, plain sparse_conv_dgrad "
        f"{dg_p:.2f} us/call (device time, in turns); bound "
        f"{dg_bound[0] * 1e3:.2f} us ({dg_bound[1]})")
    say(f"[time] band_matmul_dgrad L0 subm plan, Cout=16 -> Cin=16 bf16: "
        f"kernel {bd_k:.2f} us/call, plain band_conv_plain {bd_p:.2f} "
        f"us/call (device time, in turns); bound {bd_bound[0] * 1e3:.2f} us "
        f"({bd_bound[1]})")
    kernel_rows["gather_matmul_dgrad"] = dict(
        source="rslo_tpu_torch/csrc/gather_matmul.cu",
        replaces="rslo_tpu/ops/dma_gather.py:132",
        max_abs_err=max(bwd_worst["rulebook", d] for d in ("bf16", "f32")),
        ms=dg_k / 1e3, plain_ms=dg_p / 1e3, bound=dg_bound, library_ms=None)
    kernel_rows["row_gather"] = dict(
        source="rslo_tpu_torch/csrc/row_gather.cu",
        replaces="rslo_tpu/ops/dma_gather.py:62", max_abs_err=0.0,
        ms=rg["kernel"] / 1e3, plain_ms=rg["plain"] / 1e3, bound=rg_bound,
        library_ms=rg["library"] / 1e3, host_ms=rg_host["kernel"] / 1e3)
    kernel_rows["nn_search"] = dict(
        source="rslo_tpu_torch/csrc/nn_search.cu",
        replaces="rslo_tpu/ops/chamfer.py:109", max_abs_err=0.0,
        ms=nn["kernel"] / 1e3, plain_ms=nn["plain"] / 1e3, bound=nn_bound,
        library_ms=None, host_ms=nn_host["kernel"] / 1e3)
    kernel_rows["band_matmul_dgrad"] = dict(
        source="rslo_tpu_torch/csrc/band_conv.cu",
        replaces="rslo_tpu/ops/band_conv.py:222",
        max_abs_err=max(bwd_worst["band", d] for d in ("bf16", "f32")),
        ms=bd_k / 1e3, plain_ms=bd_p / 1e3, bound=bd_bound, library_ms=None)

    # -- 12. card vs CPU, float32 two-frame forward; band vs rulebook ------
    cfg32 = cfg.replace(
        middle=dataclasses.replace(cfg.middle, conv_dtype="f32"),
        odom=dataclasses.replace(cfg.odom, compute_dtype="fp32"))
    cpu_state = {k: v.cpu() for k, v in net.state_dict().items()}
    net32 = OdomNet(cfg32)
    net32.load_state_dict(cpu_state)
    cpu_out = two_frame(net32, torch.device("cpu"))
    gpu_out = two_frame(copy.deepcopy(net32).to(dev), dev)
    pairs_out = [(key, gpu_out[key], cpu_out[key])
                 for key in ("odometry", "tq_map", "t_conf", "q_conf")]
    pairs_out += [(f"voxel_covs[{t}]", gpu_out["voxel_covs"][t],
                   cpu_out["voxel_covs"][t]) for t in range(2)]
    for key, a, b in pairs_out:
        a, b = a.cpu().numpy(), b.numpy()
        scale = np.abs(b).max()
        err = np.abs(a - b).max() if a.shape == b.shape else np.inf
        say(f"[cpu-ref] f32 {key}: card vs cpu max |diff| {err:.3e}, "
            f"max |cpu| {scale:.3e}")
        if not err <= CPU_TOL * scale:
            fail(f"f32 two-frame {key} on the card != the CPU reference")
    bcfg32 = cfg32.replace(middle=dataclasses.replace(cfg32.middle,
                                                      engine="band"))
    bnet32 = OdomNet(bcfg32)
    bnet32.load_state_dict(cpu_state)
    band_out = two_frame(bnet32.to(dev), dev)
    for key in ("odometry", "tq_map", "t_conf", "q_conf"):
        a, b = band_out[key].cpu().numpy(), gpu_out[key].cpu().numpy()
        scale = np.abs(b).max()
        err = np.abs(a - b).max() if a.shape == b.shape else np.inf
        say(f"[band-ref] f32 two-frame {key}: band vs rulebook on the card "
            f"max |diff| {err:.3e}, max |rulebook| {scale:.3e}")
        if not err <= CPU_TOL * scale:
            fail(f"f32 two-frame {key}: band engine != rulebook engine")

    # -- 13. card vs CPU, one float32 train step; band vs rulebook --------
    tcfg32 = tcfg.replace(
        middle=dataclasses.replace(tcfg.middle, conv_dtype="f32"),
        odom=dataclasses.replace(tcfg.odom, compute_dtype="fp32"))
    # the seeded initial weights: the trained ones differ from run to run
    # (4 steps of a chaotic trajectory whose device sums use atomics), and
    # with them the size of each loss term the check compares
    weights = {k: v.cpu() for k, v in initial.items()}
    noise_gen = torch.Generator().manual_seed(SEED)

    def jitter(ws):
        return {k: v * (1 + TRAIN_GRAD_NOISE * torch.randn(
            v.shape, generator=noise_gen)) if v.is_floating_point() else v
            for k, v in ws.items()}
    jittered = jitter(weights)
    btcfg32 = tcfg32.replace(middle=dataclasses.replace(tcfg32.middle,
                                                        engine="band"))
    cpu = torch.device("cpu")
    runs = [("card", dev, weights, tcfg32),
            ("card, jittered weights", dev, jittered, tcfg32),
            ("card, band engine", dev, weights, btcfg32),
            ("card, band engine, jittered weights", dev, jittered, btcfg32),
            ("cpu", cpu, weights, tcfg32)]
    if parent is not None:
        trained = {k: v.cpu() for k, v in state.model.state_dict().items()}
        runs += [("card, trained weights", dev, trained, tcfg32),
                 ("card, trained weights, jittered", dev, jitter(trained),
                  tcfg32),
                 ("card, trained weights, the parent's kernels", dev,
                  trained, tcfg32, parent),
                 ("cpu, trained weights", cpu, trained, tcfg32)]
    outs = {}
    for name, device, w, cfg_, *route in runs:
        model = OdomNet(cfg_).to(device)
        model.load_state_dict(w)
        st = TrainState.create(model, make_optimizer(cfg_, model),
                               {"rot": -2.5, "trans": 0.0})
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batches[0].items()}
        t0 = time.perf_counter()
        with (route[0] if route else contextlib.nullcontext)():
            out, grads = loss_and_grads(st, batch, cfg_, warmup=False)
        outs[name] = ({k: float(v) for k, v in out.aux.items()},
                      {k: g.detach().cpu().double() for k, g in
                       grads.items()})
        say(f"[cpu-ref] f32 train step on the {name}: "
            f"{time.perf_counter() - t0:.2f} s")

    def loss_limit(want):
        """The loss terms' bound, as np.isclose(got, want, **TRAIN_LOSS_TOL)
        takes it."""
        return TRAIN_LOSS_TOL["atol"] + TRAIN_LOSS_TOL["rtol"] * abs(want)

    def rel_err(a, b):
        return float((a - b).norm()) / float(b.norm())

    def compare_steps(tag, what, got, ref, got_jittered):
        """Loss terms to TRAIN_LOSS_TOL; each leaf's gradient to
        TRAIN_GRAD_FACTOR x its measured sensitivity + TRAIN_GRAD_ABS."""
        (aux_g, g_g), (aux_r, g_r), (aux_j, g_j) = got, ref, got_jittered
        for key, want in aux_r.items():
            lim = loss_limit(want)
            say(f"[{tag}] f32 train {key}: {what} {aux_g[key]:.7g} vs "
                f"{want:.7g}, |diff| {abs(aux_g[key] - want) / lim:.3f} of "
                f"the limit; jittered weights move it by "
                f"{abs(aux_j[key] - aux_g[key]) / lim:.3f} of the limit")
            if not np.isclose(aux_g[key], want, **TRAIN_LOSS_TOL):
                fail(f"f32 train step {key}: {what} differ")
        top = max(float(g.norm()) for g in g_r.values())
        leaves = [k for k, g in g_r.items()
                  if float(g.norm()) >= 1e-6 * top]
        err = {k: rel_err(g_g[k], g_r[k]) for k in leaves}
        sens = {k: rel_err(g_j[k], g_g[k]) for k in leaves}
        ratio = {k: err[k] / (TRAIN_GRAD_FACTOR * sens[k] + TRAIN_GRAD_ABS)
                 for k in leaves}
        worst = max(ratio, key=ratio.get)
        say(f"[{tag}] f32 train gradients, {len(leaves)} of {len(g_r)} "
            f"leaves: {what} relative L2 error median "
            f"{statistics.median(err.values()):.3e}, max "
            f"{max(err.values()):.3e}; sensitivity to weights jittered by "
            f"{TRAIN_GRAD_NOISE:g}: median "
            f"{statistics.median(sens.values()):.3e}, max "
            f"{max(sens.values()):.3e}; tightest leaf {worst}: error "
            f"{err[worst]:.3e}, sensitivity {sens[worst]:.3e}")
        if ratio[worst] > 1.0:
            fail(f"f32 train gradients, {what}: {worst} error "
                 f"{err[worst]:.3e} > {TRAIN_GRAD_FACTOR:g} * "
                 f"{sens[worst]:.3e} + {TRAIN_GRAD_ABS:g}")

    compare_steps("cpu-ref", "card vs cpu", outs["card"], outs["cpu"],
                  outs["card, jittered weights"])
    compare_steps("band-ref", "band vs rulebook engine on the card",
                  outs["card, band engine"], outs["card"],
                  outs["card, band engine, jittered weights"])
    if parent is not None:
        # a reading, not a check: how far the card is from the CPU at the
        # trained weights, with either checkout's kernels, against the
        # change that jittering those weights makes on the card
        ref = outs["cpu, trained weights"][0]
        for key, want in ref.items():
            lim = loss_limit(want)
            got = {n: outs[f"card, trained weights{s}"][0][key] for n, s in (
                ("this", ""), ("parent", ", the parent's kernels"),
                ("jittered", ", jittered"))}
            say(f"[trained] f32 train {key}: cpu {want:.7g}; |card - cpu| "
                f"of the limit: this checkout's kernels "
                f"{abs(got['this'] - want) / lim:.3f}, the parent's "
                f"{abs(got['parent'] - want) / lim:.3f}; jittered weights "
                f"move the card's by "
                f"{abs(got['jittered'] - got['this']) / lim:.3f}")

    # -- 14. evaluate: the CLI's evaluate verb from phase 10's checkpoints --
    from rslo_tpu_torch import cli
    eval_launches = dict.fromkeys(counted, 0)
    for engine, model_dir, kernel in (
            ("rulebook", TRAIN_DIR, "gather_matmul"),
            ("band", BAND_TRAIN_DIR, "band_matmul")):
        got_launches = evaluate_and_check(
            engine, model_dir, kernel, bcfg if engine == "band" else cfg,
            cli, Trainer, counted, reset_counts, counts, prepare_example,
            vcfg, dev, smi_line, np, torch)
        for k, n in got_launches.items():
            eval_launches[k] += n
    trainer.logger.close()
    btrainer.logger.close()
    shutil.rmtree(BAND_TRAIN_DIR, ignore_errors=True)

    # -- 15-18. the pillar configuration and the train verb ----------------
    more = pillar_and_verb_phases(
        pillar_config(PipelineCfg), TRAIN_CONFIG, rb_ops, frames, dev,
        smi_line, counted, reset_counts, counts,
        lambda *a, **kw: evaluate_and_check(
            *a, cli, Trainer, counted, reset_counts, counts,
            prepare_example, kw.pop("vcfg"), dev, smi_line, np, torch, **kw),
        np, torch)

    # -- 19-20. the refined evaluation; refinement, card against CPU -------
    more.update(refined_phases(cfg, TRAIN_DIR, cli, Trainer, counted,
                               reset_counts, counts, dev, smi_line, np,
                               torch))
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    # -- 21. the data build, its input variants and true loops -------------
    more.update(data_build_phases(cfg, tcfg, rb_ops, cli, Trainer, counted,
                                  reset_counts, counts, dev, smi_line, np,
                                  torch))

    # -- 22. every BEV-net option of the schema; DenseMiddleCov ------------
    more.update(option_phases(
        rb_ops, frames, cli, Trainer, counted, reset_counts, counts,
        lambda name, model_dir, kernel, cfg_: evaluate_and_check(
            name, model_dir, kernel, cfg_, cli, Trainer, counted,
            reset_counts, counts, prepare_example, voxelizer_config(cfg_),
            dev, smi_line, np, torch),
        dev, smi_line, np, torch))

    # -- 23. data-parallel training and evaluation ------------------------
    more.update(data_parallel_phases(tcfg, batches, trainer.history, rb_ops,
                                     cli, Trainer, counted, reset_counts,
                                     counts, dev, smi_line, np, torch))

    # -- 24. the BEV stage split over ranks; the bench; small modules ------
    pair = torch.as_tensor(np.stack(frames[:2]), device=dev)
    more.update(split_phases(
        cfg, prepare_example(pair, torch.ones(pair.shape[:2], dtype=bool,
                                              device=dev),
                             vcfg, mean_mode=True),
        lambda: cli.main(["bench"]), counted, reset_counts, counts, dev,
        smi_line, np, torch, frames[0]))

    say(smi_line)
    rows = []
    for name, row in kernel_rows.items():
        launches = (band_train_launches if name.startswith("band")
                    else train_launches)[name]
        rows.append({"name": name, "route": "cuda", "source": row["source"],
                     "replaces": row["replaces"], "launches": launches,
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
                     "bound_by": row["bound"][1],
                     "library_ms": row["library_ms"],
                     # launches in phase 14's evaluations, both engines
                     "eval_launches": eval_launches[name],
                     # launches on the paths of phases 15-21: pillar
                     # streaming, the pillar train verb (both legs, the
                     # eval hook included), evaluate --ckpt_step best on
                     # it, the train verb on kitti_train_ours.json, the
                     # refined evaluate verb with each flag, loop
                     # closing on phase 20's circuit, the hier-cloud and
                     # cross-normal training and loop closing on the
                     # rendered loop; phase 22's train verb, evaluate verb
                     # and streaming of each BEV-net option run;
                     # phase 23's train verb on NCCL at world size 1
                     # and rank 0's Trainer.fit over the gloo ranks;
                     # phase 24's split forwards (rank 0's, bf16) and
                     # the bench verb
                     **{path: n[name] for path, n in more.items()},
                     # the device times' sum over one frame's convs, for
                     # the kernels timed conv by conv (row_gather: the
                     # fused d_W im2col; band_gather: the fused d_W
                     # operand of the submanifold plans)
                     "frame_ms": frame_ms.get(name),
                     "host_ms": row.get("host_ms")})
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
