"""Smoke run of the PyTorch port (``rslo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``rslo_tpu_torch/csrc/`` and drives
its two main paths with seeded random weights: the serving path,
``StreamingOdometry``, at the full width of ``configs/kitti_eval_ours.json``,
and the self-supervised train step, ``Trainer.fit``, at the full width
of ``configs/kitti_train_ours.json``.  Phases (each one exits non-zero
when it fails):

  1. require a CUDA card; print its name and power limit; turn TF32 off
  2. build the kernels (one nvcc per source, all at once)
  3. hold ``gather_matmul`` against its plain version on the card, at
     the 20 sparse-conv calls of one KITTI-scale frame, in bf16 and f32,
     plus an edge case (all-invalid rows, masked rows, ragged V, NaN
     rows that only invalid taps point at)
  4. stream 8 synthetic KITTI-scale scans: finite poses, exactly 20
     kernel launches per scan, pose after scan 2 == the two-frame
     forward
  5. time streaming, the two-frame forward and the kernel vs its plain
     version
  6. ``nn_search`` (B3) bit-equal to its plain version at the deployed
     3 x 20000 x 20000, plus ties, an all-invalid tgt, masked src rows
     and ragged N, M
  7. ``row_gather`` (B2) bit-equal to ``features[idx]`` at the L0 im2col
  8. the sparse conv's backward (``gather_matmul_dgrad`` + ``row_gather``
     + one f32 product) against torch autograd through the plain
     ``sparse_conv_apply``, at the 20 conv calls of one frame, bf16, f32
  9. train: ``Trainer.fit`` for 2 warmup and 2 post-warmup steps on
     3-frame windows of 100k-point scans padded to 131072 (for this run
     only ``loss.warmup_steps`` is 1: a step is a warmup step while its
     index, from 0, is <= warmup_steps); finite metrics, changed
     parameters and statistics, each kernel's launches per step equal to
     the prediction; the checkpoint written and restored
 10. time the train step (both variants), peak device memory, and each
     new kernel against its plain version
     (phases 5 and 10 run before 11 and 12, whose CPU threads would
     share the host)
 11. the two-frame forward on the card against the same model on the
     CPU (plain versions), in float32 at the same widths
 12. one f32 train step on the card against the CPU, same weights and
     batch: loss terms and per-leaf gradients

The last two lines of standard output are the kernel summary (JSON)
and the result (JSON); the card's ``nvidia-smi`` line comes before.
Needs one card, no network, and no JAX.
"""
import copy
import dataclasses
import json
import math
import os
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
KERNELS = ("gather_matmul", "row_gather", "nn_search")
N_SCANS = 8
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
# streaming vs two-frame: the same kernels on the same inputs
POSE_TOL = dict(rtol=1e-5, atol=1e-5)
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
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")


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


def plain_vs_kernel_us(plain, kern, n, torch):
    """Mean µs per call of each, timed in the order plain, kernel,
    kernel, plain."""
    us = {"plain": [], "kernel": []}
    for name, fn in (("plain", plain), ("kernel", kern), ("kernel", kern),
                     ("plain", plain)):
        us[name].append(event_us(fn, n, torch))
    return statistics.mean(us["kernel"]), statistics.mean(us["plain"])


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


def predicted_launches(net, cfg, warmup):
    """Kernel launches of one train step: every sparse conv of every
    frame runs ``gather_matmul`` once forward and ``row_gather`` once
    for its d_W; every conv but the first (whose input needs no
    gradient) runs ``gather_matmul_dgrad`` once; each ICP round runs one
    ``nn_search`` for all pairs."""
    n_conv = len(net.middle._convs)
    L = cfg.data.seq_length
    return {"gather_matmul": n_conv * L,
            "gather_matmul_dgrad": (n_conv - 1) * L,
            "row_gather": n_conv * L,
            "nn_search": (cfg.loss.warmup_icp_iter if warmup
                          else cfg.loss.icp_iter)}


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


def check_backward(calls, torch, sparse_conv, sparse_conv_apply,
                   sparse_conv_dgrad, dt_name):
    """The autograd conv (kernels) against torch autograd through the
    plain conv, for d_features, d_W and d_bias; returns the largest
    |error|."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dt_name]
    rel = BWD_REL_TOL[dt_name]
    gen = torch.Generator(device=calls[0][0].device).manual_seed(SEED)
    worst = 0.0
    for n, (f, op, w, b, om) in enumerate(calls):
        V, K = op.rb.idx.shape
        ct = torch.randn(V, w.shape[2], device=f.device, generator=gen)
        grads = []
        for use_kernel in (True, False):
            fi = f.clone().requires_grad_(n > 0)
            wi = w.clone().requires_grad_()
            bi = b.clone().requires_grad_()
            if use_kernel:
                out = sparse_conv(fi, op.rb, op.rb_t, wi, bi, om, dt,
                                  op.flip_taps)
            else:
                out = sparse_conv_apply(fi, op.rb, wi, bi, om, dt)
            out.backward(ct)
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
            worst = max(worst, err.max().item())
            line.append(f"{what} {err.max().item():.2e}")
        say(f"  conv {n:2d} V={V:5d} K={K:2d} {dt_name:4s} max |err|: "
            f"{', '.join(line)}")
    return worst


def main():
    import numpy as np
    import torch

    smi_line = require_card(torch)
    sys.path.insert(0, REPO)
    from rslo_tpu.config.schema import PipelineCfg
    from rslo_tpu_torch.data.prepare import prepare_example, voxelizer_config
    from rslo_tpu_torch.eval.streaming import StreamingOdometry
    from rslo_tpu_torch.geometry import np_compose_pose
    from rslo_tpu_torch.models.net import OdomNet
    from rslo_tpu_torch.ops import _build, chamfer, dma_gather
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
    counted = {"gather_matmul": gather_matmul,
               "gather_matmul_dgrad": gather_matmul_dgrad,
               "row_gather": row_gather, "nn_search": nn_search}

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counted.items()}

    # -- 2. build ---------------------------------------------------------
    build_kernels(_build)

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

    def encode(scan):
        pts = torch.as_tensor(scan, device=dev)
        ex = prepare_example(pts[None], torch.ones(1, len(scan), dtype=bool,
                                                   device=dev),
                             vcfg, mean_mode=True)
        return net.frame_features(ex["voxel_features"][0], ex["coords"][0],
                                  ex["voxel_mask"][0])

    with torch.no_grad():
        calls = capture_conv_calls(net, lambda: encode(frames[0]))
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

    # -- 4. the serving path: streaming -------------------------------------
    stream = StreamingOdometry(net, cfg, dev)
    reset_counts()
    for scan in frames:
        stream.push(scan)
    torch.cuda.synchronize()
    launches = gather_matmul.launches
    poses = np.stack(stream.trajectory)
    say(f"[stream] {N_SCANS} scans, {launches} gather_matmul launches; "
        f"last pose {np.array2string(poses[-1], precision=5)}")
    if launches != 20 * N_SCANS:
        fail(f"expected {20 * N_SCANS} kernel launches, saw {launches}")
    if poses.shape != (N_SCANS, 7) or not np.isfinite(poses).all():
        fail(f"bad trajectory {poses.shape}: {poses}")

    def two_frame(model, device):
        pts = torch.as_tensor(np.stack(frames[:2]), device=device)
        ex = prepare_example(pts, torch.ones(pts.shape[:2], dtype=bool,
                                             device=device),
                             vcfg, mean_mode=True)
        with torch.no_grad():
            return model(ex)

    two = two_frame(net, dev)["odometry"][0].cpu().numpy()
    expect = np_compose_pose(poses[0][None], two[None])[0]
    say(f"[stream] pose after scan 2 {np.array2string(poses[1], precision=6)}"
        f" vs two-frame forward {np.array2string(expect, precision=6)}; "
        f"max |diff| {np.abs(poses[1] - expect).max():.3e}")
    if not np.allclose(poses[1], expect, **POSE_TOL):
        fail("streaming pose after scan 2 != two-frame forward")

    # -- 5. timing of the serving path -------------------------------------
    stream = StreamingOdometry(net, cfg, dev)
    for scan in frames[:3]:                   # warm-up
        stream.push(scan)
    it = iter(frames * 3)
    stream_ms = median_ms(lambda: stream.push(next(it)), 20, torch)
    two_ms = median_ms(lambda: two_frame(net, dev), 10, torch)
    f, rb, w, b, om = calls[1]                # L0 subm, 16 -> 16
    V, K = rb.idx.shape
    with torch.no_grad():
        k_us, p_us = plain_vs_kernel_us(
            lambda: sparse_conv_apply(f, rb, w, b, om, torch.bfloat16),
            lambda: gather_matmul(f, rb.idx, rb.valid, w, b, om,
                                  torch.bfloat16), 50, torch)
    say(f"[time] streaming {stream_ms:.3f} ms/scan "
        f"({1e3 / stream_ms:.2f} scans/s), median of 20 after warm-up")
    say(f"[time] two-frame forward {two_ms:.3f} ms, median of 10")
    say(f"[time] L0 subm conv V={V} K={K} Cin={f.shape[1]} "
        f"Cout={w.shape[2]} bf16: gather_matmul {k_us:.2f} us/call, plain "
        f"sparse_conv_apply {p_us:.2f} us/call (plain, kernel, kernel, "
        f"plain; 50 calls each)")
    kernel_rows = {"gather_matmul": dict(
        source="rslo_tpu_torch/csrc/gather_matmul.cu",
        replaces="rslo_tpu/ops/dma_gather.py:132", max_abs_err=worst,
        ms=k_us / 1e3, plain_ms=p_us / 1e3)}

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

    # -- 6. B3 nn_search bit-equal to its plain version ---------------------
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

    # -- 7. B2 row_gather bit-equal to features[idx] ------------------------
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
    say(f"[row_gather] L0 im2col {tuple(got.shape)}: bit-equal to "
        f"features[idx]; out-of-range indices raise")

    # -- 8. the sparse conv's backward against autograd ----------------------
    bwd_worst = {}
    for dt_name in ("bf16", "f32"):
        say(f"[backward] {dt_name}: |err| <= {BWD_REL_TOL[dt_name]:g} * "
            f"sum|terms| + {KERNEL_ABS_TOL:g} (d_bias {KERNEL_REL_TOL:g})")
        bwd_worst[dt_name] = check_backward(
            train_calls, torch, sparse_conv, sparse_conv_apply,
            sparse_conv_dgrad, dt_name)

    # -- 9. the train path: Trainer.fit --------------------------------------
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    trainer = Trainer(tcfg, TRAIN_DIR, dev)
    state = trainer.init_state()
    before = {k: v.detach().clone()
              for k, v in state.model.state_dict().items()}
    per_step = []

    def counted_batches():
        for batch in batches:
            reset_counts()
            yield batch
            per_step.append(counts())         # the step has been launched

    reset_counts()
    t0 = time.perf_counter()
    state = trainer.fit(counted_batches(), state, max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_launches = {k: sum(c[k] for c in per_step) for k in counted}
    if state.step != TRAIN_STEPS or len(per_step) != TRAIN_STEPS:
        fail(f"fit ran {state.step} steps, counted {len(per_step)}")
    for k, c in enumerate(per_step):
        warm = k <= tcfg.loss.warmup_steps
        want = predicted_launches(state.model, tcfg, warm)
        say(f"[train] step {k} ({'warmup' if warm else 'post-warmup'}): "
            f"launches {c} (predicted {want})")
        if c != want:
            fail(f"step {k}: launches {c} != predicted {want}")
    for step_i, row in trainer.history:
        bad = [k for k, v in row.items() if not math.isfinite(v)]
        say(f"[train] step {step_i}: loss {row['loss']:.5f} consistency "
            f"{row['consistency_loss']:.5f} pyramid "
            f"{row['pyramid_loss']:.5f} grad_norm {row['grad_norm']:.4f} "
            f"alpha_rot {row['alpha_rot']:.6f} alpha_trans "
            f"{row['alpha_trans']:.6f}")
        if bad:
            fail(f"step {step_i}: non-finite metrics {bad}")
    if len(trainer.history) != TRAIN_STEPS:
        fail(f"expected {TRAIN_STEPS} logged steps, got "
             f"{len(trainer.history)}")
    after = state.model.state_dict()
    same = [k for k, v in before.items() if torch.equal(v, after[k])]
    if same:
        fail(f"train steps left {len(same)} tensors unchanged: {same[:5]}")
    n_stats = sum(1 for k in after if k.endswith((".mean", ".var")))
    say(f"[train] Trainer.fit: {TRAIN_STEPS} steps in {fit_s:.2f} s (first "
        f"step included); all {len(after) - n_stats} parameters and "
        f"{n_stats} running statistics changed")
    restored = Trainer(tcfg, TRAIN_DIR, dev).init_state()
    diff = [k for k, v in after.items()
            if not torch.equal(v, restored.model.state_dict()[k])]
    if (diff or restored.step != TRAIN_STEPS or
            restored.opt_state.count != TRAIN_STEPS or
            trainer.ckpt.latest_step() != TRAIN_STEPS):
        fail(f"checkpoint restore mismatch: step {restored.step}, "
             f"{len(diff)} tensors differ")
    say(f"[train] checkpoint {trainer.ckpt.latest_step()} written and "
        f"restored: step, optimizer count and all tensors equal")

    # -- 10. timing of the train path and the new kernels -------------------
    opt = trainer.optimizer
    step_ms = {}
    torch.cuda.reset_peak_memory_stats(dev)
    for warm in (True, False):
        train_step(state, gpu_batch, tcfg, opt, warmup=warm)   # warm-up
        step_ms[warm] = median_ms(lambda: train_step(
            state, gpu_batch, tcfg, opt, warmup=warm), 5, torch)
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    say(f"[time] train step at kitti_train_ours full width, 3 frames: "
        f"warmup {step_ms[True]:.3f} ms, post-warmup {step_ms[False]:.3f} "
        f"ms (median of 5 after one warm-up step each); peak device memory "
        f"{peak_mib:.1f} MiB")
    nn_k, nn_p = plain_vs_kernel_us(
        lambda: nn_search_plain(src, sm, tgt, tm),
        lambda: chamfer._launch(src, sm, tgt, tm), 10, torch)
    rg_k, rg_p = plain_vs_kernel_us(
        lambda: f0[idx0], lambda: dma_gather._launch_row_gather(f0, idx0),
        50, torch)
    ct0 = torch.randn(V0, f0.shape[1], device=dev)
    w_t = train_calls[1][2].to(torch.bfloat16).float().flip(0)
    w_t = w_t.transpose(1, 2).contiguous()
    dg_k, dg_p = plain_vs_kernel_us(
        lambda: sparse_conv_dgrad(ct0, op0.rb_t, w_t, torch.bfloat16),
        lambda: gather_matmul_dgrad(ct0, op0.rb_t.idx, op0.rb_t.valid, w_t,
                                    torch.bfloat16), 50, torch)
    say(f"[time] nn_search P={src.shape[0]} N={src.shape[1]} "
        f"M={tgt.shape[1]}: kernel {nn_k:.2f} us/call, plain {nn_p:.2f} "
        f"us/call (plain, kernel, kernel, plain; 10 calls each)")
    say(f"[time] row_gather L0 im2col {tuple(got.shape)}: kernel "
        f"{rg_k:.2f} us/call, plain features[idx] {rg_p:.2f} us/call "
        f"(50 calls each)")
    say(f"[time] gather_matmul_dgrad L0 subm V={V0} Cout=16 -> Cin=16 "
        f"bf16: kernel {dg_k:.2f} us/call, plain sparse_conv_dgrad "
        f"{dg_p:.2f} us/call (50 calls each)")
    kernel_rows["gather_matmul_dgrad"] = dict(
        source="rslo_tpu_torch/csrc/gather_matmul.cu",
        replaces="rslo_tpu/ops/dma_gather.py:132",
        max_abs_err=max(bwd_worst.values()), ms=dg_k / 1e3,
        plain_ms=dg_p / 1e3)
    kernel_rows["row_gather"] = dict(
        source="rslo_tpu_torch/csrc/row_gather.cu",
        replaces="rslo_tpu/ops/dma_gather.py:62", max_abs_err=0.0,
        ms=rg_k / 1e3, plain_ms=rg_p / 1e3)
    kernel_rows["nn_search"] = dict(
        source="rslo_tpu_torch/csrc/nn_search.cu",
        replaces="rslo_tpu/ops/chamfer.py:109", max_abs_err=0.0,
        ms=nn_k / 1e3, plain_ms=nn_p / 1e3)

    # -- 11. card vs CPU, float32 two-frame forward --------------------------
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

    # -- 12. card vs CPU, one float32 train step -----------------------------
    tcfg32 = tcfg.replace(
        middle=dataclasses.replace(tcfg.middle, conv_dtype="f32"),
        odom=dataclasses.replace(tcfg.odom, compute_dtype="fp32"))
    weights = {k: v.cpu() for k, v in state.model.state_dict().items()}
    noise_gen = torch.Generator().manual_seed(SEED)
    jittered = {k: v * (1 + TRAIN_GRAD_NOISE * torch.randn(
        v.shape, generator=noise_gen)) if v.is_floating_point() else v
        for k, v in weights.items()}
    outs = {}
    for name, device, w in (("card", dev, weights),
                            ("card, jittered weights", dev, jittered),
                            ("cpu", torch.device("cpu"), weights)):
        model = OdomNet(tcfg32).to(device)
        model.load_state_dict(w)
        st = TrainState.create(model, make_optimizer(tcfg32, model),
                               {"rot": -2.5, "trans": 0.0})
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batches[0].items()}
        t0 = time.perf_counter()
        out, grads = loss_and_grads(st, batch, tcfg32, warmup=False)
        outs[name] = ({k: float(v) for k, v in out.aux.items()},
                      {k: g.detach().cpu().double() for k, g in
                       grads.items()})
        say(f"[cpu-ref] f32 train step on the {name}: "
            f"{time.perf_counter() - t0:.2f} s")
    (aux_g, g_g), (_, g_j), (aux_c, g_c) = outs.values()
    for key, want in aux_c.items():
        got = aux_g[key]
        say(f"[cpu-ref] f32 train {key}: card {got:.7g} cpu {want:.7g}")
        if not np.isclose(got, want, **TRAIN_LOSS_TOL):
            fail(f"f32 train step {key} on the card != the CPU")

    def rel_err(a, b):
        return float((a - b).norm()) / float(b.norm())
    top = max(float(g.norm()) for g in g_c.values())
    leaves = [k for k, g in g_c.items() if float(g.norm()) >= 1e-6 * top]
    err = {k: rel_err(g_g[k], g_c[k]) for k in leaves}
    sens = {k: rel_err(g_j[k], g_g[k]) for k in leaves}
    ratio = {k: err[k] / (TRAIN_GRAD_FACTOR * sens[k] + TRAIN_GRAD_ABS)
             for k in leaves}
    worst = max(ratio, key=ratio.get)
    say(f"[cpu-ref] f32 train gradients, {len(leaves)} of {len(g_c)} "
        f"leaves: card vs cpu relative L2 error median "
        f"{statistics.median(err.values()):.3e}, max "
        f"{max(err.values()):.3e}; card vs card with weights jittered by "
        f"{TRAIN_GRAD_NOISE:g}: median {statistics.median(sens.values()):.3e},"
        f" max {max(sens.values()):.3e}; tightest leaf {worst}: error "
        f"{err[worst]:.3e}, sensitivity {sens[worst]:.3e}")
    if ratio[worst] > 1.0:
        fail(f"f32 train gradients on the card != the CPU: {worst} error "
             f"{err[worst]:.3e} > {TRAIN_GRAD_FACTOR:g} * {sens[worst]:.3e}"
             f" + {TRAIN_GRAD_ABS:g}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    say(smi_line)
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **{k: row[k] for k in (
            "source", "replaces")}, "launches": train_launches[name],
         **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms")}}
        for name, row in kernel_rows.items()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
