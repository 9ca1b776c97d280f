"""Smoke run of the PyTorch port (``rslo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``rslo_tpu_torch/csrc/`` and drives
the serving path, ``StreamingOdometry``, at the full width of the
shipped ``configs/kitti_eval_ours.json`` with seeded random weights.
Phases (each one exits non-zero when it fails):

  1. require a CUDA card; print its name and power limit; turn TF32 off
  2. build the ``gather_matmul`` kernel
  3. hold the kernel against its plain PyTorch version on the card, at
     the 20 sparse-conv calls of one KITTI-scale frame, in bf16 and f32,
     plus an edge case (all-invalid rows, masked rows, ragged V, NaN
     rows that only invalid taps point at)
  4. stream 8 synthetic KITTI-scale scans: finite poses, exactly 20
     kernel launches per scan, pose after scan 2 == the two-frame
     forward
  5. time streaming, the two-frame forward and the kernel vs its plain
     version (before phase 6, whose CPU threads would share the host)
  6. the two-frame forward on the card against the same model on the
     CPU (plain versions), in float32 at the same widths

The last two lines of standard output are the kernel summary (JSON)
and the result (JSON); the card's ``nvidia-smi`` line comes before.
Needs one card, no network, and no JAX.
"""
import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "kitti_eval_ours.json")
N_SCANS = 8
N_POINTS = 100000
SEED = 0
# |kernel - plain| <= REL * sum_k,c |g w| + ABS: both sides add the same
# exact f32 products, in another order; reordering n f32 terms moves the
# sum by a few n^(1/2) ulps of the sum of their magnitudes
KERNEL_REL_TOL = 1e-5
KERNEL_ABS_TOL = 1e-6
# streaming vs two-frame: the same kernels on the same inputs
POSE_TOL = dict(rtol=1e-5, atol=1e-5)
# card (kernel, cuDNN f32 without TF32) vs CPU (plain versions), f32:
# ~40 layers whose f32 sums are taken in different orders; held as
# max |card - cpu| <= CPU_TOL * max |cpu| for each output
CPU_TOL = 1e-3


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
    """Record (features, rulebook, weights, bias, out_mask) of every
    sparse conv that ``run()`` makes."""
    calls = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: calls.append(
            (args[0], args[1], mod.kernel.detach(), mod.bias.detach(),
             args[2])))
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
    from rslo_tpu_torch.ops import _build
    from rslo_tpu_torch.ops.dma_gather import gather_matmul
    from rslo_tpu_torch.ops.sparse_conv import sparse_conv_apply
    from rslo_tpu_torch.utils.synthetic import synth_sequence
    dev = torch.device("cuda", 0)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    log = _build.build("gather_matmul")
    _build.load_library("gather_matmul")
    say(f"[build] gather_matmul built in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"  {line.strip()}")

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

    # -- 4. the main path: streaming ----------------------------------------
    stream = StreamingOdometry(net, cfg, dev)
    gather_matmul.launches = 0
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

    # -- 5. timing ---------------------------------------------------------
    stream = StreamingOdometry(net, cfg, dev)
    for scan in frames[:3]:                   # warm-up
        stream.push(scan)
    it = iter(frames * 3)
    stream_ms = median_ms(lambda: stream.push(next(it)), 20, torch)
    two_ms = median_ms(lambda: two_frame(net, dev), 10, torch)
    f, rb, w, b, om = calls[1]                # L0 subm, 16 -> 16
    V, K = rb.idx.shape
    with torch.no_grad():
        def kern():
            gather_matmul(f, rb.idx, rb.valid, w, b, om, torch.bfloat16)

        def plain():
            sparse_conv_apply(f, rb, w, b, om, torch.bfloat16)
        order = [("plain", plain), ("kernel", kern), ("kernel", kern),
                 ("plain", plain)]
        us = {"plain": [], "kernel": []}
        for name, fn in order:
            us[name].append(event_us(fn, 50, torch))
    k_us, p_us = statistics.mean(us["kernel"]), statistics.mean(us["plain"])
    say(f"[time] streaming {stream_ms:.3f} ms/scan "
        f"({1e3 / stream_ms:.2f} scans/s), median of 20 after warm-up")
    say(f"[time] two-frame forward {two_ms:.3f} ms, median of 10")
    say(f"[time] L0 subm conv V={V} K={K} Cin={f.shape[1]} "
        f"Cout={w.shape[2]} bf16: gather_matmul {k_us:.2f} us/call, plain "
        f"sparse_conv_apply {p_us:.2f} us/call (plain, kernel, kernel, "
        f"plain; 50 calls each)")

    # -- 6. card vs CPU, float32 at the same widths ------------------------
    cfg32 = cfg.replace(
        middle=dataclasses.replace(cfg.middle, conv_dtype="f32"),
        odom=dataclasses.replace(cfg.odom, compute_dtype="fp32"))
    state = {k: v.cpu() for k, v in net.state_dict().items()}
    net32 = OdomNet(cfg32)
    net32.load_state_dict(state)
    cpu_out = two_frame(net32, torch.device("cpu"))
    gpu_out = two_frame(copy.deepcopy(net32).to(dev), dev)
    pairs = [(key, gpu_out[key], cpu_out[key])
             for key in ("odometry", "tq_map", "t_conf", "q_conf")]
    pairs += [(f"voxel_covs[{t}]", gpu_out["voxel_covs"][t],
               cpu_out["voxel_covs"][t]) for t in range(2)]
    for key, a, b in pairs:
        a, b = a.cpu().numpy(), b.numpy()
        scale = np.abs(b).max()
        err = np.abs(a - b).max() if a.shape == b.shape else np.inf
        say(f"[cpu-ref] f32 {key}: card vs cpu max |diff| {err:.3e}, "
            f"max |cpu| {scale:.3e}")
        if not err <= CPU_TOL * scale:
            fail(f"f32 two-frame {key} on the card != the CPU reference")

    say(smi_line)
    say(json.dumps({"kernels": [{
        "name": "gather_matmul", "route": "cuda",
        "source": "rslo_tpu_torch/csrc/gather_matmul.cu",
        "replaces": "rslo_tpu/ops/dma_gather.py:130",
        "launches": launches, "max_abs_err": worst,
        "ms": k_us / 1e3, "plain_ms": p_us / 1e3}]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
