"""Replay of one drive through ``eval/streaming.py::StreamingOdometry``:
each scan is pushed as host-side numpy (in pinned memory on a card) as
soon as the last pose returns (closed loop), or at ``rate_hz`` scans a
second (open loop: a scan's latency counts from when it was due).

Parameters (``workloads/<cell>.json``): ``n_scans`` scans of
``n_points`` in a scene of ``extent`` metres (default 60) made from the
seed and replayed forth and back, so every
push follows the scan next to it; ``warmup_scans`` pushes before the
window; ``rate_hz`` (null: closed loop); ``check_samples`` pushes of the
window drawn from the seed for the reference; ``trace_scans`` pushes the
profiler traces after the window.
"""
from __future__ import annotations

import gc
import time

import numpy as np

from harness import counts as counts_mod
from harness import judge, peaks, scenes, weights
from harness.record import Record, nearest_rank
from harness.refpath import ref as load_ref
from harness.trace import DeviceClock, trace_steps


def replay_index(k: int, n: int) -> int:
    """The scan of push ``k``: 0, 1, .., n-1, n-2, .., 1, 0, 1, .."""
    period = 2 * n - 2
    k %= period
    return k if k < n else period - k


def run(ctx):
    import torch
    from rslo_tpu_torch.config.schema import PipelineCfg
    from rslo_tpu_torch.eval.streaming import StreamingOdometry
    from rslo_tpu_torch.models.net import OdomNet

    p = ctx.cell.params
    dev = ctx.device
    ref = load_ref()
    rec = Record(kind="stream")
    cfg = PipelineCfg.from_dict(ctx.cell.pipeline)
    ref_cfg = ref.config.schema.PipelineCfg.from_dict(ctx.cell.pipeline)

    # traffic: the drive's scans, host side
    frames = scenes.drive(ctx.seed, int(p["n_scans"]), int(p["n_points"]),
                          p.get("extent", 60.0))
    host = [torch.from_numpy(f) for f in frames]
    if dev.type == "cuda":
        host = [t.pin_memory() for t in host]
    scans = [t.numpy() for t in host]
    n_scans = len(scans)

    w0 = weights.make_weights(
        weights.shapes_model(ref.models.net.OdomNet, ref_cfg), ctx.seed, dev)
    net = weights.build(OdomNet, cfg, w0, dev)
    odo = StreamingOdometry(net, cfg, device=dev)
    poses = []          # the pose each push returned, in push order

    def push(k):
        poses.append(np.array(odo.push(scans[replay_index(k, n_scans)]),
                              np.float64))

    k = 0
    for _ in range(int(p["warmup_scans"])):
        push(k)
        k += 1

    # the window
    rate = p.get("rate_hz")
    k_window = k
    lat = []
    # the device clock of an untraced run: its trace of the card slows
    # the host, so a traced run reads the host's clock without it
    clock = DeviceClock(torch)
    if not ctx.trace:
        clock.start()
    t0 = time.perf_counter()
    rec.setup_s = t0 - ctx.t_start
    while True:
        due = t0 if rate is None else t0 + (k - k_window) / float(rate)
        now = time.perf_counter()
        if now - t0 >= ctx.seconds:
            break
        if due > now:
            time.sleep(due - now)
        start = time.perf_counter() if rate is None else due
        push(k)
        lat.append((time.perf_counter() - start) * 1e3)
        k += 1
    rec.window_s = time.perf_counter() - t0
    clock.stop()
    if not ctx.trace:
        ctx.say(str(clock))
    rec.window_busy_s, rec.window_ops = clock.busy_s, clock.n_ops
    rec.steps = len(lat)
    rec.latencies_ms = lat
    k_end = k

    traced = []
    if ctx.trace:
        n_tr = int(p["trace_scans"])
        box = [k]

        def traced_push():
            push(box[0])
            box[0] += 1

        rec.trace = trace_steps(traced_push, n_tr, torch)
        traced = [replay_index(i, n_scans) for i in range(k, k + n_tr)]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        rec.peak_bytes = torch.cuda.max_memory_allocated(dev)
    del odo, net
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference judges a sample of the window's answers
    rng = np.random.default_rng(ctx.seed)
    picks = sorted(rng.choice(np.arange(k_window, k_end),
                              size=min(int(p["check_samples"]),
                                       k_end - k_window), replace=False))
    rnet = weights.build(ref.models.net.OdomNet, ref_cfg, w0, dev)
    rnet.eval()
    t_ref = time.perf_counter()
    pairs = []
    dev_scans = {}
    bevs = {}           # the reference's BEV features of each scan

    def on_dev(i):
        if i not in dev_scans:
            dev_scans[i] = torch.as_tensor(scans[i]).to(dev)
        return dev_scans[i]

    def bev(i):
        if i not in bevs:
            with torch.no_grad():
                bevs[i] = judge.ref_frame_bev(ref, rnet, ref_cfg, on_dev(i))
        return bevs[i]

    for j in picks:
        want = judge.ref_pair_pose(
            ref, rnet, bev(replay_index(j - 1, n_scans)),
            bev(replay_index(j, n_scans)), poses[j - 1])
        pairs.append((poses[j], want))
    bevs.clear()
    numbers = judge.stream_numbers(pairs)
    ctx.say(f"reference: {len(picks)} pushes judged in "
            f"{time.perf_counter() - t_ref:.1f} s")
    if traced:
        items = []
        for i in traced:
            pts = on_dev(i)
            mask = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
            items.append(counts_mod.stream_counts(ref, rnet, ref_cfg, pts,
                                                  mask))
        rec.counts = counts_mod.mean_counts(items)
        pts = on_dev(traced[0])
        mask = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
        counts_mod.report_sites(ctx.say, counts_mod.level_sites(
            ref, ref_cfg, pts, mask))
        c = rec.counts
        ctx.say(f"counts: model {c.model_flops / 1e9:.3f} GFLOP a scan; "
                f"gather-GEMM bound "
                f"{c.gather_gemm_bound_s(peaks) / c.per * 1e3:.4f} ms a scan")
    if lat:
        ctx.say(f"window: {len(lat)} scans in {rec.window_s:.3f} s; p95 "
                f"{nearest_rank(lat, 0.95):.3f} ms over {len(lat)} samples, "
                f"{len(lat) - int(np.ceil(0.95 * len(lat)))} beyond it; "
                f"set-up {rec.setup_s:.3f} s")
    correct, rows = judge.verdict(numbers, ctx.cell.limits)
    ctx.say(f"readings: {numbers}")
    return {"record": rec, "correct": correct, "checks": rows,
            "numbers": numbers, "detail": {"judged": len(picks)},
            "attempted": len(lat), "failed": 0}


def control(ctx, n_pushes: int):
    """The control's readings: the reference computed in fp8 put in the
    program's place as the stream, for ``n_pushes`` pushes of the cell's
    replay, each answer judged as the program's are."""
    import torch
    from harness.lower import fp8_reference
    p = ctx.cell.params
    dev = ctx.device
    ref = load_ref()
    ref_cfg = ref.config.schema.PipelineCfg.from_dict(ctx.cell.pipeline)
    frames = scenes.drive(ctx.seed, int(p["n_scans"]), int(p["n_points"]),
                          p.get("extent", 60.0))
    w0 = weights.make_weights(
        weights.shapes_model(ref.models.net.OdomNet, ref_cfg), ctx.seed, dev)
    rnet = weights.build(ref.models.net.OdomNet, ref_cfg, w0, dev).eval()
    n = len(frames)
    on_dev = [torch.as_tensor(f).to(dev) for f in frames]
    with torch.no_grad():
        want_bev = [judge.ref_frame_bev(ref, rnet, ref_cfg, x)
                    for x in on_dev]
        with fp8_reference(ref):
            got_bev = [judge.ref_frame_bev(ref, rnet, ref_cfg, x)
                       for x in on_dev]
    pose = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
    pairs = []
    for k in range(1, n_pushes + 1):
        i, j = replay_index(k - 1, n), replay_index(k, n)
        with fp8_reference(ref):
            got = judge.ref_pair_pose(ref, rnet, got_bev[i], got_bev[j],
                                      pose)
        want = judge.ref_pair_pose(ref, rnet, want_bev[i], want_bev[j], pose)
        pairs.append((got, want))
        pose = got.astype(np.float32)
    return judge.stream_numbers(pairs), {"judged": n_pushes}
