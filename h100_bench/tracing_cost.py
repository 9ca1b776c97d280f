"""What the program's tracing switch (``rslo_tpu_torch/utils/timing.py``)
costs, on one cell's own step or scan:

- a span's host cost with tracing off and on (no profiler running), and
  the card's activities a profiler records over spans taken while off;
- the user-annotation events a trace of the card's activities alone
  (the untraced run's device clock, ``harness/trace.py::DeviceClock``)
  records over two steps with tracing off, and with it on;
- host ms a step or scan with tracing off and on outside the profiler,
  in pairs of blocks of ``--per`` that alternate which goes first (the
  median of the pairs' differences follows a host whose pace drifts);
  and the bound the counts give: the spans and site counts a step (from
  one traced stretch) times what each costs on the host.

    python3 h100_bench/tracing_cost.py --workload CELL --seed N \
        [--blocks 40] [--per 1] [--device cuda]

from the root of a checkout; prints lines on standard error and one
JSON object last on standard output.  It runs nothing of a cell's
window and is not one of the benchmark's cells."""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
if str(BENCH_DIR.parent) not in sys.path:
    sys.path.insert(1, str(BENCH_DIR.parent))

from harness import manifest, spans  # noqa: E402


def span_us(timing, on: bool, n: int) -> float:
    """Host µs of one ``with span(...)`` with tracing ``on``."""
    with timing.tracing(on):
        t0 = time.perf_counter()
        for _ in range(n):
            with timing.span("cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6


def count_us(torch, timing, dev, n: int) -> float:
    """Host µs of one ``count_sites`` on a device scalar, tracing on."""
    found = torch.tensor(7, device=dev)
    with timing.tracing():
        t0 = time.perf_counter()
        for _ in range(n):
            timing.count_sites("cost", found, 5)
        us = (time.perf_counter() - t0) / n * 1e6
    timing.read_counters()
    return us


def device_events(torch, fn, cuda_only: bool = True):
    """(activities of the card, of them user annotations) that a
    ``torch.profiler`` trace records over ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if cuda_only else \
        [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    return len(ev), sum(1 for e in ev if e.is_user_annotation())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--blocks", type=int, default=40)
    p.add_argument("--per", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch
    from rslo_tpu_torch.utils import timing
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell = manifest.Manifest(Path(os.getcwd())).cell(args.workload)
    kind = "train" if cell.driver == "train_loop" else "stream"
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    n = 200_000
    out["span_off_us"] = span_us(timing, False, n)
    out["span_on_us"] = span_us(timing, True, n)
    out["count_sites_us"] = count_us(torch, timing, dev, n // 10)
    if cuda:
        out["span_off_device_events"] = device_events(
            torch, lambda: span_us(timing, False, 1000), cuda_only=False)[0]
    with tempfile.TemporaryDirectory(prefix="h100_bench_cost_") as tmp:
        ctx = SimpleNamespace(cell=cell, seed=args.seed, trace=True,
                              device=dev, tmpdir=Path(tmp), say=spans.say)
        step, n_warm, close = spans.SETUPS[kind](ctx)
        try:
            for _ in range(n_warm):
                step()
            # the spans and site counts a step, from one traced stretch
            sites = [0]
            real = timing.count_sites

            def counted(*a):
                sites[0] += 1
                real(*a)

            timing.count_sites = counted
            try:
                s = spans.trace_spans(step, 2, torch, timing)
            finally:
                timing.count_sites = real
            out["spans_a_step"] = sum(v["calls"] for v in s.layers.values())
            out["site_counts_a_step"] = sites[0] / 2
            out["bound_ms"] = 1e-3 * (
                out["spans_a_step"] * (out["span_on_us"] -
                                       out["span_off_us"]) +
                out["site_counts_a_step"] * out["count_sites_us"])
            if cuda:
                for on in (False, True):
                    with timing.tracing(on):
                        acts, ann = device_events(
                            torch, lambda: [step() for _ in range(2)])
                    out[f"device_clock_{'on' if on else 'off'}"] = \
                        {"activities": acts, "annotations": ann}
                timing.read_counters()
            ms = {False: [], True: []}
            for b in range(args.blocks):
                for on in ((False, True) if b % 2 == 0 else (True, False)):
                    with timing.tracing(on):
                        sync()
                        t0 = time.perf_counter()
                        for _ in range(args.per):
                            step()
                        sync()
                        ms[on].append((time.perf_counter() - t0) /
                                      args.per * 1e3)
                    timing.read_counters()
        finally:
            close()
    off, on = statistics.median(ms[False]), statistics.median(ms[True])
    diff = [b - a for a, b in zip(ms[False], ms[True])]
    q1, q2, q3 = statistics.quantiles(diff, n=4)
    out.update(step_ms_off=ms[False], step_ms_on=ms[True],
               median_off=off, median_on=on,
               pair_diff_pct=[100.0 * q / off for q in (q1, q2, q3)],
               bound_pct=100.0 * out["bound_ms"] / off)
    for k, v in out.items():
        spans.say(f"tracing cost {k}: {v}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
