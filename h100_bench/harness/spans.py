"""The program's own spans and counters (``rslo_tpu_torch/utils/timing.py``)
over a stretch of a traced run: each layer's device time, host time and
idle card, and the sites each capacity drops.

A traced run (``--trace 1``) on a card runs this stretch once, after
every other reading of the run is taken: the first reader of a metric
of this module sets the cell's step up again from the run's seed (the
traffic driver's own set-up: the store and loader, or the drive's
scans, the seeded weights), warms it up, and runs ``trace_steps`` steps
or ``trace_scans`` scans under ``torch.profiler`` (host and card) with
the program's tracing switched on.  The untraced run and the run's own
traced stretch never switch it on: a range open while the profiler
records the card adds an annotation event of the card's type, which the
device clock and ``trace.summarize`` would count as device work.  A
program without the switch, a run without a card, or one not traced
reads nothing here.

Attribution: each device activity is linked to the host call that
launched it through the profiler's correlation id, and credited to the
innermost span that holds that launch on the launching thread; where
none does (the autograd engine's worker thread launches the backward's
kernels), to the innermost span on any thread that holds it in time;
else it stays unattributed.  Annotation events are left out.  A span's
host self time is its time less its child spans'; its idle time is the
part of its self time in which the card runs nothing.

A stretch that raises, or that loads JAX or the JAX package, fails the
run: the error leaves the reader, and the run prints no result line."""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from harness import guard, manifest, scenes, weights
from harness.refpath import ref as load_ref

UNATTRIBUTED = "(no span)"
TOP, TOP_CHARS = 5, 160     # each span's longest activities, names cut
LEVELS = ("L0", "L1", "L2", "L3")


class Event(NamedTuple):
    name: str
    device: bool         # an activity of the card
    annotation: bool     # a user range (``record_function``)
    tid: int             # the recording thread
    corr: int            # correlation id (a launch and its activity share it)
    start: int           # ns
    end: int             # ns


@dataclasses.dataclass
class SpanSummary:
    steps: int
    layers: Dict[str, Dict[str, float]]   # name -> per step: calls,
    #                            device_ms, activities, host_self_ms, idle_ms
    unattributed_ms: float                # per step
    device_ms: float                      # all activities' time, per step
    counters: Dict[str, int]              # over the whole stretch
    top: Dict[str, list] = dataclasses.field(default_factory=dict)
    #                      name -> its longest activities [(name, ms a step)]
    read_s: float = 0.0

    def sites_dropped_pct(self) -> Optional[float]:
        """100 x the sites the capacities drop over the sites found,
        summed over the levels the program counted."""
        found = sum(self.counters.get(f"sites_found.{lv}", 0)
                    for lv in LEVELS)
        kept = sum(self.counters.get(f"sites_kept.{lv}", 0)
                   for lv in LEVELS)
        return 100.0 * (found - kept) / found if found else None

    def lines(self) -> List[str]:
        out = [f"spans: {self.steps} a stretch; per one: device "
               f"{self.device_ms:.4f} ms, of it unattributed "
               f"{self.unattributed_ms:.4f} ms; read in {self.read_s:.1f} s"]
        for name, v in sorted(self.layers.items(),
                              key=lambda kv: -kv[1]["device_ms"]):
            out.append(f"span {name}: {v['calls']:g} calls; device "
                       f"{v['device_ms']:.4f} ms in {v['activities']:.1f} "
                       f"activities, host self {v['host_self_ms']:.4f} ms, "
                       f"card idle in it {v['idle_ms']:.4f} ms")
            out += [f"span {name} runs {ms:.4f} ms of {act}"
                    for act, ms in self.top.get(name, [])]
        for lv in LEVELS:
            f = self.counters.get(f"sites_found.{lv}")
            if f is not None:
                k = self.counters.get(f"sites_kept.{lv}", 0)
                out.append(f"counter sites {lv}: found {f}, kept {k}, "
                           f"dropped {f - k} over the stretch")
        return out


def _short(name: str) -> str:
    """An activity's name without the namespace that most of them share,
    cut to ``TOP_CHARS``."""
    return name.replace("at::native::", "").removeprefix("void ")[:TOP_CHARS]


def _union(starts, ends):
    """The merged intervals of [starts, ends), sorted."""
    if not len(starts):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(starts, kind="stable")
    s = np.asarray(starts, np.int64)[order]
    e = np.maximum(np.asarray(ends, np.int64)[order], s)
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.nonzero(new)[0]
    last = np.append(first[1:] - 1, len(s) - 1)
    return s[first], reach[last]


def _covered(us, ue, a, b):
    """The length of [a, b) that the merged intervals (us, ue) cover."""
    if not len(us) or b <= a:
        return 0
    lo = np.clip(np.maximum(us, a), None, b)
    hi = np.clip(np.minimum(ue, b), a, None)
    return int(np.sum(np.maximum(hi - lo, 0)))


def _innermost(t, tid, s_start, s_end, s_tid, chunk: int = 8192):
    """For each time ``t`` on thread ``tid``: the index of the innermost
    span that holds it on that thread, else of the innermost span on any
    thread that holds it, else -1.  Of nested ranges the innermost is
    the latest to start; of ranges that start together, the shortest."""
    out = np.full(len(t), -1, np.int64)
    if not len(s_start):
        return out
    order = np.lexsort((-s_end, s_start))
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    for i in range(0, len(t), chunk):
        tt, th = t[i:i + chunk, None], tid[i:i + chunk, None]
        held = (s_start[None] <= tt) & (tt <= s_end[None])
        mine = held & (s_tid[None] == th)
        pick = np.where(mine.any(1, keepdims=True), mine, held)
        r = np.where(pick, rank[None], -1)
        best = np.argmax(r, axis=1)
        out[i:i + chunk] = np.where(r.max(1) >= 0, best, -1)
    return out


def attribute(events: List[Event], n_steps: int) -> SpanSummary:
    """Each span name's device time, activities, host self time and card
    idle time a step, and the device time no span holds."""
    spans = [e for e in events if e.annotation and not e.device]
    acts = [e for e in events if e.device and not e.annotation]
    launch = {}
    for e in events:
        # the runtime's and driver's launch and copy calls (cudaLaunch*,
        # cuLaunch*, cudaMemcpy*): the host side of each activity
        if not e.device and not e.annotation and e.name.startswith("cu"):
            launch.setdefault(e.corr, e)
    n = max(n_steps, 1)
    s_start = np.array([s.start for s in spans], np.int64)
    s_end = np.array([s.end for s in spans], np.int64)
    s_tid = np.array([s.tid for s in spans], np.int64)

    # the host call of each activity, and the innermost span holding it
    calls = [launch.get(a.corr) for a in acts]
    has = np.array([c is not None for c in calls], bool)
    t = np.array([c.start if c is not None else 0 for c in calls], np.int64)
    tid = np.array([c.tid if c is not None else -1 for c in calls], np.int64)
    pick = _innermost(t, tid, s_start, s_end, s_tid)
    pick[~has] = -1
    dev_ns: Dict[str, int] = {}
    dev_n: Dict[str, int] = {}
    by_act: Dict[str, Dict[str, int]] = {}
    for a, i in zip(acts, pick):
        name = UNATTRIBUTED if i < 0 else spans[i].name
        dev_ns[name] = dev_ns.get(name, 0) + (a.end - a.start)
        dev_n[name] = dev_n.get(name, 0) + 1
        mine = by_act.setdefault(name, {})
        short = _short(a.name)
        mine[short] = mine.get(short, 0) + (a.end - a.start)

    busy_s, busy_e = _union([a.start for a in acts], [a.end for a in acts])
    self_ns: Dict[str, int] = {}
    idle_ns: Dict[str, int] = {}
    calls: Dict[str, int] = {}
    for i, s in enumerate(spans):
        calls[s.name] = calls.get(s.name, 0) + 1
        kids = np.nonzero((s_tid == s.tid) & (s_start >= s.start) &
                          (s_end <= s.end))[0]
        kids = kids[kids != i]
        ks, ke = _union(s_start[kids], s_end[kids])
        # the span's self time: its interval less its children's
        cuts = [s.start] + [int(x) for pair in zip(ks, ke) for x in pair] \
            + [s.end]
        own = 0
        idle = 0
        for a, b in zip(cuts[::2], cuts[1::2]):
            if b > a:
                own += b - a
                idle += (b - a) - _covered(busy_s, busy_e, a, b)
        self_ns[s.name] = self_ns.get(s.name, 0) + own
        idle_ns[s.name] = idle_ns.get(s.name, 0) + idle

    layers = {}
    for name in set(self_ns) | (set(dev_ns) - {UNATTRIBUTED}):
        layers[name] = {"calls": calls.get(name, 0) / n,
                        "device_ms": dev_ns.get(name, 0) * 1e-6 / n,
                        "activities": dev_n.get(name, 0) / n,
                        "host_self_ms": self_ns.get(name, 0) * 1e-6 / n,
                        "idle_ms": idle_ns.get(name, 0) * 1e-6 / n}
    top = {name: [(act, ns * 1e-6 / n) for act, ns in
                  sorted(acts_ns.items(), key=lambda kv: -kv[1])[:TOP]]
           for name, acts_ns in by_act.items()}
    total = sum(a.end - a.start for a in acts)
    return SpanSummary(steps=n_steps, layers=layers,
                       unattributed_ms=dev_ns.get(UNATTRIBUTED, 0) * 1e-6 / n,
                       device_ms=total * 1e-6 / n, counters={}, top=top)


def _events(prof) -> List[Event]:
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append(Event(e.name(), e.device_type() == DeviceType.CUDA,
                         bool(e.is_user_annotation()), e.start_thread_id(),
                         e.correlation_id(), start, start + e.duration_ns()))
    return out


def trace_spans(step, n_steps: int, torch, timing) -> SpanSummary:
    """Run ``step`` ``n_steps`` times under ``torch.profiler`` (host and
    card) with the program's tracing on, and read its spans and
    counters."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    timing.read_counters()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with timing.tracing():
            for _ in range(n_steps):
                step()
        sync()
    counters = timing.read_counters()
    t0 = time.perf_counter()
    summary = attribute(_events(prof), n_steps)
    summary.counters = counters
    summary.read_s = time.perf_counter() - t0
    return summary


def train_step(ctx):
    """The train cell's step as its traffic driver sets it up: the
    loader over a fresh store of the seed's tree, ``device_prefetch``,
    ``train_step`` post-warmup, from the seeded weights.  Returns (step,
    the number of warm-up steps, close)."""
    from rslo_tpu_torch.models.net import OdomNet
    from rslo_tpu_torch.train.distributed import DataMesh
    from rslo_tpu_torch.train.loop import (device_prefetch, make_optimizer,
                                           shard_batch)
    from rslo_tpu_torch.train.state import TrainState
    from rslo_tpu_torch.train.step import train_step as program_step
    traffic = manifest.driver(ctx.cell.driver)
    dev = ctx.device
    cfg, ref_cfg, _ = traffic.make_store(ctx)
    w0 = weights.make_weights(
        weights.shapes_model(load_ref().models.net.OdomNet, ref_cfg),
        ctx.seed, dev)
    net = weights.build(OdomNet, cfg, w0, dev).train()
    optimizer = make_optimizer(cfg, net)
    box = [TrainState.create(
        net, optimizer, {"rot": cfg.loss.rotation_init_alpha,
                         "trans": cfg.loss.translation_init_alpha})]
    mesh = DataMesh(None, 0, 1, dev)
    loader = traffic.make_loader(cfg, ctx.seed, mesh)
    batches = device_prefetch((shard_batch(b, mesh) for b in loader), dev)

    def step():
        box[0], _ = program_step(box[0], next(batches), cfg, optimizer,
                                 warmup=False, self_supervised=True,
                                 mesh=mesh)

    return step, int(ctx.cell.params["check_steps"]), loader.close


def stream_push(ctx):
    """The stream cell's push as its traffic driver sets it up: the
    drive's scans in pinned memory, pushed in the replay's order.
    Returns (push, the number of warm-up pushes, close)."""
    import torch
    from rslo_tpu_torch.config.schema import PipelineCfg
    from rslo_tpu_torch.eval.streaming import StreamingOdometry
    from rslo_tpu_torch.models.net import OdomNet
    traffic = manifest.driver(ctx.cell.driver)
    p = ctx.cell.params
    dev = ctx.device
    ref = load_ref()
    cfg = PipelineCfg.from_dict(ctx.cell.pipeline)
    ref_cfg = ref.config.schema.PipelineCfg.from_dict(ctx.cell.pipeline)
    frames = scenes.drive(ctx.seed, int(p["n_scans"]), int(p["n_points"]),
                          p.get("extent", 60.0))
    host = [torch.from_numpy(f) for f in frames]
    if dev.type == "cuda":
        host = [t.pin_memory() for t in host]
    scans = [t.numpy() for t in host]
    w0 = weights.make_weights(
        weights.shapes_model(ref.models.net.OdomNet, ref_cfg), ctx.seed, dev)
    odo = StreamingOdometry(weights.build(OdomNet, cfg, w0, dev), cfg,
                            device=dev)
    box = [0]

    def push():
        odo.push(scans[traffic.replay_index(box[0], len(scans))])
        box[0] += 1

    return push, int(p["warmup_scans"]), lambda: None


SETUPS = {"train": train_step, "stream": stream_push}


def stretch(ctx, kind: str, timing) -> SpanSummary:
    """The cell's step or push set up, warmed up, and ``trace_steps``
    steps or ``trace_scans`` scans of it traced with the spans on."""
    import torch
    step, n_warm, close = SETUPS[kind](ctx)
    n = int(ctx.cell.params["trace_steps" if kind == "train"
                           else "trace_scans"])
    try:
        for _ in range(n_warm):
            step()
        return trace_spans(step, n, torch, timing)
    finally:
        close()


def run_args(argv=None):
    """The run's own arguments (``run.py --workload CELL --seed N
    --seconds S --trace 0|1``), or None where the process was started
    otherwise."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float)
    p.add_argument("--trace", type=int, default=0)
    args, _ = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    return args if args.workload and args.seed is not None else None


def say(msg: str):
    print(f"[h100_bench] {msg}", file=sys.stderr, flush=True)


def _card(torch):
    """The card a traced run measures on, or None without one."""
    return torch.device("cuda", 0) if torch.cuda.is_available() else None


def _measure(record) -> Optional[SpanSummary]:
    args = run_args()
    if args is None or not args.trace:
        return None
    from rslo_tpu_torch.utils import timing
    if not hasattr(timing, "tracing"):
        say("spans: the program has no tracing switch; nothing to read")
        return None
    import torch
    dev = _card(torch)
    if dev is None:
        return None
    cell = manifest.Manifest(Path(os.getcwd())).cell(args.workload)
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="h100_bench_spans_") as tmp:
            ctx = SimpleNamespace(cell=cell, seed=args.seed, trace=True,
                                  device=dev, tmpdir=Path(tmp), say=say)
            summary = stretch(ctx, record.kind, timing)
    except Exception:                       # a program that fails traced
        say("spans: the stretch failed:\n" + traceback.format_exc())
        raise                               # fails the run
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    found = guard.forbidden_modules()       # run.py checked before it
    if found:
        raise RuntimeError(f"spans: the stretch loaded {found}")
    for line in summary.lines():
        say(line)
    say(f"spans: the stretch took {time.perf_counter() - t0:.1f} s")
    return summary


def of(record) -> Optional[SpanSummary]:
    """The spans of the run that made ``record``, measured at the first
    call and kept on the record."""
    if not hasattr(record, "spans"):
        record.spans = _measure(record)
    return record.spans


def device_ms(record, kind: str, layer: str) -> Optional[float]:
    """The device ms a step or scan that the span ``layer`` launched."""
    if record.kind != kind:
        return None
    s = of(record)
    if s is None or not s.device_ms or layer not in s.layers:
        return None
    return s.layers[layer]["device_ms"]


def sites_dropped_pct(record, kind: str) -> Optional[float]:
    if record.kind != kind:
        return None
    s = of(record)
    return None if s is None else s.sites_dropped_pct()
