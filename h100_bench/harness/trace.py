"""The profiler's reading of a traced stretch of steps: the device's
busy time (the union of every device activity's interval), its
activities a step, kernel time by name, and the longest idle gaps named
by the innermost host operation running when each began (the
arithmetic of the program's ``chip_smoke.py::profile_device``).  And the
device clock of the measured window: the same busy time over every
step of the window, from a trace of the device's activities alone."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class TraceSummary:
    steps: int
    window_s: float          # host clock over the traced steps, synced
    busy_s: float            # union of device activity intervals
    n_device_ops: int
    kernel_s: Dict[str, float]     # device seconds by activity name
    kernel_n: Dict[str, int]
    idle_gaps: List[Tuple[str, float]]

    def breakdown(self) -> dict:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:10]]}

    def kernel_seconds(self, names) -> float:
        """Device seconds of the activities whose name holds one of
        ``names``."""
        return sum(s for k, s in self.kernel_s.items()
                   if any(n in k for n in names))


def trace_steps(step: Callable[[], None], n_steps: int, torch,
                gap_samples: int = 400) -> TraceSummary:
    """Run ``step`` ``n_steps`` times under ``torch.profiler`` (host and
    device activities) and read the trace.  Without a card the trace
    holds no device activity, and every device metric reads nothing."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        sync()
        window_s = time.perf_counter() - t0
    return summarize(_events(prof), n_steps, window_s, gap_samples)


class DeviceClock:
    """The device's busy time over a stretch of steps: ``torch.profiler``
    recording the card's activities alone (no host operations), started
    before the stretch so that its own start-up is not in it.  On a
    machine without a card it records nothing and reads None."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.busy_s = None
        self.n_ops = 0
        self.read_s = 0.0

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        if not self.torch.cuda.is_available():
            return self
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        return self

    def stop(self):
        """Ends the trace once every activity of the stretch has ended,
        and reads the union of their intervals."""
        if self.prof is None:
            return self
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.prof.stop()
        from torch.autograd import DeviceType
        iv = [(e.start_ns(), e.duration_ns())
              for e in self.prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
        self.prof = None
        self.n_ops = len(iv)
        if iv:
            a = np.array(iv, np.int64)
            self.busy_s = union_ns(a[:, 0], a[:, 0] + a[:, 1]) * 1e-9
        self.read_s = time.perf_counter() - t0
        return self

    def __str__(self):
        if self.busy_s is None:
            return "device clock: nothing recorded"
        return (f"device clock: busy {self.busy_s:.6f} s in {self.n_ops} "
                f"activities, read in {self.read_s:.1f} s")


def union_ns(starts, ends) -> int:
    """The length of the union of the intervals [starts, ends)."""
    order = np.argsort(starts, kind="stable")
    s = np.asarray(starts, np.int64)[order]
    e = np.maximum(np.asarray(ends, np.int64)[order], s)
    reach = np.maximum.accumulate(e)
    # an interval opens a new run where it starts after all before it end
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.nonzero(new)[0]
    last = np.append(first[1:] - 1, len(s) - 1)
    return int(np.sum(reach[last] - s[first]))


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every activity."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        start = e.start_ns()
        out.append((e.name(), dev, start, start + e.duration_ns()))
    return out


def summarize(events, n_steps: int, window_s: float,
              gap_samples: int = 400) -> TraceSummary:
    dev = [(n, s, e) for n, d, s, e in events if d and e >= s]
    host = [(n, s, e) for n, d, s, e in events if not d and e >= s]
    kernel_s: Dict[str, float] = {}
    kernel_n: Dict[str, int] = {}
    for n, s, e in dev:
        kernel_s[n] = kernel_s.get(n, 0.0) + (e - s) * 1e-9
        kernel_n[n] = kernel_n.get(n, 0) + 1
    busy = 0
    gaps = []                      # (start_ns, length_ns)
    if dev:
        iv = sorted((s, e) for _, s, e in dev)
        cur_s, cur_e = iv[0]
        for s, e in iv[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s - cur_e))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
    return TraceSummary(steps=n_steps, window_s=window_s,
                        busy_s=busy * 1e-9, n_device_ops=len(dev),
                        kernel_s=kernel_s, kernel_n=kernel_n,
                        idle_gaps=_name_gaps(gaps, host, gap_samples))


def _name_gaps(gaps, host, n_longest: int) -> List[Tuple[str, float]]:
    """The ``n_longest`` idle gaps, each named by the innermost host
    activity (the latest-starting one) that spans its start, summed by
    name, longest first."""
    if not gaps or not host:
        return []
    gaps = sorted(gaps, key=lambda g: -g[1])[:n_longest]
    names = [n for n, _, _ in host]
    hs = np.array([s for _, s, _ in host], np.int64)
    he = np.array([e for _, _, e in host], np.int64)
    by_name: Dict[str, float] = {}
    for g0, glen in gaps:
        inside = np.nonzero((hs <= g0) & (he >= g0))[0]
        name = (names[inside[np.argmax(hs[inside])]] if len(inside)
                else "(python: no host op running)")
        by_name[name] = by_name.get(name, 0.0) + glen * 1e-9
    return sorted(by_name.items(), key=lambda kv: -kv[1])
