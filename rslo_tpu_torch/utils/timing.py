"""Profiling / tracing harness (counterpart of
``rslo_tpu/utils/timing.py``): named sections timed on the host clock,
each ended by a device synchronization, as the reference's
measure_time timers do with ``cuda.synchronize``; and a
``torch.profiler`` trace for deep dives.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _cuda_devices(value) -> set:
    """The CUDA devices of every tensor in a (nested) value."""
    if isinstance(value, torch.Tensor):
        return {value.device} if value.is_cuda else set()
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in value))
    return set()


def block_until_ready(value):
    """Wait for the devices that hold the tensors of ``value`` (JAX's
    ``block_until_ready``): ``torch.cuda.synchronize`` on each CUDA
    device among them; CPU tensors are ready when returned."""
    for dev in _cuda_devices(value):
        torch.cuda.synchronize(dev)
    return value


class SectionTimer:
    """Accumulates wall time per named section (device-synchronized)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync_value=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if sync_value is not None:
            block_until_ready(sync_value)
        self.total[name] += time.perf_counter() - t0
        self.count[name] += 1

    def avg_ms(self) -> dict:
        return {k: self.total[k] / max(self.count[k], 1) * 1e3
                for k in self.total}

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.2f}ms"
                          for k, v in sorted(self.avg_ms().items()))


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True):
    """``torch.profiler`` trace of the block (the CPU, and the CUDA
    devices where there are any), written into ``logdir`` as a Chrome
    trace (``*.pt.trace.json``, which TensorBoard's profiler plugin and
    Perfetto read)."""
    if not enabled:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield
