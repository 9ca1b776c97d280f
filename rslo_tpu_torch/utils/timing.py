"""Tracing of the program's layers (counterpart of
``rslo_tpu/utils/timing.py``): named spans and counters, off unless
switched on, and a ``torch.profiler`` trace for deep dives.

``span(name)`` marks a layer: while tracing is off it is a shared null
context (one flag check); under ``tracing()`` it opens a
``torch.profiler.record_function`` range, which lands in any active
profiler trace on the clock of the card's activities and nests under
its caller's range.  ``count(name, value)`` keeps a device scalar while
tracing is on, without waiting for the device; ``read_counters()`` sums
them on the host and starts them anew.  The counters say how many sites
each capacity drops (``count_sites``): ``sites_found.<level>`` and
``sites_kept.<level>``, level ``L0`` the voxelizer's voxels and ``L1``
to ``L3`` the sparse middle's downsampled levels.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

_on = False
_NULL = contextlib.nullcontext()
_counters: Dict[str, List] = {}


def tracing_on() -> bool:
    """Whether spans and counters record."""
    return _on


@contextlib.contextmanager
def tracing(on: bool = True):
    """Switch spans and counters on (or off) for the block, and back to
    what they were after it."""
    global _on
    was = _on
    _on = on
    try:
        yield
    finally:
        _on = was


def span(name: str):
    """A context that records the range ``name`` while tracing is on."""
    if not _on:
        return _NULL
    return torch.profiler.record_function(name)


def count(name: str, value) -> None:
    """Add ``value`` (a number or a scalar tensor, read later) to the
    counter ``name`` while tracing is on."""
    if _on:
        _counters.setdefault(name, []).append(value)


def count_sites(level: str, found: torch.Tensor, capacity: int) -> None:
    """Count the ``found`` sites of ``level`` (a scalar tensor) and the
    ones its ``capacity`` keeps.  A caller checks ``tracing_on()`` first,
    so that ``found`` costs nothing while tracing is off."""
    count(f"sites_found.{level}", found)
    count(f"sites_kept.{level}", torch.clamp(found, max=capacity))


def read_counters() -> Dict[str, int]:
    """{name: the sum of its values} of every counter, which then start
    anew.  Waits for the device that holds them."""
    out = {name: sum(int(v) for v in vals)
           for name, vals in _counters.items()}
    _counters.clear()
    return out


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


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True):
    """``torch.profiler`` trace of the block (the CPU, and the CUDA
    devices where there are any), with tracing on so that it carries
    the layers' spans, written into ``logdir`` as a Chrome trace
    (``*.pt.trace.json``, which TensorBoard's profiler plugin and
    Perfetto read).  The counters the block keeps are dropped at its
    end, unless tracing was on before it (a reader of its own)."""
    if not enabled:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    was = _on
    try:
        with torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    logdir)), tracing():
            yield
    finally:
        if not was:
            _counters.clear()
