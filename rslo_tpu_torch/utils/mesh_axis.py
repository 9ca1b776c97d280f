"""Mesh-axis binding for cross-replica statistics (counterpart of
``rslo_tpu/utils/mesh_axis.py``).

JAX's sync-BN variants reduce their moments over the mesh "data" axis
when traced inside ``shard_map`` and use local statistics outside it
(single-device eval, unit tests, streaming).  The port runs one process
per card, with the "data" axis as a ``torch.distributed`` process group,
and ``bind_axis`` plays the part of ``shard_map``: the group is bound to
the axis name for the span of a step, and a reduction happens only
inside it.  Outside it every ``*_if_present`` is the identity, as JAX's
helpers are outside a mesh.

The binding is process-wide, not thread-local: autograd runs a CUDA
graph's backward on its own device thread, and a checkpointed module
recomputes its forward (and its reductions) there, inside the step.

``psum`` is a ``torch.autograd.Function`` whose backward is the
all-reduce SUM of the incoming gradient, the transpose JAX takes under
``shard_map(check_vma=False)``: for ``L = sum(pmean(x * x))`` over two
ranks holding [1, 2] and [2, 2] the gradients are [2, 4] and [4, 4].  An
in-place ``dist.all_reduce`` on the moments would give each rank only
its own share of that gradient, without an error.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

AXES = ("data",)                 # the mesh axis names the package uses
_BOUND: dict = {}                # axis name -> (group, size)


def _check(name: str):
    if name not in AXES:
        raise ValueError(f"unknown mesh axis {name!r}; the axes are {AXES}")


@contextlib.contextmanager
def bind_axis(name: str, group, size: int):
    """Bind the process group ``group`` of ``size`` ranks to the axis
    ``name`` for the span of the block (JAX: tracing inside
    ``shard_map`` over that axis)."""
    _check(name)
    if name in _BOUND:
        raise RuntimeError(f"mesh axis {name!r} is already bound")
    _BOUND[name] = (group, size)
    try:
        yield
    finally:
        del _BOUND[name]


def axis_present(name: str) -> bool:
    """True iff the named axis is bound (inside ``bind_axis``).  A name
    that is not a mesh axis of the package raises."""
    _check(name)
    return name in _BOUND


def axis_size(name: str) -> int:
    """Ranks on the bound axis ``name`` (1 when it is not bound)."""
    return _BOUND[name][1] if axis_present(name) else 1


class _AllReduceSum(torch.autograd.Function):
    """all-reduce SUM forward; all-reduce SUM of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum_if_present(x: torch.Tensor, name: str) -> torch.Tensor:
    """Sum over the ranks of the bound axis ``name`` (differentiable),
    the identity when it is not bound."""
    if not axis_present(name):
        return x
    return _AllReduceSum.apply(x, _BOUND[name][0])


def pmean_if_present(x: torch.Tensor, name: str) -> torch.Tensor:
    """Mean over the ranks of the bound axis ``name``: ``psum / size``,
    as ``lax.pmean``; the identity when it is not bound."""
    if not axis_present(name):
        return x
    return psum_if_present(x, name) / axis_size(name)
