"""Mesh-axis binding for cross-replica statistics and the BEV stage's
spatial and tensor parallelism (counterpart of
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

The "space" and "model" axes (``rslo_tpu_torch/parallel/``) shard the
BEV stage's width and channels over a ``GridMesh``, a (space x model)
grid of ranks with a process group per row and per column.  Their
halos and gathers are ``all_gather_if_present``: every rank's bits
through an integer all-reduce (gloo takes CUDA tensors only for
``all_reduce`` and ``broadcast``), exact for -0.0 and NaN, whose
backward all-reduces the cotangent and keeps the rank's share.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("data", "space", "model")   # the mesh axis names the package uses
_BOUND: dict = {}                # axis name -> (group, size, rank)


def _check(name: str):
    if name not in AXES:
        raise ValueError(f"unknown mesh axis {name!r}; the axes are {AXES}")


@contextlib.contextmanager
def bind_axis(name: str, group, size: int, rank: Optional[int] = None):
    """Bind the process group ``group`` of ``size`` ranks to the axis
    ``name`` for the span of the block (JAX: tracing inside
    ``shard_map`` over that axis).  ``rank`` is this process's rank in
    the group (by default asked of the group; 0 without one)."""
    _check(name)
    if name in _BOUND:
        raise RuntimeError(f"mesh axis {name!r} is already bound")
    if rank is None:
        rank = dist.get_rank(group) if group is not None else 0
    _BOUND[name] = (group, size, rank)
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


def axis_index(name: str) -> int:
    """This process's rank on the bound axis ``name`` (0 when it is not
    bound), as ``lax.axis_index``."""
    return _BOUND[name][2] if axis_present(name) else 0


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


def gather_bits(x: torch.Tensor, group, rank: int,
                size: int) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` in rank order.  Each rank
    writes the bits of its elements into a zero-filled integer buffer
    that one all-reduce sums, so every value, -0.0 and NaN included,
    arrives unchanged (gloo's ``all_gather`` takes no CUDA tensor).
    2-byte floats travel as float32, which holds each of them exactly."""
    if x.element_size() == 2 and x.is_floating_point():
        return gather_bits(x.float(), group, rank, size).to(x.dtype)
    ints = {4: torch.int32, 8: torch.int64}[x.element_size()]
    buf = torch.zeros((size,) + tuple(x.shape), dtype=ints,
                      device=x.device)
    buf[rank] = x.contiguous().view(ints)
    dist.all_reduce(buf, group=group)
    return buf.view(x.dtype)


class _AllGather(torch.autograd.Function):
    """``gather_bits`` forward; backward, the all-reduced cotangent's
    share of this rank (the transpose of an all-gather)."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rank = group, rank
        return gather_bits(x, group, rank, size)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank], None, None, None


def all_gather_if_present(x: torch.Tensor, name: str) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` on the bound axis ``name``
    in rank order (differentiable); ``x[None]`` when it is not bound."""
    if not axis_present(name):
        return x[None]
    group, size, rank = _BOUND[name]
    return _AllGather.apply(x, group, rank, size)


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """A (space x model) grid of every rank of the default process group
    (JAX: a 2-D ``Mesh`` with axes ("space", "model")): rank ``s * model
    + m`` sits at row ``s``, column ``m``.  ``space_group`` holds the
    ranks of this rank's column (the same ``m``: they split the BEV
    width), ``model_group`` those of its row (the same ``s``: they split
    the channels)."""
    space: int
    model: int
    space_index: int
    model_index: int
    space_group: object
    model_group: object

    def axis(self, name: str):
        """(group, size, this rank's index) of the mesh axis ``name``."""
        if name == "space":
            return self.space_group, self.space, self.space_index
        if name == "model":
            return self.model_group, self.model, self.model_index
        raise ValueError(f"a GridMesh has the axes 'space' and 'model', "
                         f"not {name!r}")


def grid_mesh(space: int, model: int = 1) -> GridMesh:
    """The (space x model) grid over every rank of the initialized
    default group (``space * model`` must be its size).  Every rank
    calls ``dist.new_group`` for every row and every column, rows
    first, in the same order, as torch requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if space * model != world:
        raise ValueError(f"a {space} x {model} grid needs {space * model} "
                         f"ranks, the group has {world}")
    s_i, m_i = divmod(rank, model)
    rows = [dist.new_group([s * model + m for m in range(model)])
            for s in range(space)]
    cols = [dist.new_group([s * model + m for s in range(space)])
            for m in range(model)]
    return GridMesh(space, model, s_i, m_i, cols[m_i], rows[s_i])
