"""Spatial partitioning (SP) of the dense BEV stage (counterpart of
``rslo_tpu/parallel/spatial.py``).

The BEV grid's width is split over the ranks of the "space" mesh axis,
to cut a scan's latency below one card's (data parallelism only scales
throughput).  JAX attaches a sharding to the (pairs, H, W, C) pair
tensor and lets GSPMD write the halo exchanges; the port has no
partitioner, so the BEV net's layers ask this module for them:

- ``bev_constraint`` (called by ``OdomNet.forward`` on the pair tensor,
  where JAX constrains it) keeps this rank's columns.  The middle runs
  whole on every rank before it, as in JAX, which constrains only the
  pair tensor.  W splits into chunks of the encoder's stride product
  (8), the first ranks taking one more chunk where they do not divide
  evenly: the shipped 176 columns go 88/88 over 2 ranks and 48/48/40/40
  over 4.  Fewer chunks than ranks raise ``ValueError`` (GSPMD pads).
- ``pad_same`` pads as flax's SAME does for the GLOBAL width: the inner
  edges take the neighbours' columns (halos), only the global edges the
  pad value (-inf for the mask max-pool).  So every conv, pool and
  mask-sum conv gives, on a rank's columns, the columns of the unsharded
  result.
- ``gather_width`` gathers a map along W (the confidence softmax over
  H * W, the output maps); the batch-norm moments and spatial means sum
  over the axis (``utils/mesh_axis.py::psum_if_present``).

Transport: the halos and gathers are ``all_gather_if_present``, bits
through an integer all-reduce, since gloo takes CUDA tensors only for
``all_reduce`` and ``broadcast``; NCCL runs the same all-reduce over
NVLink (a ``batch_isend_irecv`` of the two edge columns would move
fewer bytes, on NCCL only).  A halo is one all-reduce of every rank's
two edges.

Outside the ``_active`` context of :func:`make_spatial_forward` (or
``parallel/tensor.py``'s forwards) nothing here is reached and the BEV
net computes what it computes unsharded, bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.mesh_axis import (all_gather_if_present, axis_index, axis_size,
                               bind_axis)


@dataclasses.dataclass
class _Split:
    """The BEV stage's layout while a split forward runs: which axes are
    split, the width chunk (the encoder's stride product) and, once
    ``bev_constraint`` has seen the pair tensor, every space rank's
    columns of it."""
    space: bool
    model: bool
    block: int
    widths: Optional[tuple] = None


_SPLIT: Optional[_Split] = None


def active() -> Optional[_Split]:
    """The layout of the BEV net being split, or None.  A split applies
    from ``bev_constraint`` on: the frames' middle runs whole before."""
    s = _SPLIT
    return s if s is not None and s.widths is not None else None


def space_split() -> bool:
    s = active()
    return s is not None and s.space


@contextlib.contextmanager
def _active(split: _Split):
    global _SPLIT
    prev = _SPLIT
    _SPLIT = split
    try:
        yield
    finally:
        _SPLIT = prev


def split_widths(width: int, ranks: int, block: int) -> tuple:
    """Each rank's columns of a ``width``-wide map cut into chunks of
    ``block`` columns, the first ``width // block % ranks`` ranks taking
    one chunk more."""
    if width % block:
        raise ValueError(f"BEV width {width} is not a multiple of the "
                         f"encoder's stride product {block}")
    blocks = width // block
    if blocks < ranks:
        raise ValueError(
            f"the BEV width {width} holds {blocks} chunks of {block} "
            f"columns, fewer than the {ranks} ranks of the space axis")
    base, extra = divmod(blocks, ranks)
    return tuple((base + (r < extra)) * block for r in range(ranks))


def bev_constraint(x: torch.Tensor) -> torch.Tensor:
    """This rank's columns of the (P, H, W, C) pair tensor under a split
    with the space axis; the tensor itself otherwise (the model axis
    splits channels inside the net, whose first conv and
    ``input_mask`` read every channel)."""
    s = _SPLIT
    if s is None:
        return x
    s.widths = (split_widths(x.shape[2], axis_size("space"), s.block)
                if s.space else (x.shape[2],))
    if not s.space:
        return x
    r = axis_index("space")
    return x[:, :, sum(s.widths[:r]):sum(s.widths[:r + 1])]


def level_widths(local: int) -> tuple:
    """Every space rank's columns at the BEV level where this rank holds
    ``local`` of them (the pair tensor's split, divided by the level's
    stride)."""
    widths = active().widths
    own = widths[axis_index("space")]
    if own % local or any(w % (own // local) for w in widths):
        raise ValueError(f"{local} columns are not a level of the split "
                         f"{widths}")
    return tuple(w // (own // local) for w in widths)


def global_width(local: int) -> int:
    return sum(level_widths(local)) if space_split() else local


def gather_width(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every space rank's columns of ``x`` along ``dim``, concatenated
    (``x`` itself without a space split)."""
    if not space_split():
        return x
    sizes = level_widths(x.shape[dim])
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, max(sizes) -
                                                   x.shape[dim]]
    parts = all_gather_if_present(F.pad(x, pad), "space")
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)],
                     dim)


def local_columns(full: torch.Tensor, local: int, dim: int) -> torch.Tensor:
    """This rank's ``local`` columns of a gathered ``full`` map."""
    sizes = level_widths(local)
    return full.narrow(dim, sum(sizes[:axis_index("space")]), local)


def same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """flax's SAME padding (before, after) of a ``size``-long axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def halo_pad(x: torch.Tensor, widths: tuple, left: int, right: int,
             value: float) -> torch.Tensor:
    """``x`` (..., W) with ``left`` columns before and ``right`` after:
    the neighbouring space ranks' edge columns, ``value`` at the global
    edges.  ``widths`` are every space rank's columns at this level, so
    that a halo wider than some rank's share raises on every rank,
    before the collective."""
    if left == 0 and right == 0:
        return x
    h = max(left, right)
    if min(widths) < h:
        raise ValueError(f"a halo of {h} columns needs at least {h} on "
                         f"every rank, the split gives {widths}: use "
                         f"fewer ranks on the space axis")
    edges = all_gather_if_present(
        torch.cat([x[..., :h], x[..., -h:]], dim=-1), "space")
    r, n = axis_index("space"), axis_size("space")
    fill = x.new_full(x.shape[:-1] + (h,), value)
    lo = edges[r - 1][..., 2 * h - left:] if r > 0 else fill[..., :left]
    hi = edges[r + 1][..., :right] if r < n - 1 else fill[..., :right]
    return torch.cat([lo, x, hi], dim=-1)


def pad_same(x: torch.Tensor, k: int, s: int,
             value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor as flax/XLA ``padding="SAME"`` does; under a
    space split W from the global width, with halos at the inner
    edges."""
    ph = same_pad(x.shape[-2], k, s)
    if not space_split():
        pw = same_pad(x.shape[-1], k, s)
        if ph == (0, 0) and pw == (0, 0):
            return x
        return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)
    widths = level_widths(x.shape[-1])
    if any(w % s for w in widths):
        raise ValueError(f"a stride-{s} op on the columns {widths}: every "
                         f"rank's share must be a multiple of the stride")
    if ph != (0, 0):
        x = F.pad(x, (0, 0, ph[0], ph[1]), value=value)
    return halo_pad(x, widths, *same_pad(sum(widths), k, s), value)


def check_options(cfg) -> None:
    """Raise ``ValueError`` for a BEV-net option the split forwards do
    not shard."""
    if cfg.bn_type == "semiglobal_sync_bn":
        raise ValueError("bn_type='semiglobal_sync_bn' has no spatial or "
                         "tensor split (its statistics are not sharded)")


def split_forward(net, mesh, axes: dict, train: bool):
    """``fwd(example) -> preds``: ``net`` in train or eval
    mode, each port axis of ``axes`` ("space", "model") bound to the
    mesh axis it names, the BEV stage split along those axes.  The maps
    come out gathered and the odometry replicated: what the unsharded
    forward returns, on every rank."""
    cfg = net.cfg.odom
    check_options(cfg)
    block = math.prod(cfg.layer_strides)

    def fwd(example):
        was = net.training
        net.train(train)
        try:
            with contextlib.ExitStack() as stack:
                for name, mesh_axis in axes.items():
                    group, size, rank = mesh.axis(mesh_axis)
                    stack.enter_context(bind_axis(name, group, size, rank))
                stack.enter_context(_active(_Split(
                    "space" in axes, "model" in axes, block)))
                return net(example)
        finally:
            net.train(was)

    return fwd


def make_spatial_forward(net, mesh, axis: str = "space",
                         train: bool = False):
    """``fwd(example) -> preds`` with the BEV stage's width split over
    ``mesh``'s axis ``axis`` (a ``utils/mesh_axis.py::GridMesh``).
    ``example`` is one sample (no batch axis), the same on every rank,
    and so are the weights."""
    return split_forward(net, mesh, {"space": axis}, train)
