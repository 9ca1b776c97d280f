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
  over 4.  Ranks beyond the chunk count hold no columns (16 go 8/8/0/0
  over 4, where GSPMD pads): they compute nothing but join every
  collective, in the same order as the others.
- ``pad_same`` pads as flax's SAME does for the GLOBAL width: the inner
  edges take the neighbours' columns (halos), only the global edges the
  pad value (-inf for the mask max-pool).  So every conv, pool and
  mask-sum conv gives, on a rank's columns, the columns of the unsharded
  result.
- ``gather_width`` gathers a map along W (the confidence softmax over
  H * W, the output maps); the batch-norm moments (``batch_moments``,
  the plain and the semi-global BN) and spatial means sum over the axis
  (``utils/mesh_axis.py::psum_if_present``).
- A halo may be wider than a neighbour's share (the spatial gate's
  7 x 7 conv at the encoder's last stage of a 4-rank split), or the
  neighbour may hold none: it takes columns of the ranks beyond, as
  GSPMD's exchange does.
- Rows are never split, so a map's height tells its level on every
  rank, one without columns too (``level_widths``).

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
                               bind_axis, gather_shares, psum_if_present)


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
    height: Optional[int] = None


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
    one chunk more; with fewer chunks than ranks the last ranks hold
    none."""
    if width % block:
        raise ValueError(f"BEV width {width} is not a multiple of the "
                         f"encoder's stride product {block}")
    base, extra = divmod(width // block, ranks)
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
    s.height = x.shape[1]
    if not s.space:
        return x
    r = axis_index("space")
    return x[:, :, sum(s.widths[:r]):sum(s.widths[:r + 1])]


def level_widths(height: int, local: int) -> tuple:
    """Every space rank's columns at the BEV level of ``height`` rows,
    where this rank holds ``local`` columns: the pair tensor's split
    divided by the level's stride, the pair tensor's rows over
    ``height`` (rows are never split, so a rank without columns knows
    its level too)."""
    s = active()
    stride, rem = divmod(s.height, height)
    widths = tuple(w // stride for w in s.widths) if stride else ()
    if rem or not stride or any(w % stride for w in s.widths) or \
            widths[axis_index("space")] != local:
        raise ValueError(f"a map of {height} rows and {local} columns is "
                         f"not a level of the split {s.widths} of "
                         f"{s.height} rows")
    return widths


def global_width(height: int, local: int) -> int:
    """The global width of a map of ``height`` rows of which this rank
    holds ``local`` columns."""
    return sum(level_widths(height, local)) if space_split() else local


def gather_width(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every space rank's columns of ``x`` along ``dim`` (the dim before
    it holds the rows), concatenated (``x`` itself without a space
    split)."""
    if not space_split():
        return x
    return gather_shares(x, "space", level_widths(x.shape[dim - 1],
                                                  x.shape[dim]), dim)


def local_columns(full: torch.Tensor, local: int, dim: int) -> torch.Tensor:
    """This rank's ``local`` columns of a gathered ``full`` map (the dim
    before ``dim`` holds the rows)."""
    sizes = level_widths(full.shape[dim - 1], local)
    return full.narrow(dim, sum(sizes[:axis_index("space")]), local)


def same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """flax's SAME padding (before, after) of a ``size``-long axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def halo_pad(x: torch.Tensor, widths: tuple, left: int, right: int,
             value: float) -> torch.Tensor:
    """``x`` (..., W) with ``left`` columns before and ``right`` after:
    the columns of the ranks to the left (r-1, r-2, ...) and to the
    right (r+1, r+2, ...) until there are enough, ``value`` only past
    the global edges.  ``widths`` are every space rank's columns at this
    level, so a halo wider than a neighbour's share (or none) reaches
    past it.
    One collective: every rank contributes its first and its last
    ``min(h, share)`` columns, padded to h = max(left, right)."""
    if left == 0 and right == 0:
        return x
    h = max(left, right)
    r, n = axis_index("space"), axis_size("space")
    k = min(h, x.shape[-1])
    pad = x.new_full(x.shape[:-1] + (h - k,), value)
    edges = all_gather_if_present(torch.cat(
        [x[..., :k], pad, pad, x[..., x.shape[-1] - k:]], dim=-1), "space")

    def fill(m):
        return x.new_full(x.shape[:-1] + (m,), value)
    lo, need = [], left
    for j in range(r - 1, -1, -1):       # rank j's last columns
        if need == 0:
            break
        take = min(need, widths[j])
        lo.insert(0, edges[j][..., 2 * h - take:])
        need -= take
    if need:
        lo.insert(0, fill(need))
    hi, need = [], right
    for j in range(r + 1, n):            # rank j's first columns
        if need == 0:
            break
        take = min(need, widths[j])
        hi.append(edges[j][..., :take])
        need -= take
    if need:
        hi.append(fill(need))
    return torch.cat(lo + [x] + hi, dim=-1)


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
    widths = level_widths(x.shape[-2], x.shape[-1])
    if any(w % s for w in widths):
        raise ValueError(f"a stride-{s} op on the columns {widths}: every "
                         f"rank's share must be a multiple of the stride")
    if ph != (0, 0):
        x = F.pad(x, (0, 0, ph[0], ph[1]), value=value)
    return halo_pad(x, widths, *same_pad(sum(widths), k, s), value)


def same_op(op, x: torch.Tensor, k: int, s: int,
            value: float = 0.0) -> torch.Tensor:
    """``op`` (a conv or a pool of kernel ``k`` and stride ``s`` that
    pads nothing itself) over ``x`` padded as flax's SAME does
    (``pad_same``).  A rank holding no columns of a space split takes
    part in the halo exchange and returns ``op``'s output without
    columns: torch's convs and pools refuse an empty output, so ``op``
    runs on ``k`` columns of the pad value and the column it gives is
    dropped."""
    xp = pad_same(x, k, s, value)
    if x.shape[-1] or not space_split():
        return op(xp)
    return op(F.pad(xp[..., :0], (0, k), value=value))[..., :0]


def batch_moments(xf: torch.Tensor):
    """E[x] and E[x^2] per channel (dim 1) over every other dim; under a
    space split the sums over the ranks divided by the global count
    (the shares are uneven, so a mean of the ranks' means would be
    wrong)."""
    dims = (0,) + tuple(range(2, xf.dim()))
    if not space_split():
        return torch.mean(xf, dim=dims), torch.mean(xf * xf, dim=dims)
    n = math.prod(xf.shape[d] for d in dims[:-1]) * global_width(
        xf.shape[-2], xf.shape[-1])
    return (psum_if_present(torch.sum(xf, dim=dims), "space") / n,
            psum_if_present(torch.sum(xf * xf, dim=dims), "space") / n)


def split_forward(net, mesh, axes: dict, train: bool):
    """``fwd(example) -> preds``: ``net`` in train or eval
    mode, each port axis of ``axes`` ("space", "model") bound to the
    mesh axis it names, the BEV stage split along those axes.  The maps
    come out gathered and the odometry replicated: what the unsharded
    forward returns, on every rank."""
    if mesh is None:
        raise ValueError("this rank is outside the grid (grid_mesh gave it "
                         "None): it runs no split forward")
    block = math.prod(net.cfg.odom.layer_strides)

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
