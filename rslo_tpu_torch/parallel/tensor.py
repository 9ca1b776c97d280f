"""Tensor (channel) parallelism of the dense BEV stage (counterpart of
``rslo_tpu/parallel/tensor.py``).

JAX shards the BEV maps' channels over a mesh axis and lets GSPMD
partition every conv's filter bank.  Here each rank of the "model" axis
holds a contiguous slice of the channels of every BEV activation, the
first C % R ranks one channel more than the others (128 over 3 ranks go
43/43/42; a rank holds none where C < R, as GSPMD's padding leaves it):
each conv all-gathers its input channels and computes its own slice of
the output channels, so ``Norm``, the ReLUs and the residual adds work
on the slice and the masks (one channel) on every rank.
Heads with fewer output channels than that (the 7-channel tq convs, the
1-channel confidence conv, the SE and FC dense layers) run replicated on
the gathered input.  The pair tensor and ``input_mask`` stay whole.

A 2-D (space x model) split composes this with ``spatial.py``'s width
split on one ``GridMesh``.  The reference has no analog; pipeline
parallelism is deliberately absent, as in JAX.
"""
from __future__ import annotations

import torch

from ..utils.mesh_axis import (axis_index, axis_size, gather_shares,
                               psum_if_present)
from .spatial import active, global_width, split_forward


def model_split() -> bool:
    s = active()
    return s is not None and s.model


def channel_sizes(channels: int) -> tuple:
    """Every model rank's share of ``channels``: the first ``channels %
    R`` of the R ranks take one more."""
    base, extra = divmod(channels, axis_size("model"))
    return tuple(base + (r < extra) for r in range(axis_size("model")))


def channel_range(channels: int) -> tuple[int, int]:
    """This model rank's slice [lo, hi) of ``channels`` (may be
    empty)."""
    sizes, r = channel_sizes(channels), axis_index("model")
    return sum(sizes[:r]), sum(sizes[:r + 1])


def holds_slice(x: torch.Tensor, channels: int, dim: int = 1) -> bool:
    """Whether ``x`` holds this model rank's slice of ``channels``
    rather than all of them, the same answer on every rank: a slice of
    two or more channels is narrower than the whole on every rank; a
    map of one channel (the bottleneck's inner width at 4 features) is
    a slice, rank 0's being that channel, as the BEV net's whole maps
    (the pair tensor, the decoder's concat) hold more."""
    return model_split() and (x.shape[dim] != channels or channels == 1)


def gather_channels(x: torch.Tensor, channels: int,
                    dim: int = 1) -> torch.Tensor:
    """All ``channels`` along ``dim`` from every model rank's slice
    ``x`` of them."""
    return gather_shares(x, "model", channel_sizes(channels), dim)


def local_channels(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    lo, hi = channel_range(x.shape[dim])
    return x.narrow(dim, lo, hi - lo)


def bev_mean(x: torch.Tensor, channels: int) -> torch.Tensor:
    """(N, C) float32 mean over H and W of an NCHW map of ``channels``
    channels: under a split layout summed over the space ranks, divided
    by the global count, every channel gathered."""
    if active() is None:
        return torch.mean(x.float(), dim=(2, 3))
    m = psum_if_present(torch.sum(x.float(), dim=(2, 3)), "space") / (
        x.shape[2] * global_width(x.shape[2], x.shape[3]))
    return gather_channels(m, channels) if holds_slice(x, channels) else m


def make_model_forward(net, mesh, axis: str = "model",
                       train: bool = False):
    """``fwd(example) -> preds`` with the BEV channels split over
    ``mesh``'s axis ``axis`` (tensor parallelism)."""
    return split_forward(net, mesh, {"model": axis}, train)


def make_spatial_model_forward(net, mesh, space_axis: str = "space",
                               model_axis: str = "model",
                               train: bool = False):
    """2-D split: the grid width over ``space_axis`` AND the channels
    over ``model_axis`` of one ``GridMesh`` (SP x TP)."""
    return split_forward(net, mesh, {"space": space_axis,
                                     "model": model_axis}, train)

