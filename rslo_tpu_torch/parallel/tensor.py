"""Tensor (channel) parallelism of the dense BEV stage (counterpart of
``rslo_tpu/parallel/tensor.py``).

JAX shards the BEV maps' channels over a mesh axis and lets GSPMD
partition every conv's filter bank.  Here each rank of the "model" axis
holds C / R channels of every BEV activation (the rank's contiguous
slice): each conv all-gathers its input channels and computes its own
slice of the output channels, so ``Norm``, the ReLUs and the residual
adds work on the slice and the masks (one channel) on every rank.
Heads with fewer output channels than that (the 7-channel tq convs, the
1-channel confidence conv, the SE and FC dense layers) run replicated on
the gathered input.  The pair tensor and ``input_mask`` stay whole.

A 2-D (space x model) split composes this with ``spatial.py``'s width
split on one ``GridMesh``.  The reference has no analog; pipeline
parallelism is deliberately absent, as in JAX.
"""
from __future__ import annotations

import torch

from ..utils.mesh_axis import (all_gather_if_present, axis_index, axis_size,
                               psum_if_present)
from .spatial import active, global_width, split_forward


def model_split() -> bool:
    s = active()
    return s is not None and s.model


def channel_range(channels: int) -> tuple[int, int]:
    """This model rank's slice [lo, hi) of ``channels``."""
    n = axis_size("model")
    if channels % n:
        raise ValueError(f"{channels} channels do not split over the "
                         f"{n} ranks of the model axis")
    c = channels // n
    r = axis_index("model")
    return r * c, (r + 1) * c


def gather_channels(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Every model rank's channel slice of ``x``, concatenated along
    ``dim``."""
    return torch.cat(list(all_gather_if_present(x, "model")), dim)


def local_channels(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    lo, hi = channel_range(x.shape[dim])
    return x.narrow(dim, lo, hi - lo)


def bev_mean(x: torch.Tensor) -> torch.Tensor:
    """(N, C) float32 mean over H and W of an NCHW map: under a split
    layout summed over the space ranks, divided by the global count,
    every channel gathered."""
    if active() is None:
        return torch.mean(x.float(), dim=(2, 3))
    m = psum_if_present(torch.sum(x.float(), dim=(2, 3)), "space") / (
        x.shape[2] * global_width(x.shape[3]))
    return gather_channels(m) if model_split() else m


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

