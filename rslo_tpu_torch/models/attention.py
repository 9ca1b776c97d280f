"""Channel (SE) and spatial attention blocks (counterpart of
``rslo_tpu/models/attention.py``), on NCHW tensors inside the BEV net.

flax's ``Dense`` and ``Conv`` without a dtype promote a bfloat16 input
against their float32 parameters, so both blocks compute their gates in
float32 and return float32 (the gate times the input), as JAX does.
Channel means of a bfloat16 input are summed in float32 and rounded
back, as ``jnp.mean`` does.

Under a split forward (``rslo_tpu_torch/parallel/``) the SE means sum
over the "space" ranks and gather the channels, and the spatial gate's
channel mean and max read every channel, its conv pads with halos.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.spatial import pad_same, space_split
from ..parallel.tensor import (bev_mean, gather_channels, local_channels,
                               model_split)


def _mean(x: torch.Tensor, dim) -> torch.Tensor:
    return torch.mean(x.float(), dim=dim, keepdim=True).to(x.dtype)


class SELayer(nn.Module):
    """Squeeze-and-excitation over channels: the spatial mean, Dense to
    C // reduction, relu, Dense back to C, sigmoid, times the input."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, max(channels // reduction, 1))
        self.Dense_1 = nn.Linear(self.Dense_0.out_features, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = bev_mean(x).to(x.dtype).float()               # (N, C)
        s = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(s))))
        if model_split():
            s = local_channels(s)
        return x * s[:, :, None, None]


class SpatialAttention(nn.Module):
    """Per-pixel gate: a ``kernel`` x ``kernel`` SAME conv (odd kernel,
    stride 1: symmetric padding) over the channel mean and max, sigmoid,
    times the input."""

    def __init__(self, kernel: int = 7):
        super().__init__()
        if kernel % 2 != 1:
            raise ValueError(f"SpatialAttention needs an odd kernel, got "
                             f"{kernel}")
        self.Conv_0 = nn.Conv2d(2, 1, kernel, padding=kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = gather_channels(x) if model_split() else x
        g = torch.cat([_mean(xs, 1), torch.amax(xs, dim=1, keepdim=True)],
                      dim=1).float()
        if space_split():       # SAME padding with halos
            k = self.Conv_0.kernel_size[0]
            a = F.conv2d(pad_same(g, k, 1), self.Conv_0.weight,
                         self.Conv_0.bias)
        else:
            a = self.Conv_0(g)
        return x * torch.sigmoid(a)
