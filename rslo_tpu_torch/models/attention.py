"""Channel (SE) and spatial attention blocks (counterpart of
``rslo_tpu/models/attention.py``), on NCHW tensors inside the BEV net.

flax's ``Dense`` and ``Conv`` without a dtype promote a bfloat16 input
against their float32 parameters, so both blocks compute their gates in
float32 and return float32 (the gate times the input), as JAX does.
Channel means of a bfloat16 input are summed in float32 and rounded
back, as ``jnp.mean`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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
        s = _mean(x, (2, 3))[:, :, 0, 0].float()          # (N, C)
        s = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(s))))
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
        avg = _mean(x, 1)
        mx = torch.amax(x, dim=1, keepdim=True)
        a = self.Conv_0(torch.cat([avg, mx], dim=1).float())
        return x * torch.sigmoid(a)
