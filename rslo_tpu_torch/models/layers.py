"""Small layers (counterpart of ``rslo_tpu/models/layers.py``).

Tensors keep the JAX layout: channels last, so a mask or an image is
(N, H, W, C).  ``Dropout2dGivenMask`` draws its channel mask from an
explicit ``torch.Generator`` (JAX's from a "dropout" rng stream).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .bev_net import max_pool_mask


def elu_plus(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """ELU + 1 (+eps): a smooth positive map for scales and
    confidences."""
    return F.elu(x) + 1.0 + eps


def trunc_exp(x: torch.Tensor, max_value: float = 20.0) -> torch.Tensor:
    """exp of the input clipped to [-max_value, max_value]."""
    return torch.exp(torch.clamp(x, -max_value, max_value))


class ParameterLayer(nn.Module):
    """A bare learnable tensor of ``shape``, filled with ``init_value``
    (flax leaf ``value``)."""

    def __init__(self, shape, init_value: float = 0.0):
        super().__init__()
        self.value = nn.Parameter(torch.full(tuple(shape), init_value))

    def forward(self) -> torch.Tensor:
        return self.value


class Dropout2dGivenMask(nn.Module):
    """Channel dropout that can replay a given mask, to drop the same
    channels in both frames of a pair.  x: (N, H, W, C); the mask is
    (N, 1, 1, C), keep / (1 - rate).  In eval mode (or at rate 0) the
    input passes and the mask is ones.  In train mode without a mask,
    one is drawn from ``generator``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        shape = x.shape[:1] + (1, 1) + x.shape[-1:]
        if not self.training or self.rate <= 0.0:
            return x, torch.ones(shape, dtype=x.dtype, device=x.device)
        if mask is None:
            u = torch.rand(shape, generator=generator, device=x.device)
            keep = (u < 1.0 - self.rate).to(x.dtype)
            mask = keep / (1.0 - self.rate)
        return x * mask, mask


def mask_propagate(mask: torch.Tensor, kernel: int = 3,
                   stride: int = 1) -> torch.Tensor:
    """Max-pool an (N, H, W, 1) mask with SAME padding (standalone mask
    propagation)."""
    out = max_pool_mask(mask.permute(0, 3, 1, 2), kernel, stride)
    return out.permute(0, 2, 3, 1)
