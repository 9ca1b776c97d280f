"""Adaptive (homoscedastic-uncertainty) weighted L2 loss (counterpart of
``rslo_tpu/losses/adaptive.py``): per-sample masked mean of squared
error, focal re-weighting ``(e^{-a} l)^g / sum``, and the learned
log-variance term ``e^{-a} l + a``."""
from __future__ import annotations

from typing import Optional

import torch


def _per_sample_mean(sq: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, ...) squared errors -> (B,) masked means."""
    dims = tuple(range(1, sq.dim()))
    if mask is None:
        return torch.mean(sq, dim=dims)
    mask = mask.expand(sq.shape)
    return torch.sum(sq * mask, dim=dims) / (torch.sum(mask, dim=dims) +
                                             1e-12)


def adaptive_weighted_l2(pred: torch.Tensor, target: torch.Tensor,
                         alpha: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         focal_gamma: float = 0.0,
                         weight: float = 1.0) -> torch.Tensor:
    """pred/target: (B, ...); alpha: scalar log-variance."""
    diff = pred.float() - target.float()
    loss_b = _per_sample_mean(diff * diff, mask)
    scaled = torch.exp(-alpha) * loss_b
    focal_w = scaled ** focal_gamma
    focal_w = focal_w / (torch.sum(focal_w) + 1e-12)
    return weight * (torch.sum(focal_w * scaled) + alpha)
