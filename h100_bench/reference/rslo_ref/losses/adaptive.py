"""Adaptive (homoscedastic-uncertainty) weighted L2 losses (counterpart of
``rslo_tpu/losses/adaptive.py``): per-sample masked mean of squared
error, focal re-weighting ``(e^{-a} l)^g / sum``, and the learned
log-variance term ``e^{-a} l + a``; on the pose (``adaptive_weighted_l2``)
or on the rotation-matrix residual (``adaptive_weighted_l2_rmatrix``);
and the plain masked ``l2_loss``."""
from __future__ import annotations

from typing import Optional

import torch

from ..geometry import quat_to_matrix
from ..ops.precision import f32_matmul


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


def adaptive_weighted_l2_rmatrix(pred_q: torch.Tensor,
                                 target_q: torch.Tensor,
                                 alpha: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None,
                                 focal_gamma: float = 0.0,
                                 weight: float = 1.0) -> torch.Tensor:
    """The rotation variant on the residual R_pred^T R_tgt - I.  Inputs
    are (B, ..., 4) wxyz quaternions or (B, ..., 9) row-major
    matrices; mask (B, ...)."""
    def to_mat(x):
        if x.shape[-1] == 4:
            return quat_to_matrix(x)
        return x.reshape(x.shape[:-1] + (3, 3))
    P = to_mat(pred_q.float())
    T = to_mat(target_q.float())
    eye = torch.eye(3, dtype=P.dtype, device=P.device)
    with f32_matmul():
        diff = torch.matmul(P.transpose(-1, -2), T) - eye
    sq = (diff * diff).reshape(diff.shape[0], -1)
    if mask is not None:
        mask = mask[..., None, None].expand(diff.shape).reshape(sq.shape)
    loss_b = _per_sample_mean(sq, mask)
    scaled = torch.exp(-alpha) * loss_b
    focal_w = scaled ** focal_gamma
    focal_w = focal_w / (torch.sum(focal_w) + 1e-12)
    return weight * (torch.sum(focal_w * scaled) + alpha)


def l2_loss(pred: torch.Tensor, target: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            weight: float = 1.0) -> torch.Tensor:
    """The (masked) mean squared error, times ``weight``."""
    diff = (pred - target).float()
    sq = diff * diff
    if mask is None:
        return weight * torch.mean(sq)
    mask = mask.expand(sq.shape)
    return weight * torch.sum(sq * mask) / (torch.sum(mask) + 1e-12)
