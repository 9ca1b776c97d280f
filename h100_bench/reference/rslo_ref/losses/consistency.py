"""Self-supervised chamfer/ICP consistency loss with covariance modeling
(counterpart of ``rslo_tpu/losses/consistency.py``).

One-direction NN association, normal-cosine weighting, percentile
outlier gating, Mahalanobis residual under
``Σ = Σ_src + R Σ_assoc Rᵀ`` with a log-det regularizer (or, without
covariances, as on the offline hier clouds, the plain squared distance
with no regularizer), and an inner
weighted-Kabsch ICP loop whose accumulated ``(res_R, res_t)`` correction
becomes the pseudo ego-motion target.  The JAX package vmaps one pair;
here every function carries the pair axis P in front, so each NN search
is one kernel launch for all pairs.

Every small matrix product is a broadcast multiply-and-sum in f32 (JAX
pins ``Precision.HIGHEST`` there), so none runs in TF32 on the card.
"""
from __future__ import annotations

import torch

from ..geometry import quat_to_matrix, weighted_kabsch
from ..ops.chamfer import BIG, nn_search


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3, 3) in f32 multiply-adds."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3)."""
    return torch.sum(a * v[..., None, :], dim=-1)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (P, M, ...) gathered at idx (P, N) along the point axis."""
    flat = x.reshape(x.shape[0], x.shape[1], -1)
    out = torch.gather(flat, 1, idx.long()[..., None].expand(
        -1, -1, flat.shape[-1]))
    return out.reshape(idx.shape + x.shape[2:])


def span_cov(cov_params: torch.Tensor) -> torch.Tensor:
    """(..., 7) covariance params -> (..., 3, 3) SPD matrices:
    cumulative eigenvalue increments and a wxyz eigenvector
    quaternion."""
    lam1 = cov_params[..., 0]
    lam2 = lam1 + cov_params[..., 1]
    lam3 = lam2 + cov_params[..., 2]
    q = cov_params[..., 3:]
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-18)
    V = quat_to_matrix(q)
    lam = torch.stack([lam1, lam2, lam3], dim=-1)
    # V diag(lam) V^T
    return torch.sum((V * lam[..., None, :])[..., :, None, :] *
                     V[..., None, :, :], dim=-1)


def inv3x3(M: torch.Tensor, eps: float = 1e-6):
    """Closed-form batched 3x3 inverse and determinant of M + eps*I."""
    M = M + eps * torch.eye(3, dtype=M.dtype, device=M.device)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, 1e-20)
    adj = torch.stack([
        A, -(b * i - c * h), (b * f - c * e),
        B, (a * i - c * g), -(a * f - c * d),
        C, -(a * h - b * g), (a * e - b * d),
    ], dim=-1).reshape(M.shape)
    return adj * inv_det[..., None, None], det


def roi_gate(dist: torch.Tensor, valid: torch.Tensor,
             penalize_ratio: float) -> torch.Tensor:
    """Distance-percentile outlier gate over the last axis: keep points
    with dist < max(kth-smallest valid distance, 1.0), k = 1 +
    floor(n_valid * ratio)."""
    N = dist.shape[-1]
    d = torch.where(valid, dist, BIG)
    ds = torch.sort(d, dim=-1).values
    n_valid = torch.sum(valid.to(torch.int32), dim=-1)
    k = 1 + (n_valid.to(torch.float32) * penalize_ratio).to(torch.int32)
    k = torch.clamp(k - 1, 0, N - 1)
    m = torch.clamp(torch.gather(ds, -1, k[..., None].long()), min=1.0)
    return (dist < m) & valid


def _cos_weight(normal: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    num = torch.sum(normal * vec, dim=-1)
    den = torch.sqrt((torch.sum(normal * normal, -1) + 1e-16) *
                     (torch.sum(vec * vec, -1) + 1e-16))
    return torch.abs(num / den)


def consistency_pair(src, src_mask, src_normal, cov_src, tgt, tgt_mask,
                     cov_tgt_spanned, R_pred, *, penalize_ratio: float,
                     reg_weight: float, icp_iter: int):
    """All pairs at once.  src (P, N, 3) reference-frame points; tgt
    (P, M, 3) counterpart points already warped by the predicted
    motion; cov_src (P, N, 7) params; cov_tgt_spanned (P, M, 3, 3) the
    warped cloud's spanned covariances (rotated here by R_pred); both
    None for the covariance-free data term.
    Returns (loss (P,), res_R (P, 3, 3), res_t (P, 3))."""
    src = src.float()
    tgt = tgt.float()
    R_det = R_pred.detach()

    dist, idx = nn_search(src.detach(), src_mask, tgt.detach(), tgt_mask)
    assoc = _rows(tgt, idx)
    assoc_valid = _rows(tgt_mask, idx) & src_mask

    w = _cos_weight(src_normal, assoc - src)
    roi = roi_gate(dist, assoc_valid, penalize_ratio)

    diff = src - assoc
    nroi = torch.sum(roi.float(), dim=-1) + 1e-12
    if cov_src is None:
        md = torch.sum(diff * diff, dim=-1)
        loss = torch.sum(torch.where(roi, md, 0.0), dim=-1) / nroi
    else:
        sigma_src = span_cov(cov_src)
        sigma_assoc = _rows(cov_tgt_spanned, idx)
        Rb = R_det[:, None]
        sigma = sigma_src + _mm(_mm(Rb, sigma_assoc), Rb.transpose(-1, -2))
        # padded rows carry zero covariance: inverting them explodes the
        # backward (1/det^2) into inf * masked-0 = NaN, so they become I
        eye = torch.eye(3, dtype=sigma.dtype, device=sigma.device)
        sigma = torch.where(assoc_valid[..., None, None], sigma, eye)
        sigma_inv, det = inv3x3(sigma)
        md = torch.sum(diff * _mv(sigma_inv, diff), dim=-1)
        data_term = torch.sum(torch.where(roi, md, 0.0), dim=-1) / nroi
        logdet = 0.5 * torch.log(torch.clamp(det, min=1e-20))
        reg_term = torch.sum(torch.where(roi, logdet, 0.0), dim=-1) / nroi
        loss = data_term + reg_weight * reg_term

    # inner ICP loop, all stop-gradient
    with torch.no_grad():
        P = src.shape[0]
        src_d, tgt_d = src.detach(), tgt.detach()
        src_normal = src_normal.detach()
        res_R = torch.eye(3, device=src.device).expand(P, 3, 3)
        res_t = torch.zeros((P, 3), device=src.device)
        cur_assoc, cur_w, cur_roi = assoc.detach(), w.detach(), roi
        for it in range(icp_iter):
            kw = cur_w ** 2 * cur_roi.float()
            R_, t_ = weighted_kabsch(src_d, cur_assoc, kw)
            res_R = _mm(R_, res_R)
            res_t = _mv(R_, res_t) + t_
            if it < icp_iter - 1:
                tgt2 = _mv(res_R[:, None], tgt_d) + res_t[:, None]
                d2, i2 = nn_search(src_d, src_mask, tgt2, tgt_mask)
                cur_assoc = _rows(tgt2, i2)
                cur_w = _cos_weight(src_normal, cur_assoc - src_d)
                cur_roi = roi_gate(d2, _rows(tgt_mask, i2) & src_mask,
                                   penalize_ratio)
    return loss, res_R, res_t


def consistency_loss_pairs(src, src_mask, src_normal, cov_src, tgt,
                           tgt_mask, cov_tgt, R_pred, *,
                           penalize_ratio: float, reg_weight: float,
                           icp_iter: int):
    """src/tgt (P, N, 3); masks (P, N); cov_* (P, N, 7), or None for
    the covariance-free data term (the hier-points consistency); R_pred
    (P, 3, 3).  ``tgt`` must already be warped by the predicted motion.
    Returns (mean loss, res_R (P, 3, 3), res_t (P, 3))."""
    if cov_src is None or cov_tgt is None:
        cov_src = cov_tgt_spanned = None
    else:
        cov_tgt_spanned = span_cov(cov_tgt)
    loss, res_R, res_t = consistency_pair(
        src, src_mask, src_normal, cov_src, tgt, tgt_mask,
        cov_tgt_spanned, R_pred, penalize_ratio=penalize_ratio,
        reg_weight=reg_weight, icp_iter=icp_iter)
    return torch.mean(loss), res_R, res_t
