"""Total training objective: pose + pyramid + self-supervised consistency
(counterpart of ``rslo_tpu/losses/objective.py``).

The consistency runs on the middle net's voxel points with their
covariances, or with ``use_hier_points`` on the offline hier clouds
without covariances; the cross-normal VFE's ``normal_gt`` weights the
association in place of the network-input normals.  Before
``warmup_steps`` the consistency term sees identity rotation and
zero translation and runs ``warmup_icp_iter`` inner ICP iterations;
pseudo ego-motion targets come from the ICP-refined predictions; the
pyramid tq-map targets are regenerated from them each step.  The warmup
phase is the caller's host-side decision (``warmup``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from ..config.schema import LossCfg
from ..data.prepare import dequantize_points
from ..geometry import (generate_tq_map, hemisphere, matrix_to_quat,
                        quat_to_matrix)
from .adaptive import adaptive_weighted_l2
from .consistency import _mm, _mv, consistency_loss_pairs


class LossOut(NamedTuple):
    total: torch.Tensor
    aux: Dict[str, torch.Tensor]


def _pair_indices(L: int):
    return [(i, j) for i in range(L) for j in range(i + 1, L)]


def resize_nearest(maps: torch.Tensor, size) -> torch.Tensor:
    """(P, H, W, C) -> (P, h, w, C), picking cells as
    ``jax.image.resize(..., "nearest")`` does: the input cell under each
    output cell's centre, i.e. torch's ``nearest-exact`` (torch's
    ``nearest`` picks the cell under the output cell's corner)."""
    out = F.interpolate(maps.permute(0, 3, 1, 2), size=tuple(size),
                        mode="nearest-exact")
    return out.permute(0, 2, 3, 1)


def compute_objective(preds: Dict[str, Any], example: Dict[str, Any],
                      alphas: Dict[str, torch.Tensor], cfg: LossCfg,
                      pc_range, *, warmup: bool,
                      self_supervised: bool = True) -> LossOut:
    """preds: OdomNet output; example: the batch example (``odometry``
    (P, 7) GT pair motions, the targets in supervised mode); alphas:
    {"rot", "trans"} learned log-variances; warmup: True while the
    global step is <= ``cfg.warmup_steps``."""
    odom = preds["odometry"].float()
    T_pred, q_pred = odom[:, :3], odom[:, 3:]
    P = odom.shape[0]
    dev = odom.device
    aux: Dict[str, torch.Tensor] = {}
    C_loss = torch.zeros((), device=dev)

    if self_supervised:
        L = preds["seq_length"]
        feats = preds["voxel_features"]
        masks = preds["voxel_masks"]
        V = feats[0].shape[0]
        stride = max(1, -(-V // cfg.max_loss_points))

        def sub(x):
            """Strided static subsample to <= max_loss_points rows."""
            return x[::stride][:cfg.max_loss_points]

        def pts_of(t):
            f = sub(feats[t])
            if f.shape[1] > 6:
                return torch.cat([f[:, 0:3], f[:, 4:7]], dim=-1)
            return f[:, 0:6]

        pairs = _pair_indices(L)
        use_hier = cfg.use_hier_points and "hier_points" in example
        if use_hier:
            # the consistency on the offline hier clouds (xyz + normals),
            # with no covariance modeling
            hp = dequantize_points(example["hier_points"]).float()
            hm = example["hier_mask"]
            stride_h = max(1, -(-hp.shape[1] // cfg.max_loss_points))

            def subh(x):
                return x[::stride_h][:cfg.max_loss_points]

            src_pts = torch.stack([subh(hp[i]) for i, _ in pairs])
            src_mask = torch.stack([subh(hm[i]) for i, _ in pairs])
            tgt_pts = torch.stack([subh(hp[j]) for _, j in pairs])
            tgt_mask = torch.stack([subh(hm[j]) for _, j in pairs])
            src_cov = tgt_cov = None
        else:
            covs = preds["voxel_covs"]
            src_pts = torch.stack([pts_of(i) for i, _ in pairs]).float()
            src_mask = torch.stack([sub(masks[i]) for i, _ in pairs])
            src_cov = torch.stack([sub(covs[i]) for i, _ in pairs]).float()
            tgt_pts = torch.stack([pts_of(j) for _, j in pairs]).float()
            tgt_mask = torch.stack([sub(masks[j]) for _, j in pairs])
            tgt_cov = torch.stack([sub(covs[j]) for _, j in pairs]).float()
        icp_iter = cfg.warmup_icp_iter if warmup else cfg.icp_iter
        # cross-normal mode: the finer supervision normals weight the
        # association instead of the network-input normals
        if "normal_gt" in preds and not use_hier:
            src_normals = torch.stack(
                [sub(preds["normal_gt"][i]) for i, _ in pairs]).detach()
        else:
            src_normals = src_pts[..., 3:6].detach()

        # one consistency term per pyramid level of odometry; the ICP
        # corrections compose across levels
        levels = preds.get("odometry_levels") or [odom]
        weights = cfg.pyramid_level_weights[-len(levels):]
        C_raw_sum = torch.zeros((), device=dev)
        res_R = torch.eye(3, device=dev).expand(P, 3, 3)
        res_t = torch.zeros((P, 3), device=dev)
        for lvl, w_lvl in zip(levels, weights):
            lvl = lvl.float()
            if warmup:
                R_use = torch.eye(3, device=dev).expand(P, 3, 3)
                T_use = torch.zeros((P, 3), device=dev)
            else:
                R_use = quat_to_matrix(lvl[:, 3:])
                T_use = lvl[:, :3]
            tgt_xyz = _mv(R_use[:, None], tgt_pts[..., :3]) + \
                T_use[:, None, :]
            c_raw, rR, rt = consistency_loss_pairs(
                src_pts[..., :3], src_mask, src_normals, src_cov,
                tgt_xyz, tgt_mask, tgt_cov, R_use,
                penalize_ratio=cfg.penalize_ratio,
                reg_weight=cfg.reg_weight, icp_iter=icp_iter)
            C_raw_sum = C_raw_sum + w_lvl * c_raw
            res_t = _mv(rR, res_t) + rt
            res_R = _mm(rR, res_R)
        C_loss = cfg.consistency_weight * C_raw_sum
        aux["consistency_loss"] = C_raw_sum

        # pseudo targets: the composed ICP correction applied to the
        # final level's prediction
        with torch.no_grad():
            R_base = R_use.detach()
            T_base = T_use.detach()
            q_tgt = hemisphere(matrix_to_quat(_mm(res_R, R_base)))
            t_tgt = _mv(res_R, T_base) + res_t
        rotation_targets, translation_targets = q_tgt, t_tgt
    else:
        gt = example["odometry"].float().reshape(-1, 7)
        translation_targets = gt[:, :3]
        rotation_targets = hemisphere(gt[:, 3:])

    T_loss = adaptive_weighted_l2(T_pred, translation_targets,
                                  alphas["trans"],
                                  focal_gamma=cfg.focal_gamma,
                                  weight=cfg.translation_weight)
    R_loss = adaptive_weighted_l2(q_pred, rotation_targets, alphas["rot"],
                                  focal_gamma=cfg.focal_gamma,
                                  weight=cfg.rotation_weight)

    pyramid = preds.get("pyramid", [])
    pyramid_loss = torch.zeros((), device=dev)
    if pyramid:
        tq_targets = torch.cat([translation_targets, rotation_targets],
                               dim=-1)
        H, W = pyramid[-1][0].shape[1:3]
        tgt_map = generate_tq_map(tq_targets, (H, W), pc_range).detach()
        n = len(pyramid)
        for i, (pmap, pmask) in enumerate(pyramid):
            h, w = pmap.shape[1:3]
            tm = tgt_map if (h, w) == (H, W) else resize_nearest(
                tgt_map, (h, w))
            t_l = adaptive_weighted_l2(
                pmap[..., :3], tm[..., :3], alphas["trans"],
                mask=pmask[..., 0:1], focal_gamma=cfg.focal_gamma,
                weight=cfg.pyramid_translation_weight)
            r_l = adaptive_weighted_l2(
                pmap[..., 3:], tm[..., 3:], alphas["rot"],
                mask=pmask[..., -1:], focal_gamma=cfg.focal_gamma,
                weight=cfg.pyramid_rotation_weight)
            pyramid_loss = pyramid_loss + \
                cfg.pyloss_exp_w_base ** (n - i) * (t_l + r_l)

    # diagnostic only: odometry error against the GT motions, which the
    # self-supervised objective never trains on
    if "odometry" in example:
        with torch.no_grad():
            gt = example["odometry"].float().reshape(-1, 7)
            if gt.shape[0] == P:
                aux["t_err_gt"] = torch.mean(torch.sqrt(
                    torch.sum((T_pred - gt[:, :3]) ** 2, -1) + 1e-12))
                qn = q_pred / torch.sqrt(
                    torch.sum(q_pred * q_pred, -1, keepdim=True) + 1e-12)
                dq = torch.abs(torch.sum(qn * hemisphere(gt[:, 3:]), -1))
                aux["q_err_deg"] = torch.mean(
                    2 * torch.arccos(torch.clamp(dq, 0.0, 1.0)) * 180.0 /
                    math.pi)

    total = T_loss + R_loss + pyramid_loss + C_loss
    aux.update({
        "translation_loss": T_loss,
        "rotation_loss": R_loss,
        "pyramid_loss": pyramid_loss,
        "C_loss": C_loss,
        "loss": total,
    })
    return LossOut(total, {k: v.detach() for k, v in aux.items()})
