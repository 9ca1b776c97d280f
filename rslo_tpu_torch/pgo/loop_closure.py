"""Loop-closure detection and edge measurement for the refinement layer
(counterpart of ``rslo_tpu/pgo/loop_closure.py``).

  * place recognition = a Scan-Context-style polar BEV descriptor
    (ring x sector max-height signature).  Rotation invariance is a
    maximum over circular sector shifts: the S shifted query signatures
    against the database in one (K, R*S) @ (R*S, S) product;
  * a rotation-invariant ring key (per-ring mean) prefilters candidates
    with an (N, N) distance matrix;
  * each detected loop edge is measured by a fixed-iteration
    point-to-point ICP (nearest-neighbor association through
    ``ops.chamfer.nn_search`` — the hand-written CUDA kernel on a card —
    and weighted Kabsch), seeded with the descriptor's yaw estimate;
  * the edges drop into ``pose_graph.chain_graph`` /
    ``optimize_pose_graph``.

Every matrix product runs in full float32 (no TF32), as JAX pins
``Precision.HIGHEST`` there.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import matrix_to_quat, rotate_vec_by_q, weighted_kabsch
from ..ops.chamfer import nn_search
from ..ops.precision import f32_matmul
from .pose_graph import chain_graph, optimize_pose_graph

# rows of the descriptor distance search scored at once (bounds the
# (rows, S, R*S) shifted-query buffer)
_SCORE_ROWS = 128


# ---------------------------------------------------------------------------
# Descriptor


def polar_descriptor(points: torch.Tensor, mask: torch.Tensor,
                     n_rings: int = 20, n_sectors: int = 60,
                     max_radius: float = 70.0,
                     z_offset: float = 2.0) -> torch.Tensor:
    """(N, >=3) masked points -> (R, S) max-height polar signature.

    Cells with no points are 0; heights are offset so ground (~-z_offset)
    maps near 0 and structure rises above it."""
    xy = points[:, :2].float()
    r = torch.sqrt(torch.sum(xy * xy, dim=-1) + 1e-12)
    theta = torch.atan2(xy[:, 1], xy[:, 0])
    ring = torch.clamp((r / max_radius * n_rings).to(torch.int32),
                       0, n_rings - 1)
    sector = (((theta + math.pi) / (2 * math.pi) * n_sectors)
              .to(torch.int32)) % n_sectors
    z = points[:, 2].float() + z_offset
    valid = mask & (r < max_radius)
    cells = n_rings * n_sectors
    # invalid points go to one spare cell past the end, then dropped
    flat = torch.where(valid, ring * n_sectors + sector, cells)
    sig = torch.zeros(cells + 1, dtype=torch.float32, device=points.device)
    sig.scatter_reduce_(0, flat.long(),
                        torch.where(valid, torch.clamp(z, min=1e-3), 0.0),
                        "amax", include_self=True)
    return sig[:-1].reshape(n_rings, n_sectors)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """(..., R, S) -> (..., R) rotation-invariant per-ring mean."""
    return torch.mean(desc, dim=-1)


def _shift_scores(query: torch.Tensor, database: torch.Tensor):
    """query (..., R, S), database (..., K, R, S) -> cosine similarity
    (..., K, S) of each database entry with the query rolled by each
    sector shift s: ``roll(query, s)[..., k] = query[..., (k - s) % S]``,
    one gather."""
    R, S = query.shape[-2:]
    ar = torch.arange(S, device=query.device)
    roll = (ar[None, :] - ar[:, None]) % S                # [s, k]
    shifted = query[..., roll].transpose(-3, -2)          # (..., S, R, S)
    qn = torch.sqrt(torch.sum(query * query, dim=(-2, -1)) + 1e-12)
    dn = torch.sqrt(torch.sum(database * database, dim=(-2, -1)) + 1e-12)
    dot = database.flatten(-2) @ shifted.flatten(-2).transpose(-2, -1)
    return dot / (qn[..., None, None] * dn[..., None])


@f32_matmul()
def shift_similarity(query: torch.Tensor, database: torch.Tensor):
    """Rotation-searched cosine similarity.

    query: (R, S); database: (K, R, S).
    Returns (scores (K,), shifts (K,)): the best circular sector shift
    of the query against each database entry."""
    scores = _shift_scores(query, database)                # (K, S)
    return scores.max(dim=-1).values, scores.argmax(dim=-1)


def shift_to_yaw(shift: torch.Tensor, n_sectors: int) -> torch.Tensor:
    """Sector shift -> yaw angle (radians) rotating the candidate frame
    into the query frame about +z.  Shifts > S/2 wrap negative."""
    s = torch.where(shift > n_sectors // 2, shift - n_sectors, shift)
    return -2.0 * math.pi * s.to(torch.float32) / n_sectors


def yaw_pose(yaw: torch.Tensor) -> torch.Tensor:
    """(…,) yaw -> (…, 7) pose [0, 0, 0, qw, 0, 0, qz]."""
    half = 0.5 * yaw
    zeros = torch.zeros_like(yaw)
    return torch.stack([zeros, zeros, zeros, torch.cos(half),
                        zeros, zeros, torch.sin(half)], dim=-1)


# ---------------------------------------------------------------------------
# Detection


class LoopCandidates(NamedTuple):
    pairs: np.ndarray     # (L, 2) int (i, j), j < i - min_separation
    scores: np.ndarray    # (L,) descriptor cosine similarity
    yaws: np.ndarray      # (L,) initial yaw estimate (candidate->query)


@f32_matmul()
def detect_loops(descriptors: torch.Tensor, min_separation: int = 50,
                 score_threshold: float = 0.8,
                 ring_top_k: int = 5) -> LoopCandidates:
    """All-pairs loop detection over a trajectory's descriptors, on
    their device.

    descriptors: (N, R, S).  For each frame i, the ring-key (N, N)
    distance matrix prefilters the ``ring_top_k`` most similar earlier
    frames (j <= i - min_separation; a stable sort, so ties keep the
    earlier frame first); the shifted-cosine match then scores them,
    keeping the best per i above ``score_threshold``."""
    desc = torch.as_tensor(descriptors)
    N = desc.shape[0]
    if N <= min_separation:
        return LoopCandidates(np.zeros((0, 2), np.int32),
                              np.zeros((0,), np.float32),
                              np.zeros((0,), np.float32))
    keys = ring_key(desc)                                   # (N, R)
    sq = torch.sum(keys ** 2, dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (keys @ keys.T)  # (N, N)
    ii = torch.arange(N, device=desc.device)
    allowed = ii[None, :] <= ii[:, None] - min_separation
    d2 = torch.where(allowed, d2, math.inf)
    k = min(ring_top_k, N)
    cand = torch.argsort(d2, dim=1, stable=True)[:, :k]    # (N, k)
    sc = torch.cat([_shift_scores(desc[a:a + _SCORE_ROWS],
                                  desc[cand[a:a + _SCORE_ROWS]])
                    for a in range(0, N, _SCORE_ROWS)])      # (N, k, S)
    sc, sh = sc.max(dim=-1).values, sc.argmax(dim=-1)       # (N, k)
    sc = torch.where(torch.isfinite(torch.gather(d2, 1, cand)), sc, -1.0)
    b = torch.argmax(sc, dim=1)
    scores = sc[ii, b].cpu().numpy()
    best_j = cand[ii, b].cpu().numpy()
    yaws = shift_to_yaw(sh[ii, b], desc.shape[-1]).cpu().numpy()
    keep = scores >= score_threshold
    idx = np.nonzero(keep)[0]
    pairs = np.stack([idx, best_j[idx]], axis=-1).astype(np.int32)
    return LoopCandidates(pairs, scores[idx], yaws[idx])


# ---------------------------------------------------------------------------
# Edge measurement (point-to-point ICP)


@torch.no_grad()
def icp_align(pts_i: torch.Tensor, mask_i: torch.Tensor,
              pts_j: torch.Tensor, mask_j: torch.Tensor,
              init_pose: torch.Tensor, iters: int = 8,
              gate: float = 2.0):
    """Align cloud j onto cloud i on their device: returns (pose
    T_{i<-j}, mean residual, inlier fraction) with
    ``p_i ≈ R(T) p_j + t(T)``.

    Fixed-iteration ICP: transform j by the current pose, associate to
    the nearest i point (one ``nn_search`` launch an iteration), gate by
    ``gate`` metres, and re-solve the full alignment with weighted
    Kabsch each iteration."""
    pi = pts_i[:, :3].float()
    pj = pts_j[:, :3].float()
    pose = init_pose.float()
    res = frac = torch.zeros((), device=pi.device)
    for _ in range(iters):
        moved = rotate_vec_by_q(pj, pose[3:]) + pose[:3]
        d2, idx = nn_search(moved[None], mask_j[None], pi[None],
                            mask_i[None])
        d2, idx = d2[0], idx[0]
        w = (mask_j & (d2 < gate * gate)).float()
        src = pi[idx.long()]                   # matched i points
        R, t = weighted_kabsch(src[None], pj[None], w[None])
        q = matrix_to_quat(R[0])
        pose = torch.cat([t[0], q])
        res = torch.sqrt(torch.sum(d2 * w) / torch.clamp(w.sum(), min=1.0))
        frac = w.sum() / torch.clamp(mask_j.sum(), min=1.0)
    return pose, res, frac


# ---------------------------------------------------------------------------
# The full loop-closing pass


def close_loops(odoms: np.ndarray, clouds, masks=None,
                min_separation: int = 50, score_threshold: float = 0.8,
                icp_iters: int = 8, gate: float = 2.0,
                min_inlier_frac: float = 0.3,
                odom_info: float = 1.0, loop_info: float = 10.0,
                gn_iters: int = 15, device="cuda"):
    """Full loop-closing pass over a trajectory, on ``device``.

    odoms: (N-1, 7) sequential relative motions; clouds: length-N
    sequence of (P, >=3) scans (fixed P; pad + mask).  Returns
    (poses (N, 7) optimized absolute trajectory, LoopCandidates kept).
    """
    if masks is None:
        masks = [np.ones(len(c), bool) for c in clouds]
    clouds = [torch.as_tensor(np.asarray(c), dtype=torch.float32,
                              device=device) for c in clouds]
    masks = [torch.as_tensor(np.asarray(m), dtype=torch.bool, device=device)
             for m in masks]
    desc = torch.stack([polar_descriptor(c, m)
                        for c, m in zip(clouds, masks)])
    cands = detect_loops(desc, min_separation, score_threshold)
    edges, meas, infos = [], [], []
    for (i, j), yaw in zip(cands.pairs, cands.yaws):
        # i is the later (query) frame, j the revisited earlier one.
        pose_ij, res, frac = icp_align(
            clouds[i], masks[i], clouds[j], masks[j],
            yaw_pose(torch.tensor(yaw, device=device)), iters=icp_iters,
            gate=gate)
        if float(frac) < min_inlier_frac:
            continue
        # icp gives T_{i<-j} (j's points into i's frame) — exactly the
        # solver's "pose of j in i's frame" measurement for edge (i, j).
        edges.append((int(i), int(j)))
        meas.append(pose_ij.cpu().numpy().astype(np.float32))
        w = loop_info / (1.0 + float(res))
        infos.append(np.eye(6, dtype=np.float32) * w)
    odoms_t = torch.as_tensor(np.asarray(odoms), dtype=torch.float32,
                              device=device)
    if edges:
        poses0, graph = chain_graph(
            odoms_t, odom_info,
            loop_edges=torch.tensor(edges, dtype=torch.int32, device=device),
            loop_meas=torch.as_tensor(np.stack(meas), device=device),
            loop_info=torch.as_tensor(np.stack(infos), device=device))
    else:
        poses0, graph = chain_graph(odoms_t, odom_info)
    poses, _cost = optimize_pose_graph(poses0, graph, iters=gn_iters)
    return poses.cpu().numpy(), cands
