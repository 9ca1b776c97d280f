"""Synthetic LiDAR scenes for benches and tests when no KITTI data is
mounted (counterpart of ``rslo_tpu/utils/synthetic.py``; numpy only):
a ground plane + random walls, with analytic normals and a rigid
ego-motion between frames."""
from __future__ import annotations

import numpy as np

from ..geometry.transforms import quat_to_matrix_np


def synth_cloud(rng: np.random.Generator, n_points: int = 100000,
                extent: float = 60.0) -> np.ndarray:
    """Returns (N, 7): x, y, z, intensity, nx, ny, nz."""
    n_ground = n_points // 2
    n_struct = n_points - n_ground
    r = np.sqrt(rng.uniform(4.0, extent ** 2, n_ground))
    th = rng.uniform(0, 2 * np.pi, n_ground)
    gx, gy = r * np.cos(th), r * np.sin(th)
    gz = -1.7 + 0.05 * np.sin(gx * 0.1) * np.sin(gy * 0.1)
    gn = np.tile(np.array([0.0, 0.0, 1.0]), (n_ground, 1))

    n_walls = 40
    per = n_struct // n_walls
    pts, nrm = [], []
    for _ in range(n_walls):
        cx, cy = rng.uniform(-extent, extent, 2)
        yaw = rng.uniform(0, np.pi)
        length = rng.uniform(2, 15)
        height = rng.uniform(1, 4)
        u = rng.uniform(-length / 2, length / 2, per)
        h = rng.uniform(-1.7, -1.7 + height, per)
        d, c = np.sin(yaw), np.cos(yaw)
        pts.append(np.stack([cx + u * c, cy + u * d, h], -1))
        n = np.array([-d, c, 0.0])
        nrm.append(np.tile(n, (per, 1)))
    sx = np.concatenate(pts)[:n_struct]
    sn = np.concatenate(nrm)[:n_struct]

    xyz = np.concatenate([np.stack([gx, gy, gz], -1), sx])
    normals = np.concatenate([gn, sn])
    inten = rng.uniform(0, 1, (len(xyz), 1))
    out = np.concatenate([xyz, inten, normals], axis=1).astype(np.float32)
    out = out[rng.permutation(len(out))]
    if len(out) < n_points:  # wall-count rounding: top up by repetition
        out = np.concatenate([out, out[: n_points - len(out)]])
    return out[:n_points]


def transform_cloud(cloud: np.ndarray, tq: np.ndarray) -> np.ndarray:
    """Apply inverse ego-motion to simulate the next frame's scan: points
    observed from a sensor that moved by pose tq."""
    R = quat_to_matrix_np(tq[3:])
    xyz = (cloud[:, :3] - tq[:3]) @ R  # R^T (x - t)
    nrm = cloud[:, 4:7] @ R
    out = cloud.copy()
    out[:, :3] = xyz
    out[:, 4:7] = nrm
    return out


def synth_sequence(seed: int = 0, n_frames: int = 3,
                   n_points: int = 100000):
    """Returns (frames list[(N,7)], gt_odometry (n_frames-1, 7))."""
    rng = np.random.default_rng(seed)
    base = synth_cloud(rng, n_points)
    step_tq = np.array([1.2, 0.03, 0.01, 0.9998, 0.0, 0.0, 0.02],
                       np.float32)
    step_tq[3:] /= np.linalg.norm(step_tq[3:])
    frames = [base]
    cur = base
    for _ in range(n_frames - 1):
        cur = transform_cloud(cur, step_tq)
        # jitter points a little so frames aren't identical samples
        cur = cur.copy()
        cur[:, :3] += rng.normal(0, 0.01, cur[:, :3].shape).astype(np.float32)
        frames.append(cur)
    gts = np.tile(step_tq, (n_frames - 1, 1))
    return frames, gts
