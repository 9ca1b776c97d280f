"""Synthetic LiDAR scenes made from the seed (a copy of the program's
``utils/synthetic.py``: a ground plane and random walls with analytic
normals, moved by a fixed ego step a frame), and the raw KITTI odometry
tree that the train cells' store is built from."""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .refpath import ref

# the ego step of a frame: ~1.2 m and ~2.3 deg of yaw
STEP_TQ = (1.2, 0.03, 0.01, 0.9998, 0.0, 0.0, 0.02)
# KITTI's calibration as the program's KITTI twin writes it: every
# camera's P, and Tr (velo -> cam)
CALIB_P = "7.1e+02 0 6.0e+02 0 0 7.1e+02 1.8e+02 0 0 0 1 0"
CALIB_TR = "0 -1 0 0 0 0 -1 0 1 0 0 0"
TR = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]],
              float)


def synth_cloud(rng: np.random.Generator, n_points: int = 100000,
                extent: float = 60.0) -> np.ndarray:
    """(N, 7): x, y, z, intensity, nx, ny, nz."""
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
    """The scan seen from a sensor that moved by pose ``tq``."""
    R = ref().geometry.transforms.quat_to_matrix_np(tq[3:])
    out = cloud.copy()
    out[:, :3] = (cloud[:, :3] - tq[:3]) @ R  # R^T (x - t)
    out[:, 4:7] = cloud[:, 4:7] @ R
    return out


def step_tq() -> np.ndarray:
    s = np.array(STEP_TQ, np.float32)
    s[3:] /= np.linalg.norm(s[3:])
    return s


def drive(seed: int, n_frames: int, n_points: int,
          extent: float = 60.0) -> list:
    """``n_frames`` scans (N, 7) of one drive through a scene of
    ``extent`` metres made from ``seed``: each the last one moved by
    ``step_tq`` and jittered by 1 cm, so no two frames are the same
    sample."""
    rng = np.random.default_rng(seed)
    cur = synth_cloud(rng, n_points, extent)
    frames = [cur]
    step = step_tq()
    for _ in range(n_frames - 1):
        cur = transform_cloud(cur, step)
        cur[:, :3] += rng.normal(0, 0.01, cur[:, :3].shape).astype(np.float32)
        frames.append(cur)
    return frames


def write_kitti_tree(root, seed: int, seqs, frames_per_seq: int,
                     n_points: int, extent: float = 60.0) -> Path:
    """A raw KITTI odometry tree under ``root``: for each of ``seqs`` one
    drive (``drive(seed + seq)``) as ``sequences/XX/velodyne/*.bin`` (x y
    z reflectance), ``calib.txt`` and ``poses/XX.txt``, the chained lidar
    poses in the camera frame (``Tr @ T_lidar @ Tr^-1``)."""
    tr = ref().geometry.transforms
    root = Path(root)
    (root / "poses").mkdir(parents=True, exist_ok=True)
    step = step_tq()
    for seq in seqs:
        seq_dir = root / "sequences" / f"{seq:02d}"
        (seq_dir / "velodyne").mkdir(parents=True, exist_ok=True)
        with open(seq_dir / "calib.txt", "w") as f:
            for k in ("P0", "P1", "P2", "P3"):
                f.write(f"{k}: {CALIB_P}\n")
            f.write(f"Tr: {CALIB_TR}\n")
        pose = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
        rows = []
        for i, cloud in enumerate(drive(seed + seq, frames_per_seq,
                                        n_points, extent)):
            cloud[:, :4].astype(np.float32).tofile(
                seq_dir / "velodyne" / f"{i:06d}.bin")
            T_l = np.eye(4)
            T_l[:3] = tr.tq_to_RT(pose)
            rows.append((TR @ T_l @ np.linalg.inv(TR))[:3].reshape(-1))
            pose = tr.np_compose_pose(pose[None], step[None])[0]
        np.savetxt(root / "poses" / f"{seq:02d}.txt", np.stack(rows))
    return root
