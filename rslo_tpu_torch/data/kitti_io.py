"""Raw KITTI odometry dataset parsing (host side, numpy; counterpart of
``rslo_tpu/data/kitti_io.py``): sequences 00-21, poses in the left-camera
frame, ``Tr`` (velo->cam) from calib.txt, velodyne scans as float32
(N, 4) .bin files.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def read_calib(seq_dir: str | Path) -> dict:
    """Parse calib.txt -> dict of 3x4 matrices (P0..P3, Tr)."""
    out = {}
    with open(Path(seq_dir) / "calib.txt") as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            vals = np.fromstring(v, sep=" ")
            if vals.size == 12:
                out[k.strip()] = vals.reshape(3, 4)
    return out


def read_poses(pose_file: str | Path) -> np.ndarray:
    """(N, 3, 4) camera-frame poses from a KITTI poses/XX.txt file."""
    data = np.loadtxt(pose_file)
    return data.reshape(-1, 3, 4)


def read_velodyne(bin_file: str | Path) -> np.ndarray:
    """(N, 4) x, y, z, reflectance; rows with a non-finite value are
    dropped."""
    pts = np.fromfile(str(bin_file), dtype=np.float32).reshape(-1, 4)
    return pts[np.all(np.isfinite(pts), axis=1)]


def sequence_paths(root: str | Path, seq: int):
    """Returns (velodyne_dir, calib_file_dir, poses_file | None)."""
    root = Path(root)
    seq_dir = root / "sequences" / f"{seq:02d}"
    poses = root / "poses" / f"{seq:02d}.txt"
    return seq_dir / "velodyne", seq_dir, poses if poses.exists() else None


def list_frames(velodyne_dir: str | Path) -> list:
    d = Path(velodyne_dir)
    return sorted(p for p in d.glob("*.bin"))
