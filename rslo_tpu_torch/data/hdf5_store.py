"""The KITTI HDF5 store, ``all.h5``: its offline build from a raw KITTI
tree (``create_hdf5``) and its readers (counterpart of
``rslo_tpu/data/hdf5_store.py``).

Per sequence group ``"XX"``: vlen float32 datasets ``lidar_points``
(Nx4 flattened), ``lidar_normals`` (Nx3), optionally
``lidar_cross_normals`` (Nx3) and ``hier_lidar_points_normals_{size}``
(Nx6), plus ``poses`` (Nx12) and ``calib_Tr`` (Nx12).  Normals are
kNN-PCA normals (``data/normals.py``, the native build); hierarchical
clouds are voxel-grid means of xyz + normals.  One reader handle per
file and process (SWMR).  ``h5py`` is imported when a store is built or
opened, so the package imports without it.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

_HANDLES: dict = {}


def get_h5(path: str):
    import h5py
    key = (os.getpid(), str(path))
    if key not in _HANDLES:
        _HANDLES[key] = h5py.File(path, "r", libver="latest", swmr=True,
                                  rdcc_nbytes=1024 ** 3, rdcc_nslots=100003)
    return _HANDLES[key]


def build_frame_record(points: np.ndarray,
                       downsample_sizes: Sequence[float] = (0.1,),
                       normal_radius: float = 0.6, normal_k: int = 30,
                       cross_normal_radius: Optional[float] = None
                       ) -> Dict[str, np.ndarray]:
    """One frame's datasets of the store, keyed by dataset name, each
    shaped as ``SequenceReader.frame`` reads it back: ``lidar_points``
    (N, 4) as given, ``lidar_normals`` (N, 3) at ``normal_radius``,
    ``lidar_cross_normals`` (N, 3) at ``cross_normal_radius`` when it is
    set (the network-input normals of the cross-normal dataset, at a
    coarser spatial scale), and ``hier_lidar_points_normals_{s}``
    (M, 6), the voxel-grid means of xyz + normals at each size."""
    from .normals import estimate_normals, voxel_downsample
    normals = estimate_normals(points[:, :3], normal_radius, normal_k)
    rec = {"lidar_points": points, "lidar_normals": normals}
    if cross_normal_radius:
        rec["lidar_cross_normals"] = estimate_normals(
            points[:, :3], cross_normal_radius, normal_k)
    pn = np.concatenate([points[:, :3], normals], axis=1)
    for s in downsample_sizes:
        rec[f"hier_lidar_points_normals_{s}"] = voxel_downsample(pn, s)
    return rec


def create_hdf5(kitti_root: str, out_path: str,
                sequences: Sequence[int] = tuple(range(11)),
                downsample_sizes: Sequence[float] = (0.1,),
                normal_radius: float = 0.6, normal_k: int = 30,
                cross_normal_radius: Optional[float] = None,
                max_frames: Optional[int] = None,
                progress: bool = True) -> None:
    """Build the training store from a raw KITTI odometry tree: per
    sequence, every frame's ``build_frame_record`` (flattened), the
    camera-frame poses (identity where the tree has no pose file) and
    the calibration's ``Tr``, one row a frame."""
    import h5py
    from .kitti_io import (list_frames, read_calib, read_poses,
                           read_velodyne, sequence_paths)

    with h5py.File(out_path, "w", libver="latest") as f:
        for seq in sequences:
            velo_dir, seq_dir, pose_file = sequence_paths(kitti_root, seq)
            frames = list_frames(velo_dir)
            if max_frames:
                frames = frames[:max_frames]
            Tr = read_calib(seq_dir)["Tr"].reshape(-1)
            n = len(frames)
            poses = (read_poses(pose_file)[:n] if pose_file is not None
                     else np.tile(np.eye(3, 4).reshape(1, 3, 4), (n, 1, 1)))
            g = f.create_group(f"{seq:02d}")
            vf = h5py.vlen_dtype(np.float32)
            names = ["lidar_points", "lidar_normals"]
            if cross_normal_radius:
                names.append("lidar_cross_normals")
            names += [f"hier_lidar_points_normals_{s}"
                      for s in downsample_sizes]
            dsets = {k: g.create_dataset(k, (n,), dtype=vf) for k in names}
            g.create_dataset("poses", data=poses.reshape(n, 12))
            g.create_dataset("calib_Tr", data=np.tile(Tr, (n, 1)))
            for i, fr in enumerate(frames):
                rec = build_frame_record(
                    read_velodyne(fr), downsample_sizes, normal_radius,
                    normal_k, cross_normal_radius)
                for k, d in dsets.items():
                    d[i] = rec[k].reshape(-1)
                if progress and i % 100 == 0:
                    print(f"seq {seq:02d}: {i}/{n}", flush=True)


class SequenceReader:
    """Random access to one sequence's frames in an all.h5 store."""

    def __init__(self, h5_path: str, seq: int):
        self.path = h5_path
        self.seq = seq
        g = get_h5(h5_path)[f"{seq:02d}"]
        self.n_frames = len(g["lidar_points"])

    def frame(self, i: int, cross_normals: bool = False) -> dict:
        g = get_h5(self.path)[f"{self.seq:02d}"]
        pts = g["lidar_points"][i].reshape(-1, 4)
        nrm = g["lidar_normals"][i].reshape(-1, 3)
        if cross_normals and "lidar_cross_normals" in g:
            # network input = cross normals; the fine normals ride along
            # as supervision (10-column points)
            cross = g["lidar_cross_normals"][i].reshape(-1, 3)
            points = np.concatenate([pts, cross, nrm], axis=1)
        else:
            points = np.concatenate([pts, nrm], axis=1)  # (N, 7)
        out = {
            "points": points,
            "pose": g["poses"][i].reshape(3, 4),
            "Tr": g["calib_Tr"][i].reshape(3, 4),
        }
        for k in g:
            if k.startswith("hier_"):
                out[k] = g[k][i].reshape(-1, 6)
        return out
