"""Readers of the KITTI HDF5 store, ``all.h5`` (counterpart of
``rslo_tpu/data/hdf5_store.py``; the store's writer, ``create_hdf5``,
is not ported yet).

Per sequence group ``"XX"``: vlen datasets ``lidar_points`` (Nx4
flattened), ``lidar_normals`` (Nx3), optionally ``lidar_cross_normals``
(Nx3) and ``hier_lidar_points_normals_{size}`` (Nx6), plus ``poses``
(Nx12) and ``calib_Tr`` (Nx12).  One reader handle per file and
process (SWMR).  ``h5py`` is imported when a store is opened, so the
package imports without it.
"""
from __future__ import annotations

import os

import numpy as np

_HANDLES: dict = {}


def get_h5(path: str):
    import h5py
    key = (os.getpid(), str(path))
    if key not in _HANDLES:
        _HANDLES[key] = h5py.File(path, "r", libver="latest", swmr=True,
                                  rdcc_nbytes=1024 ** 3, rdcc_nslots=100003)
    return _HANDLES[key]


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
