"""Host-side point-cloud normal estimation and voxel downsampling
(counterpart of ``rslo_tpu/data/normals.py``): kNN-PCA normals (radius
capped, k = 30) oriented toward the sensor, and voxel-grid means for
the hierarchical clouds.

``estimate_normals`` runs ``native/prep.cpp`` (grid-hash neighbour
search, one thread per core).  At first use the source is compiled with
``g++`` into ``build/rslo_tpu_torch/libprep-<hash>.so`` at the
repository root (listed in ``.gitignore``); the hash covers the source
and the flags, so an edited source is never served from a stale build.
A failed build or load raises: the scipy version agrees with the native
one on only ~90% of rows, so it is never a silent substitute.
``estimate_normals_plain`` is that scipy (cKDTree) version, for callers
that ask for it by name.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR

_SRC = Path(__file__).resolve().parents[2] / "native" / "prep.cpp"
GXX_FLAGS = ("-O3", "-march=x86-64-v2", "-fPIC", "-std=c++17", "-pthread",
             "-shared")


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libprep-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/prep.cpp`` unless its library exists; returns the
    library's path.  Raises RuntimeError when ``g++`` fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {_SRC}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{_SRC}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.estimate_normals.restype = None
    lib.estimate_normals.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
    return lib


def estimate_normals(xyz: np.ndarray, radius: float = 0.6,
                     k: int = 30) -> np.ndarray:
    """(N, 3+) -> (N, 3) float32 unit normals oriented toward the origin
    (the sensor), by the native library."""
    xyz = np.ascontiguousarray(xyz[:, :3], np.float32)
    n = len(xyz)
    lib = _load(str(build()))
    out = np.empty((n, 3), np.float32)
    lib.estimate_normals(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        ctypes.c_float(radius), k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def estimate_normals_plain(xyz: np.ndarray, radius: float = 0.6,
                           k: int = 30) -> np.ndarray:
    """``estimate_normals`` by scipy's cKDTree: the k nearest within
    ``radius`` (the point itself always), the smallest eigenvector of
    their covariance, flipped toward the origin."""
    from scipy.spatial import cKDTree
    xyz = np.ascontiguousarray(xyz[:, :3], np.float32)
    n = len(xyz)
    tree = cKDTree(xyz)
    dist, idx = tree.query(xyz, k=min(k, n), workers=-1)
    nb = xyz[idx]                                   # (N, k, 3)
    valid = dist <= radius
    valid[:, 0] = True
    w = valid[..., None].astype(np.float32)
    cnt = np.maximum(w.sum(1), 1.0)
    mean = (nb * w).sum(1) / cnt
    d = (nb - mean[:, None]) * w
    cov = np.einsum('nki,nkj->nij', d, d) / cnt[..., :1, None]
    _, eigvec = np.linalg.eigh(cov)
    normals = eigvec[:, :, 0]
    flip = np.sum(normals * xyz, axis=1) > 0
    normals[flip] *= -1
    nrm = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(nrm, 1e-12)).astype(np.float32)


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Voxel-grid mean of (N, F) points (xyz in columns 0:3): one row
    per occupied cell, in lexicographic (x, y, z) cell order, every
    column averaged in float64 and returned as float32.  Each cell's
    rows are summed in their input order (the stable sort keeps it), one
    column at a time, so the sums equal a sum over the sorted points;
    the temporaries stay at a few times the input's size."""
    keys = points[:, :3] / voxel
    np.floor(keys, out=keys)
    keys = keys.astype(np.int64)
    order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
    head = np.zeros(len(order), bool)
    head[:1] = True
    for c in range(3):
        kc = keys[order, c]
        head[1:] |= kc[1:] != kc[:-1]
    del keys, kc
    group = np.cumsum(head)
    group -= 1
    del head
    n_groups = int(group[-1]) + 1 if len(group) else 0
    cell = np.empty_like(group)
    cell[order] = group                  # each input row's cell
    del order, group
    sums = np.zeros((n_groups, points.shape[1]), np.float64)
    for c in range(points.shape[1]):
        np.add.at(sums[:, c], cell, points[:, c])
    counts = np.bincount(cell, minlength=n_groups)[:, None]
    del cell
    sums /= np.maximum(counts, 1)
    return sums.astype(np.float32)
