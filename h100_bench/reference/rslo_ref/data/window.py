"""The train cells' batches, built plainly from the raw KITTI odometry
tree that set-up writes (``sequences/XX/velodyne/*.bin``, ``calib.txt``,
``poses/XX.txt``): the reference's own read of what the program's store
build, dataset, flip and collation hand the train step.

  * a frame's points: the scan's x, y, z, reflectance, then its normals:
    the smallest principal axis of the covariance of its ``k`` nearest
    neighbours within ``radius`` (fewer than 3 give +z), turned toward
    the sensor, worked out step for step as the store's build does
    (``native/prep.cpp``: squared distances in float32, the axis by the
    trigonometric formula in float64), so that the two agree to the
    bit on all but ill-conditioned points;
  * a window: consecutive frames of one sequence, their camera-frame
    poses mapped to the LiDAR frame (``inv(Tr) @ T_cam @ Tr``), and the
    relative motion of every frame pair (i < j), each quaternion with a
    non-negative w;
  * the y-flip: y and the normals' y negated in every frame, each pair's
    motion mirrored across the xz-plane (R' = F R F, t' = F t);
  * the batch: each frame's rows first, padded with zeros to
    ``max_points`` under a mask.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..geometry.transforms import (matrix_to_quat_np, np_calc_vo,
                                   quat_to_matrix_np)

FLIP = np.diag([1.0, -1.0, 1.0])


def read_scan(tree, seq: int, frame: int) -> np.ndarray:
    path = Path(tree) / "sequences" / f"{seq:02d}" / "velodyne" / \
        f"{frame:06d}.bin"
    return np.fromfile(path, np.float32).reshape(-1, 4)


def read_tr(tree, seq: int) -> np.ndarray:
    """The calibration's velo -> cam transform, 4 x 4."""
    for line in (Path(tree) / "sequences" / f"{seq:02d}" /
                 "calib.txt").read_text().splitlines():
        if line.startswith("Tr:"):
            T = np.eye(4)
            T[:3] = np.array(line[3:].split(), float).reshape(3, 4)
            return T
    raise ValueError(f"no Tr in sequence {seq:02d}'s calib.txt")


def read_cam_poses(tree, seq: int) -> np.ndarray:
    """(n, 4, 4) camera-frame poses."""
    rows = np.loadtxt(Path(tree) / "poses" / f"{seq:02d}.txt", ndmin=2)
    T = np.tile(np.eye(4), (len(rows), 1, 1))
    T[:, :3] = rows.reshape(-1, 3, 4)
    return T


def hemisphere(q: np.ndarray) -> np.ndarray:
    return q * np.sign(q[0]) if q[0] != 0 else q


def lidar_pose(cam_pose: np.ndarray, tr: np.ndarray) -> np.ndarray:
    """(7,) [t, q] of the LiDAR-frame pose of a camera-frame pose."""
    T = np.linalg.inv(tr) @ cam_pose @ tr
    return np.concatenate([T[:3, 3], hemisphere(matrix_to_quat_np(T[:3, :3]))])


def pair_motions(poses: np.ndarray) -> np.ndarray:
    """(L, 7) absolute poses -> (C(L, 2), 7) motions of the pairs i < j."""
    out = []
    for i in range(len(poses)):
        for j in range(i + 1, len(poses)):
            vo = np_calc_vo(poses[i:i + 1], poses[j:j + 1])[0]
            out.append(np.concatenate([vo[:3], hemisphere(vo[3:])]))
    return np.stack(out).astype(np.float32)


def mirror_motion(tq: np.ndarray) -> np.ndarray:
    R = FLIP @ quat_to_matrix_np(tq[3:]) @ FLIP
    return np.concatenate([FLIP @ tq[:3],
                           hemisphere(matrix_to_quat_np(R))]).astype(
                               np.float32)


def smallest_axis(C: np.ndarray) -> np.ndarray:
    """(n, 3) float32 unit eigenvectors of the smallest eigenvalue of
    symmetric 3 x 3 matrices packed as (n, 6) [xx, xy, xz, yy, yz, zz]
    float64: the eigenvalue by the trigonometric formula, the vector as
    the longest cross product of two rows of (C - eig I); +z where that
    is shorter than 1e-12; a diagonal matrix gives the axis of its
    smallest entry."""
    a, d, f, b, e, c = (C[:, i] for i in range(6))
    p1 = d * d + f * f + e * e
    with np.errstate(divide="ignore", invalid="ignore"):
        q = (a + b + c) / 3.0
        p2 = (a - q) * (a - q) + (b - q) * (b - q) + \
            (c - q) * (c - q) + 2.0 * p1
        p = np.sqrt(p2 / 6.0)
        b00, b11, b22 = (a - q) / p, (b - q) / p, (c - q) / p
        b01, b02, b12 = d / p, f / p, e / p
        r = b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02) + \
            b02 * (b01 * b12 - b11 * b02)
        r = np.clip(r * 0.5, -1.0, 1.0)
        eig = q + 2.0 * p * np.cos(np.arccos(r) / 3.0 + 2.0 * np.pi / 3.0)
    r0 = np.stack([a - eig, d, f], -1)
    r1 = np.stack([d, b - eig, e], -1)
    r2 = np.stack([f, e, c - eig], -1)
    vs = [np.cross(r0, r1), np.cross(r0, r2), np.cross(r1, r2)]
    ns = [v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2]
          for v in vs]
    best, bn = vs[0].copy(), ns[0].copy()
    for v, n in zip(vs[1:], ns[1:]):
        take = n > bn
        best[take], bn[take] = v[take], n[take]
    diag = p1 < 1e-18
    ax = np.stack([(a <= b) & (a <= c), (b < a) & (b <= c)], -1)
    best[diag] = np.concatenate(
        [ax[diag], ~(ax[diag, :1] | ax[diag, 1:])], -1).astype(np.float64)
    norm = np.sqrt(best[:, 0] * best[:, 0] + best[:, 1] * best[:, 1] +
                   best[:, 2] * best[:, 2])
    out = np.zeros((len(C), 3), np.float32)
    out[:, 2] = 1.0
    ok = norm > 1e-12
    out[ok] = (best[ok] / norm[ok, None]).astype(np.float32)
    return out


def normals(xyz: np.ndarray, radius: float = 0.6, k: int = 30,
            spare: int = 18, chunk: int = 16384) -> np.ndarray:
    """(N, 3) float32 unit normals of (N, 3+) points, as the module
    docstring says: the ``k`` nearest within ``radius`` by the squared
    distance in float32 (ties to the lower index), their mean and
    covariance in float64, ``smallest_axis``.  The candidates are the
    ``k + spare`` nearest by a k-d tree."""
    from scipy.spatial import cKDTree
    xyz = np.ascontiguousarray(xyz[:, :3], np.float32)
    n = len(xyz)
    r2 = np.float32(radius) * np.float32(radius)
    tree = cKDTree(xyz)
    out = np.empty((n, 3), np.float32)
    kq = min(k + spare, n)
    for lo in range(0, n, chunk):
        p = xyz[lo:lo + chunk]
        _, idx = tree.query(p, k=kq, distance_upper_bound=radius * 1.001,
                            workers=-1)
        idx = idx.reshape(len(p), kq)
        found = idx < n
        nb = xyz[np.where(found, idx, 0)]                  # (c, kq, 3)
        d = nb - p[:, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + \
            d[..., 2] * d[..., 2]
        d2 = np.where(found & (d2 <= r2), d2, np.float32(np.inf))
        order = np.lexsort((np.where(found, idx, n), d2), axis=-1)[:, :k]
        keep = np.take_along_axis(d2, order, 1) < np.inf   # (c, k)
        sel = np.take_along_axis(nb, order[..., None], 1).astype(np.float64)
        cnt = keep.sum(1)
        w = keep[..., None].astype(np.float64)
        mean = (sel * w).sum(1) / np.maximum(cnt, 1)[:, None]
        e = (sel - mean[:, None]) * w
        cov = np.stack([np.einsum("nk,nk->n", e[..., i], e[..., j])
                        for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                     (2, 2))], -1)
        nrm = smallest_axis(cov)
        nrm[cnt < 3] = (0.0, 0.0, 1.0)
        toward = (nrm[:, 0] * p[:, 0] + nrm[:, 1] * p[:, 1] +
                  nrm[:, 2] * p[:, 2]) > 0
        nrm[toward] *= -1
        out[lo:lo + len(p)] = nrm
    return out


def window(tree, seq: int, frames, max_points: int, radius: float = 0.6,
           k: int = 30) -> dict:
    """One sample's batch, unflipped: ``points`` (L, max_points, 7)
    float32, ``point_mask`` (L, max_points), ``odometry`` (C(L, 2), 7)."""
    tr = read_tr(tree, seq)
    cam = read_cam_poses(tree, seq)
    L = len(frames)
    pts = np.zeros((L, max_points, 7), np.float32)
    mask = np.zeros((L, max_points), bool)
    for t, fr in enumerate(frames):
        scan = read_scan(tree, seq, fr)
        if len(scan) > max_points:
            raise ValueError(f"a scan of {len(scan)} points over the "
                             f"batch's {max_points}")
        pts[t, :len(scan)] = np.concatenate([scan, normals(scan, radius, k)],
                                            axis=1)
        mask[t, :len(scan)] = True
    odom = pair_motions(np.stack([lidar_pose(cam[fr], tr) for fr in frames]))
    return {"points": pts, "point_mask": mask, "odometry": odom}


def flipped(sample: dict) -> dict:
    """``sample`` mirrored across the xz-plane (a new dict)."""
    pts = sample["points"].copy()
    pts[..., 1] = -pts[..., 1]
    pts[..., 5] = -pts[..., 5]
    return {"points": pts, "point_mask": sample["point_mask"],
            "odometry": np.stack([mirror_motion(o)
                                  for o in sample["odometry"]])}
