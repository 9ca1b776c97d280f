"""Host-side numpy pose helpers (counterpart of
``rslo_tpu/geometry/transforms.py``, which is reachable only through a
package that imports JAX), used by the data and eval layers.  Poses are
``[t(3), q(4 wxyz)]``; KITTI ground-truth poses live in the left camera
frame and are mapped into the LiDAR frame via ``Tr_velo_to_cam``."""
from __future__ import annotations

import numpy as np


def _np_qmult(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - np.sum(v1 * v2, axis=-1, keepdims=True)
    v = w2 * v1 + w1 * v2 + np.cross(v1, v2)
    q = np.concatenate([w, v], axis=-1)
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def _np_qinv(q: np.ndarray) -> np.ndarray:
    return np.concatenate([q[..., :1], -q[..., 1:]], axis=-1)


def _np_rotate(t: np.ndarray, q: np.ndarray) -> np.ndarray:
    qw, qv = q[..., :1], q[..., 1:]
    b = np.cross(qv, t)
    return t + 2.0 * qw * b + 2.0 * np.cross(qv, b)


def np_compose_pose(p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Compose 7-dim poses: apply ``p2`` first, then ``p1``."""
    t = p1[..., :3] + _np_rotate(p2[..., :3], p1[..., 3:])
    q = _np_qmult(p1[..., 3:], p2[..., 3:])
    return np.concatenate([t, q], axis=-1)


def np_invert_pose(p: np.ndarray) -> np.ndarray:
    qi = _np_qinv(p[..., 3:])
    ti = -_np_rotate(p[..., :3], qi)
    return np.concatenate([ti, qi], axis=-1)


def np_calc_vo(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    return np_compose_pose(np_invert_pose(p0), p1)


def matrix_to_quat_np(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> wxyz quaternion (single, numpy)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                      (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                      0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                      (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    return q / np.linalg.norm(q)


def quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def expand_rigid(T: np.ndarray) -> np.ndarray:
    if T.shape == (4, 4):
        return T
    out = np.eye(4)
    out[:3, :4] = T
    return out


def RT_to_tq(RT: np.ndarray) -> np.ndarray:
    """3x4 / 4x4 rigid transform -> (1, 7) pose with hemisphere-normalized q."""
    q = matrix_to_quat_np(RT[:3, :3])
    q = q * np.sign(q[0]) if q[0] != 0 else q
    return np.concatenate([RT[:3, 3], q]).reshape(1, 7)


def tq_to_RT(tq: np.ndarray, expand: bool = False) -> np.ndarray:
    tq = np.asarray(tq).reshape(7)
    RT = np.zeros((3, 4))
    RT[:3, :3] = quat_to_matrix_np(tq[3:])
    RT[:3, 3] = tq[:3]
    return expand_rigid(RT) if expand else RT


def cam_pose_to_lidar(cam_pose: np.ndarray, velo_to_cam: np.ndarray) -> np.ndarray:
    """KITTI camera-frame pose -> LiDAR-frame pose: inv(Tr) @ T_cam @ Tr."""
    cam_pose = expand_rigid(cam_pose)
    velo_to_cam = expand_rigid(velo_to_cam)
    return np.linalg.inv(velo_to_cam) @ cam_pose @ velo_to_cam


def odom_to_abs_pose(odoms: np.ndarray) -> np.ndarray:
    """Chain relative odometries (N, 7) into absolute poses (N, 7).

    Pose 0 is the identity; each subsequent absolute pose composes the
    previous absolute pose with the step's relative motion.
    """
    odoms = np.asarray(odoms).reshape(-1, 7)
    abs_poses = np.empty_like(odoms)
    abs_poses[0] = np.array([0, 0, 0, 1, 0, 0, 0], dtype=odoms.dtype)
    cur = abs_poses[0:1]
    for i in range(1, len(odoms)):
        cur = np_compose_pose(cur, odoms[i:i + 1])
        abs_poses[i] = cur[0]
    return abs_poses


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares similarity/rigid alignment dst ~ c R src + t
    (Umeyama).

    src, dst: (N, 3).  Returns (c, R, t)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        c = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        c = 1.0
    t = mu_d - c * R @ mu_s
    return c, R, t


def ate_rmse(pred_abs: np.ndarray, gt_abs: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error (RMSE of positions) after optional
    rigid/similarity alignment."""
    p = np.asarray(pred_abs)[:, :3]
    g = np.asarray(gt_abs)[:, :3]
    n = min(len(p), len(g))
    p, g = p[:n], g[:n]
    if align and n >= 3:
        c, R, t = umeyama_alignment(p, g, with_scale)
        p = (c * (R @ p.T)).T + t
    return float(np.sqrt(np.mean(np.sum((p - g) ** 2, axis=1))))
