"""Host-side numpy pose helpers (counterpart of
``rslo_tpu/geometry/transforms.py``, which is reachable only through a
package that imports JAX).  Poses are ``[t(3), q(4 wxyz)]``."""
from __future__ import annotations

import numpy as np


def _np_qmult(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - np.sum(v1 * v2, axis=-1, keepdims=True)
    v = w2 * v1 + w1 * v2 + np.cross(v1, v2)
    q = np.concatenate([w, v], axis=-1)
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def _np_rotate(t: np.ndarray, q: np.ndarray) -> np.ndarray:
    qw, qv = q[..., :1], q[..., 1:]
    b = np.cross(qv, t)
    return t + 2.0 * qw * b + 2.0 * np.cross(qv, b)


def np_compose_pose(p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Compose 7-dim poses: apply ``p2`` first, then ``p1``."""
    t = p1[..., :3] + _np_rotate(p2[..., :3], p1[..., 3:])
    q = _np_qmult(p1[..., 3:], p2[..., 3:])
    return np.concatenate([t, q], axis=-1)
