"""The host batch: fixed-shape padded numpy arrays from dataset samples
(counterpart of the collation half of ``rslo_tpu/data/loader.py``; the
train sampler and the prefetching loader are not ported yet).

points (D, L, N, F) + masks and odometry targets (D, P, 7), D samples;
voxelization happens on the device (``data/prepare.py``), the host only
pads.
"""
from __future__ import annotations

import numpy as np

from ..config.schema import DataCfg

# int16 transfer-quantization scales: channels 0-2 are metric positions
# (+-128 m at ~3.9 mm resolution), all remaining channels are unit-range
# (intensity, normals)
QUANT_POS_SCALE = 128.0 / 32767.0
QUANT_UNIT_SCALE = 1.0 / 32767.0


def quant_scale(n_features: int) -> np.ndarray:
    s = np.full((n_features,), QUANT_UNIT_SCALE, np.float32)
    s[:3] = QUANT_POS_SCALE
    return s


def quantize_points(pts: np.ndarray) -> np.ndarray:
    """(..., F) f32 -> int16 with the shared per-channel scales."""
    s = quant_scale(pts.shape[-1])
    return np.clip(np.rint(pts / s), -32767, 32767).astype(np.int16)


def pad_points(pts: np.ndarray, n_max: int,
               rng: np.random.Generator | None = None):
    """(N, F) -> ((n_max, F), (n_max,) mask).  Over-capacity clouds are
    subsampled: seeded ``rng`` when given (reproducible train batches),
    fixed-stride otherwise (deterministic eval)."""
    n = len(pts)
    out = np.zeros((n_max, pts.shape[1]), np.float32)
    mask = np.zeros((n_max,), bool)
    if n > n_max:
        if rng is not None:
            sel = rng.choice(n, n_max, replace=False)
        else:
            sel = (np.arange(n_max) * n) // n_max
        out[:] = pts[sel]
        mask[:] = True
    else:
        out[:n] = pts
        mask[:n] = True
    return out, mask


def collate(samples: list, cfg: DataCfg,
            rng: np.random.Generator | None = None) -> dict:
    """list[D] of dataset samples -> fixed-shape batch.  With
    ``cfg.quantize_transfer`` the points are int16, which the port's
    ``prepare_example`` does not take yet."""
    D = len(samples)
    L = len(samples[0]["points"])
    N = cfg.max_points
    pts = np.zeros((D, L, N, samples[0]["points"][0].shape[1]), np.float32)
    msk = np.zeros((D, L, N), bool)
    P = len(samples[0]["odometry"])
    odom = np.zeros((D, P, 7), np.float32)
    meta = []
    want_hier = "hier_points" in samples[0]
    if want_hier:
        Nh = cfg.max_hier_points
        hier = np.zeros((D, L, Nh, samples[0]["hier_points"][0].shape[1]),
                        np.float32)
        hmask = np.zeros((D, L, Nh), bool)
    for d, s in enumerate(samples):
        for t in range(L):
            pts[d, t], msk[d, t] = pad_points(s["points"][t], N, rng)
            if want_hier:
                hier[d, t], hmask[d, t] = pad_points(
                    s["hier_points"][t], Nh, rng)
        odom[d] = s["odometry"]
        meta.append((s.get("seq", -1), tuple(s.get("frames", ()))))
    if cfg.quantize_transfer:
        pts = quantize_points(pts)
    out = {"points": pts, "point_mask": msk, "odometry": odom,
           "meta": meta}
    if want_hier:
        if cfg.quantize_transfer:
            hier = quantize_points(hier)
        out["hier_points"] = hier
        out["hier_mask"] = hmask
    return out
