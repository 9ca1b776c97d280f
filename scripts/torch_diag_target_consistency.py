"""Target-consistency audit of the full train-time sample path on the
PyTorch port (the twin of ``scripts/diag_target_consistency.py``, which
drives the JAX package).

For each emitted sample (dataset.sample -> random_flip_y ->
pose_interp_aug, the loader's chain), warp each pair's target frame by
the emitted odometry target and measure the NN alignment residual of
the emitted point clouds, then compare against small yaw perturbations
of the target.  If the emitted target is the alignment optimum
(consistent), the residual curve bottoms at 0 perturbation; a bottom
offset means the targets the supervised control trains on are
rotationally wrong for the emitted clouds.

    python scripts/torch_diag_target_consistency.py [n_samples]

Host work only (numpy and scipy), no checkpoint, so no ``--device``: it
reads the train sequences of the proxy's directory store
(``scripts/torch_accuracy_proxy.py``'s ``STORE`` under
``RSLO_PROXY_ROOT``).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import numpy as np
from scipy.spatial import cKDTree

from torch_accuracy_proxy import base_cfg
from rslo_tpu_torch.data.dataset import KittiWindowDataset
from rslo_tpu_torch.data.augment import pose_interp_aug, random_flip_y
from rslo_tpu_torch.geometry.transforms import tq_to_RT


def pair_residual(src, tgt, vo_tq, yaw_pert_deg=0.0):
    RT = tq_to_RT(vo_tq)
    R, t = RT[:, :3], RT[:, 3]
    if yaw_pert_deg:
        a = np.deg2rad(yaw_pert_deg)
        P = np.array([[np.cos(a), -np.sin(a), 0],
                      [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        R = P @ R
    w = tgt[:, :3] @ R.T + t
    # subsample for speed
    s = src[::7, :3][:6000]
    d, _ = cKDTree(w[::3]).query(s, workers=2)
    # trimmed mean (ignore non-overlap tails)
    d = np.sort(d)[: int(0.9 * len(d))]
    return float(np.mean(d))


def main(n_samples=16):
    cfg = base_cfg("PillarMiddleCov", 3000)
    ds = KittiWindowDataset(cfg.data, "train")
    pairs = [(i, j) for i in range(cfg.data.seq_length)
             for j in range(i + 1, cfg.data.seq_length)]
    perts = (-1.0, -0.5, 0.0, 0.5, 1.0)
    print(f"{'sample':18s} pair  " +
          "  ".join(f"{p:+.1f}d" for p in perts) + "   verdict")
    bad = 0
    rng_master = np.random.default_rng(123)
    for k in range(n_samples):
        idx = int(rng_master.integers(0, len(ds)))
        rng = np.random.default_rng(k)
        s = ds.sample(idx, rng)
        s = random_flip_y(s, rng)
        s = pose_interp_aug(s, rng, cfg.data.pose_interp_ratio)
        for pi, (i, j) in enumerate(pairs):
            vo = s["odometry"][pi]
            res = [pair_residual(s["points"][i], s["points"][j], vo, p)
                   for p in perts]
            best = perts[int(np.argmin(res))]
            ok = best == 0.0
            bad += int(not ok)
            print(f"idx{idx:5d} k{k:3d}    ({i},{j})  " +
                  "  ".join(f"{r:.3f}" for r in res) +
                  f"   {'OK' if ok else f'OFF by {best:+.1f}d'}",
                  flush=True)
    print(f"\n{bad} inconsistent pair targets "
          f"/ {n_samples * len(pairs)}", flush=True)
    return bad


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
