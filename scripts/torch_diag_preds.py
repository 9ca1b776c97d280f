"""Diagnose odometry predictions vs GT on the accuracy proxy, on the
PyTorch port (the twin of ``scripts/diag_preds.py``, which drives the
JAX package).

Loads the latest checkpoint of a proxy model dir, runs N two-frame
windows from the val sequence, and prints per-window predicted vs GT
odometry plus aggregate direction/scale statistics: the fastest way to
tell "untrained noise" from "sign-inverted" from "scale collapse".

    python scripts/torch_diag_preds.py [middle] [n_windows]
        [--supervised] [--tag=T] [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from torch_accuracy_proxy import base_cfg, _model_dir  # noqa: E402
from torch_diag_net import add_device, forward, restore_net  # noqa: E402


def main(middle: str, n: int, supervised: bool = False, tag: str = "",
         device="cuda"):
    from rslo_tpu_torch.data.dataset import KittiWindowDataset
    from rslo_tpu_torch.data.loader import collate
    from rslo_tpu_torch.data.prepare import mean_vfe_ok

    cfg = base_cfg(middle, 100)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, seq_length=2))
    ds = KittiWindowDataset(cfg.data, "val", seq_length=2)
    mean_mode = mean_vfe_ok(cfg)
    net, step = restore_net(cfg, _model_dir(middle, supervised, tag),
                            device)
    print("restored step:", step)

    preds, gts = [], []
    step = max(1, len(ds) // n)
    for i in range(0, step * n, step):
        s = ds[i]
        b = collate([s], cfg.data)
        (o,) = forward(net, cfg, b["points"][0], b["point_mask"][0],
                       device, mean_mode=mean_mode)
        preds.append(o[0])            # first pair = frame0 -> frame1
        gts.append(np.asarray(b["odometry"][0][0]))
    P, G = np.stack(preds), np.stack(gts)
    print("pred t (first 6):\n", np.round(P[:6, :3], 3))
    print("gt   t (first 6):\n", np.round(G[:6, :3], 3))
    print("pred q (first 3):\n", np.round(P[:3, 3:], 4))
    print("gt   q (first 3):\n", np.round(G[:3, 3:], 4))
    tp, tg = P[:, :3], G[:, :3]
    dots = np.sum(tp * tg, 1) / (np.linalg.norm(tp, axis=1) *
                                 np.linalg.norm(tg, axis=1) + 1e-9)
    print(f"|t_pred| mean {np.linalg.norm(tp, axis=1).mean():.3f} "
          f"|t_gt| mean {np.linalg.norm(tg, axis=1).mean():.3f}")
    print(f"direction cos(t_pred, t_gt): mean {dots.mean():.3f} "
          f"min {dots.min():.3f}")
    err = np.linalg.norm(tp - tg, axis=1)
    err_neg = np.linalg.norm(-tp - tg, axis=1)
    print(f"mean |t_pred - t_gt| {err.mean():.3f}  "
          f"inverted {err_neg.mean():.3f}")

    # rotation: signed yaw per frame (the val loop turns at a constant
    # rate, so a yaw ratio << 1 means "predicts straight", the
    # rotation-collapse signature)
    def yaw(q):
        w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        return np.degrees(np.arctan2(2 * (w * z + x * y),
                                     1 - 2 * (y * y + z * z)))
    yp, yg = yaw(P[:, 3:] * np.sign(P[:, 3:4])), yaw(G[:, 3:])
    print(f"yaw/frame deg: pred mean {yp.mean():+.3f} std {yp.std():.3f}"
          f" | gt mean {yg.mean():+.3f} std {yg.std():.3f}"
          f" | corr {np.corrcoef(yp, yg)[0, 1]:.3f}"
          f" | ratio {yp.mean() / (yg.mean() + 1e-9):+.3f}")
    return P, G


def cli(argv=None):
    p = add_device(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    p.add_argument("middle", nargs="?", default="PillarMiddleCov")
    p.add_argument("n", nargs="?", type=int, default=24)
    p.add_argument("--supervised", action="store_true")
    p.add_argument("--tag", default="")
    a = p.parse_args(argv)
    return main(a.middle, a.n, a.supervised, a.tag, a.device)


if __name__ == "__main__":
    cli()
