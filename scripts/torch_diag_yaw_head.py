"""Localize the rotation failure inside the head, on the PyTorch port
(the twin of ``scripts/diag_yaw_head.py``, which drives the JAX
package): does the dense tq map encode yaw at all, or does the
confidence vote cancel it?

Runs the trained pillar model on TRAIN windows (varied yaw, unlike the
constant-yaw val loop; ``--val`` takes the val sequence), and reports
per window:
  * gt yaw,
  * the aggregated vote's yaw (the odometry output),
  * the CELL-LEVEL yaw field statistics (conf-weighted mean, spatial
    std) from the raw tq map, over the same (H, W) cells as JAX's
    (the port's BEV net returns its maps in JAX's NHWC layout).

If map-level yaw correlates with gt but the vote does not, the voting /
confidence stage is the bug; if the map itself is yaw-dead (spatially
uniform near zero, uncorrelated), the failure is upstream.

    python scripts/torch_diag_yaw_head.py [tag] [n] [--supervised]
        [--val] [--device cpu]

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


def yaw_of(q):
    q = q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.degrees(np.arctan2(2 * (w * z + x * y),
                                 1 - 2 * (y * y + z * z)))


def main(tag: str, n: int, supervised: bool, val: bool = False,
         device="cuda"):
    from rslo_tpu_torch.data.dataset import KittiWindowDataset
    from rslo_tpu_torch.data.loader import collate
    from rslo_tpu_torch.data.prepare import mean_vfe_ok

    cfg = base_cfg("PillarMiddleCov", 100)
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, seq_length=2, skip=1, random_skip=False,
        pose_interp_ratio=0.0, random_flip_y=False))
    split = "val" if val else "train"
    ds = KittiWindowDataset(cfg.data, split, seq_length=2)
    mean_mode = mean_vfe_ok(cfg)
    mdir = _model_dir("PillarMiddleCov", supervised, tag)
    net, step = restore_net(cfg, mdir, device)
    print("restored step:", step, "from", mdir, flush=True)

    print(f"{'gt yaw':>8s} {'vote yaw':>9s} {'map yaw(cw)':>11s} "
          f"{'map yaw std':>11s} {'conf cv':>8s}")
    rows = []
    step = max(1, len(ds) // n)
    for i in range(0, step * n, step):
        s = ds[i]
        b = collate([s], cfg.data)
        odom, tq, qc, im = forward(
            net, cfg, b["points"][0], b["point_mask"][0], device,
            mean_mode=mean_mode,
            keys=("odometry", "tq_map", "q_conf", "input_mask"))
        odom = odom[0]
        tq = tq[0]                                  # (H, W, 7)
        qc = qc[0][..., 0]                          # (H, W)
        m = im[0][..., 0] > 0
        gt_yaw = yaw_of(np.asarray(b["odometry"][0][0][3:])[None])[0]
        vote_yaw = yaw_of(odom[3:][None] * np.sign(odom[3]))[0]
        cell_yaw = yaw_of(tq[..., 3:])
        w = qc * m
        wsum = w.sum() + 1e-12
        map_yaw = float((cell_yaw * w).sum() / wsum)
        map_std = float(np.sqrt(((cell_yaw - map_yaw) ** 2 * w).sum()
                                / wsum))
        conf_cv = float(qc[m].std() / (qc[m].mean() + 1e-12))
        rows.append((gt_yaw, vote_yaw, map_yaw, map_std, conf_cv))
        print(f"{gt_yaw:8.3f} {vote_yaw:9.3f} {map_yaw:11.3f} "
              f"{map_std:11.3f} {conf_cv:8.3f}", flush=True)
    R = np.array(rows)

    def corr(a, b):
        return np.corrcoef(a, b)[0, 1]
    print(f"\ncorr(gt, vote) {corr(R[:,0], R[:,1]):+.3f}   "
          f"corr(gt, map)  {corr(R[:,0], R[:,2]):+.3f}")
    print(f"slope vote/gt {np.polyfit(R[:,0], R[:,1], 1)[0]:+.3f}   "
          f"slope map/gt {np.polyfit(R[:,0], R[:,2], 1)[0]:+.3f}")
    return R


def cli(argv=None):
    p = add_device(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    p.add_argument("tag", nargs="?", default="v3naf32")
    p.add_argument("n", nargs="?", type=int, default=8)
    p.add_argument("--supervised", action="store_true")
    p.add_argument("--val", action="store_true")
    a = p.parse_args(argv)
    return main(a.tag, a.n, a.supervised, a.val, a.device)


if __name__ == "__main__":
    cli()
