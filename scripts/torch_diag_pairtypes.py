"""Per-pair-type magnitude probe (translation scale diagnosis) on the
PyTorch port (the twin of ``scripts/diag_pairtypes.py``, which drives
the JAX package).

Loads a trained proxy model, runs TRAIN windows (L=3 -> pairs (0,1),
(0,2), (1,2)), and prints predicted vs GT |t| per pair type.  A
magnitude-blind net predicts ~the same |t| for 1-step and 2-step
pairs; a healthy one predicts ~2x for (0,2).

    python scripts/torch_diag_pairtypes.py [middle] [n] [--supervised]
        [--tag=T] [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from torch_accuracy_proxy import base_cfg, _model_dir  # noqa: E402
from torch_diag_net import add_device, forward, restore_net  # noqa: E402


def main(middle: str, n: int, supervised: bool, tag: str = "",
         device="cuda"):
    from rslo_tpu_torch.data.dataset import KittiWindowDataset
    from rslo_tpu_torch.data.loader import collate

    cfg = base_cfg(middle, 100)
    ds = KittiWindowDataset(cfg.data, "train", seq_length=3)
    net, step = restore_net(cfg, _model_dir(middle, supervised, tag),
                            device)
    print("restored step:", step, flush=True)

    names = ["(0,1)", "(0,2)", "(1,2)"]
    P = {k: [] for k in names}
    G = {k: [] for k in names}
    stride = max(1, len(ds) // n)
    for w in range(0, stride * n, stride):
        b = collate([ds[w]], cfg.data)
        (od,) = forward(net, cfg, b["points"][0], b["point_mask"][0],
                        device)
        gt = np.asarray(b["odometry"][0]).reshape(-1, 7)
        for k in range(3):
            P[names[k]].append(od[k, :3])
            G[names[k]].append(gt[k, :3])
    for k in names:
        p = np.linalg.norm(np.stack(P[k]), axis=1)
        g = np.linalg.norm(np.stack(G[k]), axis=1)
        print(f"pair {k}: |t_pred| {p.mean():.3f}+-{p.std():.3f}  "
              f"|t_gt| {g.mean():.3f}  ratio {p.mean()/g.mean():.3f}",
              flush=True)
    return P, G


def cli(argv=None):
    p = add_device(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    p.add_argument("middle", nargs="?", default="PillarMiddleCov")
    p.add_argument("n", nargs="?", type=int, default=6)
    p.add_argument("--supervised", action="store_true")
    p.add_argument("--tag", default="")
    a = p.parse_args(argv)
    return main(a.middle, a.n, a.supervised, a.tag, a.device)


if __name__ == "__main__":
    cli()
