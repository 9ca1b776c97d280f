"""Measure self-supervised pseudo-target quality on the proxy, on the
PyTorch port (the twin of ``scripts/diag_pseudo.py``, which drives the
JAX package).

Runs the train-mode forward on training windows with the self-sup
checkpoint, reproduces the objective's ICP pseudo-target composition
(``losses/objective.py``), and prints pred / pseudo-target / GT motion
triples: the direct test of "is the ICP correction pulling the
predictions toward the true motion?".  ``--warmup`` composes it as the
warmup steps do (identity rotation, ``warmup_icp_iter``).

    python scripts/torch_diag_pseudo.py [middle] [n_windows] [--warmup]
        [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given.  The
train-mode forward computes with batch statistics and would move the BN
running statistics (JAX's script throws the mutated ``batch_stats``
away); they are put back after each window, so the restored model is
left as it was found.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np
import torch

from torch_accuracy_proxy import base_cfg, _model_dir  # noqa: E402
from torch_diag_net import add_device  # noqa: E402


def pseudo_target(net, cfg, points, point_mask, warmup, device):
    """One window's train-mode forward and the objective's pseudo target
    of its first pair: (pred (7,), pseudo t (3,), pseudo q (4,), the
    consistency loss), numpy.  The net's buffers are restored."""
    from rslo_tpu_torch.data.prepare import prepare_example, voxelizer_config
    from rslo_tpu_torch.geometry import (hemisphere, matrix_to_quat,
                                         quat_to_matrix)
    from rslo_tpu_torch.losses.consistency import (_mm, _mv,
                                                   consistency_loss_pairs)
    lcfg = cfg.loss
    saved = {k: b.clone() for k, b in net.named_buffers()}
    net.train()
    try:
        with torch.no_grad():
            e = prepare_example(torch.as_tensor(points).to(device),
                                torch.as_tensor(point_mask).to(device),
                                voxelizer_config(cfg))
            preds = net(e)
            odom = preds["odometry"].float()
            T_pred, q_pred = odom[:, :3], odom[:, 3:]
            feats = preds["voxel_features"]
            covs = preds["voxel_covs"]
            masks = preds["voxel_masks"]
            V = feats[0].shape[0]
            stride = max(1, -(-V // lcfg.max_loss_points))

            def sub(x):
                return x[::stride][:lcfg.max_loss_points]

            def pts_of(t):
                f = sub(feats[t])
                return torch.cat([f[:, 0:3], f[:, 4:7]], dim=-1)

            src_pts = pts_of(0)[None].float()
            tgt_pts = pts_of(1)[None].float()
            src_mask = sub(masks[0])[None]
            tgt_mask = sub(masks[1])[None]
            src_cov = sub(covs[0])[None].float()
            tgt_cov = sub(covs[1])[None].float()
            if warmup:
                R_use = torch.eye(3, device=odom.device)[None]
                T_use = torch.zeros((1, 3), device=odom.device)
            else:
                R_use = quat_to_matrix(q_pred[:1])
                T_use = T_pred[:1]
            tgt_xyz = _mv(R_use[:, None], tgt_pts[..., :3]) + \
                T_use[:, None, :]
            c_raw, rR, rt = consistency_loss_pairs(
                src_pts[..., :3], src_mask, src_pts[..., 3:6], src_cov,
                tgt_xyz, tgt_mask, tgt_cov, R_use,
                penalize_ratio=lcfg.penalize_ratio,
                reg_weight=lcfg.reg_weight,
                icp_iter=lcfg.warmup_icp_iter if warmup else lcfg.icp_iter)
            R_tgt = _mm(rR, R_use)
            t_tgt = _mv(rR, T_use) + rt
            q_tgt = hemisphere(matrix_to_quat(R_tgt))
            return (odom[0].cpu().numpy(), t_tgt[0].cpu().numpy(),
                    q_tgt[0].cpu().numpy(), float(c_raw))
    finally:
        with torch.no_grad():
            for k, b in net.named_buffers():
                b.copy_(saved[k])
        net.eval()


def main(middle: str, n: int, warmup: bool, device="cuda"):
    from rslo_tpu_torch.data.dataset import KittiWindowDataset
    from rslo_tpu_torch.data.loader import collate
    from rslo_tpu_torch.train.loop import Trainer

    cfg = base_cfg(middle, 100)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, seq_length=2,
                                               random_flip_y=False))
    ds = KittiWindowDataset(cfg.data, "train", seq_length=2)
    trainer = Trainer(cfg, _model_dir(middle, False), device=device)
    state = trainer.init_state()
    trainer.logger.close()
    print("restored step:", int(state.step), flush=True)
    net = state.model

    step = max(1, (len(ds) - 1) // n)
    rows = []
    for i in range(0, step * n, step):
        b = collate([ds[i]], cfg.data)
        o, tt, qt, c = pseudo_target(net, cfg, b["points"][0],
                                     b["point_mask"][0], warmup, device)
        gt = np.asarray(b["odometry"][0][0])
        rows.append((o, tt, qt, gt, c))
    print(f"{'pred t':>24s} | {'pseudo t':>24s} | {'gt t':>24s} | C")
    for o, tt, qt, gt, c in rows[:10]:
        f = lambda v: np.array2string(np.asarray(v)[:3],  # noqa: E731
                                      precision=3, suppress_small=True)
        print(f"{f(o):>24s} | {f(tt):>24s} | {f(gt):>24s} | {c:.4f}")
    P = np.stack([r[0][:3] for r in rows])
    T = np.stack([r[1] for r in rows])
    G = np.stack([r[3][:3] for r in rows])
    Qp = np.stack([r[0][3:] for r in rows])
    Qt = np.stack([r[2] for r in rows])
    Qg = np.stack([r[3][3:] for r in rows])
    print("mean |pseudo - gt| t:", np.linalg.norm(T - G, axis=1).mean())
    print("mean |pred   - gt| t:", np.linalg.norm(P - G, axis=1).mean())
    print("mean |pseudo - pred| t:",
          np.linalg.norm(T - P, axis=1).mean())
    print("qz pred/pseudo/gt means:",
          Qp[:, 3].mean(), Qt[:, 3].mean(), Qg[:, 3].mean())
    return rows


def cli(argv=None):
    p = add_device(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    p.add_argument("middle", nargs="?", default="PillarMiddleCov")
    p.add_argument("n", nargs="?", type=int, default=16)
    p.add_argument("--warmup", action="store_true")
    a = p.parse_args(argv)
    return main(a.middle, a.n, a.warmup, a.device)


if __name__ == "__main__":
    cli()
