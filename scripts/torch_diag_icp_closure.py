"""Checkpoint-free probe on the PyTorch port (the twin of
``scripts/diag_icp_closure.py``, which drives the JAX package): can the
consistency ICP recover a known pose residual on realistic proxy
clouds?

The pseudo-target mechanism (``losses/objective.py``) can pull rotation
only if the inner weighted-Kabsch ICP (``losses/consistency.py``)
recovers a ~1 deg yaw residual from the two warped clouds.  This probe
measures that closure rate directly:

  1. render two frames of the synth world with a known relative motion
     (translation 0.8 m + yaw 0.9 deg: the val loop's per-frame motion);
  2. voxel-subsample both clouds at proxy settings;
  3. inject a known residual into the "predicted" motion and warp the
     target cloud by the prediction (as the objective does);
  4. run the consistency ICP and compare the pseudo target against GT.

Prints closure tables across residual magnitude / axis and icp_iter.
closure = 1 - err(pseudo)/err(pred): 1.0 is full recovery, 0 means the
pseudo target is no better than the prediction, < 0 means ICP pushes
the wrong way.

    python scripts/torch_diag_icp_closure.py [--device cpu]

It runs on the CUDA card (the NN search is the hand-written kernel)
unless ``--device cpu`` is given.  ``main`` takes the beam grid and the
cloud cap as keywords (the JAX script's 64 x 1024 beams and 8192
points by default).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np
import torch

from rslo_tpu_torch.geometry.transforms import (_np_qmult, np_calc_vo,
                                                quat_to_matrix_np, tq_to_RT)
from rslo_tpu_torch.losses.consistency import _mv, consistency_pair
from rslo_tpu_torch.utils.world import SynthWorld
from torch_diag_net import add_device


def yaw_quat(deg):
    a = np.deg2rad(deg) / 2
    return np.array([np.cos(a), 0, 0, np.sin(a)])


def subsample_voxel(pts, cell=0.3, cap=8192, rng=None):
    """Voxel-grid subsample (keep one point per cell): a stand-in for the
    voxelizer's centroid clouds at matching density."""
    ids = np.floor(pts[:, :3] / cell).astype(np.int64)
    _, first = np.unique(ids, axis=0, return_index=True)
    sel = np.sort(first)
    if len(sel) > cap:
        sel = rng.choice(sel, cap, replace=False)
    out = np.zeros((cap, pts.shape[1]), np.float32)
    m = np.zeros((cap,), bool)
    out[:len(sel)] = pts[sel]
    m[:len(sel)] = True
    return out, m


def rot_angle_deg(R):
    c = (np.trace(R) - 1) / 2
    return np.rad2deg(np.arccos(np.clip(c, -1, 1)))


def main(device="cuda", beams=(64, 1024), cap=8192):
    rng = np.random.default_rng(0)
    world = SynthWorld(seed=0)
    # frame A at a generic spot; frame B = A + (0.8 m forward, yaw deg)
    yaw0 = np.deg2rad(30.0)
    qA = np.array([np.cos(yaw0 / 2), 0, 0, np.sin(yaw0 / 2)])
    pA = np.array([5.0, -3.0, 0.0, *qA], np.float32)

    gt_yaw_deg = 0.9
    gt_t_fwd = 0.8
    q_rel = yaw_quat(gt_yaw_deg)
    # pose B = pose A composed with relative motion (in A's frame)
    RA = quat_to_matrix_np(qA)
    tB = pA[:3] + RA @ np.array([gt_t_fwd, 0.0, 0.0])
    qB = _np_qmult(qA[None], q_rel[None])[0]
    pB = np.array([*tB, *qB], np.float32)

    fA = world.scan(pA, rng, n_beams=beams[0], n_azimuth=beams[1])
    fB = world.scan(pB, rng, n_beams=beams[0], n_azimuth=beams[1])

    # GT motion mapping B-frame points into A-frame coords:
    # vo = inv(pose_A) o pose_B
    vo = np_calc_vo(pA[None], pB[None])[0]
    RT = tq_to_RT(vo)                   # (3, 4)
    R_gt, t_gt = RT[:, :3], RT[:, 3]

    srcp, srcm = subsample_voxel(fA, cap=cap, rng=rng)
    tgtp, tgtm = subsample_voxel(fB, cap=cap, rng=rng)

    # sanity: GT warp aligns clouds (mean NN dist should be small)
    warped = tgtp[:, :3] @ R_gt.T + t_gt
    from scipy.spatial import cKDTree
    d0, _ = cKDTree(warped[tgtm]).query(srcp[srcm][:2000, :3])
    print(f"sanity: GT-warp NN mean dist = {d0.mean():.3f} m "
          f"(cloud cell 0.3 m)", flush=True)

    def dev_t(x):
        return torch.as_tensor(x).to(device)[None]

    src_t = dev_t(srcp[:, :3])
    srcn_t = dev_t(srcp[:, 4:7])
    srcm_t = dev_t(srcm)
    tgt_t = dev_t(tgtp[:, :3])
    tgtm_t = dev_t(tgtm)

    def run_icp(R_pred, t_pred, icp_iter, penalize_ratio=0.97):
        R = torch.as_tensor(R_pred, dtype=torch.float32, device=device)
        t = torch.as_tensor(t_pred, dtype=torch.float32, device=device)
        tgt_w = _mv(R, tgt_t) + t           # f32 multiply-adds, no TF32
        _, res_R, res_t = consistency_pair(
            src_t, srcm_t, srcn_t, None, tgt_w, tgtm_t, None, R[None],
            penalize_ratio=penalize_ratio, reg_weight=0.005,
            icp_iter=icp_iter)
        res_R = res_R[0].cpu().numpy()
        res_t = res_t[0].cpu().numpy()
        R_tgt = res_R @ R_pred
        t_tgt = res_R @ t_pred + res_t
        return R_tgt, t_tgt

    def report(label, R_pred, t_pred, icp_iter):
        R_tgt, t_tgt = run_icp(R_pred, t_pred, icp_iter)
        e_rot_pred = rot_angle_deg(R_pred.T @ R_gt)
        e_rot_tgt = rot_angle_deg(R_tgt.T @ R_gt)
        e_t_pred = np.linalg.norm(t_pred - t_gt)
        e_t_tgt = np.linalg.norm(t_tgt - t_gt)
        cr = 1 - e_rot_tgt / max(e_rot_pred, 1e-9)
        ct = 1 - e_t_tgt / max(e_t_pred, 1e-9)
        print(f"{label:38s} rot {e_rot_pred:6.3f}->{e_rot_tgt:6.3f} deg "
              f"(closure {cr:+.2f})   t {e_t_pred:5.3f}->{e_t_tgt:5.3f} m "
              f"(closure {ct:+.2f})", flush=True)

    print("\n== residual sweep (icp_iter=6, deployed weighting) ==")
    for yaw_err in (0.3, 0.9, 2.0):
        Rp = R_gt @ quat_to_matrix_np(yaw_quat(-yaw_err))
        report(f"yaw residual {yaw_err:.1f} deg", Rp, t_gt.copy(), 6)
    for t_err in (0.2, 0.5):
        report(f"t residual {t_err:.1f} m (fwd)",
               R_gt.copy(), t_gt - RA.T @ np.zeros(3) -
               np.array([t_err, 0, 0]), 6)
    # combined: the realistic early-training state
    Rp = R_gt @ quat_to_matrix_np(yaw_quat(-0.9))
    report("yaw 0.9 deg + t 0.3 m", Rp,
           t_gt - np.array([0.3, 0, 0]), 6)

    print("\n== icp_iter sweep (yaw residual 0.9 deg) ==")
    Rp = R_gt @ quat_to_matrix_np(yaw_quat(-0.9))
    for it in (1, 2, 6, 12):
        report(f"icp_iter={it}", Rp, t_gt.copy(), it)

    print("\n== identity prediction (warmup regime) ==")
    report("R=I, t=0 (full motion residual)",
           np.eye(3), np.zeros(3), 6)


# each report's consistency_pair runs one NN search before its ICP loop
# and one after each ICP iteration but the last: icp_iter in all
ICP_ITERS = (6, 6, 6, 6, 6, 6, 1, 2, 6, 12, 6)


def cli(argv=None):
    args = add_device(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0])).parse_args(argv)
    return main(args.device)


if __name__ == "__main__":
    cli()
