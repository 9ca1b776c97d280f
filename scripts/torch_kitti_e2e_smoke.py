"""End-to-end KITTI-shaped smoke on the PyTorch port (the twin of
``scripts/kitti_e2e_smoke.py``, which drives the JAX package): write a
raw KITTI odometry tree with real structure (ground and walls, chained
poses, camera-frame pose files, a ``Tr`` calibration), then drive the
port's CLI the way a real-KITTI user does: ``create_hdf5`` -> ``train``
-> ``evaluate``.

    python scripts/torch_kitti_e2e_smoke.py [--device cpu] [--root TREE]
        [--out STORE] [--model_dir RUN] [--n_points N] [--n_frames F]
        [--steps S] [--max_windows W]

The tree, the pillar configuration, the steps and the windows are the
JAX script's (its sizes are the defaults).  ``--out`` defaults to a directory store (needs only
numpy); an ``--out`` ending in ``.h5`` writes HDF5 (needs h5py).
``train`` and ``evaluate`` run on the CUDA card unless ``--device cpu``
is given.  Each stage is a function, so a caller can run them one by
one (``build_tree``, ``create_store``, ``pillar_cfg``, ``train``,
``evaluate``).
"""
import argparse
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

WORK = Path(tempfile.gettempdir())
# the JAX script's calibration: every camera's P, and Tr (velo -> cam)
CALIB_P = "7.1e+02 0 6.0e+02 0 0 7.1e+02 1.8e+02 0 0 0 1 0"
CALIB_TR = "0 -1 0 0 0 0 -1 0 1 0 0 0"
TR = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]],
              float)


def build_tree(root, n_points=20000, n_frames=10, seqs=(0, 1), seed=0):
    """A raw KITTI tree under ``root`` (replaced): per sequence, one
    ``synth_cloud`` of ``n_points`` moved by a fixed ego step each frame
    (``sequences/XX/velodyne/*.bin``, x y z reflectance), ``calib.txt``
    and ``poses/XX.txt``, the chained lidar poses in the camera frame
    (``Tr @ T_lidar @ Tr^-1``).  One ``default_rng(seed)`` feeds every
    sequence's cloud, in order.  Returns ``root``."""
    from rslo_tpu_torch.geometry import np_compose_pose, tq_to_RT
    from rslo_tpu_torch.utils.synthetic import synth_cloud, transform_cloud
    root = Path(root)
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(seed)
    for seq in seqs:
        seq_dir = root / "sequences" / f"{seq:02d}"
        (seq_dir / "velodyne").mkdir(parents=True)
        (root / "poses").mkdir(exist_ok=True)
        with open(seq_dir / "calib.txt", "w") as f:
            for k in ("P0", "P1", "P2", "P3"):
                f.write(f"{k}: {CALIB_P}\n")
            f.write(f"Tr: {CALIB_TR}\n")
        cloud = synth_cloud(rng, n_points)
        step = np.array([0.8, 0.02, 0.0, 0.99995, 0, 0, 0.01], np.float32)
        step[3:] /= np.linalg.norm(step[3:])
        lidar_pose = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
        poses = []
        cur = cloud
        for i in range(n_frames):
            pts4 = np.concatenate([cur[:, :3], cur[:, 3:4]],
                                  axis=1).astype(np.float32)
            pts4.tofile(seq_dir / "velodyne" / f"{i:06d}.bin")
            T_l = np.eye(4)
            T_l[:3] = tq_to_RT(lidar_pose)
            T_c = TR @ T_l @ np.linalg.inv(TR)
            poses.append(T_c[:3].reshape(-1))
            lidar_pose = np_compose_pose(lidar_pose[None], step[None])[0]
            cur = transform_cloud(cur, step)
        np.savetxt(root / "poses" / f"{seq:02d}.txt", np.stack(poses))
    return root


def create_store(tree, out, seqs=(0, 1)):
    """The ``create_hdf5`` verb over the tree's ``seqs``."""
    from rslo_tpu_torch.cli import main
    main(["create_hdf5", "--kitti_root", str(tree), "--out", str(out),
          "--sequences", ",".join(str(s) for s in seqs)])


def pillar_cfg(store):
    """The JAX script's pillar configuration over ``store``."""
    from rslo_tpu_torch.config.schema import (DataCfg, LossCfg, MiddleCfg,
                                              OdomCfg, PipelineCfg, TrainCfg,
                                              VoxelizerCfg)
    return PipelineCfg(
        voxelizer=VoxelizerCfg(
            point_cloud_range=(-51.2, -25.6, -3.0, 51.2, 25.6, 5.0),
            voxel_size=(0.2, 0.2, 0.2), max_points_per_voxel=5,
            max_voxels=8192),
        middle=MiddleCfg(name="PillarMiddleCov",
                         level_capacities=(8192, 8192, 4096, 2048),
                         channels=(8, 16, 32, 32), remat=False),
        odom=OdomCfg(num_input_features=64, layer_nums=(1, 1, 1),
                     num_filters=(32, 32, 64),
                     num_upsample_filters=(32, 32, 32), bn_type="sync_bn"),
        loss=LossCfg(max_loss_points=8192, warmup_steps=1000),
        data=DataCfg(root=str(store), seq_length=2, max_points=20480,
                     train_sequences=(0,), val_sequences=(1,)),
        train=TrainCfg(steps=3, display_step=1, steps_per_eval=1000),
    )


def train(cfg_path, model_dir, steps=3, device="cuda"):
    """The ``train`` verb; returns the final train state."""
    from rslo_tpu_torch.cli import main
    return main(["train", "--config", str(cfg_path), "--model_dir",
                 str(model_dir), "--steps", str(steps), "--device", device])


def evaluate(cfg_path, model_dir, max_windows=9, device="cuda"):
    """The ``evaluate`` verb; returns its results (also written to
    ``model_dir/eval_results.json``)."""
    from rslo_tpu_torch.cli import main
    return main(["evaluate", "--config", str(cfg_path), "--model_dir",
                 str(model_dir), "--max_windows", str(max_windows),
                 "--device", device])


def run(root, out, model_dir, device="cuda", n_points=20000, n_frames=10,
        steps=3, max_windows=9):
    """Every stage, as the JAX script runs them; returns the evaluate
    verb's results."""
    tree = build_tree(root, n_points, n_frames)
    print("tree built", flush=True)
    create_store(tree, out)
    print("STORE OK", flush=True)
    cfg_path = Path(model_dir).parent / f"{Path(model_dir).name}_cfg.json"
    cfg_path.write_text(pillar_cfg(out).to_json())
    shutil.rmtree(model_dir, ignore_errors=True)
    train(cfg_path, model_dir, steps, device)
    print("TRAIN ON KITTI-SHAPED DATA OK", flush=True)
    res = evaluate(cfg_path, model_dir, max_windows, device)
    print("EVAL ON KITTI-SHAPED DATA OK", flush=True)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--root", default=str(WORK / "mini_kitti_torch"),
                   help="where the KITTI tree is written (replaced)")
    p.add_argument("--out", default=str(WORK / "mini_kitti_torch_store"),
                   help="the store: a directory (default), or a .h5 file")
    p.add_argument("--model_dir", default=str(WORK / "mini_kitti_torch_run"),
                   help="the train and evaluate run dir (replaced); its "
                        "config goes beside it as <model_dir>_cfg.json")
    p.add_argument("--n_points", type=int, default=20000,
                   help="points a scan")
    p.add_argument("--n_frames", type=int, default=10,
                   help="frames a sequence")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--max_windows", type=int, default=9)
    args = p.parse_args(argv)
    return run(args.root, args.out, args.model_dir, device=args.device,
               n_points=args.n_points, n_frames=args.n_frames,
               steps=args.steps, max_windows=args.max_windows)


if __name__ == "__main__":
    main()
