"""The port's KITTI-shaped end-to-end smoke (``scripts/
torch_kitti_e2e_smoke.py``) against the JAX package's
(``scripts/kitti_e2e_smoke.py``): the raw KITTI tree it writes is byte
for byte the tree that JAX's script writes with the JAX package's
functions (``synth_cloud``, ``transform_cloud``, ``tq_to_RT``,
``np_compose_pose``), its configuration is JAX's, and it runs
``create_hdf5`` -> ``train`` -> ``evaluate`` through the port's CLI on
the CPU without h5py."""
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np

from rslo_tpu.config.schema import (DataCfg, LossCfg, MiddleCfg, OdomCfg,
                                    PipelineCfg, TrainCfg, VoxelizerCfg)
from rslo_tpu.geometry import np_compose_pose, tq_to_RT
from rslo_tpu.utils.synthetic import synth_cloud, transform_cloud

from torch_port_helpers import to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _twin():
    spec = importlib.util.spec_from_file_location(
        "_torch_kitti_e2e_smoke",
        os.path.join(REPO, "scripts", "torch_kitti_e2e_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_tree(root):
    """The tree of scripts/kitti_e2e_smoke.py, by its own code with the
    JAX package's functions (its paths made ``root``)."""
    rng = np.random.default_rng(0)
    for seq in (0, 1):
        seq_dir = root / "sequences" / f"{seq:02d}"
        (seq_dir / "velodyne").mkdir(parents=True)
        (root / "poses").mkdir(exist_ok=True)
        with open(seq_dir / "calib.txt", "w") as f:
            P = "7.1e+02 0 6.0e+02 0 0 7.1e+02 1.8e+02 0 0 0 1 0"
            for k in ("P0", "P1", "P2", "P3"):
                f.write(f"{k}: {P}\n")
            f.write("Tr: 0 -1 0 0 0 0 -1 0 1 0 0 0\n")
        cloud = synth_cloud(rng, 20000)
        step = np.array([0.8, 0.02, 0.0, 0.99995, 0, 0, 0.01], np.float32)
        step[3:] /= np.linalg.norm(step[3:])
        Tr = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                       [0, 0, 0, 1]], float)
        lidar_pose = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
        poses = []
        cur = cloud
        for i in range(10):
            pts4 = np.concatenate([cur[:, :3], cur[:, 3:4]],
                                  axis=1).astype(np.float32)
            pts4.tofile(seq_dir / "velodyne" / f"{i:06d}.bin")
            T_l = np.eye(4)
            T_l[:3] = tq_to_RT(lidar_pose)
            T_c = Tr @ T_l @ np.linalg.inv(Tr)
            poses.append(T_c[:3].reshape(-1))
            lidar_pose = np_compose_pose(lidar_pose[None], step[None])[0]
            cur = transform_cloud(cur, step)
        np.savetxt(root / "poses" / f"{seq:02d}.txt", np.stack(poses))


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def test_tree_and_config_match_jax(tmp_path):
    twin = _twin()
    got = twin.build_tree(tmp_path / "port")      # the JAX script's sizes
    _jax_tree(tmp_path / "jax")
    got, want = _files(got), _files(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(want) == 2 * 11 + 2
    for name, data in want.items():
        assert got[name] == data, name
    # the JAX script's configuration, store path included
    jax_cfg = PipelineCfg(
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
        data=DataCfg(root="/tmp/mini_kitti.h5", seq_length=2,
                     max_points=20480, train_sequences=(0,),
                     val_sequences=(1,)),
        train=TrainCfg(steps=3, display_step=1, steps_per_eval=1000))
    assert twin.pillar_cfg("/tmp/mini_kitti.h5").to_json() == \
        to_port(jax_cfg).to_json()


def test_twin_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """The script's ``main`` with ``--device cpu``, h5py hidden as on the
    card's machine, at a smaller tree (4 frames of 4000 points), 1 step
    and 2 windows: every stage runs and the metrics are finite."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    twin = _twin()
    mdir = tmp_path / "run"
    res = twin.main(["--device", "cpu", "--root", str(tmp_path / "tree"),
                     "--out", str(tmp_path / "store"), "--model_dir",
                     str(mdir), "--n_points", "4000", "--n_frames", "4",
                     "--steps", "1", "--max_windows", "2"])
    assert sorted(os.listdir(tmp_path / "store")) == ["00", "01"]
    assert (tmp_path / "run_cfg.json").exists()
    log = [json.loads(ln) for ln in open(mdir / "log.json.lst")]
    train_rows = [r for r in log if "loss" in r]
    assert len(train_rows) == 1 and all(
        np.isfinite(v) for r in train_rows for v in r.values()
        if isinstance(v, float))
    assert res["_meta"]["windows"] == 2 and set(res) == {
        "_meta", "seq_01", "avg"}
    for k in ("ate_rmse_m", "t_rel_pct", "r_rel_deg_per_100m"):
        assert np.isfinite(res["avg"][k]), k
    assert json.loads((mdir / "eval_results.json").read_text())[
        "_meta"]["windows"] == 2
    assert sys.modules["h5py"] is None
