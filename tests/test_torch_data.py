"""Port the host data path (rslo_tpu_torch.data: kitti_io, hdf5_store,
dataset, loader's collation) and the CLI's synthetic dataset against
the JAX package: the same numpy code on the same inputs, so every array
is bit-equal.  The store is written by the JAX package's create_hdf5
from a small fake KITTI tree, as tests/test_data.py writes it."""
import numpy as np
import pytest

from rslo_tpu.cli import _synthetic_dataset as jax_synthetic
from rslo_tpu.config.schema import DataCfg as JaxDataCfg
from rslo_tpu.data import dataset as JD
from rslo_tpu.data import hdf5_store as JH
from rslo_tpu.data import kitti_io as JIO
from rslo_tpu.data import loader as JL
from rslo_tpu_torch.cli import _synthetic_dataset
from rslo_tpu_torch.config.schema import DataCfg
from rslo_tpu_torch.data import dataset as PD
from rslo_tpu_torch.data import hdf5_store as PH
from rslo_tpu_torch.data import kitti_io as PIO
from rslo_tpu_torch.data import loader as PL

from torch_port_helpers import assert_same, port_cfg, to_port


@pytest.fixture(scope="module")
def mini_kitti(tmp_path_factory):
    """A KITTI tree of 2 sequences x 8 frames and its HDF5 store (with
    cross normals, so the crossnorm dataset reads them)."""
    root = tmp_path_factory.mktemp("kitti")
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
        poses = []
        for i in range(8):
            pts = rng.uniform(-10, 10, size=(512, 4)).astype(np.float32)
            pts[:, 3] = rng.uniform(0, 1, 512)
            if i == 2:
                pts[5, 1] = np.nan        # a corrupt row, dropped on read
            pts.tofile(seq_dir / "velodyne" / f"{i:06d}.bin")
            T = np.eye(4)[:3]
            T[0, 3] = 0.1 * i
            T[2, 3] = 0.05 * i * i
            poses.append(T.reshape(-1))
        np.savetxt(root / "poses" / f"{seq:02d}.txt", np.stack(poses))
    out = root / "all.h5"
    JH.create_hdf5(str(root), str(out), sequences=(0, 1), progress=False,
                   cross_normal_radius=1.5)
    return root, str(out)


def test_kitti_io_bit_equal(mini_kitti):
    root, _ = mini_kitti
    for seq in (0, 1):
        assert_same([str(p) for p in PIO.sequence_paths(root, seq)],
                    [str(p) for p in JIO.sequence_paths(root, seq)])
        velo, seq_dir, pose_file = PIO.sequence_paths(root, seq)
        assert_same(PIO.read_calib(seq_dir), JIO.read_calib(seq_dir))
        assert_same(PIO.read_poses(pose_file), JIO.read_poses(pose_file))
        frames = PIO.list_frames(velo)
        assert frames == JIO.list_frames(velo) and len(frames) == 8
        for fr in frames:
            assert_same(PIO.read_velodyne(fr), JIO.read_velodyne(fr))
    assert len(PIO.read_velodyne(frames[2])) == 511


@pytest.mark.parametrize("seq", [0, 1])
@pytest.mark.parametrize("cross", [False, True])
def test_sequence_reader_bit_equal(mini_kitti, seq, cross):
    _, h5 = mini_kitti
    got, want = PH.SequenceReader(h5, seq), JH.SequenceReader(h5, seq)
    assert got.n_frames == want.n_frames == 8
    for i in range(8):
        assert_same(got.frame(i, cross_normals=cross),
                    want.frame(i, cross_normals=cross))


def _data_cfgs(h5, **kw):
    kw = dict(root=h5, train_sequences=(0, 1), val_sequences=(1, 0), **kw)
    return DataCfg(**kw), JaxDataCfg(**kw)


@pytest.mark.parametrize("name", ["kitti_hdf5", "kitti_crossnorm_hdf5"])
@pytest.mark.parametrize("split,seq_length,skip", [
    ("val", 2, 1), ("val", 3, 1), ("train", None, 2)])
def test_window_dataset_bit_equal(mini_kitti, name, split, seq_length,
                                  skip):
    _, h5 = mini_kitti
    pcfg, jcfg = _data_cfgs(h5, skip=skip, load_hier_points=True)
    jax_cls = {"kitti_hdf5": JD.KittiWindowDataset,
               "kitti_crossnorm_hdf5": JD.KittiCrossNormWindowDataset}[name]
    got = PD.DATASETS[name](pcfg, split, seq_length=seq_length)
    want = jax_cls(jcfg, split, seq_length=seq_length)
    assert got.index == want.index and len(got) == len(want) > 0
    assert got.sequence_segments() == want.sequence_segments()
    for i in range(len(want)):
        assert_same(got[i], want[i], f"window {i}")


def test_generate_cyc_vo_bit_equal():
    rng = np.random.default_rng(4)
    for L in (2, 3, 4):
        poses = rng.normal(size=(L, 7)).astype(np.float32)
        poses[:, 3:] /= np.linalg.norm(poses[:, 3:], axis=1, keepdims=True)
        assert_same(PD.generate_cyc_vo(poses), JD.generate_cyc_vo(poses))


@pytest.mark.parametrize("n", [100, 128, 300])
@pytest.mark.parametrize("seeded", [False, True])
def test_pad_points_bit_equal(n, seeded):
    pts = np.random.default_rng(n).normal(size=(n, 7)).astype(np.float32)
    rngs = ((np.random.default_rng(9), np.random.default_rng(9)) if seeded
            else (None, None))
    assert_same(PL.pad_points(pts, 128, rngs[0]),
                JL.pad_points(pts, 128, rngs[1]))


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("quantize", [False, True])
def test_collate_bit_equal(seeded, quantize):
    """Three samples of two frames, with hier clouds, some frames over
    the capacity (strided or seeded subsample) and some under it."""
    rng = np.random.default_rng(2)
    samples = [{"points": [rng.normal(size=(n, 7)).astype(np.float32)
                           for n in (50 + 80 * d, 300 - 60 * d)],
                "hier_points": [rng.normal(size=(40 * d + 10, 6)).astype(
                    np.float32) for _ in range(2)],
                "odometry": rng.normal(size=(1, 7)).astype(np.float32),
                "seq": d, "frames": (d, d + 1)} for d in range(3)]
    kw = dict(max_points=128, max_hier_points=64, quantize_transfer=quantize)
    got = PL.collate(samples, DataCfg(**kw),
                     np.random.default_rng(5) if seeded else None)
    want = JL.collate(samples, JaxDataCfg(**kw),
                      np.random.default_rng(5) if seeded else None)
    assert_same(got, want)
    assert got["points"].dtype == (np.int16 if quantize else np.float32)
    assert_same(PL.quant_scale(7), JL.quant_scale(7))


@pytest.mark.parametrize("split", ["val", "train"])
def test_synthetic_dataset_bit_equal(split):
    """The CLI's synthetic split at the tiny test config (scaled scene)."""
    import dataclasses
    cfg = port_cfg("f32")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, max_points=2048))
    got = _synthetic_dataset(to_port(cfg), split, n_windows=3)
    want = jax_synthetic(cfg, split, n_windows=3)
    assert len(got) == len(want) == 3
    for i in range(3):
        assert_same(got[i], want[i], f"window {i}")
