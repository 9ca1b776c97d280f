"""The port's store build (rslo_tpu_torch.data.hdf5_store.create_hdf5 and
the CLI's ``create_hdf5`` verb) against the JAX package's: on a raycast
KITTI tree of 2 sequences (the port's world), with cross normals and a
hier size, every dataset of every group is byte-equal, and the port's
window datasets over the port's store equal JAX's over JAX's."""
import h5py
import numpy as np
import pytest

from rslo_tpu.cli import main as jax_main
from rslo_tpu.config.schema import DataCfg as JaxDataCfg
from rslo_tpu.data import dataset as JD
from rslo_tpu.data import hdf5_store as JH
from rslo_tpu_torch.cli import main
from rslo_tpu_torch.config.schema import DataCfg
from rslo_tpu_torch.data import dataset as PD
from rslo_tpu_torch.data import hdf5_store as PH
from rslo_tpu_torch.utils.world import write_kitti_tree

from torch_port_helpers import assert_same, jax_native_normals

SEQS = {0: (5, "loop", 3.0), 3: (4, "curve", 4.0)}
CROSS = 1.5


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    write_kitti_tree(root, SEQS, world_seed=3, n_beams=16, n_azimuth=512,
                     world_kwargs=dict(extent=10.0, n_walls=30, n_boxes=12,
                                       n_cyl=14, corridor=2.5))
    jax_native_normals()
    return root


def _datasets(path):
    """{group/dataset: list of per-row arrays}."""
    out = {}
    with h5py.File(path, "r") as f:
        for g in f:
            for k in f[g]:
                d = f[g][k]
                out[f"{g}/{k}"] = (d.dtype, d.shape,
                                   [np.asarray(d[i]) for i in range(len(d))])
    return out


def _assert_byte_equal(got_path, want_path):
    got, want = _datasets(got_path), _datasets(want_path)
    assert sorted(got) == sorted(want)
    for key, (dtype, shape, rows) in want.items():
        g_dtype, g_shape, g_rows = got[key]
        assert (g_dtype, g_shape) == (dtype, shape), key
        for i, (g, w) in enumerate(zip(g_rows, rows)):
            assert g.dtype == w.dtype and g.shape == w.shape, (key, i)
            assert g.tobytes() == w.tobytes(), (key, i)
    return want


@pytest.mark.parametrize("how", ["function", "verb"])
def test_create_hdf5_matches_jax(tree, tmp_path, how):
    want, got = tmp_path / "jax.h5", tmp_path / "port.h5"
    if how == "function":
        kw = dict(sequences=tuple(SEQS), downsample_sizes=(0.2,),
                  cross_normal_radius=CROSS, max_frames=4, progress=False)
        JH.create_hdf5(str(tree), str(want), **kw)
        PH.create_hdf5(str(tree), str(got), **kw)
    else:
        argv = ["create_hdf5", "--kitti_root", str(tree), "--sequences",
                "0,3", "--cross_normal_radius", str(CROSS)]
        jax_main(argv + ["--out", str(want)])
        main(argv + ["--out", str(got)])
    data = _assert_byte_equal(got, want)
    hier = "0.2" if how == "function" else "0.1"
    n0 = 4 if how == "function" else SEQS[0][0]
    assert sorted(k for k in data if k.startswith("00/")) == [
        "00/calib_Tr", f"00/hier_lidar_points_normals_{hier}",
        "00/lidar_cross_normals", "00/lidar_normals", "00/lidar_points",
        "00/poses"]
    assert data["00/lidar_points"][1] == (n0,)
    # the records are what build_frame_record makes of each scan
    pts = data["03/lidar_points"][2][1].reshape(-1, 4)
    rec = PH.build_frame_record(pts, (float(hier),),
                                cross_normal_radius=CROSS)
    for k, v in rec.items():
        np.testing.assert_array_equal(v.reshape(-1),
                                      data[f"03/{k}"][2][1], k)


@pytest.fixture(scope="module")
def stores(tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("stores")
    kw = dict(sequences=tuple(SEQS), downsample_sizes=(0.2,),
              cross_normal_radius=CROSS, progress=False)
    JH.create_hdf5(str(tree), str(out / "jax.h5"), **kw)
    PH.create_hdf5(str(tree), str(out / "port.h5"), **kw)
    return str(out / "port.h5"), str(out / "jax.h5")


@pytest.mark.parametrize("name", ["kitti_hdf5", "kitti_crossnorm_hdf5"])
@pytest.mark.parametrize("split,seq_length", [("val", 3), ("train", None)])
def test_windows_on_the_port_store_match_jax(stores, name, split,
                                             seq_length):
    port_h5, jax_h5 = stores
    kw = dict(train_sequences=tuple(SEQS), val_sequences=(3, 0),
              load_hier_points=True, downsample_voxel_sizes=(0.2,))
    pcfg = DataCfg(root=port_h5, **kw)
    jcfg = JaxDataCfg(root=jax_h5, **kw)
    jax_cls = {"kitti_hdf5": JD.KittiWindowDataset,
               "kitti_crossnorm_hdf5": JD.KittiCrossNormWindowDataset}[name]
    got = PD.DATASETS[name](pcfg, split, seq_length=seq_length)
    want = jax_cls(jcfg, split, seq_length=seq_length)
    assert got.index == want.index and len(want) > 0
    for i in range(len(want)):
        w = want[i]
        assert "hier_points" in w
        assert w["points"][0].shape[1] == (10 if "cross" in name else 7)
        assert_same(got[i], w, f"window {i}")
    rng = (np.random.default_rng(5), np.random.default_rng(5))
    assert_same(got.sample(1, rng[0]), want.sample(1, rng[1]))
