"""The port's store build (rslo_tpu_torch.data.hdf5_store.create_hdf5 and
the CLI's ``create_hdf5`` verb) against the JAX package's: on a raycast
KITTI tree of 2 sequences (the port's world), with cross normals and a
hier size, every dataset of every sequence of the port's store, an HDF5
file or a directory store, is byte-equal to JAX's HDF5 store and reads
back through the port's ``SequenceReader`` as JAX's reads through JAX's,
and the port's window datasets over the port's store equal JAX's over
JAX's.  Without h5py the verbs build, train on and evaluate from a
directory store, and a ``.h5`` path raises; the build and the reader
hold about a frame at a time; a build that dies leaves its sequence
unreadable."""
import dataclasses
import importlib.util
import json
import os
import sys
import tracemalloc

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

from torch_port_helpers import assert_same, jax_native_normals, port_cfg, \
    to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQS = {0: (5, "loop", 3.0), 3: (4, "curve", 4.0)}
CROSS = 1.5
TINY_WORLD = dict(extent=10.0, n_walls=30, n_boxes=12, n_cyl=14,
                  corridor=2.5)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    write_kitti_tree(root, SEQS, world_seed=3, n_beams=16, n_azimuth=512,
                     world_kwargs=TINY_WORLD)
    jax_native_normals()
    return root


def _datasets(path):
    """{sequence/dataset: (dtype, [each frame's row])} of either kind of
    store: an HDF5 file's vlen rows and pose rows, or a directory
    store's frames (a ragged dataset's rows flattened, as HDF5 keeps
    them)."""
    out = {}
    if PH.is_hdf5(path):
        with h5py.File(path, "r") as f:
            for g in f:
                for k in f[g]:
                    d = f[g][k]
                    rows = [np.asarray(d[i]) for i in range(len(d))]
                    out[f"{g}/{k}"] = (rows[0].dtype, rows)
        return out
    for g in sorted(os.listdir(path)):
        seq = os.path.join(path, g)
        for name in sorted(os.listdir(seq)):
            if name.endswith(".offsets.npy"):
                continue
            k = name[:-len(".npy")]
            arr = np.load(os.path.join(seq, name))
            off = os.path.join(seq, k + ".offsets.npy")
            if os.path.exists(off):
                o = np.load(off)
                assert o.dtype == np.int64 and o[0] == 0 and \
                    o[-1] == len(arr), (g, k)
                rows = [arr[o[i]:o[i + 1]].reshape(-1)
                        for i in range(len(o) - 1)]
            else:
                rows = list(arr)
            out[f"{g}/{k}"] = (arr.dtype, rows)
    return out


def _assert_byte_equal(got_path, want_path):
    got, want = _datasets(got_path), _datasets(want_path)
    assert sorted(got) == sorted(want)
    for key, (dtype, rows) in want.items():
        g_dtype, g_rows = got[key]
        assert g_dtype == dtype and len(g_rows) == len(rows), key
        for i, (g, w) in enumerate(zip(g_rows, rows)):
            assert g.dtype == w.dtype and g.shape == w.shape, (key, i)
            assert g.tobytes() == w.tobytes(), (key, i)
    return want


def _assert_frames_equal(got_path, want_path, seqs):
    """The port's SequenceReader over its store reads every frame as
    JAX's SequenceReader reads JAX's store: the same keys in the same
    order, dtypes, shapes and bytes, with and without cross normals."""
    for seq in seqs:
        got = PH.SequenceReader(str(got_path), seq)
        want = JH.SequenceReader(str(want_path), seq)
        assert got.n_frames == want.n_frames
        for i in range(want.n_frames):
            for cross in (False, True):
                a, b = got.frame(i, cross), want.frame(i, cross)
                assert list(a) == list(b), (seq, i)
                assert "hier_lidar_points_normals_0.1" in a or \
                    "hier_lidar_points_normals_0.2" in a
                for k in b:
                    assert type(a[k]) is np.ndarray, (seq, i, k)
                    assert a[k].dtype == b[k].dtype, (seq, i, k)
                    assert a[k].shape == b[k].shape, (seq, i, k)
                    assert a[k].tobytes() == b[k].tobytes(), (seq, i, k)


def _proxy_build(tree, store, seqs):
    """The port's accuracy proxy's ``build --h5_only --seqs`` stage over
    ``tree``, writing its store to ``store``."""
    spec = importlib.util.spec_from_file_location(
        "_proxy_for_store", os.path.join(REPO, "scripts",
                                         "torch_accuracy_proxy.py"))
    proxy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(proxy)
    proxy.ROOT, proxy.TREE, proxy.STORE = store.parent, tree, store
    proxy.SEQS = dict(SEQS)
    proxy.main(["build", "--h5_only", "--seqs",
                ",".join(str(s) for s in seqs)])


@pytest.mark.parametrize("kind,how", [
    pytest.param("h5", "function", id="function"),
    pytest.param("h5", "verb", id="verb"),
    pytest.param("dir", "function", id="dir-function"),
    pytest.param("dir", "verb", id="dir-verb"),
    # the accuracy proxy's build stage (its store is a directory store)
    pytest.param("dir", "proxy", id="proxy")])
def test_create_hdf5_matches_jax(tree, tmp_path, kind, how):
    want = tmp_path / "jax.h5"
    got = tmp_path / ("port.h5" if kind == "h5" else "port_store")
    if how == "function":
        kw = dict(sequences=tuple(SEQS), downsample_sizes=(0.2,),
                  cross_normal_radius=CROSS, max_frames=4, progress=False)
        JH.create_hdf5(str(tree), str(want), **kw)
        PH.create_hdf5(str(tree), str(got), **kw)
    elif how == "verb":
        argv = ["create_hdf5", "--kitti_root", str(tree), "--sequences",
                "0,3", "--cross_normal_radius", str(CROSS)]
        jax_main(argv + ["--out", str(want)])
        main(argv + ["--out", str(got)])
    else:
        # JAX's proxy build --h5_only runs this verb (the argv is held
        # in tests/test_torch_accuracy_proxy.py)
        jax_main(["create_hdf5", "--kitti_root", str(tree), "--out",
                  str(want), "--sequences", "0,3"])
        _proxy_build(tree, got, SEQS)
    assert got.is_dir() == (kind == "dir")
    data = _assert_byte_equal(got, want)
    _assert_frames_equal(got, want, SEQS)
    hier = "0.2" if how == "function" else "0.1"
    n0 = 4 if how == "function" else SEQS[0][0]
    cross = [] if how == "proxy" else ["00/lidar_cross_normals"]
    assert sorted(k for k in data if k.startswith("00/")) == sorted([
        "00/calib_Tr", f"00/hier_lidar_points_normals_{hier}",
        "00/lidar_normals", "00/lidar_points", "00/poses"] + cross)
    assert len(data["00/lidar_points"][1]) == n0
    # the records are what build_frame_record makes of each scan
    pts = data["03/lidar_points"][1][2].reshape(-1, 4)
    rec = PH.build_frame_record(pts, (float(hier),),
                                cross_normal_radius=CROSS if cross else None)
    for k, v in rec.items():
        np.testing.assert_array_equal(v.reshape(-1),
                                      data[f"03/{k}"][1][2], k)


@pytest.fixture(scope="module")
def stores(tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("stores")
    kw = dict(sequences=tuple(SEQS), downsample_sizes=(0.2,),
              cross_normal_radius=CROSS, progress=False)
    JH.create_hdf5(str(tree), str(out / "jax.h5"), **kw)
    PH.create_hdf5(str(tree), str(out / "port.h5"), **kw)
    PH.create_hdf5(str(tree), str(out / "port_store"), **kw)
    return {"h5": str(out / "port.h5"), "dir": str(out / "port_store"),
            "jax": str(out / "jax.h5")}


def _window_cases():
    for kind in ("h5", "dir"):
        for split, seq_length in (("val", 3), ("train", None)):
            for name in ("kitti_hdf5", "kitti_crossnorm_hdf5"):
                id_ = f"{split}-{seq_length}-{name}" + (
                    "-dir" if kind == "dir" else "")
                yield pytest.param(kind, name, split, seq_length, id=id_)


@pytest.mark.parametrize("kind,name,split,seq_length", _window_cases())
def test_windows_on_the_port_store_match_jax(stores, kind, name, split,
                                             seq_length):
    kw = dict(train_sequences=tuple(SEQS), val_sequences=(3, 0),
              load_hier_points=True, downsample_voxel_sizes=(0.2,))
    pcfg = DataCfg(root=stores[kind], **kw)
    jcfg = JaxDataCfg(root=stores["jax"], **kw)
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


# -- without h5py ----------------------------------------------------------

@pytest.fixture
def no_h5py(monkeypatch):
    """h5py as the card's machine has it: not importable."""
    monkeypatch.delitem(sys.modules, "h5py", raising=False)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        import h5py  # noqa: F401
    return monkeypatch


def test_verbs_run_on_a_directory_store_without_h5py(tree, tmp_path,
                                                     no_h5py):
    store = tmp_path / "store"
    main(["create_hdf5", "--kitti_root", str(tree), "--out", str(store),
          "--sequences", "0,3"])
    assert sorted(os.listdir(store)) == ["00", "03"]
    cfg = to_port(port_cfg("bf16"))
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, root=str(store),
                                 train_sequences=(0,), val_sequences=(3,),
                                 num_workers=0, max_points=4096),
        train=dataclasses.replace(cfg.train, steps_per_eval=2,
                                  display_step=1))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    mdir = tmp_path / "model"
    state = main(["train", "--config", str(cfg_path), "--model_dir",
                  str(mdir), "--steps", "2", "--device", "cpu"])
    assert state.step == 2
    log = [json.loads(ln) for ln in open(mdir / "log.json.lst")]
    assert all(np.isfinite(r["loss"]) for r in log if "loss" in r)
    # the eval hook read the val sequence from the store
    assert any("eval/ate_rmse_m" in r for r in log)
    res = main(["evaluate", "--config", str(cfg_path), "--model_dir",
                str(mdir), "--max_windows", "2", "--device", "cpu"])
    assert res["_meta"]["windows"] == 2 and set(res) == {
        "_meta", "seq_03", "avg"}
    assert np.isfinite(res["avg"]["ate_rmse_m"])
    assert json.loads((mdir / "eval_results.json").read_text()) == \
        json.loads(json.dumps(res, default=str))
    assert sys.modules["h5py"] is None


def test_h5_path_without_h5py_raises(tree, tmp_path, no_h5py):
    out = tmp_path / "all.h5"
    with pytest.raises(ImportError, match="directory store"):
        main(["create_hdf5", "--kitti_root", str(tree), "--out", str(out),
              "--sequences", "0"])
    # nothing was written in another format
    assert os.listdir(tmp_path) == []


def _record_bytes(store, seq):
    """The largest frame record of a directory store's sequence, in
    bytes (every ragged dataset's rows of the frame)."""
    d = os.path.join(store, f"{seq:02d}")
    offs = [np.load(os.path.join(d, n)) for n in os.listdir(d)
            if n.endswith(".offsets.npy")]
    widths = [np.load(os.path.join(d, n.replace(".offsets", "")),
                      mmap_mode="r").shape[1]
              for n in os.listdir(d) if n.endswith(".offsets.npy")]
    return max(sum(int(o[i + 1] - o[i]) * w * 4 for o, w in zip(offs, widths))
               for i in range(len(offs[0]) - 1))


def _peak(fn):
    tracemalloc.start()
    try:
        fn()
        return tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


def test_build_and_read_hold_about_a_frame(tree, tmp_path):
    """tracemalloc's peak while building a sequence (5 frames) of a
    directory store, and while reading every frame of it in random
    order, stays under 3 frames' records: nothing accumulates over the
    frames.  A one-frame build and read first takes the one-time
    allocations (imports, caches) out of the measurement."""
    kw = dict(downsample_sizes=(0.1,), cross_normal_radius=CROSS,
              progress=False)
    PH.create_hdf5(str(tree), str(tmp_path / "warm"), sequences=(3,),
                   max_frames=1, **kw)
    PH.SequenceReader(str(tmp_path / "warm"), 3).frame(0, True)
    store = str(tmp_path / "store")
    build = _peak(lambda: PH.create_hdf5(str(tree), store, sequences=(0,),
                                         **kw))
    rec = _record_bytes(store, 0)
    order = np.random.default_rng(0).permutation(SEQS[0][0])

    def read():
        reader = PH.SequenceReader(store, 0)
        for i in order:
            reader.frame(int(i), cross_normals=True)

    read_peak = _peak(read)
    assert build < 3 * rec, (build, rec)
    assert read_peak < 3 * rec, (read_peak, rec)


def test_interrupted_build_leaves_the_sequence_unreadable(tree, tmp_path,
                                                          monkeypatch):
    store = tmp_path / "store"
    real = PH.build_frame_record
    calls = []

    def dies_in_sequence_3(*a, **kw):
        calls.append(1)
        if len(calls) == SEQS[0][0] + 2:        # seq 03's third frame
            raise RuntimeError("the build died")
        return real(*a, **kw)

    monkeypatch.setattr(PH, "build_frame_record", dies_in_sequence_3)
    with pytest.raises(RuntimeError, match="the build died"):
        PH.create_hdf5(str(tree), str(store), sequences=(0, 3),
                       progress=False)
    # seq 00 completed and reads whole; seq 03 is not there to read
    assert sorted(os.listdir(store)) == ["00"]
    assert PH.SequenceReader(str(store), 0).n_frames == SEQS[0][0]
    with pytest.raises(FileNotFoundError):
        PH.SequenceReader(str(store), 3)
    # a run that dies before cleaning up leaves only a temporary name
    (store / ".03.123.tmp").mkdir()
    with pytest.raises(FileNotFoundError):
        PH.SequenceReader(str(store), 3)
    # another build completes seq 03 beside seq 00
    monkeypatch.setattr(PH, "build_frame_record", real)
    PH.create_hdf5(str(tree), str(store), sequences=(3,), progress=False)
    assert PH.SequenceReader(str(store), 3).n_frames == SEQS[3][0]
    assert PH.SequenceReader(str(store), 0).n_frames == SEQS[0][0]
