"""The port's eval scripts against the JAX package's, on the CPU:
``scripts/torch_eval_trend.py`` against ``scripts/eval_trend.py`` (the
same table, bit for bit, from the same ``log.json.lst`` and from a tiny
port proxy run's), and ``scripts/torch_eval_gen_world.py`` against
``scripts/eval_gen_world.sh`` (the stages' argv, the world-seed-1 store
against the one JAX's proxy builds for it, and the stages end to end on
the tiny run's checkpoint).  The tiny proxy run is
tests/test_torch_accuracy_proxy.py's: the raycast world at 16 x 512
beams, the tiny model at 4096 points, no h5py."""
import functools
import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest

from test_torch_accuracy_proxy import TINY_WORLD, _tiny

import rslo_tpu.cli as jax_cli
import rslo_tpu.utils.world as jax_world
from rslo_tpu_torch.data.hdf5_store import SequenceReader
from rslo_tpu_torch.utils import world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TRAIN_SEQS = {0: (6, "curve", 3.0), 7: (6, "loop", 3.0)}
GEN_FRAMES = 5
EVAL_KEYS = ("t_rel", "r_rel", "ate", "frame_t_err", "frame_q_err")


def _load(name, **env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        spec = importlib.util.spec_from_file_location(
            f"_{name}", os.path.join(SCRIPTS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    return mod


def tiny_proxy(proxy, seqs):
    """A proxy module at the tiny model, its sequences ``seqs``."""
    proxy.SEQS = dict(seqs)
    proxy.TRAIN_SEQS = tuple(s for s in seqs if s != 7)
    proxy.base_cfg = _tiny(proxy.base_cfg)
    return proxy


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A tiny proxy run of the pillar middle (tag ``aug``, 2 steps, an
    eval every step) under a root of its own; (root, model dir)."""
    root = tmp_path_factory.mktemp("trend")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "h5py", None)
        mp.setattr(world, "write_kitti_tree", functools.partial(
            world.write_kitti_tree, n_beams=16, n_azimuth=512,
            world_kwargs=TINY_WORLD))
        proxy = tiny_proxy(_load("torch_accuracy_proxy",
                                 RSLO_PROXY_ROOT=root), TRAIN_SEQS)
        proxy.main(["build"])
        proxy.main(["train", "--steps", "2", "--steps_per_eval", "1",
                    "--tag", "aug", "--device", "cpu"])
    return root, root / "model_PillarMiddleCov_aug"


# -- eval_trend ------------------------------------------------------------------

def _trend(mod, dirs, capsys):
    capsys.readouterr()
    mod.main([str(d) for d in dirs])
    return capsys.readouterr().out


def test_eval_trend_matches_jax_on_a_log(tmp_path, capsys):
    """Rows with and without eval keys, a broken line, a missing metric
    (printed nan), a missing step, and a dir without a log."""
    mdir = tmp_path / "model_X"
    mdir.mkdir()
    rows = [{"step": 50, "loss": 1.0, "t_err_gt": 0.5},
            {"step": 100, "eval/t_rel_pct": 61.25,
             "eval/r_rel_deg_per_100m": 108.5, "eval/ate_rmse_m": 12.3456,
             "eval/frame_t_err_m": 0.0345, "eval/frame_q_err_deg": 0.75},
            {"eval/t_rel_pct": 1.0, "eval/ate_rmse_m": 2.0}]
    lines = [json.dumps(r) for r in rows]
    lines.insert(1, "{not json")
    (mdir / "log.json.lst").write_text("\n".join(lines) + "\n")
    jax_mod, port_mod = _load("eval_trend"), _load("torch_eval_trend")
    dirs = [mdir, tmp_path / "model_missing"]
    got, want = _trend(port_mod, dirs, capsys), _trend(jax_mod, dirs, capsys)
    assert got == want
    table = got.splitlines()
    assert table[0] == "== model_X" and table[-2] == "== model_missing"
    assert [ln.split()[0] for ln in table[2:4]] == ["100", "-1"]
    assert "nan" in table[3]


def test_eval_trend_reads_the_port_logger(tiny_run, capsys):
    """The port's logger writes the eval hook's rows with keys holding
    each metric the table reads; the table is JAX's, a row a hook
    eval."""
    _, mdir = tiny_run
    log = [json.loads(ln) for ln in open(mdir / "log.json.lst")]
    evals = [r for r in log if any("t_rel" in k for k in r)]
    assert [r["step"] for r in evals] == [1, 2]
    for r in evals:
        for key in EVAL_KEYS:
            assert any(key in k for k in r), (key, sorted(r))
    jax_mod, port_mod = _load("eval_trend"), _load("torch_eval_trend")
    got = _trend(port_mod, [mdir], capsys)
    assert got == _trend(jax_mod, [mdir], capsys)
    table = got.splitlines()[2:]
    assert [int(ln.split()[0]) for ln in table] == [1, 2]
    assert all(np.isfinite(float(v)) for ln in table for v in ln.split())


# -- eval_gen_world ------------------------------------------------------------------

def _jax_argv():
    """The stages of scripts/eval_gen_world.sh: its header's build command
    and its eval and report lines, with the defaults substituted."""
    text = open(os.path.join(SCRIPTS, "eval_gen_world.sh")).read()
    build = re.search(r"accuracy_proxy\.py (build [^(\n]*?)\s*\(", text)
    evals = re.findall(r"accuracy_proxy\.py\s+(eval|report)(.*?)\n",
                       text.replace("\\\n", " "))
    sub = {'"$MIDDLE"': "PillarMiddleCov", '"$CKPT"': "best"}
    out = [build.group(1).split()]
    for verb, rest in evals:
        out.append([verb] + [sub.get(a, a) for a in rest.split()])
    return out


def test_gen_world_stages_match_jax(tmp_path, monkeypatch):
    """The argv of each stage: JAX's, with the port's --device added."""
    twin = _load("torch_eval_gen_world")
    seen = []
    load = twin.load_proxy

    def recording(root):
        proxy = load(root)
        proxy.main = lambda argv: seen.append((str(proxy.ROOT), argv))
        return proxy

    monkeypatch.setattr(twin, "load_proxy", recording)
    train_root = tmp_path / "train"
    (train_root / "model_PillarMiddleCov_aug").mkdir(parents=True)
    twin.main(train_root=train_root, gen_root=tmp_path / "gen")
    want = _jax_argv()
    assert want[0] == ["build", "--seqs", "7", "--world_seed", "1"]
    assert [argv for _, argv in seen] == [
        want[0], want[1] + ["--device", "cuda"], want[2]]
    assert {root for root, _ in seen} == {str(tmp_path / "gen")}
    assert (tmp_path / "gen" / "model_PillarMiddleCov_aug").is_dir()
    # the defaults are JAX's: PillarMiddleCov, best, tag aug
    assert want[1] == ["eval", "--middle", "PillarMiddleCov", "--tag",
                       "aug", "--ckpt_step", "best"]


def test_gen_world_store_matches_jax(tmp_path, monkeypatch):
    """The twin's build stage stores what JAX's proxy builds for world
    seed 1 (``build --seqs 7 --world_seed 1``, then its store of seq 7),
    frame for frame, with the same ground-truth poses."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    kw = dict(n_beams=16, n_azimuth=512, world_kwargs=TINY_WORLD)
    monkeypatch.setattr(world, "write_kitti_tree", functools.partial(
        world.write_kitti_tree, **kw))
    twin = _load("torch_eval_gen_world")
    load = twin.load_proxy
    seqs = {7: (GEN_FRAMES, "loop", 3.0)}
    monkeypatch.setattr(twin, "load_proxy",
                        lambda root: tiny_proxy(load(root), seqs))
    gen = tmp_path / "gen"
    assert twin.build(gen) == ["build", "--seqs", "7", "--world_seed", "1"]
    assert twin.build(gen) is None          # the store holds seq 7
    monkeypatch.delitem(sys.modules, "h5py")
    jroot = tmp_path / "jax"
    jax_proxy = _load("accuracy_proxy", RSLO_PROXY_ROOT=jroot)
    jax_proxy.SEQS = seqs
    monkeypatch.setattr(jax_world, "write_kitti_tree", functools.partial(
        jax_world.write_kitti_tree, **kw))
    monkeypatch.setattr(sys, "argv", ["accuracy_proxy.py", "build", "--seqs",
                                      "7", "--world_seed", "1"])
    jax_proxy.main()
    jax_cli.main(["create_hdf5", "--kitti_root", str(jroot / "kitti_tree"),
                  "--out", str(jroot / "proxy.h5"), "--sequences", "7"])
    got = SequenceReader(str(gen / "proxy_store"), 7)
    want = SequenceReader(str(jroot / "proxy.h5"), 7)
    assert got.n_frames == want.n_frames == GEN_FRAMES
    for i in range(GEN_FRAMES):
        g, w = got.frame(i), want.frame(i)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    g, w = (np.load(r / "gt_poses_7.npz") for r in (gen, jroot))
    np.testing.assert_array_equal(g["seq7"], w["seq7"])


def test_gen_world_end_to_end(tiny_run, tmp_path, monkeypatch):
    """Build, copy and evaluate the tiny run's best step on world 1's seq
    7: JAX's result keys, finite metrics, and the report's row."""
    train_root, _ = tiny_run
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setattr(world, "write_kitti_tree", functools.partial(
        world.write_kitti_tree, n_beams=16, n_azimuth=512,
        world_kwargs=TINY_WORLD))
    twin = _load("torch_eval_gen_world")
    load = twin.load_proxy
    monkeypatch.setattr(twin, "load_proxy", lambda root: tiny_proxy(
        load(root), {7: (GEN_FRAMES, "loop", 3.0)}))
    res, rows, argv = twin.main("PillarMiddleCov", "best", "aug",
                                train_root, tmp_path / "gen", "cpu")
    assert argv[0][-2:] == ["--device", "cpu"]
    assert set(res) == {"_meta", "seq_07", "avg"}
    assert res["_meta"]["windows"] == GEN_FRAMES - 1
    for k in ("t_rel_pct", "r_rel_deg_per_100m", "ate_rmse_m"):
        assert np.isfinite(res["avg"][k]), k
    assert [r[0] for r in rows] == ["PillarMiddleCov_aug_sbest"]
    best = json.loads((tmp_path / "gen" / "model_PillarMiddleCov_aug" /
                       "best_ckpt.json").read_text())
    assert best["step"] in (1, 2)
