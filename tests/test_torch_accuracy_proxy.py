"""The port's accuracy proxy (``scripts/torch_accuracy_proxy.py``)
against the JAX package's (``scripts/accuracy_proxy.py``, loaded as it
is through importlib with ``RSLO_PROXY_SEQSET`` and ``RSLO_PROXY_ROOT``
set for it): the sequences and configs, the argv each stage hands its
package's ``cli.main`` (recorded by a stand-in), the report's text, and
a tiny build -> train -> eval -> report on the CPU without h5py.  The
port's script keeps its store in a directory store (``STORE``) where
JAX's writes ``proxy.h5`` (``H5``): the configs and argv differ in that
path alone.  Its build stage's store is held byte for byte against
JAX's in tests/test_torch_store.py."""
import dataclasses
import functools
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest

from torch_port_helpers import port_cfg, to_port

import rslo_tpu.cli as jax_cli
import rslo_tpu_torch.cli as port_cli
from rslo_tpu.config.schema import PipelineCfg as JaxPipelineCfg
from rslo_tpu_torch.utils import world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQSETS = (None, "v4")
TINY_WORLD = dict(extent=10.0, n_walls=30, n_boxes=12, n_cyl=14,
                  corridor=2.5)


def _load(which, root, seqset, monkeypatch):
    """JAX's script ("jax") or the port's ("port") as a fresh module,
    with its root and seqset set."""
    monkeypatch.setenv("RSLO_PROXY_ROOT", str(root))
    if seqset is None:
        monkeypatch.delenv("RSLO_PROXY_SEQSET", raising=False)
    else:
        monkeypatch.setenv("RSLO_PROXY_SEQSET", seqset)
    name = {"jax": "accuracy_proxy", "port": "torch_accuracy_proxy"}[which]
    spec = importlib.util.spec_from_file_location(
        f"_{name}_{seqset}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def pair(tmp_path, monkeypatch):
    """(jax script, port script, their roots) for a seqset."""
    def make(seqset=None):
        roots = tmp_path / "jax", tmp_path / "port"
        for r in roots:
            r.mkdir(exist_ok=True)
        jax_mod = _load("jax", roots[0], seqset, monkeypatch)
        port_mod = _load("port", roots[1], seqset, monkeypatch)
        return jax_mod, port_mod, roots
    return make


# -- (a) sequences and the base config -------------------------------------

@pytest.mark.parametrize("seqset", SEQSETS)
def test_sequences_match_jax(pair, seqset):
    jax_mod, port_mod, _ = pair(seqset)
    assert port_mod.SEQS == jax_mod.SEQS
    assert port_mod.TRAIN_SEQS == jax_mod.TRAIN_SEQS
    assert port_mod.VAL_SEQS == jax_mod.VAL_SEQS
    assert len(port_mod.SEQS) == (5 if seqset == "v4" else 3)


@pytest.mark.parametrize("steps", [100, 3000, 25000])
@pytest.mark.parametrize("middle", ["PillarMiddleCov", "SparseMiddleCov"])
@pytest.mark.parametrize("seqset", SEQSETS)
def test_base_cfg_matches_jax(pair, tmp_path, monkeypatch, seqset, middle,
                              steps):
    jax_mod, port_mod, roots = pair(seqset)
    # one root, so the store paths differ only in their names
    port_mod = _load("port", roots[0], seqset, monkeypatch)
    want = to_port(jax_mod.base_cfg(middle, steps)).to_json()
    assert port_mod.STORE.parent == jax_mod.H5.parent
    assert _jax_text(port_mod.base_cfg(middle, steps).to_json(), jax_mod,
                     port_mod, roots) == want


# -- (b) the argv of each stage -------------------------------------------

def _recorders(monkeypatch, roots):
    """Stand-ins for both packages' ``cli.main``; an ``evaluate`` call
    writes an eval_results.json into its model dir."""
    seen = {"jax": [], "port": []}

    def recorder(which):
        def main(argv):
            seen[which].append(list(argv))
            if argv[0] == "evaluate":
                mdir = argv[argv.index("--model_dir") + 1]
                os.makedirs(mdir, exist_ok=True)
                with open(os.path.join(mdir, "eval_results.json"), "w") as f:
                    json.dump({"avg": {"t_rel_pct": 1.0}, "argv": argv}, f)
        return main

    monkeypatch.setattr(jax_cli, "main", recorder("jax"))
    monkeypatch.setattr(port_cli, "main", recorder("port"))
    return seen


def _run_both(jax_mod, port_mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["accuracy_proxy.py", *argv])
    jax_mod.main()
    port_mod.main(argv)


def _jax_text(text, jax_mod, port_mod, roots):
    """``text`` of the port's script with its store replaced by JAX's
    and its root by JAX's."""
    return text.replace(str(port_mod.STORE), str(jax_mod.H5)).replace(
        str(roots[1]), str(roots[0]))


def _as_jax(argv, roots, jax_mod, port_mod):
    """The port's argv in JAX's paths (``_jax_text``) with its
    ``--device`` taken off (it must be the last two entries)."""
    assert argv[-2:] in (["--device", "cpu"], ["--device", "cuda"])
    return [_jax_text(a, jax_mod, port_mod, roots) for a in argv[:-2]]


TRAIN_VARIANTS = [
    [],
    ["--no_aug"],
    ["--no_quantize"],
    ["--engine", "band"],
    ["--engine", "tiles", "--middle", "SparseMiddleCov"],
    ["--remat", "0"],
    ["--remat", "1"],
    ["--steps_per_eval", "1500"],
    ["--steps", "25000", "--remat", "0", "--tag", "r5b",
     "--steps_per_eval", "1500", "--leg_until", "3000"],
    ["--supervised", "--middle", "SparseMiddleCov", "--steps", "500"],
    ["--init_from", "/runs/pillar", "--tag", "warm"],
]


@pytest.mark.parametrize("seqset", SEQSETS)
@pytest.mark.parametrize("variant", TRAIN_VARIANTS,
                         ids=lambda v: "_".join(v).strip("-") or "default")
def test_train_stage_matches_jax(pair, monkeypatch, seqset, variant):
    jax_mod, port_mod, roots = pair(seqset)
    seen = _recorders(monkeypatch, roots)
    _run_both(jax_mod, port_mod, ["train", *variant], monkeypatch)
    (jax_argv,), (port_argv,) = seen["jax"], seen["port"]
    assert port_argv[-2:] == ["--device", "cuda"]   # the default
    assert _as_jax(port_argv, roots, jax_mod, port_mod) == jax_argv
    cfg_path = jax_argv[jax_argv.index("--config") + 1]
    jax_cfg = JaxPipelineCfg.from_json(open(cfg_path).read())
    port_text = open(port_argv[port_argv.index("--config") + 1]).read()
    # the config files differ only in the store path
    assert _jax_text(port_text, jax_mod, port_mod, roots) == \
        to_port(jax_cfg).to_json()


EVAL_VARIANTS = [
    [],
    ["--refine"],
    ["--refine_loops"],
    ["--refine_ba"],
    ["--max_windows", "64"],
    ["--ckpt_step", "best", "--tag", "r5b", "--refine", "--refine_loops"],
    ["--ckpt_step", "1500", "--tag", "r5b"],
    ["--engine", "band", "--middle", "SparseMiddleCov"],
    ["--supervised"],
]


@pytest.mark.parametrize("variant", EVAL_VARIANTS,
                         ids=lambda v: "_".join(v).strip("-") or "default")
def test_eval_stage_matches_jax(pair, monkeypatch, variant):
    jax_mod, port_mod, roots = pair("v4")
    seen = _recorders(monkeypatch, roots)
    _run_both(jax_mod, port_mod, ["eval", *variant], monkeypatch)
    (jax_argv,), (port_argv,) = seen["jax"], seen["port"]
    assert _as_jax(port_argv, roots, jax_mod, port_mod) == jax_argv
    jax_cfg = JaxPipelineCfg.from_json(
        open(jax_argv[jax_argv.index("--config") + 1]).read())
    port_text = open(port_argv[port_argv.index("--config") + 1]).read()
    assert _jax_text(port_text, jax_mod, port_mod, roots) == \
        to_port(jax_cfg).to_json()
    # the same result file, holding what the verb wrote
    got = sorted(p.name for p in roots[1].glob("result_*.json"))
    assert got == sorted(p.name for p in roots[0].glob("result_*.json"))
    assert len(got) == 1
    res = json.loads((roots[1] / got[0]).read_text())
    assert res["argv"] == port_argv


@pytest.mark.parametrize("seqs", [None, "0,7"])
def test_build_store_stage_matches_jax(pair, monkeypatch, seqs):
    jax_mod, port_mod, roots = pair()
    seen = _recorders(monkeypatch, roots)
    argv = ["build", "--h5_only"] + ([] if seqs is None else
                                     ["--seqs", seqs])
    _run_both(jax_mod, port_mod, argv, monkeypatch)
    (jax_argv,), (port_argv,) = seen["jax"], seen["port"]
    assert port_argv[0] == "create_hdf5"
    # the same verb and sequences; the port's --out a directory store
    out = port_argv[port_argv.index("--out") + 1]
    assert out == str(port_mod.STORE) and not out.endswith(".h5")
    assert [_jax_text(a, jax_mod, port_mod, roots) for a in port_argv] \
        == jax_argv


def test_stages_hand_the_device_on(pair, monkeypatch):
    _, port_mod, _ = pair()
    seen = _recorders(monkeypatch, None)
    port_mod.main(["train", "--device", "cpu"])
    port_mod.main(["eval", "--refine_loops", "--device", "cpu"])
    assert [a[-2:] for a in seen["port"]] == [["--device", "cpu"]] * 2


# -- (c) the report --------------------------------------------------------

def _report(mod, capsys):
    capsys.readouterr()
    mod.cmd_report(None)
    return capsys.readouterr().out


def test_report_matches_jax(pair, capsys):
    jax_mod, port_mod, roots = pair()
    results = os.path.join(REPO, "results")
    names = sorted(n for n in os.listdir(results)
                   if n.startswith("result_") and n.endswith(".json"))
    assert "result_PillarMiddleCov_r5b_sbest_refine_loops.json" in names
    avg = {"_meta": {"windows": 499},
           "seq_07": {"t_rel_pct": 50.0},
           "avg": {"t_rel_pct": 61.25, "r_rel_deg_per_100m": None,
                   "ate_rmse_m": 12.3456}}
    for root in roots:
        for n in names:
            shutil.copy(os.path.join(results, n), root / n)
        (root / "result_SparseMiddleCov_avg.json").write_text(
            json.dumps(avg))
    jax_out, port_out = _report(jax_mod, capsys), _report(port_mod, capsys)
    assert port_out == jax_out
    lines = port_out.splitlines()
    # the avg layout, a missing value printed as "-"
    assert lines[-1].split() == ["SparseMiddleCov_avg", "61.250", "-",
                                 "12.346"]
    # the refined layout reproduces the committed r5b rows
    with open(os.path.join(results, "proxy_report_r5b.txt")) as f:
        want = [ln for ln in f.read().splitlines()
                if ln.startswith("PillarMiddleCov_r5b_sbest_refine_loops:")]
    got = [ln for ln in lines
           if ln.startswith("PillarMiddleCov_r5b_sbest_refine_loops:")]
    assert len(want) == 3 and got == want


# -- (d) build -> train -> eval -> report on the CPU -----------------------

def _tiny(base_cfg):
    """``base_cfg`` at the tiny test model and 4096 points a scan."""
    tiny = to_port(port_cfg("bf16"))

    def cfg(middle, steps):
        c = base_cfg(middle, steps)
        return c.replace(
            voxelizer=tiny.voxelizer, odom=tiny.odom,
            middle=dataclasses.replace(tiny.middle, name=c.middle.name),
            data=dataclasses.replace(c.data, max_points=4096),
            loss=dataclasses.replace(
                c.loss, max_loss_points=tiny.loss.max_loss_points))
    return cfg


def _keys(x):
    """The nested key structure of a result, leaves and the per-length
    and per-speed tables left out."""
    if not isinstance(x, dict):
        return None
    return {k: _keys(v) for k, v in x.items()
            if k not in ("segments", "speed_bins")}


def test_tiny_proxy_end_to_end(pair, monkeypatch, capsys):
    _, port_mod, roots = pair()
    # as on the card's machine: no h5py
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setattr(port_mod, "SEQS", {0: (6, "curve", 3.0),
                                           7: (6, "loop", 3.0)})
    monkeypatch.setattr(port_mod, "TRAIN_SEQS", (0,))
    monkeypatch.setattr(port_mod, "base_cfg", _tiny(port_mod.base_cfg))
    monkeypatch.setattr(world, "write_kitti_tree", functools.partial(
        world.write_kitti_tree, n_beams=16, n_azimuth=512,
        world_kwargs=TINY_WORLD))
    # one build a sequence, into the one directory store
    port_mod.main(["build", "--seqs", "0"])
    port_mod.main(["build", "--seqs", "7"])
    assert sorted(os.listdir(port_mod.STORE)) == ["00", "07"]
    state = port_mod.main(["train", "--steps", "2", "--steps_per_eval",
                           "2", "--device", "cpu"])
    assert state.step == 2
    mdir = roots[1] / "model_PillarMiddleCov"
    log = [json.loads(ln) for ln in open(mdir / "log.json.lst")]
    assert all(np.isfinite(r["t_err_gt"]) for r in log if "t_err_gt" in r)
    assert any("eval/ate_rmse_m" in r for r in log)
    assert (mdir / "best_ckpt.json").exists()
    plain = port_mod.main(["eval", "--device", "cpu"])
    loops = port_mod.main(["eval", "--ckpt_step", "best", "--refine_loops",
                           "--device", "cpu"])
    assert sys.modules["h5py"] is None
    assert plain["_meta"]["windows"] == 5 and loops["_meta"]["windows"] == 4
    assert set(plain) == {"_meta", "seq_07", "avg"}
    for k in ("ate_rmse_m", "frame_t_err_m", "frame_q_err_deg"):
        assert np.isfinite(plain["avg"][k]), k
    with open(os.path.join(REPO, "results",
                           "result_PillarMiddleCov_r5b_sbest_refine_loops."
                           "json")) as f:
        want = json.load(f)
    assert _keys(loops) == _keys(want)
    for mode in ("chained", "refined", "loop_closed"):
        assert np.isfinite(loops["seq_07"][mode]["ate_rmse_m"])
    out = _report(port_mod, capsys).splitlines()
    assert [ln.split()[0] for ln in out[1:]] == [
        "PillarMiddleCov", "PillarMiddleCov_sbest_loops:chained",
        "PillarMiddleCov_sbest_loops:refined",
        "PillarMiddleCov_sbest_loops:loop_closed"]
