"""The port's bench (rslo_tpu_torch/bench.py, the CLI's ``bench`` verb):
``bench_middle`` and ``bench_streaming`` on the CPU at the tiny test
config, and ``main``'s JSON line against the root bench.py's (JAX's)
for the same environment, both with their two bench functions stubbed
(JAX's bench is not run here: its compile is slow)."""
import dataclasses
import importlib.util
import json
import math
import os

import pytest

from torch_port_helpers import port_cfg, to_port

from rslo_tpu_torch import bench, cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny(middle="SparseMiddleCov"):
    cfg = port_cfg("bf16")
    return to_port(cfg.replace(
        data=dataclasses.replace(cfg.data, max_points=4096),
        middle=dataclasses.replace(cfg.middle, name=middle)))


@pytest.mark.parametrize("middle", ["SparseMiddleCov", "PillarMiddleCov"])
def test_bench_middle_runs_on_the_cpu(middle):
    fps = bench.bench_middle(middle, "rulebook", n_iter=2,
                             cfg=tiny(middle), device="cpu")
    assert math.isfinite(fps) and fps > 0


def test_bench_streaming_runs_on_the_cpu():
    fps = bench.bench_streaming("SparseMiddleCov", "rulebook", T=2,
                                n_iter=1, cfg=tiny(), device="cpu")
    assert math.isfinite(fps) and fps > 0


def test_rejected_plan_lookup_raises(monkeypatch):
    monkeypatch.setenv("RSLO_PLAN_LOOKUP", "hash")
    with pytest.raises(NotImplementedError, match="plan_lookup"):
        bench.bench_middle("SparseMiddleCov", "rulebook", n_iter=1,
                           cfg=tiny(), device="cpu")


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stub(fail_sparse, devices):
    def middle(name, engine, *a, **kw):
        devices.append(kw.get("device"))
        if fail_sparse and name == "SparseMiddleCov":
            raise RuntimeError("no sparse today")
        return 25.0 if name == "PillarMiddleCov" else 12.5

    def streaming(name, engine, *a, **kw):
        devices.append(kw.get("device"))
        return 40.0 if name == "PillarMiddleCov" else 20.0
    return middle, streaming


ENVS = {
    "default": ({}, False),
    "streaming": ({"RSLO_BENCH_STREAMING": "1"}, False),
    "sparse_only": ({"RSLO_BENCH_MIDDLE": "SparseMiddleCov",
                     "RSLO_BENCH_STREAMING": "1"}, False),
    "pillar_only": ({"RSLO_BENCH_MIDDLE": "PillarMiddleCov"}, False),
    "sparse_fails": ({"RSLO_BENCH_ENGINE": "band"}, True),
    "budget_spent": ({"RSLO_BENCH_BUDGET": "-1"}, False),
}


@pytest.mark.parametrize("name", list(ENVS))
def test_main_prints_jax_keys(name, monkeypatch, capsys):
    env, fail = ENVS[name]
    for k in ("RSLO_BENCH_MIDDLE", "RSLO_BENCH_ENGINE", "RSLO_BENCH_BUDGET",
              "RSLO_BENCH_STREAMING"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    lines, devices = {}, {"jax": [], "port": []}
    for who, mod in (("jax", _jax_bench()), ("port", bench)):
        middle, streaming = _stub(fail, devices[who])
        monkeypatch.setattr(mod, "bench_middle", middle)
        monkeypatch.setattr(mod, "bench_streaming", streaming)
        if who == "port":
            cli.main(["bench"])        # the verb, on the card by default
        else:
            mod.main()
        out = capsys.readouterr().out.strip().splitlines()
        lines[who] = json.loads(out[-1])
    assert set(devices["port"]) == {"cuda"}
    assert len(devices["port"]) == len(devices["jax"])
    assert list(lines["port"]) == list(lines["jax"])
    for k, v in lines["jax"].items():
        if k == "sparse_skipped":
            assert lines["port"][k].split(":")[0] == v.split(":")[0]
        else:
            assert lines["port"][k] == v, k
