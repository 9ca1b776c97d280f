"""Rank-sharded evaluation of the PyTorch port (eval/runner.py over a
data mesh) against one process, on the CPU.

Two gloo ranks (tests/torch_dist_workers.py) evaluate the synthetic
splits at the tiny config with the seeded initial net: step i runs
windows i and i+1, one a rank (the last step of an odd count runs the
last window on both, as JAX's clamped device batch does), and the
ranks' results are gathered.  ``run_eval``, ``run_eval_refined`` with
covariance BA on each rank's own windows, and ``run_eval_refined`` with
loop closing over the gathered clouds return, on both ranks, exactly
the per-sequence metrics of one process (every value bit-equal; the
clocks in ``_meta`` aside)."""
import dataclasses

import numpy as np
import pytest

from torch_dist_workers import eval_runs, run_ranks
from torch_port_helpers import port_cfg, to_port

RUNS = (("plain", "plain", 5, {}),
        ("refine_ba", "refined", 3, dict(use_ba=True)),
        # every window is a scene of its own, so a low threshold makes
        # loop candidates (tests/test_torch_eval_refined.py)
        ("refine_loops", "refined", 5,
         dict(use_loops=True, loop_min_separation=2, loop_points=512,
              loop_score_threshold=0.3)))
CLOCKS = ("elapsed_s", "frames_per_s")


def _cfg():
    cfg = port_cfg("f32")
    return to_port(cfg.replace(
        data=dataclasses.replace(cfg.data, max_points=4096)))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cfg = _cfg()
    root = tmp_path_factory.mktemp("dp_eval")
    one = eval_runs(cfg, str(root / "one"), RUNS)
    two = run_ranks("evaluate", root, cfg_json=cfg.to_json(),
                    model_dir=str(root), runs=RUNS)
    return one, two


def _same(got, want, path):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            if k not in CLOCKS:
                _same(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_two_ranks_equal_one_process(results, name):
    one, two = results
    assert any(k.startswith("seq_") for k in one[name])
    for rank in range(2):
        _same(two[rank][name], one[name], f"rank {rank} {name}")


def test_loop_closing_ran(results):
    """The loop run closed loops: ICP on the gathered clouds."""
    one, _ = results
    seqs = [v for k, v in one["refine_loops"].items()
            if k.startswith("seq_")]
    assert seqs and all("loop_closed" in v for v in seqs)
    assert sum(v["n_loops"] for v in seqs) > 0
