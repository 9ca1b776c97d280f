"""The port's exponential-decay-with-warmup and manual-stepping
schedules (rslo_tpu_torch/train/optim.py) against the JAX package's at
the steps around their boundaries and warmup (f32; bit-equal on the
CPU, held to one f32 ulp's relative size), and the port's section
timer and profiler trace (rslo_tpu_torch/utils/timing.py)."""
import os

import numpy as np
import pytest
import torch

from rslo_tpu.train import optim as joptim
from rslo_tpu_torch.train import optim
from rslo_tpu_torch.utils.timing import (SectionTimer, block_until_ready,
                                         profile_trace)

SCHED_TOL = dict(rtol=2 ** -23, atol=0)


@pytest.mark.parametrize("staircase, warmup", [(True, 0), (True, 50),
                                               (False, 50), (False, 0)])
def test_exponential_decay_warmup_matches_jax(staircase, warmup):
    args = (3e-3, 100, 0.8, warmup, staircase)
    want = joptim.exponential_decay_warmup(*args)
    got = optim.exponential_decay_warmup(*args)
    for step in (0, 1, 25, 49, 50, 51, 99, 100, 101, 199, 200, 250, 1000):
        np.testing.assert_allclose(float(got(step)), float(want(step)),
                                   err_msg=f"step {step}", **SCHED_TOL)
        assert got(step).dtype == torch.float32


def test_manual_stepping_matches_jax():
    boundaries, rates = (10, 20, 40), (1e-3, 5e-4, 1e-4, 3e-5)
    want = joptim.manual_stepping(boundaries, rates)
    got = optim.manual_stepping(boundaries, rates)
    for step in (0, 9, 10, 11, 19, 20, 21, 39, 40, 41, 1000):
        np.testing.assert_allclose(float(got(step)), float(want(step)),
                                   err_msg=f"step {step}", **SCHED_TOL)


def test_section_timer_counts_and_averages():
    t = SectionTimer()
    x = torch.ones(3)
    for _ in range(3):
        with t.section("a", sync_value={"x": [x, (x,)]}):
            pass
    with t.section("b"):
        pass
    assert dict(t.count) == {"a": 3, "b": 1}
    assert set(t.avg_ms()) == {"a", "b"}
    assert all(v >= 0 for v in t.avg_ms().values())
    assert t.report().startswith("a: ") and " | b: " in t.report()
    off = SectionTimer(enabled=False)
    with off.section("a"):
        pass
    assert not off.count and not off.total
    assert block_until_ready(x) is x


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path)):
        torch.ones(64) @ torch.ones(64)
    files = os.listdir(tmp_path)
    assert any(f.endswith(".pt.trace.json") for f in files), files
    with profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
