"""The port's data-parallel scaling harness (``scripts/
torch_scaling_bench.py``) against the JAX package's
(``scripts/scaling_bench.py``, loaded as it is through importlib) on the
CPU: the same configuration and batch, and from JAX's initial weights
(captured as JAX's ``bench`` makes them, converted) the same loss, at
world 1 and 2.  JAX runs its one- and two-device meshes on the virtual
CPU devices; the port's world 2 is two gloo ranks in their own
processes, each on the same batch, so its losses equal its world 1's.

The losses are compared in f32 (the configuration with f32 convs and BEV
net, else the script's): in bf16 the forwards differ by bf16 roundings,
which train-mode BN over the tiny BEV amplifies to ~1% of the loss.  The
warm-up step's loss (from the same weights) is held to the train step's
LOSS_TOL.  The timed step's loss follows one Adam step, whose gradient
through that BN is ill-conditioned in both frameworks (f32 rounding
moves ``grad_norm`` by ~0.1%, tests/test_torch_dp_train.py and ROADMAP
C): it is held to the port's own world 1, bit for bit."""
import dataclasses
import functools
import importlib.util
import os
import sys

import numpy as np
import pytest

from torch_port_helpers import to_port
from test_torch_train_step import LOSS_TOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def f32(cfg):
    return cfg.replace(
        middle=dataclasses.replace(cfg.middle, conv_dtype="f32"),
        odom=dataclasses.replace(cfg.odom, compute_dtype="fp32"))


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's ``bench(world, n_steps=1)`` for world 1 and 2 in f32, with
    the config, the synthetic frames, the initial variables and the
    warm-up step's loss of each."""
    mod = _load("scaling_bench")
    seen = {"cfg": [], "frames": [], "variables": [], "first": []}
    net_cls, state_cls, synth = mod.OdomNet, mod.TrainState, mod.synth_sequence
    make_step = mod.make_train_step

    def odom_net(cfg):
        seen["cfg"].append(cfg)
        return net_cls(cfg)

    class State:
        @staticmethod
        def create(variables, tx, alphas):
            # numpy copies: the step donates the state's buffers
            seen["variables"].append(_numpy_tree(variables))
            return state_cls.create(variables, tx, alphas)

    def synth_sequence(**kw):
        out = synth(**kw)
        seen["frames"].append((kw, out))
        return out

    def make_train_step(*a, **kw):
        step = make_step(*a, **kw)

        def recorded(state, batch):
            out = step(state, batch)
            if len(seen["first"]) < len(seen["cfg"]):
                seen["first"].append(float(out[1]["loss"]))
            return out
        return recorded

    mod.OdomNet, mod.TrainState, mod.synth_sequence = \
        odom_net, State, synth_sequence
    mod.make_train_step = make_train_step
    mod.MiddleCfg = functools.partial(mod.MiddleCfg, conv_dtype="f32")
    mod.OdomCfg = functools.partial(mod.OdomCfg, compute_dtype="fp32")
    losses = {n: mod.bench(n, n_steps=1)[1] for n in (1, 2)}
    return mod, seen, losses


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def test_config_and_batch_match_jax(jax_runs):
    _, seen, _ = jax_runs
    port = _load("torch_scaling_bench")
    assert len(seen["cfg"]) == 2
    for cfg in seen["cfg"]:
        assert f32(port.bench_cfg()).to_json() == to_port(cfg).to_json()
    # the script's own config: bf16, as JAX's
    assert port.bench_cfg().middle.conv_dtype == "bf16"
    assert port.bench_cfg().odom.compute_dtype == "bf16"
    batch = port.bench_batch()
    for kw, (frames, gts) in seen["frames"]:
        assert kw == dict(seed=0, n_frames=2, n_points=port.N_POINTS)
        np.testing.assert_array_equal(batch["points"], np.stack(frames))
        np.testing.assert_array_equal(batch["odometry"], gts[:1])
    assert batch["point_mask"].shape == (2, port.N_POINTS)
    assert batch["point_mask"].all()


def test_losses_match_jax(jax_runs):
    _, seen, jax_losses = jax_runs
    port = _load("torch_scaling_bench")
    # both of JAX's runs start from the same seeded init
    variables = seen["variables"][0]
    cfg = f32(port.bench_cfg())
    got = {n: port.bench(n, n_steps=1, device="cpu", variables=variables,
                         cfg=cfg) for n in (1, 2)}
    assert got[1]["backend"] is None and got[2]["backend"] == "gloo"
    for n, want in zip((1, 2), seen["first"]):
        assert np.isfinite(got[n]["loss"]) and got[n]["dt"] > 0
        np.testing.assert_allclose(got[n]["first_loss"], want,
                                   err_msg=f"world {n}", **LOSS_TOL)
        assert np.isfinite(jax_losses[n])
    # every rank has the same batch: the mean over ranks is world 1's
    assert got[2]["first_loss"] == got[1]["first_loss"]
    assert got[2]["loss"] == got[1]["loss"]
    # the pillar middle launches no sparse kernel; on the CPU nothing
    # is launched at all (the plain versions run)
    assert set(got[2]["launches"].values()) == {0}


def test_main_prints_jax_lines(capsys, monkeypatch):
    """The printed line of each world size: JAX's, with the backend."""
    port = _load("torch_scaling_bench")
    monkeypatch.setattr(port, "bench", lambda n, n_steps, device: {
        "dt": 0.1 * n, "first_loss": 2.0, "loss": 1.25, "backend": port.backend_for(n, device),
        "launches": {}})
    port.main([1, 2], device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out == [
        "devices=1: 100.0 ms/step (samples/s 10.00, efficiency 100%) "
        "loss=1.250 backend=none",
        "devices=2: 200.0 ms/step (samples/s 10.00, efficiency 50%) "
        "loss=1.250 backend=gloo"]
    assert port.backend_for(1, "cuda") is None
    monkeypatch.setattr(sys.modules["torch"].cuda, "device_count",
                        lambda: 1)
    assert port.backend_for(2, "cuda") == "gloo"
    monkeypatch.setattr(sys.modules["torch"].cuda, "device_count",
                        lambda: 4)
    assert port.backend_for(2, "cuda") == "nccl"
    assert port.backend_for(8, "cuda") == "gloo"
