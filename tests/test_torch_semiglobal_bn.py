"""Port SemiGlobalSyncBN (rslo_tpu_torch.models.semiglobal_bn) against
the JAX package: the train-mode outputs and all eight statistics over
three train calls on different inputs, then the eval output; its
initial values through ``OdomNet.reset_parameters``; and a warm start
with ``--pretrained_include bev_net`` carrying every statistic of a
semi-global BEV net."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import np_, port_cfg, to_port, tt

from rslo_tpu.models.semiglobal_bn import SemiGlobalSyncBN as JaxSGBN
from rslo_tpu_torch.convert import flax_path, load_flax_variables
from rslo_tpu_torch.models.net import OdomNet
from rslo_tpu_torch.models.semiglobal_bn import STATS, SemiGlobalSyncBN
from rslo_tpu_torch.train.loop import Trainer

# f32 moments summed in other orders (~1e-7 relative), which the
# dynamic momenta and the running statistics carry over three calls:
# statistics to 1e-5, outputs (up to ~5) as tests/test_torch_bev_net.py
# holds f32 maps; bf16 outputs to 2 ulps
STAT_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}


def _inputs(dtype, C=6):
    """Three (2, 5, 7, C) batches whose moments move between calls,
    with a constant channel (var 0) and a zero channel (its mean probe
    stays exactly 0, so the divide guard acts at every call; every
    channel's mean probe starts at 0, so it acts at the first call)."""
    rng = np.random.default_rng(3)
    xs = []
    for k in range(3):
        x = rng.normal(2.0 + k, 1.0 + 0.5 * k, size=(2, 5, 7, C))
        x[..., 0] = 1.5
        x[..., 1] = 0.0
        xs.append(x.astype(np.float32))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return xs, jdt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum", [0.1, 0.5])
def test_three_train_calls_then_eval_match_jax(momentum, dtype):
    xs, jdt = _inputs(dtype)
    jmod = JaxSGBN(momentum=momentum, sync=False)
    variables = jax.jit(lambda k, a: jmod.init(k, a, train=True))(
        jax.random.PRNGKey(0), jnp.asarray(xs[0], jdt))
    params = jax.tree.map(np.array, variables["params"])
    params["scale"] *= np.linspace(0.5, 1.5, 6, dtype=np.float32)
    params["bias"] += np.linspace(-1, 1, 6, dtype=np.float32)
    stats = variables["batch_stats"]
    mod = SemiGlobalSyncBN(6, momentum=momentum)
    load_flax_variables(mod, {"params": params,
                              "batch_stats": jax.tree.map(np.array, stats)})
    train = jax.jit(lambda s, a: jmod.apply(
        {"params": params, "batch_stats": s}, a, train=True,
        mutable=["batch_stats"]))
    tdt = getattr(torch, dtype)
    tol = TOL[dtype]
    mod.train()
    for k, x in enumerate(xs):
        ref, mut = train(stats, jnp.asarray(x, jdt))
        stats = mut["batch_stats"]
        out = mod(tt(x, tdt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert out.dtype == tdt
        np.testing.assert_allclose(np_(out), np_(ref),
                                   err_msg=f"call {k}", **tol)
        assert set(stats) == set(STATS)
        for name in STATS:
            np.testing.assert_allclose(
                np_(getattr(mod, name)), np.asarray(stats[name]),
                err_msg=f"call {k} {name}", **STAT_TOL)
    # the statistics and the probes moved
    for name in ("mean", "var", "mean_probe", "var_g2"):
        assert not np.allclose(np.asarray(stats[name]),
                               np.asarray(variables["batch_stats"][name]))
    ref = jmod.apply({"params": params, "batch_stats": stats},
                     jnp.asarray(xs[0], jdt), train=False)
    mod.eval()
    before = {n: getattr(mod, n).clone() for n in STATS}
    out = mod(tt(xs[0], tdt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(np_(out), np_(ref), **tol)
    for n in STATS:
        assert torch.equal(getattr(mod, n), before[n]), n


def test_gradient_bypasses_the_statistics():
    """Train mode normalizes with the (updated) running statistics, so
    the input's gradient is scale * rsqrt(var + eps) per channel, as
    JAX's stop-gradient gives."""
    xs, _ = _inputs("float32")
    jmod = JaxSGBN(sync=False)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]),
                          train=True)
    w = np.random.default_rng(4).normal(size=xs[0].shape)
    w = w.astype(np.float32)

    def loss(x):
        y, _ = jmod.apply(variables, x, train=True, mutable=["batch_stats"])
        return jnp.sum(y * w)
    ref = jax.grad(loss)(jnp.asarray(xs[0]))
    mod = SemiGlobalSyncBN(6).train()
    x = tt(xs[0]).permute(0, 3, 1, 2).requires_grad_()
    (mod(x) * tt(w).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(np_(x.grad.permute(0, 2, 3, 1)),
                               np.asarray(ref), rtol=1e-6, atol=1e-7)


def _sg_cfg():
    cfg = port_cfg("f32")
    return cfg.replace(odom=dataclasses.replace(
        cfg.odom, bn_type="semiglobal_sync_bn"))


def test_reset_parameters_gives_flax_initial_values():
    """OdomNet's init gives every semi-global BN flax's initial values:
    scale 1, bias 0, mean 0, var 1, dynamic momenta 0.1, g^2 1, probes
    0 (mean) and 1 (var), leaf for leaf with the JAX init's."""
    from rslo_tpu.models.bev_net import BEVOdomNet as JaxBEV
    cfg = _sg_cfg()
    x = jnp.zeros((1, 16, 16, 2 * cfg.odom.num_input_features))
    jmod = JaxBEV(cfg.odom, cfg.voxelizer.point_cloud_range)
    variables = jax.jit(lambda k, a: jmod.init(k, a, train=False))(
        jax.random.PRNGKey(0), x)
    net = OdomNet(to_port(cfg), torch.Generator().manual_seed(0))
    n_sg = 0
    for name, t in net.bev_net.state_dict().items():
        col, path = flax_path(name, t.dim())
        if "SemiGlobalSyncBN_0" not in path or path[-1] == "kernel":
            continue
        tree = variables[col]
        for k in path:
            tree = tree[k]
        np.testing.assert_array_equal(np_(t), np.asarray(tree), name)
        n_sg += 1
    assert n_sg == 10 * sum(isinstance(m, SemiGlobalSyncBN)
                            for m in net.modules()) > 0


def test_pretrained_include_bev_net_carries_semiglobal_statistics(tmp_path):
    """A warm start with --pretrained_include bev_net copies every
    parameter and all eight statistics of each semi-global BN of the
    BEV net (the six beyond mean and var live in "batch_stats" too), and
    nothing of the middle."""
    cfg = to_port(_sg_cfg())
    src = Trainer(cfg, str(tmp_path / "src"), device="cpu")
    state = src.init_state()
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, t in src.net.state_dict().items():
            t.add_(torch.rand(t.shape, generator=gen))
    src.ckpt.save(1, state)
    src.logger.close()
    dst = Trainer(cfg, str(tmp_path / "dst"), device="cpu")
    dst.init_state(pretrained=str(tmp_path / "src"),
                   pretrained_include="bev_net")
    dst.logger.close()
    want, got = src.net.state_dict(), dst.net.state_dict()
    sg = [k for k in got if ".SemiGlobalSyncBN_0." in k]
    assert {k.rsplit(".", 1)[1] for k in sg} == set(STATS) | {"scale",
                                                               "bias"}
    for k in got:
        same = torch.equal(got[k], want[k])
        assert same == k.startswith("bev_net."), k
    log = (tmp_path / "dst" / "log.txt").read_text()
    n_stats = sum(1 for k in got if k.startswith("bev_net.") and
                  k.rsplit(".", 1)[1] in STATS)
    assert n_stats == 8 * len(sg) // 10
    assert f"+ {n_stats} stat leaves" in log
