"""Every BEVOdomNet option of the schema in the port
(rslo_tpu_torch.models.bev_net) against the JAX package, on the same
pair input and weights: the normalized convs (conv_type
"sparse_conv"), the semi-global BN, SE and spatial attention, the fire
and bottleneck blocks, the linear confidence, the SVD vote, the
per-level votes, the FC head (both odometry formats) and all of
variant (a) together.  Eval mode in f32 and bf16; train mode (no BN or
the semi-global BN's statistics, gradients of a fixed linear loss, the
new statistics) in f32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (jax_variables, np_, port_cfg, to_jax,
                                to_port, tt)

from rslo_tpu.models.bev_net import BEVOdomNet as JaxBEV
from rslo_tpu_torch.convert import (flax_path, load_flax_variables,
                                    to_flax_leaf)
from rslo_tpu_torch.models.bev_net import BEVOdomNet, DropoutRngError

# as tests/test_torch_bev_net.py: f32 convs differ in summation order
# only; bf16 rounds conv outputs to bf16 at other places on each side
TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
       "bf16": dict(rtol=5e-2, atol=5e-2)}
# train mode, as tests/test_torch_train_step.py's BEV test: outputs to
# 1e-5, gradients to GRAD_REL of each leaf's largest entry plus NOISE
# of the largest gradient of all, statistics to 1e-5
GRAD_REL, NOISE = 1e-4, 1e-6
STAT_TOL = dict(rtol=1e-5, atol=1e-6)

# layer_nums (2, 2, 2) puts an attention block on each stage's last
# block (a one-block stage has none)
VARIANT_A = dict(bn_type="semiglobal_sync_bn", conv_type="sparse_conv",
                 use_se=True, use_sa=True, conf_type="linear",
                 multi_level_odom=True, use_svd=True, layer_nums=(2, 2, 2))
VARIANTS = {
    "sparse_conv": dict(conv_type="sparse_conv"),
    "semiglobal_bn": dict(bn_type="semiglobal_sync_bn"),
    "se": dict(use_se=True, layer_nums=(2, 2, 2)),
    "sa": dict(use_sa=True, layer_nums=(2, 2, 2)),
    "fire": dict(block_type="fire", layer_nums=(2, 1, 2)),
    "bottleneck": dict(block_type="bottleneck", layer_nums=(2, 1, 2)),
    "linear_conf": dict(conf_type="linear"),
    "svd": dict(use_svd=True),
    "multi_level": dict(multi_level_odom=True),
    "fc": dict(dense_predict=False, dropout=0.0),
    "fc_r(x+t)": dict(dense_predict=False, dropout=0.0,
                      odom_format="r(x+t)"),
    "variant_a": VARIANT_A,
}


def _cfg(precision, variant, **base):
    cfg = port_cfg(precision)
    return cfg.replace(odom=dataclasses.replace(
        cfg.odom, **{**base, **VARIANTS[variant]}))


def _input(cfg, seed, n_pairs=2):
    """n_pairs pairs of a 24 x 40 BEV with 40% empty cells: odd sizes
    (3 x 5) at the bottom level take the symmetric SAME padding, even
    ones the (0, 1) padding."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_pairs, 24, 40, 2 * cfg.odom.num_input_features))
    x[:, rng.random((24, 40)) < 0.4] = 0.0
    return x.astype(np.float32)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _compare(out, ref, tol):
    assert set(out) == set(ref)
    for key in ("odometry", "tq_map", "t_conf", "q_conf", "input_mask"):
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(np_(out[key]), np_(ref[key]),
                                   err_msg=key, **tol)
    assert len(out["pyramid"]) == len(ref["pyramid"])
    for i, ((a, am), (b, bm)) in enumerate(zip(out["pyramid"],
                                               ref["pyramid"])):
        assert a.shape == b.shape and am.shape == bm.shape, i
        np.testing.assert_allclose(np_(a), np_(b), err_msg=f"map {i}",
                                   **tol)
        np.testing.assert_allclose(np_(am), np_(bm), err_msg=f"mask {i}",
                                   **tol)
    for i, (a, b) in enumerate(zip(out.get("odometry_levels", []),
                                   ref.get("odometry_levels", []))):
        np.testing.assert_allclose(np_(a), np_(b), err_msg=f"level {i}",
                                   **tol)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bev_option_matches_jax(variant, precision):
    cfg = _cfg(precision, variant)
    pc_range = cfg.voxelizer.point_cloud_range
    x = _input(cfg, 11)
    jmod = JaxBEV(cfg.odom, pc_range)
    variables = jax_variables(jmod, 1, jnp.asarray(x), train=False)
    ref = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(
        to_jax(variables), jnp.asarray(x))
    mod = load_flax_variables(BEVOdomNet(to_port(cfg).odom, pc_range),
                              variables)
    with torch.no_grad():
        out = mod.eval()(tt(x))
    _compare(out, ref, TOL[precision])
    if cfg.odom.multi_level_odom:
        assert len(out["odometry_levels"]) == 3
    if cfg.odom.dense_predict:
        # the vote is a real function of the input, not the identity
        assert float(np.abs(np_(ref["odometry"])[:, :3]).max()) > 1e-2


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bev_option_train_mode_matches_jax(variant):
    """Train mode in f32 on one shared input of 3 pairs: outputs, the
    per-leaf gradients of a fixed linear loss over the odometry (and
    the tq map and the per-level votes where they are real), and the
    new running statistics (all eight of a semi-global BN).  The BN is
    "none" unless the variant sets one: batch-statistics BN over this
    tiny input makes the gradients of the deeper variants
    ill-conditioned in both frameworks (two blocks a stage without any
    option already miss the gradient bound), and
    tests/test_torch_train_step.py::test_bev_net_train_mode_matches_jax
    holds that BN in train mode."""
    cfg = _cfg("f32", variant, bn_type="none")
    pc_range = cfg.voxelizer.point_cloud_range
    x = _input(cfg, 12, n_pairs=3)
    jmod = JaxBEV(cfg.odom, pc_range)
    variables = jax_variables(jmod, 3, jnp.asarray(x), train=False)
    rng = np.random.default_rng(12)
    w = {"odometry": rng.normal(size=(3, 7)).astype(np.float32)}
    if cfg.odom.dense_predict:
        w["tq_map"] = rng.normal(size=(3, 24, 40, 7)).astype(np.float32)
    n_lvl = 3 if cfg.odom.multi_level_odom else 0
    w_lvl = rng.normal(size=(n_lvl, 3, 7)).astype(np.float32)

    def loss_of(out, wrap):
        loss = sum((out[k] * wrap(w[k])).sum() for k in w)
        for i in range(n_lvl):
            lvl = out["odometry_levels"][i]
            loss = loss + (lvl * wrap(w_lvl[i])).sum()
        return loss

    def jax_loss(params):
        out, mut = jmod.apply({"params": params,
                               "batch_stats": variables.get("batch_stats",
                                                            {})},
                              jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        return loss_of(out, jnp.asarray), mut.get("batch_stats", {})
    (ref, ref_stats), ref_grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(to_jax(variables["params"]))

    mod = load_flax_variables(BEVOdomNet(to_port(cfg).odom, pc_range),
                              variables).train()
    loss = loss_of(mod(tt(x)), tt)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref),
                               rtol=1e-5)
    top = max(float(np.abs(g).max()) for _, g in _flat(ref_grads))
    seen = set()
    for name, p in mod.named_parameters():
        path = flax_path(name, p.dim())[1]
        seen.add(path)
        want = _get(ref_grads, path)
        got = 0.0 if p.grad is None else to_flax_leaf(name, p.grad)
        err = float(np.abs(got - want).max())
        assert err <= GRAD_REL * float(np.abs(want).max()) + NOISE * top, \
            (name, err)
    assert seen == {p for p, _ in _flat(ref_grads)}
    stats = dict(mod.named_buffers())
    assert len(stats) == len(list(_flat(ref_stats)))
    for name, b in stats.items():
        col, path = flax_path(name, b.dim())
        assert col == "batch_stats"
        np.testing.assert_allclose(np_(b), _get(ref_stats, path),
                                   err_msg=name, **STAT_TOL)


def test_fc_head_train_mode_with_dropout_raises_in_both():
    """The FC head in train mode at dropout > 0 has no dropout rng: JAX
    fails (its train step passes none), and so does the port, before
    any running statistic moves.  Eval mode runs on both."""
    import flax.errors
    cfg = port_cfg("f32")
    cfg = cfg.replace(odom=dataclasses.replace(
        cfg.odom, dense_predict=False, dropout=0.1))
    pc_range = cfg.voxelizer.point_cloud_range
    x = _input(cfg, 13)
    jmod = JaxBEV(cfg.odom, pc_range)
    variables = jax_variables(jmod, 4, jnp.asarray(x), train=False)
    with pytest.raises(flax.errors.InvalidRngError):
        jmod.apply(to_jax(variables), jnp.asarray(x), train=True,
                   mutable=["batch_stats"])
    mod = load_flax_variables(BEVOdomNet(to_port(cfg).odom, pc_range),
                              variables)
    before = {k: b.clone() for k, b in mod.named_buffers()}
    with pytest.raises(DropoutRngError, match="dropout"):
        mod.train()(tt(x))
    for k, b in mod.named_buffers():
        assert torch.equal(b, before[k]), k
    ref = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(
        to_jax(variables), jnp.asarray(x))
    with torch.no_grad():
        out = mod.eval()(tt(x))
    _compare(out, ref, TOL["f32"])


@pytest.mark.parametrize("bad", [dict(conv_type="sparse"),
                                 dict(block_type="wide"),
                                 dict(conf_type="sigmoid"),
                                 dict(bn_type="group_norm")])
def test_unknown_option_values_raise(bad):
    """A value the schema does not name is refused at construction."""
    cfg = to_port(port_cfg("f32"))
    with pytest.raises(ValueError):
        BEVOdomNet(dataclasses.replace(cfg.odom, **bad),
                   cfg.voxelizer.point_cloud_range)


@pytest.mark.parametrize("variant", ["variant_a", "fc", "fire",
                                     "bottleneck"])
def test_init_follows_flax(variant):
    """``OdomNet.reset_parameters`` against the JAX init, leaf by leaf:
    every leaf but the kernels equal (zero biases, the identity-pose
    bias of the tq heads and of the FC head's last layer, unit BN
    scales, the semi-global BN's eight initial statistics); every
    kernel a truncated normal of flax's LeCun scale (bound
    2 sqrt(1 / fan_in) / 0.8796, fan_in the kernel's input size), as
    is JAX's."""
    from rslo_tpu_torch.models.net import OdomNet
    cfg = _cfg("f32", variant)
    x = jnp.zeros((1, 16, 16, 2 * cfg.odom.num_input_features))
    jmod = JaxBEV(cfg.odom, cfg.voxelizer.point_cloud_range)
    ref = jax.jit(lambda k, a: jmod.init(k, a, train=False))(
        jax.random.PRNGKey(0), x)
    net = OdomNet(to_port(cfg), torch.Generator().manual_seed(0))
    n_const = n_rand = 0
    for name, t in net.bev_net.state_dict().items():
        col, path = flax_path(name, t.dim())
        want = np.asarray(_get(ref[col], path))
        got = to_flax_leaf(name, t)
        assert got.shape == want.shape, name
        if path[-1] != "kernel":
            np.testing.assert_array_equal(got, want, name)
            n_const += 1
            continue
        bound = 2 * np.sqrt(1.0 / np.prod(want.shape[:-1])) / 0.8796256610
        for w in (got, want):
            assert np.abs(w).max() <= bound * (1 + 1e-6), name
            assert np.abs(w).max() > 0.5 * bound, name
        n_rand += 1
    assert n_const > 0 and n_rand > 0
    if variant == "fc":
        np.testing.assert_array_equal(np_(net.bev_net.Dense_1.bias),
                                      [0, 0, 0, 1, 0, 0, 0])
