"""Port the self-supervised train step (rslo_tpu_torch.train) against
the JAX package: one step's loss, aux terms, per-leaf gradients and BN
running statistics; then three steps of the optimizer (clip, decay
mask, OneCycle lr and momentum) compared parameter by parameter; one
step on the offline hier clouds (``use_hier_points``); the OneCycle
schedules; and the port's initializers against flax's.

The JAX side is ``jax.value_and_grad`` of ``make_train_step``'s own
loss function and the JAX ``build_optimizer`` chain, which is what the
step computes on one device (its ``pmean`` is then the identity).  Its
chamfer search is the interpret-mode Pallas kernel (see
``pallas_nn_search``), so both sides associate the same points."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import (jax_variables, np_, port_cfg, tiny_scans,
                                to_jax, to_port, tt)

import rslo_tpu.losses.consistency as jax_consistency
from rslo_tpu.data.prepare import prepare_example as jax_prepare
from rslo_tpu.data.prepare import voxelizer_config as jax_vcfg
from rslo_tpu.losses.objective import compute_objective as jax_objective
from rslo_tpu.models.bev_net import BEVOdomNet as JaxBEV
from rslo_tpu.models.net import OdomNet as JaxOdomNet
from rslo_tpu.ops.chamfer import nn_search_pallas
from rslo_tpu.data.loader import quantize_points
from rslo_tpu.train import optim as jax_optim
from rslo_tpu_torch.convert import (flax_path, load_flax_variables,
                                    to_flax_leaf)
from rslo_tpu_torch.models.bev_net import BEVOdomNet
from rslo_tpu_torch.models.net import OdomNet
from rslo_tpu_torch.train import optim
from rslo_tpu_torch.train.loop import make_optimizer
from rslo_tpu_torch.train.state import TrainState
from rslo_tpu_torch.train.step import loss_and_grads, train_step

L = 3                       # frames per window: 3 pairs
N_STEPS = 3
# f32 on both sides; the step's sums run in other orders (BN
# statistics, conv reductions, the 3x3 inverses of the Mahalanobis
# term), so loss terms agree to ~1e-6 relative (observed) and
# gradients, which pass through all of that twice, to ~1e-5 of each
# leaf's largest entry.  The biases of convs that a train-mode BN
# follows have a zero gradient in exact arithmetic and carry only f32
# noise on both sides, so the bound has a floor relative to the largest
# gradient of all: |port - jax| <= GRAD_REL * max|leaf| + NOISE * max|all|.
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL, NOISE = 1e-4, 1e-6
STAT_TOL = dict(rtol=1e-5, atol=1e-6)
# Adam normalizes each entry's step to ~lr (<= 8e-4 here), so where the
# two sides' gradients agree to 1% at every step so far the parameters
# agree to ~1e-2 * lr.  An entry whose gradients differ by more at some
# step (f32 noise around a near-zero gradient, e.g. the bias of a conv
# that a train-mode BN follows) has no determined direction: Adam moves
# it by up to lr each step on either side, so it is held to 2 * sum(lr);
# fewer than 2% of the entries may be such.
PARAM_ATOL = 1e-5


def pallas_nn_search(src, src_mask, tgt, tgt_mask, tile=256):
    """The Pallas NN kernel in interpret mode, padded to tile
    multiples (padding tgt rows are invalid, padding src rows are cut
    off), in place of the XLA scan the JAX package runs on the CPU."""
    N, M = src.shape[0], tgt.shape[0]
    pn, pm = (-N) % tile, (-M) % tile
    d, i = nn_search_pallas(
        jnp.pad(src, ((0, pn), (0, 0))), jnp.pad(src_mask, (0, pn)),
        jnp.pad(tgt, ((0, pm), (0, 0))), jnp.pad(tgt_mask, (0, pm)),
        src_tile=tile, tgt_tile=tile, interpret=True)
    return d[:N], i[:N]


def _batch(cfg):
    scans = tiny_scans(5, L)
    rng = np.random.default_rng(5)
    odom = np.zeros((L * (L - 1) // 2, 7), np.float32)
    odom[:, :3] = rng.normal(0, 0.05, (len(odom), 3))
    odom[:, 3] = 1.0
    return {"points": np.stack(scans),
            "point_mask": np.ones((L, len(scans[0])), bool),
            "odometry": odom}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _grad_bound(want, global_max):
    return GRAD_REL * float(np.abs(want).max()) + NOISE * global_max


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def step_cfg():
    """The tiny f32 config with BN in the middle's encoder and none in
    the BEV net.  Train-mode BN over the tiny 16 x 16 BEV of 3 pairs
    makes the BEV gradients ill-conditioned in both frameworks: the
    ~1e-6 f32 differences of the middle's output move them by ~1e-2
    (JAX against JAX on the two inputs shows the same), which would
    hide a real fault; ``test_bev_net_train_mode_matches_jax`` holds the
    BEV net's train-mode Norm on one shared input instead.  A weight
    decay of 10 (1e-5 ships) makes the decay mask visible: decaying a
    BN scale or a bias by mistake would move it by ~lr * 10."""
    cfg = port_cfg("f32", middle_bn="bn")
    return cfg.replace(
        odom=dataclasses.replace(cfg.odom, bn_type="none"),
        optimizer=dataclasses.replace(cfg.optimizer, weight_decay=10.0),
        train=dataclasses.replace(cfg.train, steps=40))


@pytest.fixture(scope="module")
def setup():
    cfg = step_cfg()
    batch = _batch(cfg)
    jnet = JaxOdomNet(cfg)
    ex = jax_prepare(jnp.asarray(batch["points"]),
                     jnp.asarray(batch["point_mask"]), jax_vcfg(cfg),
                     mean_mode=True)
    ex["odometry"] = jnp.asarray(batch["odometry"])
    variables = jax_variables(jnet, 0, ex, train=False)
    pc_range = cfg.voxelizer.point_cloud_range

    def loss_fn(trainable, batch_stats, example):
        preds, mutated = jnet.apply(
            {"params": trainable["params"], "batch_stats": batch_stats},
            example, train=True, mutable=["batch_stats"])
        out = jax_objective(preds, example, trainable["alphas"], cfg.loss,
                            pc_range, warmup=False)
        return out.total, (out.aux, mutated["batch_stats"])

    tx = jax_optim.build_optimizer(cfg.optimizer, cfg.train)
    trainable = to_jax({"params": variables["params"],
                        "alphas": {"rot": np.float32(-2.5),
                                   "trans": np.float32(0.0)}})
    stats = to_jax(variables["batch_stats"])
    opt_state = tx.init(trainable)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_consistency, "nn_search", pallas_nn_search)
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        update = jax.jit(tx.update)
        steps = []
        for _ in range(N_STEPS):
            (loss, (aux, stats)), grads = grad_fn(trainable, stats, ex)
            updates, opt_state = update(grads, opt_state, trainable)
            trainable = optax.apply_updates(trainable, updates)
            steps.append(jax.tree.map(np.asarray, dict(
                loss=loss, aux=aux, grads=grads, stats=stats,
                trainable=trainable)))

    pcfg = to_port(cfg)
    net = load_flax_variables(OdomNet(pcfg), variables)
    opt = make_optimizer(pcfg, net)
    state = TrainState.create(net, opt, {"rot": -2.5, "trans": 0.0})
    tbatch = {k: tt(v) for k, v in batch.items()}
    port = []
    for _ in range(N_STEPS):
        grads = {}
        hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g))
                 for n, p in state.trainable().items()]
        state, metrics = train_step(state, tbatch, pcfg, opt,
                                    warmup=False)
        for h in hooks:
            h.remove()
        port.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads={k: g.clone() for k, g in grads.items()},
            stats={k: b.clone() for k, b in net.named_buffers()},
            params={k: p.detach().clone()
                    for k, p in state.trainable().items()}))
    return steps, port


def test_first_step_loss_and_aux_match_jax(setup):
    steps, port = setup
    ref, out = steps[0], port[0]["metrics"]
    np.testing.assert_allclose(out["loss"], ref["loss"], **LOSS_TOL)
    for key, val in ref["aux"].items():
        np.testing.assert_allclose(out[key], val, err_msg=key, **LOSS_TOL)
    assert ref["aux"]["consistency_loss"] != 0.0
    gnorm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                        for _, g in _flat(ref["grads"])))
    np.testing.assert_allclose(out["grad_norm"], gnorm, rtol=GRAD_REL)
    assert gnorm > 10.0             # the clip at 10 is taken
    assert out["alpha_rot"] == -2.5 and out["alpha_trans"] == 0.0


def test_first_step_grads_match_jax_per_leaf(setup):
    steps, port = setup
    ref, grads = steps[0]["grads"], port[0]["grads"]
    top = max(float(np.abs(g).max()) for _, g in _flat(ref))
    seen = set()
    for name, g in grads.items():
        if name.startswith("alphas."):
            path = ("alphas", name.split(".", 1)[1])
        else:
            col, path = flax_path(name, g.dim())
            assert col == "params"
            path = ("params",) + path
        seen.add(path)
        want = _get(ref, path)
        got = to_flax_leaf(name, g)
        err = float(np.abs(got - want).max())
        assert err <= _grad_bound(want, top), (name, err)
    assert seen == {p for p, _ in _flat(ref)}


def test_first_step_running_stats_match_jax(setup):
    steps, port = setup
    ref, stats = steps[0]["stats"], port[0]["stats"]
    paths = {p for p, _ in _flat(ref)}
    assert len(paths) == len(stats) > 0
    for name, b in stats.items():
        col, path = flax_path(name, b.dim())
        assert col == "batch_stats" and path in paths
        np.testing.assert_allclose(np_(b), _get(ref, path), err_msg=name,
                                   **STAT_TOL)


def test_three_steps_params_match_jax(setup):
    steps, port = setup
    cfg = step_cfg()
    lr = optim.onecycle_lr(to_port(cfg).optimizer, cfg.train.steps)
    loose = {}
    for k in range(N_STEPS):
        ref, params = steps[k]["trainable"], port[k]["params"]
        lr_sum = sum(float(lr(i)) for i in range(k + 1))
        for name, p in params.items():
            if name.startswith("alphas."):
                path = ("alphas", name.split(".", 1)[1])
            else:
                path = ("params",) + flax_path(name, p.dim())[1]
            g = _get(steps[k]["grads"], path)
            off = (np.abs(to_flax_leaf(name, port[k]["grads"][name]) - g)
                   > 0.01 * np.abs(g))
            loose[name] = loose.get(name, False) | off
            bound = np.where(loose[name], 2 * lr_sum, PARAM_ATOL)
            err = np.abs(to_flax_leaf(name, p) - _get(ref, path))
            assert (err <= bound).all(), (k + 1, name, float(err.max()))
        np.testing.assert_allclose(port[k]["metrics"]["loss"],
                                   steps[k]["loss"], **LOSS_TOL)
    n_loose = sum(int(np.sum(v)) for v in loose.values())
    n_all = sum(p.numel() for p in port[0]["params"].values())
    assert n_loose < 0.02 * n_all, (n_loose, n_all)


def test_hier_points_step_matches_jax(monkeypatch):
    """One f32 post-warmup step with ``use_hier_points``: the consistency
    on the int16-shipped hier clouds, carried by the step into the
    example; loss terms and per-leaf gradients (the covariance decoder's
    are zero on both sides)."""
    cfg = step_cfg()
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss,
                                               use_hier_points=True))
    batch = _batch(cfg)
    rng = np.random.default_rng(6)
    hier = np.concatenate([b[::3, :3] for b in batch["points"]])
    hier = np.stack([np.concatenate(
        [hier[:1200] + 0.02 * t, rng.normal(size=(1200, 3))], 1)
        for t in range(L)]).astype(np.float32)
    batch["hier_points"] = quantize_points(hier)
    batch["hier_mask"] = np.arange(1200)[None] < [[1200], [1100], [1000]]
    jnet = JaxOdomNet(cfg)
    ex = jax_prepare(jnp.asarray(batch["points"]),
                     jnp.asarray(batch["point_mask"]), jax_vcfg(cfg),
                     mean_mode=True)
    for k in ("odometry", "hier_points", "hier_mask"):
        ex[k] = jnp.asarray(batch[k])
    variables = jax_variables(jnet, 1, ex, train=False)

    def loss_fn(params):
        preds, _ = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            ex, train=True, mutable=["batch_stats"])
        out = jax_objective(preds, ex, {"rot": jnp.float32(-2.5),
                                        "trans": jnp.float32(0.0)},
                            cfg.loss, cfg.voxelizer.point_cloud_range,
                            warmup=False)
        return out.total, out.aux
    monkeypatch.setattr(jax_consistency, "nn_search", pallas_nn_search)
    (_, ref_aux), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(to_jax(variables["params"]))

    pcfg = to_port(cfg)
    net = load_flax_variables(OdomNet(pcfg), variables)
    state = TrainState.create(net, make_optimizer(pcfg, net),
                              {"rot": -2.5, "trans": 0.0})
    out, grads = loss_and_grads(state, {k: tt(v) for k, v in batch.items()},
                                pcfg, warmup=False)
    assert set(out.aux) == set(ref_aux)
    for key, val in ref_aux.items():
        np.testing.assert_allclose(float(out.aux[key]), val, err_msg=key,
                                   **LOSS_TOL)
    assert float(ref_aux["consistency_loss"]) > 0
    top = max(float(np.abs(g).max()) for _, g in _flat(ref_grads))
    zero = 0
    for name, g in grads.items():
        if name.startswith("alphas."):
            continue
        want = _get(ref_grads, flax_path(name, g.dim())[1])
        got = to_flax_leaf(name, g)
        zero += not np.abs(want).any()
        err = float(np.abs(got - want).max())
        assert err <= _grad_bound(want, top), (name, err)
    assert zero > 0          # the covariance decoder gets no gradient


# BEV-net variants through the whole step (step_cfg's middle and loss):
# (a) every option at once (its semi-global BN normalizes with running
# statistics, so it stays well-conditioned in train mode; two blocks a
# stage place the attention), (b) fire and (c) bottleneck blocks, (d)
# the FC head at dropout 0 (JAX's train step passes no dropout rng)
STEP_VARIANTS = {
    "a_all_options": dict(bn_type="semiglobal_sync_bn",
                          conv_type="sparse_conv", use_se=True, use_sa=True,
                          conf_type="linear", multi_level_odom=True,
                          use_svd=True, layer_nums=(2, 2, 2)),
    "b_fire": dict(block_type="fire"),
    "c_bottleneck": dict(block_type="bottleneck"),
    "d_fc_head": dict(dense_predict=False, dropout=0.0),
}


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_bev_variant_step_matches_jax(variant, monkeypatch):
    """One f32 post-warmup step of each variant: loss terms, per-leaf
    gradients and the new statistics (the middle's BN and all eight of
    every semi-global BN).  Variant (a) emits three per-level votes,
    each with its own consistency term."""
    cfg = step_cfg()
    cfg = cfg.replace(odom=dataclasses.replace(cfg.odom,
                                               **STEP_VARIANTS[variant]))
    batch = _batch(cfg)
    jnet = JaxOdomNet(cfg)
    ex = jax_prepare(jnp.asarray(batch["points"]),
                     jnp.asarray(batch["point_mask"]), jax_vcfg(cfg),
                     mean_mode=True)
    ex["odometry"] = jnp.asarray(batch["odometry"])
    variables = jax_variables(jnet, 2, ex, train=False)
    alphas = {"rot": jnp.float32(-2.5), "trans": jnp.float32(0.0)}

    def loss_fn(params):
        preds, mut = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            ex, train=True, mutable=["batch_stats"])
        out = jax_objective(preds, ex, alphas, cfg.loss,
                            cfg.voxelizer.point_cloud_range, warmup=False)
        n_lvl = len(preds.get("odometry_levels", [None]))
        return out.total, (out.aux, mut["batch_stats"], n_lvl)
    monkeypatch.setattr(jax_consistency, "nn_search", pallas_nn_search)
    (_, (ref_aux, ref_stats, n_lvl)), ref_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
            to_jax(variables["params"]))
    assert int(n_lvl) == (3 if variant.startswith("a_") else 1)

    pcfg = to_port(cfg)
    net = load_flax_variables(OdomNet(pcfg), variables)
    state = TrainState.create(net, make_optimizer(pcfg, net),
                              {"rot": -2.5, "trans": 0.0})
    out, grads = loss_and_grads(state, {k: tt(v) for k, v in batch.items()},
                                pcfg, warmup=False)
    assert set(out.aux) == set(ref_aux)
    for key, val in ref_aux.items():
        tol = dict(LOSS_TOL)
        if key == "q_err_deg":
            # 2 arccos(dq) near dq = 1 turns one f32 ulp of dq (2^-24)
            # into 2^-23 / sin(angle / 2) radians; the SVD vote's last
            # bits differ between the frameworks: allow 2 such ulps
            tol["atol"] = np.degrees(2 * 2.0 ** -23 /
                                     np.sin(np.radians(float(val)) / 2))
        np.testing.assert_allclose(float(out.aux[key]), val, err_msg=key,
                                   **tol)
    assert float(ref_aux["consistency_loss"]) > 0
    top = max(float(np.abs(g).max()) for _, g in _flat(ref_grads))
    seen = set()
    for name, g in grads.items():
        if name.startswith("alphas."):
            continue
        path = flax_path(name, g.dim())[1]
        seen.add(path)
        want = _get(ref_grads, path)
        err = float(np.abs(to_flax_leaf(name, g) - want).max())
        assert err <= _grad_bound(want, top), (name, err)
    assert seen == {p for p, _ in _flat(ref_grads)}
    n_sg = 0
    for name, b in net.named_buffers():
        col, path = flax_path(name, b.dim())
        assert col == "batch_stats"
        np.testing.assert_allclose(np_(b), _get(ref_stats, path),
                                   err_msg=name, **STAT_TOL)
        n_sg += "SemiGlobalSyncBN_0" in path
    assert len(dict(net.named_buffers())) == len(list(_flat(ref_stats)))
    if variant.startswith("a_"):
        assert n_sg > 0 and n_sg % 8 == 0


def test_bev_net_train_mode_matches_jax():
    """Train-mode Norm (statistics over N*H*W, biased variance, running
    statistics 0.99 * old + 0.01 * batch) through the whole BEV net at
    the shipped sync_bn, on one shared input: outputs, per-leaf
    gradients of a fixed linear loss, and the new running statistics."""
    cfg = port_cfg("f32")
    cfg = cfg.replace(odom=dataclasses.replace(cfg.odom, bn_type="sync_bn"))
    pc_range = cfg.voxelizer.point_cloud_range
    rng = np.random.default_rng(12)
    x = rng.normal(size=(3, 24, 40, 2 * cfg.odom.num_input_features))
    x[:, rng.random((24, 40)) < 0.4] = 0.0
    x = x.astype(np.float32)
    jmod = JaxBEV(cfg.odom, pc_range)
    variables = jax_variables(jmod, 3, jnp.asarray(x), train=False)
    w = {k: rng.normal(size=s).astype(np.float32) for k, s in
         (("odometry", (3, 7)), ("tq_map", (3, 24, 40, 7)))}

    def jax_loss(params):
        out, mut = jmod.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        return sum(jnp.sum(out[k] * w[k]) for k in w), mut["batch_stats"]
    (ref, ref_stats), ref_grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(to_jax(variables["params"]))

    mod = load_flax_variables(BEVOdomNet(to_port(cfg).odom, pc_range),
                              variables).train()
    out = mod(tt(x))
    loss = sum(torch.sum(out[k] * tt(w[k])) for k in w)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)
    top = max(float(np.abs(g).max()) for _, g in _flat(ref_grads))
    for name, p in mod.named_parameters():
        want = _get(ref_grads, flax_path(name, p.dim())[1])
        got = 0.0 if p.grad is None else to_flax_leaf(name, p.grad)
        err = float(np.abs(got - want).max())
        assert err <= _grad_bound(want, top), (name, err)
    for name, b in mod.named_buffers():
        np.testing.assert_allclose(
            np_(b), _get(ref_stats, flax_path(name, b.dim())[1]),
            err_msg=name, **STAT_TOL)


@pytest.mark.parametrize("step", [0, 1, 2, 9, 10, 11, 500, 9999, 10000,
                                  20000])
def test_onecycle_schedules_match_jax(step):
    cfg = port_cfg("f32")
    total = 10000
    for port_fn, jax_fn in ((optim.onecycle_lr, jax_optim.onecycle_lr),
                            (optim.onecycle_momentum,
                             jax_optim.onecycle_momentum)):
        got = float(port_fn(to_port(cfg).optimizer, total)(step))
        want = float(jax_fn(cfg.optimizer, total)(step))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))


def test_init_is_flax_truncated_normal():
    """He-normal (scale 2) sparse-conv kernels and LeCun-normal (scale
    1) dense convs, truncated at 2 sigma / 0.8796 like flax's
    variance_scaling(..., "truncated_normal"); std within 5%."""
    cfg = port_cfg("f32").replace(middle=dataclasses.replace(
        port_cfg("f32").middle, channels=(16, 32, 64, 64)))
    net = OdomNet(to_port(cfg), torch.Generator().manual_seed(0))
    kern = net.middle.SpConv_9.kernel.detach()      # (27, 64, 64)
    assert kern.shape == (27, 64, 64)
    conv = net.bev_net.BasicBlock_2.MaskConv_0.Conv_0.weight.detach()
    for w, fan_in, scale in ((kern, 27 * 64, 2.0),
                             (conv, conv[0].numel(), 1.0)):
        std = np.sqrt(scale / fan_in)
        bound = 2 * std / 0.87962566103423978
        assert float(w.abs().max()) <= bound * (1 + 1e-6)
        assert float(w.abs().max()) > 0.95 * bound
        np.testing.assert_allclose(float(w.std()), std, rtol=0.05)
    # flax's own draw at the same shape has the same bound and std
    import flax.linen as nn
    ref = np.asarray(nn.initializers.he_normal()(
        jax.random.PRNGKey(0), (27, 64, 64), jnp.float32))
    np.testing.assert_allclose(float(np.abs(ref).max()),
                               float(kern.abs().max()), rtol=0.02)
    np.testing.assert_allclose(float(ref.std()), float(kern.std()),
                               rtol=0.05)
