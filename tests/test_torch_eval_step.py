"""Port the eval step (rslo_tpu_torch.train.step.eval_step) against the
JAX package's make_eval_step on a one-device mesh, and the covariance
decoder switch (``with_cov``) of SparseMiddleCov, OdomNet and
StreamingOdometry: skipping the decoder changes no odometry bit, runs 14
instead of 20 sparse convs a frame and moves no BN statistic; an eval
step in the middle of training leaves the net in train mode."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torch_port_helpers import (jax_variables, np_, port_cfg, tiny_scans,
                                to_jax, to_port)

from rslo_tpu.data.prepare import prepare_example as jax_prepare
from rslo_tpu.data.prepare import voxelizer_config as jax_vcfg
from rslo_tpu.models.net import OdomNet as JaxOdomNet
from rslo_tpu.train.step import make_eval_step
from rslo_tpu_torch.convert import load_flax_variables
from rslo_tpu_torch.data.loader import collate
from rslo_tpu_torch.eval.streaming import StreamingOdometry
from rslo_tpu_torch.models.net import OdomNet
from rslo_tpu_torch.train.loop import Trainer
from rslo_tpu_torch.train.step import eval_step

# tests/test_torch_net_streaming.py's: f32 differs in sum order only;
# bf16 rounds at other places through the whole slice
TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
       "bf16": dict(rtol=5e-2, atol=5e-2)}


def tiny_cfg(precision):
    cfg = port_cfg(precision)
    return cfg.replace(data=dataclasses.replace(cfg.data, max_points=4096,
                                                seq_length=2))


@functools.lru_cache(maxsize=None)
def _setup(precision):
    """(precision, JAX cfg, collated 2-scan batch, JAX net, variables,
    port net, one-device mesh)."""
    cfg = tiny_cfg(precision)
    scans = tiny_scans(31, 2)
    batch = collate([{"points": scans, "odometry": np.zeros((1, 7))}],
                    to_port(cfg).data)
    jnet = JaxOdomNet(cfg)
    ex = jax_prepare(jnp.asarray(batch["points"][0]),
                     jnp.asarray(batch["point_mask"][0]), jax_vcfg(cfg),
                     mean_mode=True)
    variables = jax_variables(jnet, 0, ex, train=False)
    net = load_flax_variables(OdomNet(to_port(cfg)), variables).eval()
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    return precision, cfg, batch, jnet, variables, net, mesh


@pytest.fixture(scope="module", params=["f32", "bf16"])
def setup(request):
    return _setup(request.param)


def _jax_eval(setup, with_cov=False):
    _, cfg, batch, jnet, variables, _, mesh = setup
    step = make_eval_step(jnet, cfg, mesh, with_cov=with_cov)
    v = to_jax(variables)
    return step(v["params"], v["batch_stats"],
                {"points": jnp.asarray(batch["points"]),
                 "point_mask": jnp.asarray(batch["point_mask"])})


def _stats(net):
    return {k: v.clone() for k, v in net.state_dict().items()
            if k.endswith((".mean", ".var"))}


def _count_convs(net):
    """A list that every sparse conv forward of ``net`` appends to."""
    seen = []
    for m in net.middle._convs:
        m.register_forward_hook(lambda *a: seen.append(1))
    return seen


def test_eval_step_matches_jax(setup):
    precision, cfg, batch, _, _, net, _ = setup
    got = eval_step(net, batch, to_port(cfg), "cpu")
    want = np_(_jax_eval(setup))
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 1, 7)
    assert want.shape == (1, 1, 7)
    np.testing.assert_allclose(got.numpy(), want, **TOL[precision])
    assert float(np.abs(want[0, 0, :3]).max()) > 1e-3


def test_eval_step_with_cov_matches_jax():
    """f32: the covariance head's outputs beside the odometry."""
    setup = _setup("f32")
    precision, cfg, batch, _, _, net, _ = setup
    got = eval_step(net, batch, to_port(cfg), "cpu", with_cov=True)
    want = _jax_eval(setup, with_cov=True)
    names = ("odometry", "points", "covs", "mask")
    for name, g, w in zip(names, got, want):
        w = np_(w)
        assert tuple(g.shape) == w.shape, name
        if name == "mask":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert g.dtype == torch.float32, name
            np.testing.assert_allclose(g.numpy(), w, err_msg=name,
                                       **TOL[precision])
    V = net.cfg.voxelizer.max_voxels
    assert tuple(got[2].shape) == (1, 2, V, 7)
    assert bool(got[3].any())


def test_with_cov_false_is_bit_equal_and_skips_the_decoder(setup):
    _, cfg, batch, _, _, net, _ = setup
    pcfg = to_port(cfg)
    before = _stats(net)
    seen = _count_convs(net)
    try:
        full = eval_step(net, batch, pcfg, "cpu", with_cov=True)[0]
        n_full = len(seen)
        del seen[:]
        skip = eval_step(net, batch, pcfg, "cpu")
        n_skip = len(seen)
    finally:
        for m in net.middle._convs:
            m._forward_hooks.clear()
    assert (n_full, n_skip) == (40, 28)           # 2 frames x 20 and x 14
    assert torch.equal(skip, full)
    after = _stats(net)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert not net.training


def test_odomnet_without_cov_has_no_covs(setup):
    _, cfg, batch, _, _, net, _ = setup
    from rslo_tpu_torch.train.step import prepare_batch
    ex = prepare_batch({k: torch.as_tensor(batch[k][0])
                        for k in ("points", "point_mask")}, to_port(cfg))
    args = (ex["voxel_features"][0], ex["coords"][0], ex["voxel_mask"][0])
    with torch.no_grad():
        preds = net(ex, with_cov=False)
        bev, cov = net.frame_features(*args, with_cov=False)
        bev_full, cov_full = net.frame_features(*args)
    assert "voxel_covs" not in preds and cov is None
    assert "voxel_covs" in net(ex) and cov_full is not None
    assert torch.equal(bev, bev_full)


def _assert_equal_tree(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal_tree(x, y)
    elif dataclasses.is_dataclass(a):
        assert type(a) is type(b)
        for f in dataclasses.fields(a):
            _assert_equal_tree(getattr(a, f.name), getattr(b, f.name))
    else:
        assert a == b


@pytest.mark.parametrize("engine", ["rulebook", "band"])
def test_geometry_without_cov_skips_the_inverse_rulebooks(engine):
    """with_cov=False builds the same levels, subm and down rulebooks
    (or band plans) and no inverse ones."""
    cfg = tiny_cfg("f32")
    cfg = cfg.replace(middle=dataclasses.replace(cfg.middle, engine=engine))
    pcfg = to_port(cfg)
    batch = collate([{"points": tiny_scans(31, 2),
                      "odometry": np.zeros((1, 7))}], pcfg.data)
    from rslo_tpu_torch.train.step import prepare_batch
    ex = prepare_batch({k: torch.as_tensor(batch[k][0])
                        for k in ("points", "point_mask")}, pcfg)
    net = OdomNet(pcfg)
    args = (ex["coords"][0], ex["voxel_mask"][0])
    full = net._middle_geometry(*args)
    skip = net._middle_geometry(*args, with_cov=False)
    assert len(full.inv_rb) == 2 and skip.inv_rb == ()
    _assert_equal_tree(skip._replace(inv_rb=full.inv_rb), full)


def test_streaming_runs_14_convs_a_scan(setup):
    precision, cfg, _, _, _, net, _ = setup
    scans = tiny_scans(41, 3)
    stream = StreamingOdometry(net, to_port(cfg), "cpu")
    before = _stats(net)
    seen = _count_convs(net)
    try:
        for scan in scans:
            stream.push(scan)
    finally:
        for m in net.middle._convs:
            m._forward_hooks.clear()
    assert len(seen) == 14 * len(scans)
    after = _stats(net)
    assert all(torch.equal(before[k], after[k]) for k in before)
    # pose after scan 2 == the two-frame eval step on the same scans
    batch = collate([{"points": scans[:2], "odometry": np.zeros((1, 7))}],
                    to_port(cfg).data)
    two = eval_step(net, batch, to_port(cfg), "cpu").numpy()[0, 0]
    np.testing.assert_allclose(stream.trajectory[1], two, rtol=1e-6,
                               atol=1e-6)


def test_trainer_eval_fn_keeps_train_mode(setup, tmp_path):
    """An eval step inside training (Trainer.eval_fn on the trainer's
    train-mode net) runs in eval mode, equals the same step on an
    eval-mode copy of the net bit for bit, moves no BN statistic and
    hands the net back in train mode."""
    _, cfg, batch, _, variables, _, _ = setup
    trainer = Trainer(to_port(cfg), str(tmp_path), "cpu")
    trainer.init_state()
    load_flax_variables(trainer.net, variables)
    assert trainer.net.training
    before = _stats(trainer.net)
    for with_cov in (False, True):
        out = trainer.eval_fn(with_cov=with_cov)(batch)
        assert trainer.net.training
        assert all(m.training for m in trainer.net.modules())
    after = _stats(trainer.net)
    trainer.logger.close()
    assert all(torch.equal(before[k], after[k]) for k in before)
    ref = load_flax_variables(OdomNet(to_port(cfg)), variables).eval()
    want = eval_step(ref, batch, to_port(cfg), "cpu", with_cov=True)
    for g, w in zip(out, want):
        assert torch.equal(g, w)
