"""Port the band engine (``middle.engine="band"``) against the JAX
package at the net level, on the tiny config with band_block 128 and
band_windows (256, 640, 384):

  * ``build_band_geometry``'s choice of plan or raw rulebook for every
    rulebook at band_min_channels 0 and 16, with every plan bit-equal;
  * ``SparseMiddleCov``'s BEV map and covariances;
  * the ``OdomNet`` two-frame odometry, and streaming == two-frame;
  * one band train step: loss terms and per-leaf gradients, with the
    bounds and the BN-free BEV net of tests/test_torch_train_step.py.

All in f32, where JAX's two band paths (Pallas, and the XLA one it runs
on the CPU) agree up to the order of their sums."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (jax_variables, np_, port_cfg, tiny_scans,
                                to_jax, to_port, tt)
from test_torch_train_step import (LOSS_TOL, _flat, _get, _grad_bound,
                                   pallas_nn_search, step_cfg)

import rslo_tpu.losses.consistency as jax_consistency
from rslo_tpu.data.prepare import prepare_example as jax_prepare
from rslo_tpu.data.prepare import voxelizer_config as jax_vcfg
from rslo_tpu.losses.objective import compute_objective as jax_objective
from rslo_tpu.models.middle import SparseMiddleCov as JaxMiddle
from rslo_tpu.models.middle import build_band_geometry as jax_band_geometry
from rslo_tpu.models.net import OdomNet as JaxOdomNet
from rslo_tpu.ops import band_conv as jbc
from rslo_tpu_torch.convert import flax_path, load_flax_variables, \
    to_flax_leaf
from rslo_tpu_torch.data.prepare import prepare_example, voxelizer_config
from rslo_tpu_torch.eval.streaming import StreamingOdometry
from rslo_tpu_torch.models.middle import (SparseMiddleCov,
                                          band_overflow_counts,
                                          build_band_geometry)
from rslo_tpu_torch.models.net import OdomNet
from rslo_tpu_torch.ops import band_conv as bc
from rslo_tpu_torch.ops import sparse_conv as sc
from rslo_tpu_torch.train.loop import make_optimizer
from rslo_tpu_torch.train.state import TrainState
from rslo_tpu_torch.train.step import loss_and_grads

SPARSE_SHAPE = (41, 128, 128)
BAND = dict(band_block=128, band_windows=(256, 640, 384))
# f32: the same products summed in other orders through ~40 layers
TOL = dict(rtol=1e-5, atol=1e-5)


def band(cfg, **kw):
    """``cfg`` with the band engine at the test's block and windows."""
    return cfg.replace(middle=dataclasses.replace(
        cfg.middle, engine="band", **{**BAND, **kw}))


@pytest.fixture(scope="module")
def frame():
    """(config, JAX example of one tiny scan)."""
    cfg = band(port_cfg("f32", middle_bn="bn"))
    pts = tiny_scans(7, 1)[0]
    ex = jax_prepare(jnp.asarray(pts[None]), jnp.ones((1, len(pts)), bool),
                     jax_vcfg(cfg), mean_mode=True)
    return cfg, ex


def _geometries(cfg, ex, min_channels):
    m = cfg.middle
    kw = dict(windows=tuple(m.band_windows), block=m.band_block,
              channels=tuple(m.channels), min_channels=min_channels)
    coords, mask = ex["coords"][0], ex["voxel_mask"][0]
    jgeo = jax.jit(lambda c, k: jax_band_geometry(
        c, k, SPARSE_SHAPE, m.level_capacities, **kw))(coords, mask)
    geo = build_band_geometry(tt(coords), tt(mask), SPARSE_SHAPE,
                              m.level_capacities, **kw)
    return jgeo, geo


@pytest.mark.parametrize("min_channels", [0, 16])
def test_band_geometry_dispatch_matches_jax(frame, min_channels):
    """As tests/test_band_conv.py::test_band_dispatch_mixed_engine: with
    channels (8, 8, 16, 16) the widest convs are sub (8, 8, 16, 16),
    down (8, 16, 16, 16), inv (16, 8); below min_channels a rulebook
    stays raw."""
    cfg, ex = frame
    jgeo, geo = _geometries(cfg, ex, min_channels)
    want_band = {"sub_rb": (True,) * 4, "down_rb": (True,) * 4,
                 "inv_rb": (True, True)}
    if min_channels == 16:
        want_band = {"sub_rb": (False, False, True, True),
                     "down_rb": (False, True, True, True),
                     "inv_rb": (True, False)}
    for kind, flags in want_band.items():
        for i, is_band in enumerate(flags):
            got, ref = getattr(geo, kind)[i], getattr(jgeo, kind)[i]
            assert isinstance(got, bc.BandIndex) == is_band, (kind, i)
            assert isinstance(ref, jbc.BandIndex) == is_band, (kind, i)
            names = (("base", "sel", "ov_out", "ov_in", "ov_tap", "ov_count")
                     if is_band else ("idx", "valid"))
            for name in names:
                np.testing.assert_array_equal(
                    getattr(got, name).numpy(),
                    np.asarray(getattr(ref, name)), err_msg=(kind, i, name))
            if is_band:
                assert (got.v_out, got.v_in, got.window,
                        got.self_transpose) == (ref.v_out, ref.v_in,
                                                ref.window,
                                                ref.self_transpose)
    counts = band_overflow_counts(geo)
    assert len(counts) == sum(sum(f) for f in want_band.values())
    assert all(int(c) <= cap // 2 for c, cap in counts.values())


def test_band_middle_matches_jax(frame):
    cfg, ex = frame
    jgeo, geo = _geometries(cfg, ex, 0)
    feats = ex["voxel_features"][0]
    jmod = JaxMiddle(cfg.middle)
    variables = jax_variables(jmod, 0, feats, jgeo, train=False)
    ref_bev, ref_cov = jax.jit(
        lambda v, f, g: jmod.apply(v, f, g, train=False))(
            to_jax(variables), feats, jgeo)
    mod = load_flax_variables(SparseMiddleCov(to_port(cfg).middle),
                              variables).eval()
    with torch.no_grad():
        bev, cov = mod(tt(feats), geo)
    assert bev.shape == ref_bev.shape == (16, 16, 32)
    assert float(np.abs(np.asarray(ref_bev)).max()) > 0.1
    np.testing.assert_allclose(bev.numpy(), np.asarray(ref_bev), **TOL)
    np.testing.assert_allclose(cov.numpy(), np.asarray(ref_cov), **TOL)


def test_band_odomnet_and_streaming_match_jax():
    cfg = band(port_cfg("f32"))
    scans = tiny_scans(21, 3)
    jnet = JaxOdomNet(cfg)
    ex = jax_prepare(jnp.asarray(np.stack(scans[:2])),
                     jnp.ones((2, len(scans[0])), bool), jax_vcfg(cfg),
                     mean_mode=True)
    variables = jax_variables(jnet, 0, ex, train=False)
    ref = jax.jit(lambda v, e: jnet.apply(v, e, train=False))(
        to_jax(variables), ex)
    pcfg = to_port(cfg)
    net = load_flax_variables(OdomNet(pcfg), variables).eval()
    tex = prepare_example(tt(np.stack(scans[:2])),
                          torch.ones(2, len(scans[0]), dtype=torch.bool),
                          voxelizer_config(pcfg), mean_mode=True)
    with torch.no_grad():
        out = net(tex)
    for key in ("odometry", "tq_map", "t_conf", "q_conf"):
        np.testing.assert_allclose(np_(out[key]), np_(ref[key]),
                                   err_msg=key, **TOL)
    for t in range(2):
        np.testing.assert_allclose(np_(out["voxel_covs"][t]),
                                   np_(ref["voxel_covs"][t]), **TOL)
    assert float(np.abs(np_(ref["odometry"])[:, :3]).max()) > 1e-2
    # streaming on the band engine: its first pose is the two-frame vote
    stream = StreamingOdometry(net, pcfg, "cpu")
    for scan in scans:
        stream.push(scan)
    np.testing.assert_allclose(stream.trajectory[1],
                               np_(out["odometry"])[0], rtol=1e-6,
                               atol=1e-6)


def test_band_train_step_matches_jax(monkeypatch):
    """One band train step, the port's ``loss_and_grads`` against
    ``jax.value_and_grad`` of the JAX step's loss: loss, aux terms and
    every leaf's gradient, with test_torch_train_step's bounds.  Two
    frames (one pair) keep the JAX compile short; the three-frame window
    runs on the card (chip_smoke.py)."""
    cfg = band(step_cfg())
    scans = tiny_scans(5, 2)
    odom = np.zeros((1, 7), np.float32)
    odom[0, :3] = (0.05, -0.03, 0.01)
    odom[0, 3] = 1.0
    batch = {"points": np.stack(scans),
             "point_mask": np.ones((2, len(scans[0])), bool),
             "odometry": odom}
    jnet = JaxOdomNet(cfg)
    ex = jax_prepare(jnp.asarray(batch["points"]),
                     jnp.asarray(batch["point_mask"]), jax_vcfg(cfg),
                     mean_mode=True)
    ex["odometry"] = jnp.asarray(batch["odometry"])
    variables = jax_variables(jnet, 0, ex, train=False)
    pc_range = cfg.voxelizer.point_cloud_range

    def loss_fn(trainable, batch_stats, example):
        preds, _ = jnet.apply(
            {"params": trainable["params"], "batch_stats": batch_stats},
            example, train=True, mutable=["batch_stats"])
        out = jax_objective(preds, example, trainable["alphas"], cfg.loss,
                            pc_range, warmup=False)
        return out.total, out.aux

    trainable = to_jax({"params": variables["params"],
                        "alphas": {"rot": np.float32(-2.5),
                                   "trans": np.float32(0.0)}})
    monkeypatch.setattr(jax_consistency, "nn_search", pallas_nn_search)
    (loss, aux), ref = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        trainable, to_jax(variables["batch_stats"]), ex)
    ref = jax.tree.map(np.asarray, ref)

    pcfg = to_port(cfg)
    net = load_flax_variables(OdomNet(pcfg), variables)
    state = TrainState.create(net, make_optimizer(pcfg, net),
                              {"rot": -2.5, "trans": 0.0})
    out, grads = loss_and_grads(state, {k: tt(v) for k, v in batch.items()},
                                pcfg, warmup=False)
    np.testing.assert_allclose(float(out.total.detach()), float(loss),
                               **LOSS_TOL)
    for key, val in aux.items():
        np.testing.assert_allclose(float(out.aux[key]), float(val),
                                   err_msg=key, **LOSS_TOL)
    assert float(aux["consistency_loss"]) != 0.0
    top = max(float(np.abs(g).max()) for _, g in _flat(ref))
    seen = set()
    for name, g in grads.items():
        if name.startswith("alphas."):
            path = ("alphas", name.split(".", 1)[1])
        else:
            path = ("params",) + flax_path(name, g.dim())[1]
        seen.add(path)
        want = _get(ref, path)
        err = float(np.abs(to_flax_leaf(name, g) - want).max())
        assert err <= _grad_bound(want, top), (name, err)
    assert seen == {p for p, _ in _flat(ref)}


def test_band_train_geometry_keeps_the_raw_rulebooks(frame):
    """In training the band geometry carries the rulebook geometry with
    its transposed rulebooks; the down and inverse plans' backward runs
    over those, and without them band_conv refuses a down plan."""
    cfg, ex = frame
    m = cfg.middle
    coords, mask = tt(ex["coords"][0]), tt(ex["voxel_mask"][0])
    geo = build_band_geometry(coords, mask, SPARSE_SHAPE,
                              m.level_capacities,
                              windows=tuple(m.band_windows),
                              block=m.band_block, transposed=True)
    assert geo.raw is not None and geo.raw.down_rb_t is not None
    assert all(isinstance(r, sc.ConvIndex) for r in geo.raw.down_rb)
    assert all(r.self_transpose for r in geo.sub_rb)
    assert not any(r.self_transpose for r in geo.down_rb + geo.inv_rb)
    f = torch.randn(m.level_capacities[0], 8, requires_grad=True)
    with pytest.raises(ValueError, match="transposed"):
        bc.band_conv(f, geo.down_rb[0], torch.randn(27, 8, 8))
