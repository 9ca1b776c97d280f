"""The port's accuracy probes (``scripts/torch_diag_*.py``) against the
JAX package's (``scripts/diag_*.py``, loaded as they are through
importlib with ``RSLO_PROXY_ROOT`` set for them), on the CPU.

One tiny proxy tree (the raycast world at 16 x 512 beams, train seqs 0
and 1 and val seq 7 of 8 frames) is stored twice: JAX's ``proxy.h5``
and the port's directory store, under a root each.  Each root holds a
checkpoint of each middle at the tiny f32 model: JAX's written by its
``CheckpointManager`` from ``torch_port_helpers.jax_variables``, the
port's from the same variables through ``convert.py`` and its
``CheckpointManager``.  Both packages' ``base_cfg`` become the tiny
model (``max_points`` 4096); JAX's hard-coded sizes shrink through its
module (the beam grid of ``SynthWorld.scan``, ``subsample_voxel``'s
cap), never by editing the script.

Each probe's ``main`` runs under ``capsys`` in both packages, in two
checks.  Its device work (the jitted forward on JAX's side, the twin's
``forward``, ``pseudo_target`` or ``consistency_pair`` on the port's)
is recorded on both sides and held to the tolerance the test states,
taken from the parity test of the same computation.  The twin's own
calls return JAX's recorded results in their place, so everything the
twin computes and prints from them must be JAX's printed text exactly
(up to the model dir's path and the loggers' clock stamps): many of the
printed statistics (a correlation over a few windows of an untrained
net's near-constant yaw, a closure ratio over a rotation error of ~0)
would amplify a rounding-level difference past any fixed bound.

The tiny model's BEV net has no BN: its batch statistics over the tiny
BEV are ill-conditioned in train mode in both frameworks
(tests/test_torch_dp_train.py); the middle's BN carries the restored
running statistics.
"""
import dataclasses
import functools
import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (jax_native_normals, jax_variables,
                                port_cfg, tiny_scans, to_jax, to_port)
from test_torch_losses import LOSS_TOL
from test_torch_pillar import BF16_TOL
from test_torch_train_step import pallas_nn_search

import rslo_tpu.cli as jax_cli
import rslo_tpu.data.loader as jax_loader
import rslo_tpu.losses.consistency as jax_consistency
import rslo_tpu.train.loop as jax_loop
import rslo_tpu_torch.cli as port_cli
from rslo_tpu.data.prepare import prepare_example as jax_prepare
from rslo_tpu.data.prepare import voxelizer_config as jax_vcfg
from rslo_tpu.models.net import OdomNet as JaxOdomNet
from rslo_tpu.train.checkpoint import CheckpointManager as JaxCkpt
from rslo_tpu.train.optim import build_optimizer as jax_optimizer
from rslo_tpu.train.state import TrainState as JaxTrainState
from rslo_tpu.utils.world import SynthWorld as JaxSynthWorld
from rslo_tpu_torch.convert import load_flax_variables
from rslo_tpu_torch.data.loader import quant_scale
from rslo_tpu_torch.train.loop import Trainer
from rslo_tpu_torch.utils.world import SynthWorld, write_kitti_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
SEQS = {0: (8, "curve", 3.0), 1: (8, "curve", 3.0), 7: (8, "loop", 3.0)}
TINY_WORLD = dict(extent=10.0, n_walls=30, n_boxes=12, n_cyl=14,
                  corridor=2.5)
BEAMS = (16, 512)
MIDDLES = ("PillarMiddleCov", "SparseMiddleCov")
STEP = 7
# the forward of each middle: the sparse one in f32
# (tests/test_torch_eval_step.py's TOL), the pillar one with its bf16
# convs (tests/test_torch_pillar.py's BF16_TOL); the consistency loss
# of the sparse middle's features to test_torch_losses.py's LOSS_TOL,
# of the pillar's bf16 covariances and prediction to BF16_TOL (observed
# 2.6e-3 relative: the bf16 prediction warps the target cloud)
FWD_TOL = {"SparseMiddleCov": dict(rtol=1e-5, atol=1e-5),
           "PillarMiddleCov": BF16_TOL}
C_TOL = {"SparseMiddleCov": LOSS_TOL, "PillarMiddleCov": BF16_TOL}
# consistency_pair's ICP correction (tests/test_torch_losses.py: res_R
# and res_t within 1e-5 on clouds within 6 m of the sensor; a Kabsch
# translation's rounding grows with the clouds' extent, so res_t's bound
# scales by the largest coordinate over 6 m) and its loss (LOSS_TOL)
ICP_TOL = 1e-5
ICP_EXTENT = 6.0


def tiny(base_cfg):
    """``base_cfg`` at the tiny f32 test model and 4096 points a scan
    (tests/test_torch_accuracy_proxy.py's ``_tiny``, in f32, BN in the
    middle and none in the BEV net)."""
    def cfg(middle, steps):
        c = base_cfg(middle, steps)
        small = port_cfg("f32", middle_bn="bn")
        return c.replace(
            voxelizer=small.voxelizer,
            odom=dataclasses.replace(small.odom, bn_type="none"),
            middle=dataclasses.replace(small.middle, name=c.middle.name),
            data=dataclasses.replace(c.data, max_points=4096),
            loss=dataclasses.replace(
                c.loss, max_loss_points=small.loss.max_loss_points))
    return cfg


def load(name, root, monkeypatch):
    """``scripts/<name>.py`` as a fresh module, its proxy module (JAX's
    ``accuracy_proxy`` or the port's ``torch_accuracy_proxy``) imported
    anew under ``root``, and its ``base_cfg`` the tiny model."""
    monkeypatch.setenv("RSLO_PROXY_ROOT", str(root))
    monkeypatch.syspath_prepend(SCRIPTS)
    for proxy in ("accuracy_proxy", "torch_accuracy_proxy"):
        monkeypatch.delitem(sys.modules, proxy, raising=False)
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if hasattr(mod, "base_cfg"):
        monkeypatch.setattr(mod, "base_cfg", tiny(mod.base_cfg))
    return mod


def _variables(jcfg, middle):
    scans = tiny_scans(3, 2)
    ex = jax_prepare(jnp.asarray(np.stack(scans)),
                     jnp.ones((2, len(scans[0])), bool), jax_vcfg(jcfg),
                     mean_mode=True)
    return jax_variables(JaxOdomNet(jcfg), MIDDLES.index(middle) + 1, ex,
                         train=False)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(JAX's root, the port's root): the same tree's stores and the
    same checkpoint of each middle, each package's own way."""
    base = tmp_path_factory.mktemp("probes")
    tree = base / "tree"
    write_kitti_tree(tree, SEQS, world_seed=0, n_beams=BEAMS[0],
                     n_azimuth=BEAMS[1], world_kwargs=TINY_WORLD)
    jax_native_normals()
    jroot, proot = base / "jax", base / "port"
    jroot.mkdir()
    proot.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        jmod = load("diag_preds", jroot, mp)
        pmod = load("torch_diag_preds", proot, mp)
        seqs = ",".join(str(s) for s in SEQS)
        jax_cli.main(["create_hdf5", "--kitti_root", str(tree), "--out",
                      str(jroot / "proxy.h5"), "--sequences", seqs])
        port_cli.main(["create_hdf5", "--kitti_root", str(tree), "--out",
                       str(proot / "proxy_store"), "--sequences", seqs])
        for middle in MIDDLES:
            jcfg = jmod.base_cfg(middle, 100)
            v = _variables(jcfg, middle)
            state = JaxTrainState.create(
                to_jax(v), jax_optimizer(jcfg.optimizer, jcfg.train),
                {"rot": -2.5, "trans": 0.0}).replace(step=jnp.int32(STEP))
            JaxCkpt(os.path.join(jmod._model_dir(middle, False), "ckpt")) \
                .save(STEP, state)
            pcfg = pmod.base_cfg(middle, 100)
            assert pcfg.to_json().replace(
                str(proot / "proxy_store"), str(jroot / "proxy.h5")) == \
                to_port(jcfg).to_json()
            trainer = Trainer(pcfg, pmod._model_dir(middle, False),
                              device="cpu")
            pstate = trainer.init_state()
            trainer.logger.close()
            load_flax_variables(pstate.model, v)
            pstate.step = STEP
            trainer.ckpt.save(STEP, pstate)
    return jroot, proot


# -- recording and replaying the device work ---------------------------------

class RecordingJax:
    """Stands in for the ``jax`` module of a JAX probe: each function it
    jits records its results (numpy) under the function's name."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)

        def run(*a, **k):
            out = jitted(*a, **k)
            self.calls.setdefault(fn.__name__, []).append(
                jax.tree.map(np.asarray, out))
            return out
        return run


def replay(real, results, seen, convert=lambda x: x):
    """Stands in for a twin's ``real``: runs it, records what it returns
    in ``seen`` and returns JAX's result of the same call instead."""
    def run(*a, **kw):
        seen.append(real(*a, **kw))
        return convert(results[len(seen) - 1])
    return run


def as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def assert_close(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(as_list(g), as_list(w)):
            np.testing.assert_allclose(np.asarray(a, np.float32),
                                       np.asarray(b, np.float32), **tol)


STAMP = re.compile(r"^\[\d\d:\d\d:\d\d\] ", re.M)


def run_both(jmod, pmod, capsys, monkeypatch, args, port_kw, twin_fn,
             jax_fn, convert=as_list):
    """Both probes' ``main(*args)``; the twin's ``twin_fn`` replays JAX's
    jitted ``jax_fn``.  Returns (the twin's text, JAX's, the twin's
    recorded results, JAX's, the twin's return value); the texts without
    the loggers' clock stamps."""
    rec = RecordingJax()
    monkeypatch.setattr(jmod, "jax", rec)
    capsys.readouterr()
    jmod.main(*args)
    want = capsys.readouterr().out
    seen = []
    results = rec.calls[jax_fn]
    monkeypatch.setattr(pmod, twin_fn,
                        replay(getattr(pmod, twin_fn), results, seen,
                               convert))
    out = pmod.main(*args, **port_kw)
    got = capsys.readouterr().out
    return (STAMP.sub("", got), STAMP.sub("", want), seen, results, out)


# -- diag_icp_closure ---------------------------------------------------------

class SmallScans(JaxSynthWorld):
    """JAX's world with its hard-coded 64 x 1024 beams cut to BEAMS."""

    def scan(self, pose_tq, rng, n_beams=64, n_azimuth=1024, **kw):
        return super().scan(pose_tq, rng, n_beams=BEAMS[0],
                            n_azimuth=BEAMS[1], **kw)


def jitted_init(monkeypatch):
    """JAX's ``Trainer.init_state`` initializes its net eagerly (~10 s a
    call at the tiny model on this CPU); the same ``init`` under jit."""
    init = jax_loop.OdomNet.init

    def run(self, key, example, train=False):
        return jax.jit(lambda k, e: init(self, k, e, train=train))(
            key, example)
    monkeypatch.setattr(jax_loop.OdomNet, "init", run)


def test_icp_closure_matches_jax(tmp_path, monkeypatch, capsys):
    """No checkpoint: each consistency_pair call's ICP correction (res_R,
    res_t), and the residual, icp_iter and identity tables."""
    cap = 1024
    jmod = load("diag_icp_closure", tmp_path, monkeypatch)
    pmod = load("torch_diag_icp_closure", tmp_path, monkeypatch)
    monkeypatch.setattr(jmod, "SynthWorld", SmallScans)
    monkeypatch.setattr(jmod, "subsample_voxel",
                        functools.partial(jmod.subsample_voxel, cap=cap))
    # JAX's NN search exact (the Pallas kernel, interpreted), as the
    # port's
    monkeypatch.setattr(jax_consistency, "nn_search", pallas_nn_search)
    jitted = jax.jit(jmod.consistency_pair, static_argnames=(
        "penalize_ratio", "reg_weight", "icp_iter", "no_cov"))
    jax_calls, extents = [], []

    def jax_pair(*a, **kw):
        out = jitted(*a, **kw)
        jax_calls.append((kw["icp_iter"], np.asarray(out.res_R),
                          np.asarray(out.res_t)))
        return out

    def port_pair(*a, **kw):
        extents.append(float(a[0].abs().max()))
        loss, res_R, res_t = real(*a, **kw)
        return kw["icp_iter"], res_R[0].numpy(), res_t[0].numpy()

    real = pmod.consistency_pair
    monkeypatch.setattr(jmod, "consistency_pair", jax_pair)
    capsys.readouterr()
    jmod.main()
    want = capsys.readouterr().out
    seen = []
    monkeypatch.setattr(pmod, "consistency_pair", replay(
        port_pair, jax_calls, seen, lambda c: (
            None, torch.from_numpy(c[1])[None],
            torch.from_numpy(c[2])[None])))
    pmod.main(device="cpu", beams=BEAMS, cap=cap)
    got = capsys.readouterr().out
    assert got == want
    assert "== identity prediction (warmup regime) ==" in got
    assert [c[0] for c in seen] == [c[0] for c in jax_calls] == \
        list(pmod.ICP_ITERS)
    t_tol = ICP_TOL * max(1.0, max(extents) / ICP_EXTENT)
    for (_, pR, pt), (_, jR, jt) in zip(seen, jax_calls):
        np.testing.assert_allclose(pR, jR, atol=ICP_TOL)
        np.testing.assert_allclose(pt, jt, atol=t_tol)


def test_subsample_voxel_matches_jax(tmp_path, monkeypatch):
    jmod = load("diag_icp_closure", tmp_path, monkeypatch)
    pmod = load("torch_diag_icp_closure", tmp_path, monkeypatch)
    pts = SynthWorld(seed=0).scan(np.array([5.0, -3, 0, 1, 0, 0, 0]),
                                  np.random.default_rng(1), n_beams=16,
                                  n_azimuth=512)
    for cap in (64, 100000):
        got = pmod.subsample_voxel(pts, cap=cap,
                                   rng=np.random.default_rng(2))
        want = jmod.subsample_voxel(pts, cap=cap,
                                    rng=np.random.default_rng(2))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# -- diag_target_consistency ------------------------------------------------------

def test_target_consistency_matches_jax(roots, monkeypatch, capsys):
    """Host work on the same samples: the output is JAX's, bit for bit."""
    jroot, proot = roots
    jmod = load("diag_target_consistency", jroot, monkeypatch)
    pmod = load("torch_diag_target_consistency", proot, monkeypatch)
    capsys.readouterr()
    jmod.main(3)
    want = capsys.readouterr().out
    bad = pmod.main(3)
    got = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[-1] == f"{bad} inconsistent pair targets / 9"


# -- the eval-mode probes -------------------------------------------------------

@pytest.mark.parametrize("middle", MIDDLES)
def test_preds_matches_jax(roots, monkeypatch, capsys, middle):
    jroot, proot = roots
    jmod = load("diag_preds", jroot, monkeypatch)
    pmod = load("torch_diag_preds", proot, monkeypatch)
    got, want, seen, results, (P, G) = run_both(
        jmod, pmod, capsys, monkeypatch, (middle, 5), dict(device="cpu"),
        "forward", "fwd")
    assert got == want
    assert got.splitlines()[0] == f"restored step: {STEP}"
    assert P.shape == G.shape == (5, 7)
    assert_close(seen, results, **FWD_TOL[middle])


@pytest.mark.parametrize("middle", MIDDLES)
def test_pairtypes_matches_jax(roots, monkeypatch, capsys, middle):
    """Three-frame train windows: three pairs a window."""
    jroot, proot = roots
    jmod = load("diag_pairtypes", jroot, monkeypatch)
    pmod = load("torch_diag_pairtypes", proot, monkeypatch)
    got, want, seen, results, _ = run_both(
        jmod, pmod, capsys, monkeypatch, (middle, 3, False),
        dict(device="cpu"), "forward", "fwd")
    assert got == want and len(got.splitlines()) == 4
    assert [s[0].shape for s in seen] == [(3, 7)] * 3
    assert_close(seen, results, **FWD_TOL[middle])


def dequantized_collate(collate):
    """JAX's collate with the int16 transfer points turned back into
    floats (the values ``prepare_example`` computes from them)."""
    def run(samples, cfg, rng=None):
        out = collate(samples, cfg, rng)
        pts = out["points"]
        if not np.issubdtype(pts.dtype, np.floating):
            out["points"] = pts.astype(np.float32) * \
                quant_scale(pts.shape[-1])
        return out
    return run


@pytest.mark.parametrize("middle", MIDDLES)
def test_sensitivity_matches_jax(roots, monkeypatch, capsys, middle):
    """JAX's script adds the shift to the proxy's int16 transfer points,
    which numpy refuses; it runs here on the dequantized points (the
    same values its forward reads), as the port's twin does itself."""
    jroot, proot = roots
    jmod = load("diag_sensitivity", jroot, monkeypatch)
    pmod = load("torch_diag_sensitivity", proot, monkeypatch)
    jitted_init(monkeypatch)
    monkeypatch.setattr(jax_loader, "collate",
                        dequantized_collate(jax_loader.collate))
    got, want, seen, results, (base, shifted) = run_both(
        jmod, pmod, capsys, monkeypatch, (middle, False),
        dict(device="cpu"), "forward", "fwd")
    assert got == want
    assert f"restored step: {STEP}" in got.splitlines()
    assert len(seen) == 1 + len(pmod.SHIFTS) and shifted.shape == (4, 7)
    assert_close(seen, results, **FWD_TOL[middle])


def test_sensitivity_shift_needs_floats(roots, monkeypatch):
    """The fault the twin repairs: the proxy's points reach JAX's script
    as int16, and its in-place shift by a float raises."""
    _, proot = roots
    pmod = load("torch_diag_preds", proot, monkeypatch)
    from rslo_tpu_torch.data.dataset import KittiWindowDataset
    from rslo_tpu_torch.data.loader import collate
    cfg = pmod.base_cfg("PillarMiddleCov", 100)
    assert cfg.data.quantize_transfer
    pts = collate([KittiWindowDataset(cfg.data, "val", seq_length=2)[5]],
                  cfg.data)["points"][0]
    assert pts.dtype == np.int16
    with pytest.raises(TypeError):
        pts[1, :, 0] += -1.0


def test_yaw_head_matches_jax(roots, monkeypatch, capsys):
    """The cell-level yaw statistics over the same (H, W) cells: the
    forward's odometry, tq map, q confidence and input mask."""
    jroot, proot = roots
    jmod = load("diag_yaw_head", jroot, monkeypatch)
    pmod = load("torch_diag_yaw_head", proot, monkeypatch)
    # JAX's reads --val from sys.argv
    monkeypatch.setattr(sys, "argv", ["diag_yaw_head.py"])
    got, want, seen, results, rows = run_both(
        jmod, pmod, capsys, monkeypatch, ("", 5, False), dict(device="cpu"),
        "forward", "fwd")
    assert got == want.replace(str(jroot), str(proot))
    assert rows.shape == (5, 5)
    assert [s[1].shape[-1] for s in seen] == [7] * 5
    assert_close(seen, results, **FWD_TOL["PillarMiddleCov"])


# -- diag_pseudo ---------------------------------------------------------------

@pytest.mark.parametrize("middle,warmup", [
    ("PillarMiddleCov", False), ("SparseMiddleCov", True)])
def test_pseudo_matches_jax(roots, monkeypatch, capsys, middle, warmup):
    """The train-mode forward and the pseudo target: the prediction, the
    pseudo t and q (the ICP's correction composed with the prediction)
    and the consistency loss; the twin leaves the restored net's state
    as it was."""
    jroot, proot = roots
    jmod = load("diag_pseudo", jroot, monkeypatch)
    pmod = load("torch_diag_pseudo", proot, monkeypatch)
    jitted_init(monkeypatch)
    monkeypatch.setattr(jax_consistency, "nn_search", pallas_nn_search)
    before = {}
    compose = pmod.pseudo_target

    def kept(net, *a, **kw):
        if not before:
            before.update({k: v.clone() for k, v in
                           net.state_dict().items()})
        out = compose(net, *a, **kw)
        for k, v in net.state_dict().items():
            assert torch.equal(v, before[k]), k
        assert not net.training
        return out

    monkeypatch.setattr(pmod, "pseudo_target", kept)
    got, want, seen, results, rows = run_both(
        jmod, pmod, capsys, monkeypatch, (middle, 4, warmup),
        dict(device="cpu"), "pseudo_target", "run",
        lambda r: (r[0], r[1], r[2], float(r[3])))
    assert got == want
    assert len(rows) == 4 and before
    for (o, tt, qt, c), (jo, jt, jq, jc) in zip(seen, results):
        tol = FWD_TOL[middle]
        np.testing.assert_allclose(o, jo, **tol)
        np.testing.assert_allclose(tt, jt, rtol=tol["rtol"],
                                   atol=tol["atol"] + ICP_TOL)
        np.testing.assert_allclose(qt, jq, rtol=tol["rtol"],
                                   atol=tol["atol"] + ICP_TOL)
        np.testing.assert_allclose(c, jc, **C_TOL[middle])
