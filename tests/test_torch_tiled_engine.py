"""The port's tiled engine (rslo_tpu_torch.ops.tiled_conv and
``engine="tiles"`` of models.middle) against the JAX package: the tile
geometry bit-equal, each tiled op in float32, SparseMiddleCov in eval
and train-mode BN against JAX's tiled engine and against the port's
rulebook engine, the gradients, an OdomNet train step (against the
rulebook engine), a streamed sequence, JAX's parameters loading across
engines (the engines share one parameter tree), and the corner tap that
the tiled halo drops behind an inactive edge tile, in JAX too.

The frame is tests/test_tiled_engine.py's: 1500 random voxels of a
(41, 64, 64) grid and 200 padding rows.  The tiled engine computes in
float32 whatever ``conv_dtype`` says, on both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (jax_variables, np_, port_cfg, tiny_scans,
                                to_jax, to_port, tt)

from rslo_tpu.config.schema import MiddleCfg
from rslo_tpu.data.prepare import prepare_example as jax_prepare
from rslo_tpu.data.prepare import voxelizer_config as jax_vcfg
from rslo_tpu.eval.streaming import StreamingOdometry as JaxStreaming
from rslo_tpu.models.middle import SparseMiddleCov as JaxMiddle
from rslo_tpu.models.middle import build_geometry as jax_geometry
from rslo_tpu.models.middle import build_tiled_geometry as jax_tiled
from rslo_tpu.models.net import OdomNet as JaxOdomNet
from rslo_tpu.ops import tiled_conv as jtc
from rslo_tpu_torch.config.schema import MiddleCfg as PortMiddleCfg
from rslo_tpu_torch.convert import (flax_path, load_flax_variables,
                                    to_flax_leaf)
from rslo_tpu_torch.eval.streaming import StreamingOdometry
from rslo_tpu_torch.models.middle import (SparseMiddleCov, build_geometry,
                                          build_tiled_geometry)
from rslo_tpu_torch.models.net import OdomNet
from rslo_tpu_torch.ops import tiled_conv as tc
from rslo_tpu_torch.train.loop import make_optimizer
from rslo_tpu_torch.train.state import TrainState
from rslo_tpu_torch.train.step import loss_and_grads

GRID = (41, 64, 64)
CAPS = (4096, 6144, 4096, 2048)     # ample: no level overflows
TCAPS = (2048, 256)
OP_TOL = 1e-5                       # of the largest |value|, f32
GRAD_TOL = 1e-4                     # relative L2, per parameter
# JAX's own bounds of the tiled engine against the rulebook engine
# (tests/test_tiled_engine.py): eval, and train-mode BN
ENGINE_TOL = {False: dict(rtol=2e-4, atol=2e-4),
              True: dict(rtol=5e-4, atol=5e-4)}


def _frame(seed=0, n=1500, pad=200):
    rng = np.random.default_rng(seed)
    nz, ny, nx = GRID
    ids = np.sort(rng.choice(nz * ny * nx, size=n, replace=False))
    coords = np.stack([ids // (ny * nx), (ids // nx) % ny, ids % nx],
                      -1).astype(np.int32)
    coords = np.concatenate([coords, np.full((pad, 3), -1, np.int32)])
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    feats = rng.normal(size=(n + pad, 7)).astype(np.float32)
    feats[~mask] = 0
    return coords, mask, feats


@pytest.fixture(scope="module")
def frame():
    coords, mask, feats = _frame()
    ref = jax.jit(jax_tiled, static_argnums=(2, 3))(
        jnp.asarray(coords), jnp.asarray(mask), GRID, TCAPS)
    geo = build_tiled_geometry(tt(coords), tt(mask), GRID, TCAPS)
    return coords, mask, feats, ref, geo


def _close(got, want, tol=OP_TOL):
    want = np.asarray(want)
    got = np_(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def _eq(a, b, what):
    np.testing.assert_array_equal(np_(a), np.asarray(b), what)


@pytest.mark.parametrize("tcaps", [TCAPS, (300, 40)])
def test_tile_geometry_bit_equal_to_jax(frame, tcaps):
    """Every tensor of the geometry, also with both tile levels over
    capacity (the tiles past it dropped)."""
    coords, mask = frame[:2]
    ref = jax.jit(jax_tiled, static_argnums=(2, 3))(
        jnp.asarray(coords), jnp.asarray(mask), GRID, tcaps)
    geo = build_tiled_geometry(tt(coords), tt(mask), GRID, tcaps)
    for name in ("l0", "l1"):
        a, b = getattr(geo, name), getattr(ref, name)
        assert (a.grid, a.tgrid, a.tile) == (b.grid, b.tgrid, b.tile)
        for f in ("tile_coords", "tile_mask", "slot_map", "nb_lo", "nb_hi",
                  "occ"):
            _eq(getattr(a, f), getattr(b, f), f"{name}.{f}")
            assert np_(getattr(a, f)).dtype == np.asarray(getattr(b, f)).dtype
    for f in ("cell_index", "occ2", "occ3", "occ4"):
        _eq(getattr(geo, f), getattr(ref, f), f)
    if tcaps == (300, 40):
        assert bool(geo.l0.tile_mask.all()) and bool(geo.l1.tile_mask.all())
        assert int((geo.cell_index == geo.cell_index.max()).sum()) > 0


def _blocks(rng, lvl, C):
    x = rng.normal(size=(lvl.capacity + 1,) + tuple(lvl.tile) + (C,))
    x[-1] = 0
    return x.astype(np.float32)


def _dense(rng, shape, C):
    return rng.normal(size=tuple(shape) + (C,)).astype(np.float32)


def _w(rng, taps, cin, cout):
    return (rng.normal(size=(taps, cin, cout)) * 0.2).astype(np.float32), \
        rng.normal(size=(cout,)).astype(np.float32)


def _pad2(lvl):
    return tuple(lvl.tgrid[d] * lvl.half[d] for d in range(3))


OPS = ["subm", "down", "down_dense", "dense_subm", "dense_down",
       "zcollapse", "inv_dense", "inv_tiles"]


@pytest.mark.parametrize("op", OPS)
def test_tiled_op_matches_jax(frame, op):
    _, _, _, ref, geo = frame
    rng = np.random.default_rng(OPS.index(op))
    cin, cout = 5, 6
    w, b = _w(rng, 3 if op == "zcollapse" else 27, cin, cout)
    jw, jb, pw, pb = jnp.asarray(w), jnp.asarray(b), tt(w), tt(b)
    pad2 = _pad2(geo.l1)
    if op == "subm":
        x = _blocks(rng, geo.l0, cin)
        want = jtc.subm_conv(jnp.asarray(x), ref.l0, jw, jb)
        got = tc.subm_conv(tt(x), geo.l0, pw, pb)
    elif op == "down":
        x = _blocks(rng, geo.l0, cin)
        want = jtc.down_conv(jnp.asarray(x), ref.l0, ref.l1, jw, jb)
        got = tc.down_conv(tt(x), geo.l0, geo.l1, pw, pb)
    elif op == "down_dense":
        x = _blocks(rng, geo.l1, cin)
        want = jtc.down_to_dense(jnp.asarray(x), ref.l1, pad2, jw, jb,
                                 ref.occ2)
        got = tc.down_to_dense(tt(x), geo.l1, pad2, pw, pb, geo.occ2)
    elif op == "dense_subm":
        x = _dense(rng, pad2, cin)
        want = jtc.dense_subm_conv(jnp.asarray(x), ref.occ2, jw, jb)
        got = tc.dense_subm_conv(tt(x), geo.occ2, pw, pb)
    elif op == "dense_down":
        x = _dense(rng, pad2, cin)
        spec = ((3, 3, 3), (2, 2, 2), (0, 1, 1))
        want = jtc.dense_down_conv(jnp.asarray(x), ref.occ3, jw, jb, *spec)
        got = tc.dense_down_conv(tt(x), geo.occ3, pw, pb, *spec)
    elif op == "zcollapse":
        x = _dense(rng, geo.occ3.shape, cin)
        want = jtc.zcollapse_conv(jnp.asarray(x), ref.occ4, jw, jb)
        got = tc.zcollapse_conv(tt(x), geo.occ4, pw, pb)
    elif op == "inv_dense":
        x = _dense(rng, pad2, cin)
        want = jtc.inverse_from_dense(jnp.asarray(x), ref.l1, jw, jb)
        got = tc.inverse_from_dense(tt(x), geo.l1, pw, pb)
    else:
        x = _blocks(rng, geo.l1, cin)
        want = jtc.inverse_from_tiles(jnp.asarray(x), ref.l1, ref.l0, jw, jb)
        got = tc.inverse_from_tiles(tt(x), geo.l1, geo.l0, pw, pb)
    assert float(np.abs(np.asarray(want)).max()) > 1.0
    _close(got, want)


def test_voxel_scatter_gather_and_halo_bit_equal(frame):
    _, _, feats, ref, geo = frame
    blocks = tc.scatter_voxels(tt(feats), geo.cell_index, geo.l0)
    jblocks = jtc.scatter_voxels(jnp.asarray(feats), ref.cell_index, ref.l0)
    _eq(blocks, jblocks, "scatter")
    _eq(tc.gather_voxels(blocks, geo.cell_index),
        jtc.gather_voxels(jblocks, ref.cell_index), "gather")
    for lo, hi in (((1, 1, 1), (1, 1, 1)), ((1, 1, 1), (0, 0, 0)),
                   ((0, 0, 0), (1, 1, 1))):
        _eq(tc.halo(blocks, geo.l0, lo, hi),
            jtc.halo(jblocks, ref.l0, lo, hi), f"halo {lo} {hi}")


def test_tiled_halo_drops_a_corner_tap_as_jax_does():
    """The 3-pass halo carries a corner neighbour through the edge tile
    between: voxel A at (6, 7, 8) (tile (3, 0, 1)) reaches its
    (+1 y, -1 x) neighbour B at (6, 8, 7) (tile (3, 1, 0)) only through
    tile (3, 0, 0), which holds no voxel and no ghost, so the tiled
    subm conv drops that tap, in JAX's tiled engine as in the port
    (bit-equal), while B sees A through the active (3, 1, 1) and the
    rulebook engine sees both."""
    coords = np.array([[6, 7, 8], [6, 8, 7]] + [[-1, -1, -1]] * 6,
                      np.int32)
    mask = np.arange(8) < 2
    ones = mask[:, None].astype(np.float32)
    w = np.eye(27, dtype=np.float32)[:, None, :]       # tap k -> channel k
    b = np.zeros(27, np.float32)
    geo = build_tiled_geometry(tt(coords), tt(mask), GRID, TCAPS)
    seen = tc.gather_voxels(tc.subm_conv(tc.scatter_voxels(
        tt(ones), geo.cell_index, geo.l0), geo.l0, tt(w), tt(b)),
        geo.cell_index)
    ref = jax_tiled(jnp.asarray(coords), jnp.asarray(mask), GRID, TCAPS)
    jseen = jtc.gather_voxels(jtc.subm_conv(jtc.scatter_voxels(
        jnp.asarray(ones), ref.cell_index, ref.l0), ref.l0, jnp.asarray(w),
        jnp.asarray(b)), ref.cell_index)
    _eq(seen, jseen, "taps seen")
    rb = build_geometry(tt(coords), tt(mask), GRID, CAPS).sub_rb[0]
    a_to_b = (1 * 3 + 2) * 3 + 0          # tap (dz 0, dy +1, dx -1)
    b_to_a = (1 * 3 + 0) * 3 + 2          # tap (dz 0, dy -1, dx +1)
    assert bool(rb.valid[0, a_to_b]) and bool(rb.valid[1, b_to_a])
    want = rb.valid[:2].clone()
    want[0, a_to_b] = False               # the one tap the halo drops
    assert torch.equal(seen[:2] > 0.5, want)


def _mcfg(bn_type):
    return MiddleCfg(bn_type=bn_type, channels=(8, 8, 16, 16),
                     level_capacities=CAPS, tile_capacities=TCAPS,
                     remat=False, conv_dtype="f32")


@pytest.fixture(scope="module")
def middles(frame):
    """JAX's SparseMiddleCov on the tiled and the rulebook geometry, in
    eval (bn) and train mode (bn, then none for the gradients), and the
    port's module on the same weights."""
    coords, mask, feats, ref, _ = frame
    jcoords, jmask, jfeats = map(jnp.asarray, (coords, mask, feats))
    jgeo_rb = jax.jit(jax_geometry, static_argnums=(2, 3))(
        jcoords, jmask, GRID, CAPS)
    out = {}
    for bn in ("bn", "none"):
        jmod = JaxMiddle(_mcfg(bn))
        variables = jax_variables(jmod, 1, jfeats, jgeo_rb, train=False)
        v = to_jax(variables)
        for train in (False, True):
            (bev, cov), mut = jax.jit(lambda v_, g, t=train: jmod.apply(
                v_, jfeats, g, t, mutable=["batch_stats"] if t else []))(
                    v, ref)
            out[bn, train] = dict(bev=np.asarray(bev), cov=np.asarray(cov),
                                  stats=jax.tree.map(np.asarray, mut))
        out[bn, "vars"] = variables

    jmod = JaxMiddle(_mcfg("none"))

    def loss(params):
        (bev, cov), _ = jmod.apply(
            {"params": params}, jfeats, ref, True, mutable=["batch_stats"])
        return jnp.sum(bev ** 2) * 1e-3 + jnp.sum(cov ** 2) * 1e-3
    out["grads"] = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(
        to_jax(out["none", "vars"]["params"])))
    return out


def _port_middle(variables, bn, train):
    cfg = PortMiddleCfg(**dataclasses.asdict(_mcfg(bn)))
    return load_flax_variables(SparseMiddleCov(cfg), variables).train(train)


@pytest.mark.parametrize("train", [False, True])
def test_tiled_middle_matches_jax_and_rulebook(frame, middles, train):
    coords, mask, feats, _, geo = frame
    want = middles["bn", train]
    mod = _port_middle(middles["bn", "vars"], "bn", train)
    with torch.no_grad():
        bev, cov = mod(tt(feats), geo)
    assert bev.shape == want["bev"].shape == (8, 8, 32)
    _close(bev, want["bev"])
    _close(cov, want["cov"])
    if train:       # the running statistics moved as JAX's
        for name, b in mod.named_buffers():
            col, path = flax_path(name, b.dim())
            w = want["stats"][col]
            for k in path:
                w = w[k]
            np.testing.assert_allclose(np_(b), w, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    # the port's rulebook engine on the same weights
    mod = _port_middle(middles["bn", "vars"], "bn", train)
    with torch.no_grad():
        bev_rb, cov_rb = mod(tt(feats), build_geometry(
            tt(coords), tt(mask), GRID, CAPS))
    np.testing.assert_allclose(np_(bev), np_(bev_rb), **ENGINE_TOL[train])
    np.testing.assert_allclose(np_(cov), np_(cov_rb), **ENGINE_TOL[train])


def test_tiled_middle_gradients_match_jax(frame, middles):
    """Relative L2 over the whole tree and per parameter.  The biases of
    the convs that a train-mode BN follows (the decoder's) have a zero
    gradient in exact arithmetic and carry f32 noise on both sides, so
    a parameter's bound has a floor relative to the whole tree's norm."""
    feats, geo = frame[2], frame[4]
    mod = _port_middle(middles["none", "vars"], "none", True)
    bev, cov = mod(tt(feats), geo)
    loss = torch.sum(bev ** 2) * 1e-3 + torch.sum(cov ** 2) * 1e-3
    loss.backward()
    pairs = []
    for name, p in mod.named_parameters():
        want = middles["grads"]
        for k in flax_path(name, p.dim())[1]:
            want = want[k]
        pairs.append((name, to_flax_leaf(name, p.grad), want))
    assert len(pairs) == 50          # 20 convs, 5 decoder BNs

    def norm(a):
        return float(np.linalg.norm(np.asarray(a, np.float64)))
    total = np.sqrt(sum(norm(w) ** 2 for _, _, w in pairs))
    diff = np.sqrt(sum(norm(g - w) ** 2 for _, g, w in pairs))
    assert total > 0 and diff <= GRAD_TOL * total, (diff, total)
    for name, g, w in pairs:
        assert norm(g - w) <= GRAD_TOL * norm(w) + 1e-6 * total, name


def _tiles_cfg():
    """The tiny f32 config on the tiled engine, with level capacities
    that no scan overflows (the engines drop different sites past
    them)."""
    cfg = port_cfg("f32")
    return cfg.replace(
        middle=dataclasses.replace(cfg.middle, engine="tiles",
                                   level_capacities=(2048, 8192, 8192,
                                                     4096)),
        odom=dataclasses.replace(cfg.odom, bn_type="none"))


def test_odomnet_train_step_on_tiles_matches_rulebook():
    """One f32 step of the whole objective through ``loss_and_grads`` on
    the tiled engine against the rulebook engine on the same weights
    (JAX's train-mode bound of the two engines): the loss and the
    gradient norm.  The middle's gradients are held against JAX's in
    test_tiled_middle_gradients_match_jax."""
    cfg = _tiles_cfg()
    scans = tiny_scans(5, 2)
    batch = {"points": tt(np.stack(scans)),
             "point_mask": torch.ones((2, len(scans[0])), dtype=torch.bool),
             "odometry": torch.tensor([[0.05, 0.0, 0.0, 1, 0, 0, 0]])}
    ex = jax_prepare(jnp.asarray(np_(batch["points"])),
                     jnp.ones((2, len(scans[0])), bool), jax_vcfg(cfg),
                     mean_mode=True)
    variables = jax_variables(JaxOdomNet(cfg), 4, ex, train=False)
    out = {}
    for engine in ("tiles", "rulebook"):
        pcfg = to_port(cfg.replace(middle=dataclasses.replace(
            cfg.middle, engine=engine)))
        net = load_flax_variables(OdomNet(pcfg), variables)
        state = TrainState.create(net, make_optimizer(pcfg, net),
                                  {"rot": -2.5, "trans": 0.0})
        res, grads = loss_and_grads(state, batch, pcfg, warmup=False)
        out[engine] = (float(res.total.detach()), np.sqrt(sum(
            float(torch.sum(g.double() ** 2)) for g in grads.values())))
    assert all(np.isfinite(out["tiles"])) and out["tiles"][1] > 0
    np.testing.assert_allclose(out["tiles"], out["rulebook"],
                               **ENGINE_TOL[True])


def test_streaming_on_tiles_matches_jax():
    cfg = _tiles_cfg()
    scans = tiny_scans(21, 3)
    jnet = JaxOdomNet(cfg)
    ex = jax_prepare(jnp.asarray(np.stack(scans[:2])),
                     jnp.ones((2, len(scans[0])), bool), jax_vcfg(cfg),
                     mean_mode=True)
    variables = jax_variables(jnet, 0, ex, train=False)
    net = load_flax_variables(OdomNet(to_port(cfg)), variables).eval()
    jstream = JaxStreaming(jnet, to_jax(variables), cfg)
    stream = StreamingOdometry(net, to_port(cfg), "cpu")
    for scan in scans:
        np.testing.assert_allclose(stream.push(scan), jstream.push(scan),
                                   rtol=1e-5, atol=1e-5)
    assert len(stream.trajectory) == 3


def test_parameters_load_across_engines(frame, middles):
    """JAX's variables made on the tiled geometry have the rulebook
    engine's tree, and either engine of the port runs them: the port's
    rulebook engine on JAX's tiled-init variables matches JAX's
    rulebook engine on them."""
    coords, mask, feats, ref, _ = frame
    jmod = JaxMiddle(_mcfg("bn"))
    v_tiles = jax_variables(jmod, 1, jnp.asarray(feats), ref, train=False)
    v_rb = middles["bn", "vars"]
    assert jax.tree.structure(v_tiles) == jax.tree.structure(v_rb)
    assert all(a.shape == b.shape for a, b in zip(
        jax.tree.leaves(v_tiles), jax.tree.leaves(v_rb)))
    jgeo_rb = jax.jit(jax_geometry, static_argnums=(2, 3))(
        jnp.asarray(coords), jnp.asarray(mask), GRID, CAPS)
    want = jax.jit(lambda v, g: jmod.apply(v, jnp.asarray(feats), g, False))(
        to_jax(v_tiles), jgeo_rb)
    mod = _port_middle(v_tiles, "bn", False)
    with torch.no_grad():
        bev, cov = mod(tt(feats), build_geometry(tt(coords), tt(mask), GRID,
                                                 CAPS))
    _close(bev, want[0])
    _close(cov, want[1])
