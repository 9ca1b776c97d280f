"""The port's rulebook lookups and plane apply (rslo_tpu_torch.ops.
sparse_conv: ``LOOKUP_METHODS``, the plane builders,
``downsample_level_scatter``, ``sparse_conv_apply_planes``) against the
JAX package, as tests/test_sparse_conv.py holds them there: every
lookup's geometry bit-equal to JAX's in ``build_geometry`` and
``build_band_geometry``; the ranked lookup's strays within its capacity
and past it (the saturated output) bit-equal; the ``RSLO_BAND_CHECK``
guard; an unknown name; and the plane apply against the row apply and
JAX's, in the middle too."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (jax_variables, np_, port_cfg, tiny_scans,
                                to_jax, to_port, tt)

from rslo_tpu.data.prepare import prepare_example as jax_prepare
from rslo_tpu.data.prepare import voxelizer_config as jax_vcfg
from rslo_tpu.models.middle import SparseMiddleCov as JaxMiddle
from rslo_tpu.models.middle import build_band_geometry as jax_band_geometry
from rslo_tpu.models.middle import build_geometry as jax_geometry
from rslo_tpu.ops import band_conv as jbc
from rslo_tpu.ops import sparse_conv as jsc
from rslo_tpu_torch.convert import load_flax_variables
from rslo_tpu_torch.models.middle import (SparseMiddleCov,
                                          build_band_geometry,
                                          build_geometry)
from rslo_tpu_torch.ops import band_conv as bc
from rslo_tpu_torch.ops import sparse_conv as sc

SPARSE_SHAPE = (41, 128, 128)
CAPS = (2048, 2048, 1024, 512)
BAND = dict(windows=(256, 640, 384), block=128)


@pytest.fixture(scope="module")
def frame():
    """(coords, mask, features) of one tiny voxelized scan."""
    cfg = port_cfg("f32")
    pts = tiny_scans(7, 1)[0]
    ex = jax_prepare(jnp.asarray(pts[None]), jnp.ones((1, len(pts)), bool),
                     jax_vcfg(cfg), mean_mode=True)
    return (np.asarray(ex["coords"][0]), np.asarray(ex["voxel_mask"][0]),
            np.asarray(ex["voxel_features"][0]))


def _eq(a, b, what):
    np.testing.assert_array_equal(np_(a), np.asarray(b), err_msg=what)


def _rulebooks(geo):
    for kind in ("sub_rb", "down_rb", "inv_rb"):
        for i, rb in enumerate(getattr(geo, kind)):
            yield f"{kind}[{i}]", rb


@pytest.mark.parametrize("lookup", sc.LOOKUP_METHODS)
def test_geometry_lookup_bit_equal_to_jax(frame, lookup):
    """Levels (slot maps only where the lookup keeps them) and every
    rulebook, bit-equal to JAX's; the valid entries equal the slot-map
    build's, the transposed rulebooks too."""
    coords, mask, _ = frame
    ref = jax.jit(lambda c, m: jax_geometry(c, m, SPARSE_SHAPE, CAPS,
                                            lookup=lookup))(coords, mask)
    geo = build_geometry(tt(coords), tt(mask), SPARSE_SHAPE, CAPS,
                         lookup=lookup, transposed=True)
    base = build_geometry(tt(coords), tt(mask), SPARSE_SHAPE, CAPS,
                          transposed=True)
    for i, (a, b) in enumerate(zip(geo.levels, ref.levels)):
        _eq(a.ids, b.ids, f"L{i} ids")
        _eq(a.coords, b.coords, f"L{i} coords")
        assert (a.slot_map is None) == (b.slot_map is None) or i == 4
        if b.slot_map is not None:
            _eq(a.slot_map, b.slot_map, f"L{i} slot map")
    for (name, a), (_, b), (_, c) in zip(_rulebooks(geo), _rulebooks(ref),
                                         _rulebooks(base)):
        _eq(a.idx, b.idx, f"{lookup} {name}.idx")
        _eq(a.valid, b.valid, f"{lookup} {name}.valid")
        assert a.idx.dtype == torch.int32
        v = c.valid.numpy()
        assert v.any(), name
        _eq(a.valid, v, name)
        _eq(a.idx.numpy()[v], c.idx.numpy()[v], name)
    for a, c in zip(geo.down_rb_t, base.down_rb_t):
        v = c.valid.numpy()
        _eq(a.valid, v, "transposed")
        _eq(a.idx.numpy()[v], c.idx.numpy()[v], "transposed")


@pytest.mark.parametrize("lookup", sc.LOOKUP_METHODS)
def test_band_geometry_lookup_bit_equal_to_jax(frame, lookup):
    coords, mask, _ = frame
    ref = jax.jit(lambda c, m: jax_band_geometry(
        c, m, SPARSE_SHAPE, CAPS, lookup=lookup, **BAND))(coords, mask)
    geo = build_band_geometry(tt(coords), tt(mask), SPARSE_SHAPE, CAPS,
                              lookup=lookup, **BAND)
    for (name, a), (_, b) in zip(_rulebooks(geo), _rulebooks(ref)):
        assert isinstance(a, bc.BandIndex) and isinstance(b, jbc.BandIndex)
        for f in ("base", "sel", "ov_out", "ov_in", "ov_tap", "ov_count"):
            _eq(getattr(a, f), getattr(b, f), f"{lookup} {name}.{f}")


def _random_level(rng, n_active=40, cap=64, shape=(6, 8, 8)):
    ids = np.sort(rng.choice(np.prod(shape), size=n_active, replace=False))
    nz, ny, nx = shape
    coords = np.stack([ids // (ny * nx), (ids // nx) % ny, ids % nx], -1)
    coords = np.concatenate([coords, np.full((cap - n_active, 3), -1)])
    mask = np.arange(cap) < n_active
    return coords.astype(np.int32), mask


def _levels(coords, mask, shape):
    return (sc.level_from_coords(tt(coords), tt(mask), shape),
            jsc.level_from_coords(jnp.asarray(coords), jnp.asarray(mask),
                                  shape))


def _queries(level_coords, shape, mask):
    offs = np.array([[0, 0, 0], [1, 1, 1], [-1, 0, 1], [2, -2, 0],
                     [0, 0, 3], [-2, 1, -1]], np.int32)
    nb = level_coords[:, None, :] + offs[None]
    nz, ny, nx = shape
    q = (nb[..., 0] * ny + nb[..., 1]) * nx + nb[..., 2]
    inb = (q >= 0) & (q < nz * ny * nx) & mask[:, None]
    return q.astype(np.int32), inb


@pytest.mark.parametrize("case", ["roomy", "strays", "saturated"])
@pytest.mark.parametrize("rank", [False, True])
def test_ranked_lookup_strays_bit_equal_to_jax(case, rank):
    """A window smaller than the id spread makes strays: within the
    stray capacity they are resolved (the result equals the slot-map
    lookup's); past it the first ones in flat order are and the rest
    keep found=False, bit for bit as in JAX, the rank output too."""
    shape = (6, 8, 8)
    coords, mask = _random_level(np.random.default_rng(3), 40, 64, shape)
    lv, jlv = _levels(coords, mask, shape)
    q, inb = _queries(lv.coords.numpy(), shape, lv.mask.numpy())
    kw = {"roomy": dict(),
          "strays": dict(block=8, win=16),
          "saturated": dict(block=8, win=16, stray_capacity=5)}[case]
    got = sc._lookup_ranked(lv, tt(q), tt(inb), _return_rank=rank, **kw)
    want = jax.jit(lambda a, b: jsc._lookup_ranked(
        jlv, a, b, _return_rank=rank, **kw))(q, inb)
    _eq(got[0], want[0], "idx")
    _eq(got[1], want[1], "found")
    n_stray = int(sc.ranked_strays(lv, tt(q), tt(inb),
                                   **{k: v for k, v in kw.items()
                                      if k in ("block", "win")}))
    assert (n_stray > kw.get("stray_capacity", 8192)) == \
        (case == "saturated") and (n_stray > 0) == (case != "roomy")
    ia, fa = sc._lookup(sc.with_slot_map(lv), tt(q), tt(inb))
    if case == "saturated":
        lost = fa.numpy() & ~got[1].numpy()
        assert lost.sum() > 0 and not (got[1].numpy() & ~fa.numpy()).any()
    else:
        _eq(got[1], fa, "found vs slot map")
        m = fa.numpy()
        if not rank:
            _eq(got[0].numpy()[m], ia.numpy()[m], "idx vs slot map")


def test_ranked_lookup_last_stray_kept():
    """rows % block == 0 and the final query a stray: the dropped
    resolve entries go to the dump entry, not onto the last query."""
    shape = (6, 8, 8)
    coords, mask = _random_level(np.random.default_rng(4), 32, 32, shape)
    lv, _ = _levels(coords, mask, shape)
    q = lv.ids[-8:][:, None]
    valid = torch.ones((8, 1), dtype=torch.bool)
    idx, found = sc._lookup_ranked(lv, q, valid, block=8, win=4)
    assert bool(found.all())
    _eq(idx[:, 0], torch.arange(24, 32, dtype=torch.int32), "idx")


def test_stray_guard_and_unknown_lookup(monkeypatch, frame):
    shape = (6, 8, 8)
    coords, mask = _random_level(np.random.default_rng(5), 32, 32, shape)
    lv, _ = _levels(coords, mask, shape)
    q = lv.ids[-16:][:, None]
    valid = torch.ones((16, 1), dtype=torch.bool)
    monkeypatch.setenv("RSLO_BAND_CHECK", "1")
    with pytest.raises(RuntimeError, match="stray overflow"):
        sc._lookup_ranked(lv, q, valid, block=16, win=4, stray_capacity=2)
    _, found = sc._lookup_ranked(lv, q, valid, block=16, win=4,
                                 stray_capacity=64)
    assert bool(found.all())
    with pytest.raises(ValueError, match="plan_lookup"):
        sc._dispatch_lookup(lv, q, valid, "rankd")
    coords, mask, _ = frame
    with pytest.raises(ValueError, match="plan_lookup"):
        build_geometry(tt(coords), tt(mask), SPARSE_SHAPE, CAPS,
                       lookup="hash")


@pytest.mark.parametrize("spec", [
    ((9, 24, 24), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((9, 24, 24), (3, 3, 3), (2, 2, 2), (0, 1, 1)),
    ((9, 12, 12), (3, 1, 1), (2, 1, 1), (0, 0, 0))])
@pytest.mark.parametrize("out_capacity", [512, 100])
def test_downsample_level_scatter(spec, out_capacity):
    """Bit-equal to JAX's and to the sort-based downsample (also over
    capacity: the largest ids dropped)."""
    shape, k, s, p = spec
    coords, mask = _random_level(np.random.default_rng(7), 300, 350, shape)
    lv, jlv = _levels(coords, mask, shape)
    got = sc.downsample_level_scatter(lv, k, s, p, out_capacity)
    want = jsc.downsample_level_scatter(jlv, k, s, p, out_capacity)
    sort = sc.downsample_level(lv, k, s, p, out_capacity)
    assert got.shape == want.shape == sort.shape
    for f in ("ids", "coords", "mask"):
        _eq(getattr(got, f), getattr(want, f), f)
        _eq(getattr(got, f), getattr(sort, f), f)


def test_plane_rulebooks_no_row_wrap():
    """ids (z, y, nx-1) and (z, y+1, 0) are consecutive but not x
    neighbours: every plane builder matches the generic one."""
    shape = (3, 4, 5)
    coords = np.array([[1, 1, 4], [1, 2, 0], [1, 3, 4], [2, 0, 0]]
                      + [[-1, -1, -1]] * 4, np.int32)
    mask = np.arange(8) < 4
    lv, _ = _levels(coords, mask, shape)
    lsm = sc.with_slot_map(lv)
    a = sc.build_submanifold_index(lsm)
    for b in (sc.build_submanifold_index_planes(lv, rank_method="ranked"),
              sc.build_submanifold_index_planes(lv, rank_method="sorted"),
              sc.build_submanifold_index_slot_planes(lsm)):
        _eq(b.valid, a.valid, "valid")
        v = a.valid.numpy()
        _eq(b.idx.numpy()[v], a.idx.numpy()[v], "idx")


def _plane_books(seed=0):
    """Port and JAX rulebooks of three kinds (subm, down, inverse) on a
    random level, with their in features and out masks."""
    rng = np.random.default_rng(seed)
    shape = (6, 8, 8)
    coords, mask = _random_level(rng, 40, 64, shape)
    lv = sc.with_slot_map(sc.level_from_coords(tt(coords), tt(mask), shape))
    coarse = sc.with_slot_map(sc.downsample_level(
        lv, (3, 3, 3), (2, 2, 2), (1, 1, 1), out_capacity=32))
    f = rng.normal(size=(64, 4)).astype(np.float32) * mask[:, None]
    cf = rng.normal(size=(32, 4)).astype(np.float32) * \
        coarse.mask.numpy()[:, None]
    w = rng.normal(size=(27, 4, 5)).astype(np.float32)
    return [(sc.build_submanifold_index(lv), f, lv.mask, w),
            (sc.build_conv_index(lv, coarse, (3, 3, 3), (2, 2, 2),
                                 (1, 1, 1)), f, coarse.mask, w),
            (sc.build_inverse_index(coarse, lv, (3, 3, 3), (2, 2, 2),
                                    (1, 1, 1)), cf, lv.mask, w)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_plane_apply_matches_row_apply_and_jax(kind, dtype):
    """Forward: bit-equal to the port's row apply, and its gathered
    operand bit-equal to JAX's (an identity weight turns the conv into
    its operand); the product against JAX's plane apply at the row
    apply's bound.  Gradient (autograd): the features' and the weights'
    against the row apply's and JAX's plane apply's."""
    rb, f, om, w = _plane_books()[kind]
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jrb = jsc.ConvIndex(jnp.asarray(rb.idx.numpy()),
                        jnp.asarray(rb.valid.numpy()))
    ft, wt = tt(f).requires_grad_(), tt(w).requires_grad_()
    out = sc.sparse_conv_apply_planes(ft, rb, wt, out_mask=om,
                                      compute_dtype=tdt)
    row = sc.sparse_conv_apply(tt(f), rb, tt(w), out_mask=om,
                               compute_dtype=tdt)
    _eq(out, row, "plane vs row")
    eye = np.eye(27 * 4, dtype=np.float32).reshape(27, 4, 27 * 4)
    _eq(sc.sparse_conv_apply_planes(tt(f), rb, tt(eye), compute_dtype=tdt),
        jsc.sparse_conv_apply_planes(jnp.asarray(f), jrb, jnp.asarray(eye),
                                     compute_dtype=jdt), "operand")

    def jloss(f_, w_):
        y = jsc.sparse_conv_apply_planes(f_, jrb, w_,
                                         out_mask=jnp.asarray(om.numpy()),
                                         compute_dtype=jdt)
        return jnp.sum(y * jnp.cos(y)), y
    (_, want), (jgf, jgw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(f), jnp.asarray(w))
    np.testing.assert_allclose(np_(out), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    torch.sum(out * torch.cos(out)).backward()
    fr, wr = tt(f).requires_grad_(), tt(w).requires_grad_()
    y = sc.sparse_conv_apply(fr, rb, wr, out_mask=om, compute_dtype=tdt)
    torch.sum(y * torch.cos(y)).backward()
    # the row apply rounds its gathered rows, the plane apply the
    # features: the same values, the cotangent summed in other orders
    for got, ref_row, ref_jax in ((ft.grad, fr.grad, jgf),
                                  (wt.grad, wr.grad, jgw)):
        scale = float(np.abs(np.asarray(ref_jax, np.float32)).max())
        tol = (1e-5 if dtype == "f32" else 1e-2) * scale
        np.testing.assert_allclose(np_(got), np_(ref_row), rtol=0, atol=tol)
        np.testing.assert_allclose(np_(got), np.asarray(ref_jax, np.float32),
                                   rtol=0, atol=tol)


def test_plane_apply_asserts():
    rb, f, _, w = _plane_books()[0]
    with pytest.raises(AssertionError, match="27-tap"):
        sc.sparse_conv_apply_planes(tt(f), sc.ConvIndex(rb.idx[:, :9],
                                                        rb.valid[:, :9]),
                                    tt(w[:9]))
    small = sc.ConvIndex(torch.zeros((5, 27), dtype=torch.int32),
                         torch.zeros((5, 27), dtype=torch.bool))
    with pytest.raises(AssertionError, match=">=4 feature rows"):
        sc.sparse_conv_apply_planes(tt(f[:3]), small, tt(w))


def test_plane_apply_middle_forward(frame):
    """SparseMiddleCov with plane_apply on equals it off, bit for bit
    (the z collapse stays on the row path); and JAX's with the flag on
    at tests/test_torch_middle.py's f32 bound."""
    coords, mask, feats = frame
    cfg = port_cfg("f32", "bn")
    geo = build_geometry(tt(coords), tt(mask), SPARSE_SHAPE, CAPS)
    jgeo = jax.jit(lambda c, m: jax_geometry(c, m, SPARSE_SHAPE, CAPS))(
        coords, mask)
    jmod = JaxMiddle(dataclasses.replace(cfg.middle, plane_apply=True))
    variables = jax_variables(jmod, 0, jnp.asarray(feats), jgeo, train=False)
    ref = jax.jit(lambda v, x, g: jmod.apply(v, x, g, False))(
        to_jax(variables), jnp.asarray(feats), jgeo)
    outs = []
    for pa in (False, True):
        m = dataclasses.replace(to_port(cfg).middle, plane_apply=pa)
        mod = load_flax_variables(SparseMiddleCov(m), variables).eval()
        with torch.no_grad():
            if pa:
                outs.append(mod(tt(feats), geo))
            else:   # the row path's plain version, as on the card
                with pytest.MonkeyPatch.context() as mp:
                    from rslo_tpu_torch.models import middle as pm
                    mp.setattr(pm, "gather_matmul", _plain_gather_matmul)
                    outs.append(mod(tt(feats), geo))
    _eq(outs[1][0], outs[0][0], "bev")
    _eq(outs[1][1], outs[0][1], "cov")
    np.testing.assert_allclose(np_(outs[1][0]), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_(outs[1][1]), np.asarray(ref[1]),
                               rtol=1e-5, atol=1e-5)


def _plain_gather_matmul(features, idx, valid, weights, bias, out_mask,
                         compute_dtype):
    return sc.sparse_conv_apply(features, sc.ConvIndex(idx, valid),
                                weights, bias, out_mask, compute_dtype)
