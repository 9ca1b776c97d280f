"""Port the band engine's conv (rslo_tpu_torch.ops.band_conv) against the
JAX package, on the rulebooks of a real tiny frame:

  * plans (base, sel, ov_*, ov_count) bit-equal to ``build_band_index``
    for a submanifold, a strided and an inverse rulebook, at a roomy
    window, at a tiny one where many pairs overflow, and at a saturated
    overflow capacity; ``overflow_saturated``; the ``RSLO_BAND_CHECK``
    guard;
  * the forward against JAX's Pallas path (interpret mode) in f32 and
    bf16, and against its XLA path in f32;
  * d_features, d_W and d_bias against ``jax.vjp``: through the Pallas
    custom VJP for the self-transpose (submanifold) plan, and through
    the XLA VJP for a strided and an inverse plan, in f32 and bf16.

The plain versions of B4 and B5 are what runs here (CPU tensors)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import interpreted_pallas, tiny_scans, tt

from rslo_tpu.ops import band_conv as jbc
from rslo_tpu.ops import sparse_conv as jsc
from rslo_tpu.ops.voxelize import VoxelizerConfig as JaxVcfg
from rslo_tpu.ops.voxelize import voxelize_sorted_mean as jax_vox
from rslo_tpu_torch.models.middle import build_geometry
from rslo_tpu_torch.ops import band_conv as bc
from rslo_tpu_torch.ops import sparse_conv as sc

SPARSE_SHAPE = (41, 128, 128)     # tests/test_model.py::tiny_cfg grid
CAPS = (2048, 2048, 1024, 512)
BLOCK = 128
# roomy windows per kind (multiples of 128, as the JAX package needs)
ROOMY = {"subm": 256, "down": 640, "inverse": 384}
TINY_WINDOW, TINY_BLOCK = 16, 64
# f32, and bf16 where both sides round the same operands: the same exact
# f32 products summed in another order, |err| <= REL * sum|terms| + ABS
REL, ABS = 1e-5, 1e-6
# bf16 d_features of a strided or inverse plan: JAX's XLA VJP rounds each
# tap's partial to bf16 (as the port does, up to one ulp where the f32
# sums inside a partial run in another order) and then sums a row's
# partials in bf16 (the transpose of its windowed dynamic_slice is a bf16
# scatter-add), where the port sums them in f32: each of up to K bf16
# additions moves the sum by at most bf16's unit roundoff 2^-8 of the
# running magnitude, so |err| <= (K + 1) * 2^-8 * sum|terms| + ABS
BF16_SUM_REL = 2.0 ** -8
CDT = {"f32": (torch.float32, jnp.float32),
       "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def frame():
    pts = tiny_scans(0, 1)[0]
    vcfg = JaxVcfg(point_cloud_range=(-6.4, -6.4, -0.8, 6.4, 6.4, 0.8),
                   voxel_size=(0.1, 0.1, 0.04), max_points=4,
                   max_voxels=2048)
    vox = jax_vox(jnp.asarray(pts), jnp.ones(len(pts), bool), vcfg)
    return build_geometry(tt(np.asarray(vox.coords)),
                          tt(np.asarray(vox.mask)), SPARSE_SHAPE, CAPS,
                          transposed=True)


def _conv(geo, kind):
    """(in level, out level, rulebook, transposed rulebook, flip)."""
    return {"subm": (0, 0, geo.sub_rb[0], geo.sub_rb[0], True),
            "down": (0, 1, geo.down_rb[0], geo.down_rb_t[0], False),
            "inverse": (1, 0, geo.inv_rb[1], geo.down_rb[0], False)}[kind]


def _plans(geo, kind, case):
    """The same plan from both packages: (jax plan, port plan, rulebook
    and the rest of _conv)."""
    lin, lout, rb, rb_t, flip = _conv(geo, kind)
    v_in = geo.levels[lin].capacity
    n_valid = int(rb.valid.sum())
    kw = {"roomy": dict(block=BLOCK, window=ROOMY[kind]),
          "tiny": dict(block=TINY_BLOCK, window=TINY_WINDOW,
                       ov_capacity=n_valid + 64),
          "saturated": dict(block=TINY_BLOCK, window=TINY_WINDOW,
                            ov_capacity=16)}[case]
    jrb = jsc.ConvIndex(jnp.asarray(rb.idx.numpy()),
                        jnp.asarray(rb.valid.numpy()))
    jplan = jbc.build_band_index(jrb, v_in, self_transpose=flip, **kw)
    plan = bc.build_band_index(rb, v_in, self_transpose=flip, **kw)
    return jplan, plan, (lin, lout, rb, rb_t, flip)


@pytest.mark.parametrize("case", ["roomy", "tiny", "saturated"])
@pytest.mark.parametrize("kind", ["subm", "down", "inverse"])
def test_plan_bit_equal_to_jax(frame, kind, case):
    jplan, plan, (_, _, rb, _, flip) = _plans(frame, kind, case)
    for name in ("base", "sel", "ov_out", "ov_in", "ov_tap", "ov_count"):
        got, want = getattr(plan, name), np.asarray(getattr(jplan, name))
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert (plan.v_out, plan.v_in, plan.window, plan.self_transpose) == \
        (jplan.v_out, jplan.v_in, jplan.window, flip)
    assert plan.ov_capacity == jplan.ov_capacity
    saturated = bool(bc.overflow_saturated(plan))
    assert saturated == bool(np.asarray(jbc.overflow_saturated(jplan)))
    n_ov = int(plan.ov_count)
    Vp = plan.sel.shape[0] * plan.sel.shape[2]
    stored = int((plan.ov_out < Vp).sum())
    if case == "roomy":
        assert n_ov == stored and not saturated
    elif case == "tiny":         # many pairs overflow, all are kept
        assert n_ov == stored > 100
        assert not saturated
    else:
        assert n_ov > stored == plan.ov_capacity and saturated


def test_band_check_guard_raises_on_saturated_plan(frame, monkeypatch):
    _, sat, (lin, lout, rb, _, _) = _plans(frame, "subm", "saturated")
    _, ok, _ = _plans(frame, "subm", "tiny")
    f = torch.randn(frame.levels[lin].capacity, 4)
    w = torch.randn(27, 4, 8)
    bc.band_conv_apply(f, sat, w)                 # guard off: no raise
    monkeypatch.setenv("RSLO_BAND_CHECK", "1")
    with pytest.raises(RuntimeError, match="saturated"):
        bc.band_conv_apply(f, sat, w)
    bc.band_conv_apply(f, ok, w)                  # the exact plan passes


def _inputs(geo, lin, lout, rb, seed, cin=16, cout=8):
    rng = np.random.default_rng(seed)
    K = rb.idx.shape[1]
    f = rng.normal(size=(geo.levels[lin].capacity, cin)).astype(np.float32)
    f[~geo.levels[lin].mask.numpy()] = 0.0
    w = rng.normal(0, 0.3, (K, cin, cout)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    ct = rng.normal(size=(geo.levels[lout].capacity, cout)).astype(
        np.float32)
    return f, w, b, ct, geo.levels[lout].mask


def _assert_within(got, want, mag, rel, what):
    err = np.abs(np.asarray(got) - np.asarray(want))
    bound = rel * np.asarray(mag) + ABS
    assert (err <= bound).all(), (what, float(err.max()),
                                  float((err / bound).max()))


_JAX_RUNS = {}


def _run(frame, kind, case, precision, monkeypatch):
    """The conv through both packages, forward and backward, once per
    (kind, case, precision) for this module: JAX's Pallas path
    (interpret mode) under ``jax.vjp``, the port's ``band_conv``.
    Returns {"forward"|"d_features"|"d_W": (port, jax, sum|terms|)}."""
    key = (kind, case, precision)
    if key in _JAX_RUNS:
        return _JAX_RUNS[key]
    interpreted_pallas(monkeypatch)
    jplan, plan, (lin, lout, rb, rb_t, flip) = _plans(frame, kind, case)
    f, w, b, ct, om = _inputs(frame, lin, lout, rb, 1)
    tcdt, jcdt = CDT[precision]

    def fwd_bwd(f_, w_, b_, ct_):
        out_, vjp = jax.vjp(
            lambda a, c, d: jbc.band_conv_apply(
                a, jplan, c, d, jnp.asarray(om.numpy()), compute_dtype=jcdt,
                impl="pallas"), f_, w_, b_)
        return (out_,) + vjp(ct_)
    # jitted: an eager interpret-mode pallas_call is traced anew each call
    ref, jdf, jdw, jdb = (np.asarray(a) for a in jax.jit(fwd_bwd)(
        jnp.asarray(f), jnp.asarray(w), jnp.asarray(b), jnp.asarray(ct)))
    tf, tw, tb = (tt(a).requires_grad_() for a in (f, w, b))
    out = bc.band_conv(tf, plan, tw, tb, om, tcdt, rb, rb_t)
    assert out.shape == ref.shape and out.dtype == torch.float32
    out.backward(tt(ct))
    np.testing.assert_allclose(tb.grad.numpy(), jdb, rtol=1e-5, atol=1e-5)
    # sum of |terms| of every output and gradient entry
    mag = sc.sparse_conv_apply(tt(np.abs(f)), rb, tt(np.abs(w))).numpy()
    ctm = np.where(om.numpy()[:, None], np.abs(ct), 0.0).astype(np.float32)
    wa = tt(np.abs(w)).flip(0) if flip else tt(np.abs(w))
    mag_f = sc.sparse_conv_dgrad(tt(ctm), rb_t,
                                 wa.transpose(1, 2).contiguous()).numpy()
    g = np.abs(f)[rb.idx.numpy()] * rb.valid.numpy()[..., None]
    mag_w = np.einsum("vkc,vo->kco", g, ctm)
    for a in (ref, jdf, jdw):
        assert float(np.abs(np.asarray(a)).max()) > 0.1
    _JAX_RUNS[key] = {
        "forward": (out.detach().numpy(), np.asarray(ref), mag),
        "d_features": (tf.grad.numpy(), jdf, mag_f),
        "d_W": (tw.grad.numpy(), jdw, mag_w)}
    return _JAX_RUNS[key]


# (kind, window case, precision) of the runs against JAX's Pallas path:
# the submanifold plan at its roomy window in bf16 (the deployed case)
# and at the tiny one in both precisions; a strided plan at its roomy
# window and an inverse one at the tiny window, where ~60% of its pairs
# overflow, in both precisions.  (Each submanifold run compiles three
# interpret-mode Pallas kernels, ~9 s on one CPU core.)
RUNS = [("subm", "roomy", "bf16"), ("subm", "tiny", "f32"),
        ("subm", "tiny", "bf16"), ("down", "roomy", "f32"),
        ("down", "roomy", "bf16"), ("inverse", "tiny", "f32"),
        ("inverse", "tiny", "bf16")]


@pytest.mark.parametrize("kind,case,precision", RUNS)
def test_forward_matches_jax_pallas(frame, kind, case, precision,
                                    monkeypatch):
    """Both sides add the same exact f32 products of operands rounded to
    the compute dtype (in-window) and of unrounded f32 operands
    (overflow, the Pallas path's epilogue)."""
    run = _run(frame, kind, case, precision, monkeypatch)
    _assert_within(*run["forward"], REL, "forward")


@pytest.mark.parametrize("case", ["roomy", "tiny"])
def test_forward_matches_jax_xla_f32(frame, case):
    jplan, plan, (lin, lout, rb, _, _) = _plans(frame, "subm", case)
    f, w, b, _, om = _inputs(frame, lin, lout, rb, 2)
    ref = jbc.band_conv_apply(jnp.asarray(f), jplan, jnp.asarray(w),
                              jnp.asarray(b), jnp.asarray(om.numpy()),
                              compute_dtype=jnp.float32, impl="xla")
    out = bc.band_conv_apply(tt(f), plan, tt(w), tt(b), om, torch.float32)
    mag = sc.sparse_conv_apply(tt(np.abs(f)), rb, tt(np.abs(w)))
    _assert_within(out.numpy(), ref, mag.numpy(), REL, "forward")


@pytest.mark.parametrize("kind,case,precision", RUNS[:3])
def test_self_transpose_grads_match_jax(frame, kind, case, precision,
                                        monkeypatch):
    """The Pallas custom VJP: d_features is B4 over the same plan with the
    cotangent rounded inside the kernel, plus the f32 overflow; d_W is
    B5's im2col (plus the overflow rows) times the f32 cotangent, not
    rounded.  The port rounds the same operands, so REL holds in bf16
    too."""
    run = _run(frame, kind, case, precision, monkeypatch)
    _assert_within(*run["d_features"], REL, "d_features")
    _assert_within(*run["d_W"], REL, "d_W")


@pytest.mark.parametrize("kind,case,precision", RUNS[3:])
def test_down_and_inverse_grads_match_jax(frame, kind, case, precision,
                                          monkeypatch):
    """JAX's VJP of its XLA formulation against the rulebook backward (B1
    dgrad over the transposed rulebook, B2 im2col, d_W rounded)."""
    run = _run(frame, kind, case, precision, monkeypatch)
    K = _conv(frame, kind)[2].idx.shape[1]
    if precision == "f32":
        _assert_within(*run["d_features"], REL, "d_features")
        _assert_within(*run["d_W"], REL, "d_W")
    else:
        _assert_within(*run["d_features"], (K + 1) * BF16_SUM_REL,
                       "d_features")
        # both round the f32 d_W sum to bf16 after sums in other orders,
        # so an entry may land one bf16 ulp apart
        _assert_within(*run["d_W"], 2.0 ** -8, "d_W")
        dw = run["d_W"][0]
        np.testing.assert_array_equal(
            dw, torch.from_numpy(dw).bfloat16().float().numpy())


def test_gather_plain_is_the_selection(frame):
    """band_gather_plain holds rnd(f[base + sel]) at (row, tap) and 0
    where sel is -1; a NaN row behind sel = -1 stays out."""
    _, plan, (lin, _, rb, _, _) = _plans(frame, "subm", "tiny")
    f = torch.randn(frame.levels[lin].capacity, 4)
    f[~frame.levels[lin].mask] = float("nan")
    g = bc.band_gather(f, plan.base, plan.sel, torch.bfloat16)
    nB, K, B = plan.sel.shape
    assert g.dtype == torch.bfloat16 and g.shape == (nB * B, K * 4)
    assert torch.isfinite(g.float()).all()
    g = g.float().reshape(nB, B, K, 4)
    sel = plan.sel.permute(0, 2, 1)
    src = (plan.base[:, None, :] + sel).clamp(min=0).long()
    want = torch.where((sel >= 0)[..., None], f[src].bfloat16().float(), 0.0)
    assert torch.equal(g, want)
