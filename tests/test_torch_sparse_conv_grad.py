"""Port the sparse conv's gradient (rslo_tpu_torch.ops.dma_gather.
sparse_conv, row_gather, and the transposed rulebooks of
models.middle.build_geometry) against the JAX package:

  * ``row_gather`` bit-equal to the Pallas kernel ``dma_row_gather`` run
    in interpret mode, and its fused d_W im2col mode bit-equal to that
    kernel followed by ``jnp.where`` and the rounding to the compute
    dtype, the composition that JAX's conv differentiates;
  * the transposed rulebooks bit-equal to the JAX package's own
    ``build_inverse_index`` / ``build_conv_index`` on the same levels, and
    each the exact transpose of its forward rulebook;
  * the autograd conv's d_features, d_W and d_bias against ``jax.vjp``
    of ``sparse_conv_apply`` for submanifold, strided, z-collapse and
    inverse rulebooks of a real tiny frame, in f32 and bf16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import tiny_scans, tt

from rslo_tpu.models.middle import DOWN_SPECS
from rslo_tpu.models.middle import build_geometry as jax_geometry
from rslo_tpu.ops import sparse_conv as jsc
from rslo_tpu.ops.dma_gather import dma_row_gather
from rslo_tpu.ops.voxelize import VoxelizerConfig as JaxVcfg
from rslo_tpu.ops.voxelize import voxelize_sorted_mean as jax_vox
from rslo_tpu_torch.models.middle import build_geometry
from rslo_tpu_torch.ops import sparse_conv as sc
from rslo_tpu_torch.ops.dma_gather import row_gather, sparse_conv

SPARSE_SHAPE = (41, 128, 128)     # tests/test_model.py::tiny_cfg grid
CAPS = (2048, 2048, 1024, 512)
# f32: the same products summed in another order (<= 27*16 terms)
F32_REL = 1e-5
# bf16: both sides round each tap's d_features partial and the whole
# d_W sum to bf16 after f32 sums taken in other orders, so an entry may
# land one bf16 ulp (2^-8 relative) apart: |err| <= 2^-8 * sum|terms|
BF16_REL = 2.0 ** -8


@pytest.fixture(scope="module")
def frame():
    pts = tiny_scans(0, 1)[0]
    vcfg = JaxVcfg(point_cloud_range=(-6.4, -6.4, -0.8, 6.4, 6.4, 0.8),
                   voxel_size=(0.1, 0.1, 0.04), max_points=4,
                   max_voxels=2048)
    vox = jax_vox(jnp.asarray(pts), jnp.ones(len(pts), bool), vcfg)
    coords, mask = np.asarray(vox.coords), np.asarray(vox.mask)
    ref = jax.jit(jax_geometry, static_argnums=(2, 3))(
        jnp.asarray(coords), jnp.asarray(mask), SPARSE_SHAPE, CAPS)
    geo = build_geometry(tt(coords), tt(mask), SPARSE_SHAPE, CAPS,
                         transposed=True)
    return ref, geo


def test_row_gather_bit_equal_to_pallas():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(500, 16)).astype(np.float32)
    feats[7] = np.nan                               # copied, not touched
    idx = rng.integers(0, 500, 1000).astype(np.int32)
    idx[:5] = 7
    out = row_gather(tt(feats), tt(idx))
    block = 64
    pad = (-len(idx)) % block                       # Pallas needs blocks
    ref = dma_row_gather(jnp.asarray(feats),
                         jnp.asarray(np.pad(idx, (0, pad))), block=block,
                         inflight=4, interpret=True)
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  np.asarray(ref)[:len(idx)].view(
                                      np.uint32))
    assert out.dtype == torch.float32 and out.shape == (1000, 16)
    assert row_gather(tt(feats), torch.zeros(0, dtype=torch.int32)).shape \
        == (0, 16)
    for bad in (-1, 500):
        with pytest.raises(IndexError):
            row_gather(tt(feats), torch.tensor([0, bad], dtype=torch.int32))


def _pallas_gather(feats, idx, block=64):
    pad = (-len(idx)) % block                       # Pallas needs blocks
    out = dma_row_gather(jnp.asarray(feats),
                         jnp.asarray(np.pad(idx, (0, pad))), block=block,
                         inflight=4, interpret=True)
    return out[:len(idx)]


@pytest.mark.parametrize("cin", [7, 16])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_fused_im2col_bit_equal_to_pallas(precision, cin):
    """round(where(valid, features[idx], 0)) in one call, at the first
    conv's 7 channels (28-byte rows) and at 16; NaN rows that only
    invalid taps point at, a run of all-invalid rows, and values on bf16
    rounding ties."""
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(500, cin)).astype(np.float32)
    # exact ties between two bf16 neighbours: nearest even decides
    feats[3, :4] = 1 + np.array([2.0 ** -8, 3 * 2.0 ** -8, -2.0 ** -9,
                                 -3 * 2.0 ** -9], np.float32)
    feats[11] = np.nan
    idx = rng.integers(0, 500, 1200).astype(np.int32)
    valid = rng.random(1200) < 0.3
    valid[100:200] = False                          # all-invalid rows
    idx[idx == 11] = 12
    idx[::9] = 11                                   # NaN rows ...
    valid[::9] = False                              # ... behind invalid taps
    idx[5:20:3] = 3
    valid[5:20:3] = True
    cdt = {"f32": (torch.float32, jnp.float32),
           "bf16": (torch.bfloat16, jnp.bfloat16)}[precision]
    ref = jnp.where(jnp.asarray(valid)[:, None],
                    _pallas_gather(feats, idx), 0.0)
    ref = np.asarray(ref.astype(cdt[1]).astype(jnp.float32))
    out = row_gather(tt(feats), tt(idx), valid=tt(valid),
                     compute_dtype=cdt[0])
    assert out.dtype == torch.float32 and out.shape == (1200, cin)
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  ref.view(np.uint32))
    assert np.isfinite(ref).all() and (ref[~valid] == 0).all()
    if precision == "bf16":
        np.testing.assert_array_equal(ref[5, :4], [1, 1 + 2.0 ** -6, 1,
                                                   1 - 2.0 ** -7])
    # compute_dtype alone rounds every row; valid alone only zeroes
    both = row_gather(tt(feats), tt(idx), compute_dtype=cdt[0])
    np.testing.assert_array_equal(
        both.numpy(), torch.from_numpy(feats[idx]).to(cdt[0]).float())
    only = row_gather(tt(feats), tt(idx), valid=tt(valid))
    np.testing.assert_array_equal(
        only.numpy(), np.where(valid[:, None], feats[idx], 0.0))


def test_row_gather_rejects_bad_fused_operands():
    feats = torch.zeros(10, 4)
    idx = torch.arange(6, dtype=torch.int32)
    ok = torch.ones(6, dtype=torch.bool)
    for bad in (torch.ones(7, dtype=torch.bool),     # wrong length
                torch.ones(6, 1, dtype=torch.bool),  # wrong rank
                torch.ones(6, dtype=torch.uint8),    # wrong dtype
                torch.ones(6)):
        with pytest.raises(ValueError):
            row_gather(feats, idx, valid=bad)
    with pytest.raises(ValueError):
        row_gather(feats, idx, valid=ok, compute_dtype=torch.float16)
    with pytest.raises(ValueError):                  # rounding needs f32
        row_gather(feats.int(), idx, valid=ok)
    with pytest.raises(IndexError):                  # checked as before
        row_gather(feats, torch.tensor([0, 10], dtype=torch.int32),
                   valid=torch.tensor([True, False]))
    out = row_gather(feats + 1, torch.tensor([0, 9], dtype=torch.int32),
                     valid=torch.tensor([True, False]),
                     compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(out.numpy(), [[1] * 4, [0] * 4])


def _pairs(rb, flip=False):
    """Set of (out row, tap, in row) of a rulebook's valid entries."""
    idx, valid = rb.idx.numpy(), rb.valid.numpy()
    v, k = np.nonzero(valid)
    K = idx.shape[1]
    return set(zip(v.tolist(), ((K - 1 - k) if flip else k).tolist(),
                   idx[v, k].tolist()))


def test_transposed_rulebooks_bit_equal_to_jax(frame):
    ref, geo = frame
    assert geo.levels[4].slot_map is not None
    for i, spec in enumerate(DOWN_SPECS):
        coarse = ref.levels[i + 1]
        if coarse.slot_map is None:                  # JAX skips L4's
            coarse = jsc.with_slot_map(coarse)
        want = jsc.build_inverse_index(coarse, ref.levels[i], *spec)
        got = geo.down_rb_t[i]
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        assert got.idx.dtype == torch.int32 and bool(got.valid.any())
        # the exact transpose: (o, k, f) valid in the forward rulebook
        # iff (f, k, o) valid in the transposed one
        fwd = _pairs(geo.down_rb[i])
        assert {(f, k, o) for o, k, f in fwd} == _pairs(got), f"down {i}"
    # inverse convs are transposed by the strided rulebooks, submanifold
    # ones by themselves with flipped taps
    for inv, down in ((geo.inv_rb[0], geo.down_rb[1]),
                      (geo.inv_rb[1], geo.down_rb[0])):
        assert {(c, k, f) for f, k, c in _pairs(inv)} == _pairs(down)
    for rb in geo.sub_rb:
        assert {(u, k, v) for v, k, u in _pairs(rb)} == _pairs(rb, True)


def _ops(geo):
    """(name, in level, out level, rulebook, transposed, flip) of each
    conv kind of the middle."""
    return {
        "subm": (0, 0, geo.sub_rb[0], geo.sub_rb[0], True),
        "down": (0, 1, geo.down_rb[0], geo.down_rb_t[0], False),
        "zcollapse": (3, 4, geo.down_rb[3], geo.down_rb_t[3], False),
        "inverse": (1, 0, geo.inv_rb[1], geo.down_rb[0], False),
    }


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["subm", "down", "zcollapse", "inverse"])
def test_sparse_conv_grad_matches_jax_vjp(frame, kind, precision):
    _, geo = frame
    lin, lout, rb, rb_t, flip = _ops(geo)[kind]
    rng = np.random.default_rng(1)
    cin, cout = 16, 8
    vin, vout = geo.levels[lin].capacity, geo.levels[lout].capacity
    K = rb.idx.shape[1]
    f = rng.normal(size=(vin, cin)).astype(np.float32)
    f[~geo.levels[lin].mask.numpy()] = 0.0
    w = rng.normal(0, 0.3, (K, cin, cout)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    ct = rng.normal(size=(vout, cout)).astype(np.float32)
    out_mask = geo.levels[lout].mask
    cdt = {"f32": (torch.float32, jnp.float32),
           "bf16": (torch.bfloat16, jnp.bfloat16)}[precision]

    jrb = jsc.ConvIndex(jnp.asarray(rb.idx.numpy()),
                        jnp.asarray(rb.valid.numpy()))
    ref, vjp = jax.vjp(
        lambda f_, w_, b_: jsc.sparse_conv_apply(
            f_, jrb, w_, b_, jnp.asarray(out_mask.numpy()), cdt[1]),
        jnp.asarray(f), jnp.asarray(w), jnp.asarray(b))
    jdf, jdw, jdb = (np.asarray(g) for g in vjp(jnp.asarray(ct)))

    tf, tw, tb = (tt(a).requires_grad_() for a in (f, w, b))
    out = sparse_conv(tf, rb, rb_t, tw, tb, out_mask, cdt[0], flip)
    out.backward(tt(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=F32_REL, atol=1e-5)

    # sum of |terms| of each gradient entry, for the bounds
    ctm = np.where(out_mask.numpy()[:, None], np.abs(ct), 0.0)
    mag_f = sc.sparse_conv_dgrad(
        tt(ctm.astype(np.float32)), rb_t,
        (tw.detach().abs().flip(0) if flip else tw.detach().abs())
        .transpose(1, 2).contiguous()).numpy()
    g = np.abs(f)[rb.idx.numpy()] * rb.valid.numpy()[..., None]
    mag_w = np.einsum("vkc,vo->kco", g, ctm)
    rel = F32_REL if precision == "f32" else BF16_REL
    for got, want, mag, what in ((tf.grad, jdf, mag_f, "d_features"),
                                 (tw.grad, jdw, mag_w, "d_W")):
        err = np.abs(got.numpy() - want)
        assert (err <= rel * mag + 1e-6).all(), (what, float(err.max()))
        assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(tb.grad.numpy(), jdb, rtol=1e-5, atol=1e-5)
    if precision == "bf16":      # both sides round d_W to bf16
        wq = tw.grad.numpy()
        np.testing.assert_array_equal(
            wq, torch.from_numpy(wq).bfloat16().float().numpy())


def test_first_conv_input_needs_no_gradient(frame):
    """A conv whose input carries no gradient (the first one) computes
    only d_W and d_bias."""
    _, geo = frame
    f = torch.randn(geo.levels[0].capacity, 7)
    w = torch.randn(27, 7, 8, requires_grad=True)
    out = sparse_conv(f, geo.sub_rb[0], geo.sub_rb[0], w, None,
                      geo.levels[0].mask, torch.float32, True)
    out.sum().backward()
    assert w.grad is not None and f.grad is None
