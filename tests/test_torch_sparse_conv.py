"""Port sparse-conv geometry and conv apply (rslo_tpu_torch.ops.
sparse_conv, ops.dma_gather, models.middle.build_geometry) against the
JAX package: levels, slot maps and all three rulebook kinds bit-equal;
the plain conv apply against JAX's ``sparse_conv_apply`` and against
the Pallas kernel ``dma_gather_matmul`` run in interpret mode."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_port_helpers import tiny_scans, tt

from rslo_tpu.ops import sparse_conv as jsc
from rslo_tpu.ops.dma_gather import dma_gather_matmul
from rslo_tpu.ops.voxelize import VoxelizerConfig as JaxVcfg
from rslo_tpu.ops.voxelize import voxelize_sorted_mean as jax_vox
from rslo_tpu.models.middle import build_geometry as jax_geometry
from rslo_tpu_torch.models.middle import build_geometry
from rslo_tpu_torch.ops import sparse_conv as sc
from rslo_tpu_torch.ops.dma_gather import gather_matmul

SPARSE_SHAPE = (41, 128, 128)     # tests/test_model.py::tiny_cfg grid

# Both sides round the same operands to the compute dtype and take
# exact products in f32; only the order of the f32 sums differs
# (K*Cin <= 27*16 terms of magnitude <= ~10).
APPLY_TOL = dict(rtol=1e-5, atol=1e-4)


def _coords(seed=0):
    pts = tiny_scans(seed, 1)[0]
    vcfg = JaxVcfg(point_cloud_range=(-6.4, -6.4, -0.8, 6.4, 6.4, 0.8),
                   voxel_size=(0.1, 0.1, 0.04), max_points=4,
                   max_voxels=2048)
    vox = jax_vox(jnp.asarray(pts), jnp.ones(len(pts), bool), vcfg)
    return np.asarray(vox.coords), np.asarray(vox.mask)


@pytest.fixture(scope="module")
def frame():
    return _coords()


def _eq(a, b, what):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b), what)


@pytest.mark.parametrize("capacities", [
    (2048, 2048, 1024, 512),          # tiny_cfg: nothing truncated
    (2048, 600, 150, 40)])            # over capacity: largest ids dropped
def test_geometry_bit_equal_to_jax(frame, capacities):
    coords, mask = frame
    ref = jax.jit(jax_geometry, static_argnums=(2, 3))(
        jnp.asarray(coords), jnp.asarray(mask), SPARSE_SHAPE, capacities)
    out = build_geometry(tt(coords), tt(mask), SPARSE_SHAPE, capacities)
    for i, (a, b) in enumerate(zip(out.levels, ref.levels)):
        assert a.shape == b.shape
        _eq(a.coords, b.coords, f"L{i} coords")
        _eq(a.ids, b.ids, f"L{i} ids")
        _eq(a.mask, b.mask, f"L{i} mask")
        assert (a.slot_map is None) == (b.slot_map is None)
        if a.slot_map is not None:
            _eq(a.slot_map, b.slot_map, f"L{i} slot map")
    for kind in ("sub_rb", "down_rb", "inv_rb"):
        for i, (a, b) in enumerate(zip(getattr(out, kind),
                                       getattr(ref, kind))):
            _eq(a.idx, b.idx, f"{kind}[{i}].idx")
            _eq(a.valid, b.valid, f"{kind}[{i}].valid")
            assert a.idx.dtype == torch.int32
            assert bool(a.valid.any()), f"{kind}[{i}] is empty"
    if capacities[1] == 600:
        assert bool(out.levels[1].mask.all())   # L1 really overflowed


def test_to_dense_matches_jax(frame):
    coords, mask = frame
    lv = jsc.level_from_coords(jnp.asarray(coords), jnp.asarray(mask),
                               SPARSE_SHAPE)
    f = np.random.default_rng(2).normal(size=(len(coords), 3)).astype(
        np.float32)
    out = sc.to_dense(tt(f), sc.level_from_coords(tt(coords), tt(mask),
                                                  SPARSE_SHAPE))
    _eq(out, jsc.to_dense(jnp.asarray(f), lv), "dense")


def _conv_inputs(frame, kind, seed=3):
    coords, mask = frame
    geo = build_geometry(tt(coords), tt(mask), SPARSE_SHAPE,
                         (2048, 2048, 1024, 512))
    rb, vin, vout = {"subm": (geo.sub_rb[0], 0, 0),
                     "down": (geo.down_rb[0], 0, 1),
                     "inv": (geo.inv_rb[1], 1, 0),
                     "zcollapse": (geo.down_rb[3], 3, 4)}[kind]
    rng = np.random.default_rng(seed)
    Cin, Cout = (16, 7) if kind != "down" else (7, 16)
    n_in = geo.levels[vin].capacity
    feats = rng.normal(size=(n_in, Cin)).astype(np.float32)
    # NaN rows that only invalid taps point at must not leak
    feats[~geo.levels[vin].mask.numpy()] = np.nan
    w = rng.normal(size=(rb.idx.shape[1], Cin, Cout)).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    return rb, feats, w, b, geo.levels[vout].mask


@pytest.mark.parametrize("kind", ["subm", "down", "inv", "zcollapse"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sparse_conv_apply_matches_jax(frame, kind, dtype):
    rb, feats, w, b, out_mask = _conv_inputs(frame, kind)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    ref = jsc.sparse_conv_apply(
        jnp.asarray(np.nan_to_num(feats)),
        jsc.ConvIndex(jnp.asarray(rb.idx.numpy()),
                      jnp.asarray(rb.valid.numpy())),
        jnp.asarray(w), jnp.asarray(b), jnp.asarray(out_mask.numpy()),
        compute_dtype=jdt)
    out = sc.sparse_conv_apply(tt(np.nan_to_num(feats)), rb, tt(w), tt(b),
                               out_mask, compute_dtype=tdt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **APPLY_TOL)
    # the kernel's wrapper takes the plain version on a CPU tensor
    before = gather_matmul.launches
    wrapped = gather_matmul(tt(np.nan_to_num(feats)), rb.idx, rb.valid,
                            tt(w), tt(b), out_mask, tdt)
    np.testing.assert_array_equal(wrapped.numpy(), out.numpy())
    assert gather_matmul.launches == before


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sparse_conv_apply_matches_pallas_kernel(frame, dtype):
    """The TPU kernel this port's gather_matmul replaces, run by Pallas'
    interpreter on the first 256 rows of the L0 rulebook."""
    rb, feats, w, _, _ = _conv_inputs(frame, "subm")
    feats = np.nan_to_num(feats)
    rows = 256
    idx, valid = rb.idx[:rows].contiguous(), rb.valid[:rows].contiguous()
    K, Cin, Cout = w.shape
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    ref = dma_gather_matmul(jnp.asarray(feats).astype(jdt),
                            jnp.asarray(idx.numpy()),
                            jnp.asarray(valid.numpy()),
                            jnp.asarray(w.reshape(K * Cin, Cout)).astype(jdt),
                            block=128, inflight=8, interpret=True)
    out = sc.sparse_conv_apply(tt(feats), sc.ConvIndex(idx, valid), tt(w),
                               compute_dtype=tdt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **APPLY_TOL)


def test_invalid_taps_do_not_propagate_nan(frame):
    rb, feats, w, b, out_mask = _conv_inputs(frame, "subm")
    out = gather_matmul(tt(feats), rb.idx, rb.valid, tt(w), tt(b),
                        out_mask, torch.bfloat16)
    assert torch.isfinite(out).all()
    assert (out[~out_mask] == 0).all()


def test_gather_matmul_rejects_bad_operands(frame):
    rb, feats, w, b, out_mask = _conv_inputs(frame, "subm")
    f, wt = tt(feats), tt(w)
    with pytest.raises(ValueError, match="idx"):
        gather_matmul(f, rb.idx.long(), rb.valid, wt)
    with pytest.raises(ValueError, match="weights"):
        gather_matmul(f, rb.idx, rb.valid, wt[:, :3])
    with pytest.raises(ValueError, match="features"):
        gather_matmul(f.double(), rb.idx, rb.valid, wt)
    with pytest.raises(ValueError, match="out_mask"):
        gather_matmul(f, rb.idx, rb.valid, wt, out_mask=out_mask[:5])
    with pytest.raises(ValueError, match="compute_dtype"):
        gather_matmul(f, rb.idx, rb.valid, wt, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="meta"):
        gather_matmul(f.to("meta"), rb.idx.to("meta"), rb.valid.to("meta"),
                      wt.to("meta"))
