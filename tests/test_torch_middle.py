"""Port SparseMiddleCov (rslo_tpu_torch.models.middle) against the JAX
package: the BEV map and the per-voxel covariances of one frame, with
the same weights carried over by rslo_tpu_torch.convert."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import (jax_variables, port_cfg, tiny_scans,
                                to_jax, to_port, tt)

from rslo_tpu.data.prepare import prepare_example as jax_prepare
from rslo_tpu.data.prepare import voxelizer_config
from rslo_tpu.models.middle import SparseMiddleCov as JaxMiddle
from rslo_tpu.models.middle import build_geometry as jax_geometry
from rslo_tpu_torch.convert import load_flax_variables
from rslo_tpu_torch.models.middle import SparseMiddleCov, build_geometry

SPARSE_SHAPE = (41, 128, 128)

# f32: 20 convs whose f32 sums differ only in order.  bf16: the same
# f32 activation can round to neighbouring bf16 values on the two sides
# (2^-8 relative), and such flips compound through the 14-conv encoder.
TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
       "bf16": dict(rtol=5e-2, atol=5e-2)}


@pytest.mark.parametrize("precision,middle_bn", [("f32", "bn"),
                                                 ("bf16", "none")])
def test_sparse_middle_matches_jax(precision, middle_bn):
    cfg = port_cfg(precision, middle_bn)
    pts = tiny_scans(7, 1)[0]
    ex = jax_prepare(jnp.asarray(pts[None]), jnp.ones((1, len(pts)), bool),
                     voxelizer_config(cfg), mean_mode=True)
    feats, coords, mask = (ex["voxel_features"][0], ex["coords"][0],
                           ex["voxel_mask"][0])
    caps = cfg.middle.level_capacities
    geo = jax.jit(jax_geometry, static_argnums=(2, 3))(
        coords, mask, SPARSE_SHAPE, caps)
    jmod = JaxMiddle(cfg.middle)
    variables = jax_variables(jmod, 0, feats, geo, train=False)
    ref_bev, ref_cov = jax.jit(
        lambda v, f, g: jmod.apply(v, f, g, train=False))(
            to_jax(variables), feats, geo)

    mod = load_flax_variables(SparseMiddleCov(to_port(cfg).middle),
                              variables).eval()
    bev, cov = mod(tt(feats), build_geometry(tt(coords), tt(mask),
                                             SPARSE_SHAPE, caps))
    assert bev.shape == ref_bev.shape == (16, 16, 32)
    assert cov.shape == ref_cov.shape
    assert float(np.abs(np.asarray(ref_bev)).max()) > 0.1
    np.testing.assert_allclose(bev.detach().numpy(), np.asarray(ref_bev),
                               **TOL[precision])
    np.testing.assert_allclose(cov.detach().numpy(), np.asarray(ref_cov),
                               **TOL[precision])
