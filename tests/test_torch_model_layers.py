"""Port the small model modules against the JAX package on the same
seeded inputs and weights: the layers (rslo_tpu_torch.models.layers),
the spatial-grouped instance norm and the learned VFE; and the port's
own contract of ``Dropout2dGivenMask``, whose mask comes from a
``torch.Generator`` (JAX's from its "dropout" rng stream)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_variables, np_, to_jax, tt

from rslo_tpu.models import layers as jl
from rslo_tpu.models.spatial_group_norm import (
    SpatialGroupedInstanceNorm as JaxSGIN)
from rslo_tpu.models.vfe_learned import LearnedVFE as JaxLearnedVFE
from rslo_tpu_torch.convert import load_flax_variables
from rslo_tpu_torch.models import layers
from rslo_tpu_torch.models.spatial_group_norm import (
    SpatialGroupedInstanceNorm)
from rslo_tpu_torch.models.vfe import VFES
from rslo_tpu_torch.models.vfe_learned import LearnedVFE

TOL = dict(rtol=1e-5, atol=1e-6)


def test_elu_plus_and_trunc_exp_match_jax():
    x = np.random.default_rng(0).normal(0, 8, 200).astype(np.float32)
    x[:3] = (1000.0, -1000.0, 0.0)
    np.testing.assert_allclose(np_(layers.elu_plus(tt(x))),
                               np.asarray(jl.elu_plus(jnp.asarray(x))),
                               **TOL)
    for m in (20.0, 3.0):
        got = layers.trunc_exp(tt(x), m)
        np.testing.assert_allclose(np_(got), np.asarray(
            jl.trunc_exp(jnp.asarray(x), m)), **TOL)
        assert torch.isfinite(got).all()


@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (1, 2), (5, 2)])
def test_mask_propagate_matches_jax(kernel, stride):
    """SAME max-pool of an (N, H, W, 1) mask at odd and even sizes."""
    rng = np.random.default_rng(kernel * 10 + stride)
    m = (rng.random((2, 9, 12, 1)) < 0.2).astype(np.float32)
    got = layers.mask_propagate(tt(m), kernel, stride)
    want = jl.mask_propagate(jnp.asarray(m), kernel, stride)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np_(got), np.asarray(want))


def test_parameter_layer_matches_jax():
    jmod = jl.ParameterLayer((3, 4), init_value=0.25)
    variables = jmod.init(jax.random.PRNGKey(0))
    mod = layers.ParameterLayer((3, 4), init_value=0.25)
    np.testing.assert_array_equal(np_(mod()), np.asarray(jmod.apply(
        variables)))
    load_flax_variables(mod, jax.tree.map(np.array, variables))
    assert [n for n, _ in mod.named_parameters()] == ["value"]


def test_dropout2d_given_mask():
    """Eval mode (or rate 0) passes the input with a ones mask, as JAX's
    deterministic call; a given mask is replayed in train mode, as in
    JAX; a drawn mask is deterministic under its generator, (N, 1, 1,
    C), zero or 1 / (1 - rate), and keeps ~1 - rate of the channels."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 3, 5, 64)).astype(np.float32)
    jmod = jl.Dropout2dGivenMask(rate=0.3)
    mod = layers.Dropout2dGivenMask(0.3)
    y, m = mod.eval()(tt(x))
    jy, jm = jmod.apply({}, jnp.asarray(x), deterministic=True)
    np.testing.assert_array_equal(np_(y), np.asarray(jy))
    np.testing.assert_array_equal(np_(m), np.asarray(jm))
    _, m0 = layers.Dropout2dGivenMask(0.0).train()(tt(x))
    assert bool((m0 == 1).all())

    mod.train()
    y1, m1 = mod(tt(x), generator=torch.Generator().manual_seed(7))
    y2, m2 = mod(tt(x), generator=torch.Generator().manual_seed(7))
    assert torch.equal(y1, y2) and torch.equal(m1, m2)
    assert m1.shape == (4, 1, 1, 64)
    vals = set(np.unique(np_(m1)).tolist())
    assert vals <= {0.0, np.float32(1 / 0.7)}
    keep = float((m1 > 0).float().mean())
    assert abs(keep - 0.7) < 0.08, keep
    np.testing.assert_array_equal(np_(y1), x * np_(m1))
    # the mask's zero channels are zero at every cell of the sample
    assert bool((y1[m1.expand_as(y1) == 0] == 0).all())
    # replaying the mask, as JAX does
    jy, jm = jmod.apply({}, jnp.asarray(x), mask=jnp.asarray(np_(m1)),
                        deterministic=False)
    y3, m3 = mod(tt(x), mask=m1)
    np.testing.assert_array_equal(np_(y3), np.asarray(jy))
    np.testing.assert_array_equal(np_(m3), np.asarray(jm))
    # a large draw: the kept share and the mean of the mask are ~1
    big = torch.zeros(64, 1, 1, 512)
    _, mb = mod(big, generator=torch.Generator().manual_seed(8))
    assert abs(float(mb.mean()) - 1.0) < 0.02


@pytest.mark.parametrize("groups,width", [((1, 5), 20), ((1, 3), 20),
                                          ((4, 1), 22), ((1, 1), 7)])
def test_spatial_grouped_instance_norm_matches_jax(groups, width):
    """Even slabs, an uneven split (the last slab takes the rest), slabs
    along H (transposed) and one slab."""
    rng = np.random.default_rng(width)
    x = rng.normal(3.0, 2.0, size=(2, 8, width, 3)).astype(np.float32)
    jmod = JaxSGIN(num_groups=groups)
    variables = jax_variables(jmod, 5, jnp.asarray(x))
    want = jmod.apply(to_jax(variables), jnp.asarray(x))
    mod = load_flax_variables(SpatialGroupedInstanceNorm(3, groups),
                              variables)
    got = mod(tt(x))
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert mod.weight.shape == (max(groups), 3)


@pytest.mark.parametrize("with_distance", [False, True])
def test_learned_vfe_matches_jax(with_distance):
    """Ragged counts (0 to all 5 points), padding rows filled with
    garbage that the mask must hide: output and input gradient."""
    rng = np.random.default_rng(6)
    vox = rng.normal(size=(24, 5, 7)).astype(np.float32)
    num = rng.integers(0, 6, size=(24,)).astype(np.int32)
    num[:2] = (0, 5)
    jmod = JaxLearnedVFE(num_filters=(8, 16), with_distance=with_distance)
    variables = jax_variables(jmod, 7, jnp.asarray(vox), jnp.asarray(num))
    w = rng.normal(size=(24, 16)).astype(np.float32)

    def loss(v):
        return jnp.sum(jmod.apply(to_jax(variables), v, jnp.asarray(num))
                       * w)
    want = jmod.apply(to_jax(variables), jnp.asarray(vox), jnp.asarray(num))
    want_g = jax.grad(loss)(jnp.asarray(vox))
    mod = load_flax_variables(LearnedVFE(7, (8, 16), with_distance),
                              variables)
    v = tt(vox).requires_grad_()
    got = mod(v, tt(num))
    (got * tt(w)).sum().backward()
    assert got.shape == (24, 16)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np_(v.grad), np.asarray(want_g), rtol=1e-4,
                               atol=1e-5)
    assert not got[tt(num) == 0].any()


def test_learned_vfe_stays_out_of_the_registry():
    """Like JAX's VFE registry, the port's VFES holds no learned VFE:
    no config reaches it."""
    import rslo_tpu.models.vfe  # noqa: F401  (registers the VFEs)
    from rslo_tpu.config.registry import _REGISTRIES
    jax_vfes = _REGISTRIES["vfe"]
    assert "SimpleVoxelXYZINormal" in jax_vfes
    assert set(VFES) == set(jax_vfes)
    assert "LearnedVFE" not in VFES
