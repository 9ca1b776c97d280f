"""Port voxelizer and mean-mode prepare (rslo_tpu_torch.ops.voxelize,
data.prepare) against the JAX package: coords, counts and slots
bit-equal; means within float32 rounding."""
import numpy as np
import jax.numpy as jnp
import pytest

from torch_port_helpers import tt

from rslo_tpu.data.prepare import prepare_example as jax_prepare
from rslo_tpu.ops.voxelize import VoxelizerConfig as JaxVcfg
from rslo_tpu.ops.voxelize import voxelize_sorted_mean as jax_vox
from rslo_tpu_torch.data.prepare import prepare_example
from rslo_tpu_torch.ops.voxelize import VoxelizerConfig, voxelize_sorted_mean

RANGE = (-3.2, -3.2, -0.8, 3.2, 3.2, 0.8)
VSIZE = (0.1, 0.1, 0.1)

# means of <= 10 float32 points: one rounding per add and one for the
# divide; the two frameworks may add in another order
MEAN_TOL = dict(rtol=1e-6, atol=1e-6)


def _points(case, seed=0, n=3000):
    rng = np.random.default_rng(seed)
    if case == "per_voxel_cap":
        # 40 cells with ~75 points each: the 10-point cap binds everywhere
        cells = rng.uniform(-3, 3, size=(40, 3)) * [1, 1, 0.2]
        pts = cells[rng.integers(0, 40, n)] + rng.uniform(0, 0.05, (n, 3))
    else:
        # 20% of the points fall outside the range and must be dropped
        pts = rng.uniform(-4, 4, size=(n, 3)) * [1, 1, 0.25]
    feats = rng.normal(size=(n, 4))
    pts = np.concatenate([pts, feats], axis=1).astype(np.float32)
    mask = rng.random(n) < 0.9
    return pts, mask


@pytest.mark.parametrize("case,max_voxels", [
    ("within_capacity", 4096), ("over_capacity", 700),
    ("per_voxel_cap", 4096)])
def test_voxelize_sorted_mean_matches_jax(case, max_voxels):
    pts, mask = _points(case)
    cfg = dict(point_cloud_range=RANGE, voxel_size=VSIZE, max_points=10,
               max_voxels=max_voxels)
    ref = jax_vox(jnp.asarray(pts), jnp.asarray(mask), JaxVcfg(**cfg))
    out = voxelize_sorted_mean(tt(pts), tt(mask), VoxelizerConfig(**cfg))
    for name in ("coords", "num_points", "num_voxels", "point_voxel"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(out.features.numpy(),
                               np.asarray(ref.features), **MEAN_TOL)
    n_vox = int(ref.num_voxels)
    if case == "over_capacity":
        assert n_vox == max_voxels
    if case == "per_voxel_cap":
        assert int(np.asarray(ref.num_points).max()) == 10
    assert out.mask.sum().item() == n_vox


def test_prepare_example_mean_mode_matches_jax():
    frames = [_points("within_capacity", seed=s)[0] for s in (1, 2)]
    pts = np.stack(frames)
    mask = np.ones(pts.shape[:2], bool)
    cfg = dict(point_cloud_range=RANGE, voxel_size=VSIZE, max_points=10,
               max_voxels=2048)
    ref = jax_prepare(jnp.asarray(pts), jnp.asarray(mask), JaxVcfg(**cfg),
                      mean_mode=True)
    out = prepare_example(tt(pts), tt(mask), VoxelizerConfig(**cfg),
                          mean_mode=True)
    assert set(out) == set(ref)
    for name in ("coords", "num_points", "voxel_mask"):
        np.testing.assert_array_equal(out[name].numpy(),
                                      np.asarray(ref[name]), name)
    # the normal columns 4:7 are renormalized after the mean
    np.testing.assert_allclose(out["voxel_features"].numpy(),
                               np.asarray(ref["voxel_features"]),
                               **MEAN_TOL)
    with pytest.raises(NotImplementedError):
        prepare_example(tt(pts), tt(mask), VoxelizerConfig(**cfg))
