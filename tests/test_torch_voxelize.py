"""Port voxelizer and prepare (rslo_tpu_torch.ops.voxelize, data.prepare)
against the JAX package: the point stacks, coords, counts and slots
bit-equal (the block ground filter on and off, over capacity, masked
points); means within float32 rounding."""
import numpy as np
import jax.numpy as jnp
import pytest

from torch_port_helpers import tt

from rslo_tpu.data.prepare import prepare_example as jax_prepare
from rslo_tpu.ops.voxelize import VoxelizerConfig as JaxVcfg
from rslo_tpu.ops.voxelize import voxelize as jax_voxelize
from rslo_tpu.ops.voxelize import voxelize_sorted_mean as jax_vox
from rslo_tpu_torch.data.prepare import prepare_example
from rslo_tpu_torch.ops.voxelize import (VoxelizerConfig, voxelize,
                                         voxelize_sorted_mean)

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


# the ground filter: per 4 x 4-voxel BEV block, points below the block's
# lowest z + 0.3 m are dropped (about half of them here)
GROUND = dict(height_threshold=0.3, block_size=4)
STACK_CASES = {
    "within_capacity": ("within_capacity", 4096, {}),
    "over_capacity": ("within_capacity", 700, {}),
    "per_voxel_cap": ("per_voxel_cap", 4096, {}),
    "ground_filter": ("within_capacity", 4096, GROUND),
    "ground_filter_over_capacity": ("within_capacity", 300, GROUND),
}


@pytest.mark.parametrize("name", list(STACK_CASES))
def test_voxelize_point_stack_matches_jax(name):
    case, max_voxels, extra = STACK_CASES[name]
    pts, mask = _points(case, seed=3)
    cfg = dict(point_cloud_range=RANGE, voxel_size=VSIZE, max_points=10,
               max_voxels=max_voxels, **extra)
    ref = jax_voxelize(jnp.asarray(pts), jnp.asarray(mask), JaxVcfg(**cfg))
    out = voxelize(tt(pts), tt(mask), VoxelizerConfig(**cfg))
    for field in ref._fields:
        got, want = getattr(out, field).numpy(), np.asarray(getattr(ref,
                                                                    field))
        assert got.dtype == want.dtype and got.shape == want.shape, field
        np.testing.assert_array_equal(got, want, field)
    kept = int(np.asarray(ref.num_points).sum())
    assert kept == int((np.asarray(ref.point_voxel) >= 0).sum())
    if max_voxels < 4096:
        assert int(ref.num_voxels) == max_voxels
    if extra and max_voxels == 4096:
        # the filter drops points the unfiltered run keeps
        plain = jax_voxelize(jnp.asarray(pts), jnp.asarray(mask),
                             JaxVcfg(**dict(cfg, height_threshold=-1.0)))
        assert kept < 0.8 * int(np.asarray(plain.num_points).sum())


def test_mean_path_ignores_the_ground_filter_as_jax_does():
    pts, mask = _points("within_capacity", seed=4)
    cfg = dict(point_cloud_range=RANGE, voxel_size=VSIZE, max_points=10,
               max_voxels=4096, **GROUND)
    ref = jax_vox(jnp.asarray(pts), jnp.asarray(mask), JaxVcfg(**cfg))
    out = voxelize_sorted_mean(tt(pts), tt(mask), VoxelizerConfig(**cfg))
    plain = voxelize_sorted_mean(tt(pts), tt(mask), VoxelizerConfig(
        **dict(cfg, height_threshold=-1.0)))
    for name in ("coords", "num_points", "num_voxels", "point_voxel"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      getattr(plain, name).numpy(), name)
    np.testing.assert_allclose(out.features.numpy(),
                               np.asarray(ref.features), **MEAN_TOL)


def test_prepare_example_point_stacks_match_jax():
    frames = [_points("per_voxel_cap", seed=s)[0] for s in (5, 6)]
    pts = np.stack(frames)
    mask = np.stack([_points("per_voxel_cap", seed=s)[1] for s in (5, 6)])
    cfg = dict(point_cloud_range=RANGE, voxel_size=VSIZE, max_points=10,
               max_voxels=2048)
    ref = jax_prepare(jnp.asarray(pts), jnp.asarray(mask), JaxVcfg(**cfg))
    out = prepare_example(tt(pts), tt(mask), VoxelizerConfig(**cfg))
    assert sorted(out) == sorted(ref) == ["coords", "num_points",
                                          "voxel_mask", "voxels"]
    for name in out:
        np.testing.assert_array_equal(out[name].numpy(),
                                      np.asarray(ref[name]), name)
