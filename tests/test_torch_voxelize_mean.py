"""The port's sort-free mean voxelizer and numpy oracle
(rslo_tpu_torch/ops/voxelize.py::voxelize_mean, voxelize_np) against the
JAX package's on the same seeded points: the integer outputs (coords,
num_points, num_voxels, point_voxel) bit for bit; the means, sums of a
scatter-add, to MEAN_TOL (on the CPU both add in point order; the
observed difference is 0).  The oracle's point stacks copy input rows,
so all of its fields are held bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rslo_tpu.ops import voxelize as jvox
from rslo_tpu_torch.ops.voxelize import (VoxelizerConfig, voxelize_mean,
                                         voxelize_np)

MEAN_TOL = dict(rtol=1e-6, atol=1e-6)
CFG = dict(point_cloud_range=(-4.0, -2.0, -1.0, 4.0, 2.0, 1.0),
           voxel_size=(0.5, 0.5, 0.5), max_points=4, max_voxels=64)


def _points(seed, n, f=5):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4.5, 4.5, size=(n, f)).astype(np.float32)
    pts[:, 1] *= 0.5
    pts[:, 2] *= 0.25
    return pts


@pytest.mark.parametrize("max_voxels, masked", [(256, 0), (256, 40),
                                                (16, 0)])
def test_voxelize_mean_matches_jax(max_voxels, masked):
    """Under the capacity, with masked points, and truncated to 16 of
    ~130 voxels (the largest ids dropped)."""
    kw = dict(CFG, max_voxels=max_voxels)
    pts = _points(max_voxels + masked, 400)
    mask = np.ones(len(pts), bool)
    if masked:
        mask[-masked:] = False
    want = jvox.voxelize_mean(jnp.asarray(pts), jnp.asarray(mask),
                              jvox.VoxelizerConfig(**kw))
    got = voxelize_mean(torch.tensor(pts), torch.tensor(mask),
                        VoxelizerConfig(**kw))
    for name in ("coords", "num_points", "num_voxels", "point_voxel"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got.features.numpy(),
                               np.asarray(want.features), **MEAN_TOL)
    assert int(got.mask.sum()) == int(got.num_voxels)


def test_voxelize_np_matches_jax():
    pts = _points(7, 300)
    want = jvox.voxelize_np(pts, jvox.VoxelizerConfig(**CFG))
    got = voxelize_np(pts, VoxelizerConfig(**CFG))
    assert type(got).__name__ == "Voxels"
    for name in ("voxels", "coords", "num_points", "num_voxels",
                 "point_voxel"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
