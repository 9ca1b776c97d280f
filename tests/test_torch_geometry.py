"""Port geometry (rslo_tpu_torch.geometry, utils.synthetic) against the
JAX package on the same seeded inputs."""
import numpy as np
import jax.numpy as jnp
import pytest

from torch_port_helpers import tt

from rslo_tpu import geometry as G
from rslo_tpu.utils import synthetic as jsyn
from rslo_tpu_torch import geometry as PG
from rslo_tpu_torch.utils import synthetic as psyn

KITTI_RANGE = (-70.4, -38.4, -3.0, 70.4, 38.4, 5.0)


@pytest.fixture
def quats():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    t = rng.normal(size=(64, 3)).astype(np.float32) * 5
    return q, t


def test_quaternion_ops_match_jax(quats):
    q, t = quats
    # f32 elementwise math in both frameworks: a few ulp of |x| <= 20
    tol = dict(rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(PG.qnormalize(tt(q)).numpy(),
                               np.asarray(G.qnormalize(jnp.asarray(q))),
                               **tol)
    np.testing.assert_array_equal(PG.qinv(tt(q)).numpy(),
                                  np.asarray(G.qinv(jnp.asarray(q))))
    qn = np.asarray(G.qnormalize(jnp.asarray(q)))
    np.testing.assert_allclose(
        PG.rotate_vec_by_q(tt(t), tt(qn)).numpy(),
        np.asarray(G.rotate_vec_by_q(jnp.asarray(t), jnp.asarray(qn))),
        **tol)
    from rslo_tpu.geometry.quaternion import safe_norm
    np.testing.assert_allclose(PG.safe_norm(tt(t)).numpy(),
                               np.asarray(safe_norm(jnp.asarray(t))), **tol)


@pytest.mark.parametrize("spatial,dims,warp", [
    ((12, 22), 2, -1.0), ((12, 22), 2, 2.0), ((6, 8, 4), 3, -1.0)])
def test_decode_tq_map_matches_jax(spatial, dims, warp):
    rng = np.random.default_rng(5)
    tq = rng.normal(size=(2,) + spatial + (7,)).astype(np.float32)
    tq[..., 3] += 2.0
    # anchors reach |70| m: f32 rounding of the coords is ~1e-5 there
    tol = dict(rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(
        PG.grid_cell_coords(spatial, KITTI_RANGE).numpy(),
        np.asarray(G.grid_cell_coords(spatial, KITTI_RANGE)), **tol)
    np.testing.assert_allclose(
        PG.decode_tq_map(tt(tq), KITTI_RANGE, dims, warp).numpy(),
        np.asarray(G.decode_tq_map(jnp.asarray(tq), KITTI_RANGE, dims,
                                   warp)), **tol)


def test_np_compose_pose_matches_jax(quats):
    q, t = quats
    p1 = np.concatenate([t, q / np.linalg.norm(q, axis=-1,
                                               keepdims=True)], -1)
    p2 = p1[::-1].copy()
    np.testing.assert_array_equal(PG.np_compose_pose(p1, p2),
                                  G.np_compose_pose(p1, p2))


def test_synth_sequence_matches_jax():
    pf, pg = psyn.synth_sequence(seed=4, n_frames=3, n_points=3000)
    jf, jg = jsyn.synth_sequence(seed=4, n_frames=3, n_points=3000)
    np.testing.assert_array_equal(pg, jg)
    for a, b in zip(pf, jf):
        np.testing.assert_array_equal(a, b)
    assert pf[0].shape == (3000, 7) and pf[0].dtype == np.float32
