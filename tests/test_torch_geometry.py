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


def _poses(q, t):
    return np.concatenate([t, q / np.linalg.norm(q, axis=-1,
                                                 keepdims=True)], -1)


def test_pose_algebra_matches_jax(quats):
    """qmult, compose/invert/calc_vo and transform_points are the same
    f32 multiplies and adds in the same order: bit-equal.  qexp, qlog and
    slerp go through sin/cos/atan2/acos, whose CPU implementations differ
    by an ulp."""
    q, t = quats
    p1 = _poses(q, t)
    p2 = p1[::-1].copy()
    J = {k: jnp.asarray(v) for k, v in dict(q=q, p1=p1, p2=p2).items()}
    for normalize in (True, False):
        np.testing.assert_array_equal(
            PG.qmult(tt(q), tt(q[::-1].copy()), normalize).numpy(),
            np.asarray(G.qmult(J["q"], J["q"][::-1], normalize)))
    np.testing.assert_array_equal(PG.compose_pose(tt(p1), tt(p2)).numpy(),
                                  np.asarray(G.compose_pose(J["p1"],
                                                            J["p2"])))
    np.testing.assert_array_equal(PG.invert_pose(tt(p1)).numpy(),
                                  np.asarray(G.invert_pose(J["p1"])))
    np.testing.assert_array_equal(PG.calc_vo(tt(p1), tt(p2)).numpy(),
                                  np.asarray(G.calc_vo(J["p1"], J["p2"])))
    pts = np.random.default_rng(4).normal(size=(64, 9, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        PG.transform_points(tt(p1), tt(pts)).numpy(),
        np.asarray(G.transform_points(J["p1"], jnp.asarray(pts))))
    np.testing.assert_array_equal(
        PG.transform_points(tt(p1[0]), tt(pts[0])).numpy(),
        np.asarray(G.transform_points(J["p1"][0], jnp.asarray(pts[0]))))
    tol = dict(rtol=0, atol=1e-6)
    v = t * 0.1
    np.testing.assert_allclose(PG.qexp(tt(v)).numpy(),
                               np.asarray(G.qexp(jnp.asarray(v))), **tol)
    np.testing.assert_allclose(PG.qlog(tt(p1[:, 3:])).numpy(),
                               np.asarray(G.qlog(J["p1"][:, 3:])), **tol)
    for alpha in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(
            PG.slerp(tt(p1[:, 3:]), tt(p2[:, 3:]), alpha).numpy(),
            np.asarray(G.slerp(J["p1"][:, 3:], J["p2"][:, 3:], alpha)),
            **tol)
    # nearly parallel: the linear blend, bit-equal
    np.testing.assert_array_equal(
        PG.slerp(tt(p1[:, 3:]), tt(p1[:, 3:]), 0.3).numpy(),
        np.asarray(G.slerp(J["p1"][:, 3:], J["p1"][:, 3:], 0.3)))


@pytest.mark.parametrize("fn,at", [
    ("qexp", [0.0, 0.0, 0.0]), ("qlog", [1.0, 0.0, 0.0, 0.0]),
    ("qexp", [1e-9, -2e-9, 0.0]), ("qlog", [-1.0, 0.0, 0.0, 0.0])])
def test_qexp_qlog_jacobians_finite_at_identity(fn, at):
    """The solvers differentiate qexp at zero local coordinates and qlog
    at identity residuals: torch.func.jacfwd there is finite and equals
    jax.jacfwd (safe_norm in qexp, atan2 in qlog; an acos form or a
    plain norm gives inf/NaN)."""
    import jax
    import torch
    x = np.array(at, np.float32)
    got = torch.func.jacfwd(getattr(PG, fn))(tt(x)).numpy()
    want = np.asarray(jax.jacfwd(getattr(G, fn))(jnp.asarray(x)))
    assert np.isfinite(got).all(), got
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_bilinear_sample_matches_jax():
    """Taps outside the image read 0 (clamped index, in-bounds mask)."""
    from rslo_tpu.geometry import warp as jwarp
    from rslo_tpu_torch.geometry import warp as pwarp
    rng = np.random.default_rng(6)
    img = rng.normal(size=(12, 16, 5)).astype(np.float32)
    # pixel positions inside, on the border and outside on every side
    xy = rng.uniform(-3, 19, size=(7, 40, 2)).astype(np.float32)
    xy[0, :4] = [[0, 0], [15, 11], [15.5, 11.5], [-0.5, -0.5]]
    got = pwarp.bilinear_sample(tt(img), tt(xy)).numpy()
    want = np.asarray(jwarp.bilinear_sample(jnp.asarray(img),
                                            jnp.asarray(xy)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.shape == (7, 40, 5)


def test_inverse_warp_matches_jax():
    from rslo_tpu.geometry import warp as jwarp
    from rslo_tpu_torch.geometry import warp as pwarp
    rng = np.random.default_rng(7)
    H, W = 12, 16
    img = rng.normal(size=(H, W, 6)).astype(np.float32)
    tq = np.zeros((H, W, 7), np.float32)
    tq[..., :3] = rng.normal(0, 2, size=(H, W, 3))
    q = np.array([1, 0, 0, 0], np.float32) + rng.normal(
        0, 0.05, size=(H, W, 4)).astype(np.float32)
    tq[..., 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    pc = (-8.0, -6.0, -1.0, 8.0, 6.0, 1.0)
    got = pwarp.inverse_warp(tt(img), tt(tq), pc)
    want = jwarp.inverse_warp(jnp.asarray(img), jnp.asarray(tq), pc)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert 0 < float(want[1].mean()) < 1    # some cells warp out
