"""Port bundle adjustment (rslo_tpu_torch.pgo.ba, .ba_bridge) against
the JAX package on the same seeded numpy inputs, on the CPU.

Tolerances: linearization and Schur system within 1e-5 relative (the
same f32 products, summed in another order); solved poses within 1e-5,
landmarks within 1e-4, costs within 1e-4 relative; the problem arrays
that window_ba_problem builds bit-equal (the host association is the
same numpy and cKDTree code); cov_sqrt_info and refine_window_ba within
1e-5 (span_cov's three-term sums are ordered differently by XLA's
einsum, and the Cholesky/inverse carry that)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rslo_tpu import geometry as G
from rslo_tpu.pgo import ba as jba
from rslo_tpu.pgo import ba_bridge as jbb
from rslo_tpu_torch.pgo import ba as pba
from rslo_tpu_torch.pgo import ba_bridge as pbb

POSE_TOL = 1e-5
LM_TOL = 1e-4
COST_RTOL = 1e-4


def _step_pose(i, yaw=0.01):
    return np.array([1.0, 0.02 * i, 0.0, np.cos(yaw), 0, 0, np.sin(yaw)],
                    np.float32)


def _problem(weights, W=4, K=48, seed=0):
    """Noisy poses and landmarks seen from W poses (tests/test_ba.py's
    make_problem, smaller), observations landmark-major so the scatter
    order interleaves poses."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((W, 7), np.float32)
    gt[:, 3] = 1.0
    for i in range(1, W):
        gt[i] = G.np_compose_pose(gt[i - 1][None], _step_pose(i)[None])[0]
    lms = rng.uniform(-5, 10, size=(K, 3)).astype(np.float32)
    lms[:, 0] += 2.0
    obs_p, obs_l, obs_x = [], [], []
    for j in range(K):
        for i in range(W):
            if rng.uniform() < 0.15 and i > 0:
                continue                        # a missing observation
            inv = G.np_invert_pose(gt[i])
            R = G.quat_to_matrix_np(inv[3:])
            obs_p.append(i)
            obs_l.append(j)
            obs_x.append(lms[j] @ R.T + inv[:3] + rng.normal(0, 0.01, 3))
    O = len(obs_p)
    poses0 = gt.copy()
    poses0[1:, :3] += rng.normal(0, 0.1, (W - 1, 3))
    lms0 = lms + rng.normal(0, 0.1, lms.shape).astype(np.float32)
    if weights == "scalar":
        w = rng.uniform(0.2, 2.0, O).astype(np.float32)
        w[::17] = 0.0                           # disabled observations
    else:
        A = rng.normal(0, 0.3, (O, 3, 3)).astype(np.float32)
        w = (np.eye(3, dtype=np.float32) + np.triu(A)).astype(np.float32)
    anchor = np.zeros(W, bool)
    anchor[0] = True
    arrays = (poses0, lms0, np.asarray(obs_p, np.int32),
              np.asarray(obs_l, np.int32),
              np.asarray(obs_x, np.float32), w, anchor)
    return (jba.BAProblem(*map(jnp.asarray, arrays)),
            pba.BAProblem(*(torch.from_numpy(np.array(a)) for a in arrays)),
            gt, lms)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("weights", ["scalar", "sqrt_info"])
def test_linearize_and_reduced_system_match_jax(weights):
    jp, pp, _, _ = _problem(weights)
    jl = jax.jit(jba._linearize)(jp)
    pl = pba._linearize(pp)
    for got, want in zip(pl, jl):
        assert got.shape == want.shape
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-5
    got = pba._reduced_system(pp, *pl, 1e-4)
    want = jax.jit(jba._reduced_system, static_argnums=4)(jp, *jl, 1e-4)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= 1e-5, _rel(g.numpy(), w)


@pytest.mark.parametrize("weights", ["scalar", "sqrt_info"])
def test_solve_ba_matches_jax(weights):
    jp, pp, gt, lms = _problem(weights)
    want, wcost = jba.solve_ba(jp, iters=5)
    got, gcost = pba.solve_ba(pp, iters=5)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(got.landmarks.numpy(),
                               np.asarray(want.landmarks), rtol=0,
                               atol=LM_TOL)
    assert abs(float(gcost) - float(wcost)) <= COST_RTOL * float(wcost)
    # and it converged: poses near the truth, the anchor fixed
    err0 = np.abs(pp.poses.numpy()[:, :3] - gt[:, :3]).max()
    err1 = np.abs(got.poses.numpy()[:, :3] - gt[:, :3]).max()
    assert err1 < 0.2 * err0
    np.testing.assert_array_equal(got.poses[0].numpy(), pp.poses[0].numpy())


def test_ba_step_cost_matches_jax():
    jp, pp, _, _ = _problem("scalar", seed=1)
    (jn, jc), (pn, pc) = jax.jit(jba.ba_step)(jp), pba.ba_step(pp)
    assert abs(float(pc) - float(jc)) <= COST_RTOL * float(jc)
    np.testing.assert_allclose(pn.poses.numpy(), np.asarray(jn.poses),
                               rtol=0, atol=POSE_TOL)


def _window(seed=0, L=3, N=600, noise=0.05):
    """A static structured scene seen from L poses
    (tests/test_ba_bridge.py's make_window, smaller)."""
    rng = np.random.default_rng(seed)
    world = np.concatenate([
        rng.uniform(-20, 20, size=(N // 2, 3)) * [1, 1, 0.05],
        rng.uniform(-20, 20, size=(N // 2, 3)) * [1, 0.05, 1] + [0, 8, 2],
    ]).astype(np.float32)
    gt = np.zeros((L, 7), np.float32)
    gt[:, 3] = 1.0
    for i in range(1, L):
        gt[i] = G.np_compose_pose(gt[i - 1][None],
                                  _step_pose(2.5, 0.005)[None])[0]
    frames = []
    for i in range(L):
        inv = G.np_invert_pose(gt[i])
        R = G.quat_to_matrix_np(inv[3:])
        frames.append((world @ R.T + inv[:3] + rng.normal(
            0, 0.005, world.shape)).astype(np.float32))
    odoms = G.np_calc_vo(gt[:-1], gt[1:]).astype(np.float32)
    odoms[:, :3] += rng.normal(0, noise, odoms[:, :3].shape)
    # network-like covariance parameters: elu + 1 eigenvalue increments,
    # a random eigenvector quaternion
    cov = rng.normal(size=(L, N, 7)).astype(np.float32)
    cov[..., :3] = np.where(cov[..., :3] > 0, cov[..., :3] + 1,
                            np.exp(cov[..., :3])) * 0.05
    return frames, gt, odoms, cov


def _weights(kind, cov):
    if kind == "none":
        return None
    if kind == "scalar":
        return [jbb.cov_trace_weights(c) for c in cov]
    return [jbb.cov_sqrt_info(c) for c in cov]


@pytest.mark.parametrize("kind", ["none", "scalar", "sqrt_info"])
def test_window_ba_problem_bit_equal(kind):
    frames, gt, odoms, cov = _window()
    w = _weights(kind, cov)
    want = jbb.window_ba_problem(frames, gt, w, max_landmarks=400,
                                 assoc_threshold=0.8)
    got = pbb.window_ba_problem(frames, gt, w, max_landmarks=400,
                                assoc_threshold=0.8, device="cpu")
    for name, g, x in zip(pba.BAProblem._fields, got, want):
        x = np.asarray(x)
        assert g.numpy().dtype == x.dtype, name
        np.testing.assert_array_equal(g.numpy(), x, err_msg=name)
    assert got.obs_pose.shape[0] > 400 + 300    # frames 1, 2 associated
    # too few associations for 20 landmarks: None in both
    few = [f[:20] for f in frames]
    assert jbb.window_ba_problem(few, gt, assoc_threshold=1e-6) is None
    assert pbb.window_ba_problem(few, gt, assoc_threshold=1e-6,
                                 device="cpu") is None


def test_cov_weights_match_jax():
    cov = _window()[3].reshape(-1, 7)
    np.testing.assert_array_equal(pbb.cov_trace_weights(cov),
                                  jbb.cov_trace_weights(cov))
    got, want = pbb.cov_sqrt_info(cov), jbb.cov_sqrt_info(cov)
    assert got.shape == want.shape == (len(cov), 3, 3)
    assert _rel(got, want) <= 1e-5
    # W' W = (Sigma + eps I)^-1: the blocks whiten
    sig = np.linalg.inv(np.einsum("nba,nbc->nac", got, got))
    assert np.isfinite(sig).all()


@pytest.mark.parametrize("kind", ["none", "sqrt_info"])
def test_refine_window_ba_matches_jax(kind):
    frames, gt, odoms, cov = _window(seed=1)
    w = _weights(kind, cov)
    want = jbb.refine_window_ba(frames, odoms, w, iters=5,
                                assoc_threshold=0.8)
    got = pbb.refine_window_ba(frames, odoms, w, iters=5,
                               assoc_threshold=0.8, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    chained = G.odom_to_abs_pose(np.concatenate(
        [[[0, 0, 0, 1, 0, 0, 0]], odoms]).astype(np.float32))
    err0 = np.linalg.norm(chained[:, :3] - gt[:, :3], axis=1).mean()
    err1 = np.linalg.norm(got[:, :3] - gt[:, :3], axis=1).mean()
    assert err1 < 0.5 * err0, (err0, err1)


def test_refine_window_ba_falls_back_when_sparse():
    frames, gt, odoms, _ = _window(seed=2, N=20)
    got = pbb.refine_window_ba(frames, odoms, assoc_threshold=1e-6,
                               device="cpu")
    np.testing.assert_array_equal(got, jbb.refine_window_ba(
        frames, odoms, assoc_threshold=1e-6))
