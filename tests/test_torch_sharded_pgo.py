"""The port's sharded refinement solvers (pgo/sharded.py
``fuse_windows_sharded``, pgo/ba.py ``solve_ba_sharded``) against the
JAX package's, on the CPU: without a process group against JAX without
a mesh, and over two gloo ranks (tests/torch_dist_workers.py) against
JAX on a 2-device mesh (the twins of tests/test_sharded_pgo.py and
tests/test_ba.py's ``test_ba_sharded_matches``).  Poses are held to
tests/test_torch_pgo.py's and tests/test_torch_ba.py's tolerances, and
the two ranks return the same bits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from test_ba import make_problem
from tests_helpers_traj import make_traj
from torch_dist_workers import run_ranks

from rslo_tpu import geometry as G
from rslo_tpu.pgo import ba as jba
from rslo_tpu.pgo.refine import window_pairs_to_edges
from rslo_tpu.pgo.sharded import fuse_windows_sharded as jax_fuse
from rslo_tpu_torch.pgo.sharded import fuse_windows_sharded

D = 2
T_TOL = 1e-4        # tests/test_torch_pgo.py: translations
Q_TOL = 1e-5        # and quaternions (up to sign)
POSE_TOL = 1e-5     # tests/test_torch_ba.py: BA poses
LM_TOL = 1e-4       # and landmarks
COST_RTOL = 1e-4
FUSE = dict(window=32, overlap=8, iters=8)


def _close_poses(got, want, k=1):
    """Within k times the pose-graph tolerance."""
    np.testing.assert_allclose(got[..., :3], want[..., :3], rtol=0,
                               atol=k * T_TOL)
    dq = np.minimum(np.abs(got[..., 3:] - want[..., 3:]).max(-1),
                    np.abs(got[..., 3:] + want[..., 3:]).max(-1))
    assert dq.max() <= k * Q_TOL, dq.max()


def _pairs(seed=0, n=80):
    """tests/test_sharded_pgo.py's noisy 3-frame window pairs."""
    rng = np.random.default_rng(seed)
    gt_abs = make_traj(n)
    offsets = [(0, 1), (0, 2), (1, 2)]
    starts = list(range(0, n - 2))
    preds = []
    for s in starts:
        rows = []
        for (i, j) in offsets:
            m = G.np_calc_vo(gt_abs[s + i:s + i + 1],
                             gt_abs[s + j:s + j + 1])[0].astype(np.float32)
            m[:3] += rng.normal(0, 0.03, 3)
            qn = np.asarray(G.qexp(jnp.asarray(rng.normal(0, 0.003, 3))),
                            np.float32)
            m[3:] = np.asarray(G.qmult(jnp.asarray(m[3:]),
                                       jnp.asarray(qn)))
            rows.append(m)
        preds.append(np.stack(rows))
    E, M, W = window_pairs_to_edges(starts, offsets, np.stack(preds))
    return gt_abs, E, M, W


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    gt, E, M, W = _pairs()
    n = len(gt)
    mesh = Mesh(np.array(jax.devices()[:D]), ("data",))
    return dict(
        gt=gt, E=E, M=M,
        jax_one=jax_fuse(E, M, n, W, **FUSE),
        jax_two=jax_fuse(E, M, n, W, mesh=mesh, **FUSE),
        port_one=fuse_windows_sharded(E, M, n, W, device="cpu", **FUSE),
        port_two=run_ranks("fuse_sharded", tmp_path_factory.mktemp("fuse"),
                           E=E, M=M, n=n, W=W, kw=FUSE))


def test_fuse_windows_without_a_group_matches_jax(fused):
    _close_poses(fused["port_one"], fused["jax_one"])


def test_fuse_windows_over_two_ranks_matches_jax(fused):
    """Each side within the tolerance of JAX's (JAX's sharded solve is
    its unsharded one, bit for bit); a rank's batch of half the windows
    rounds other than the whole batch, so the port's two runs are held
    to each other at twice the tolerance (at ~50 m from the origin the
    stitched translations of this 80-pose trajectory differ by ~30
    ulps)."""
    np.testing.assert_array_equal(fused["port_two"][0], fused["port_two"][1])
    np.testing.assert_array_equal(fused["jax_two"], fused["jax_one"])
    _close_poses(fused["port_two"][0], fused["jax_two"])
    _close_poses(fused["port_two"][0], fused["port_one"], k=2)


def test_sharded_fuse_reduces_noise(fused):
    gt, E, M = fused["gt"], fused["E"], fused["M"]
    n = len(gt)
    chain = np.zeros((n, 7), np.float32)
    chain[:, 3] = 1.0
    lookup = {tuple(e): k for k, e in enumerate(E)}
    for i in range(n - 1):
        chain[i + 1] = M[lookup[(i, i + 1)]]
    err_chain = np.linalg.norm(G.odom_to_abs_pose(chain)[-1, :3] -
                               gt[-1, :3])
    err_ref = np.linalg.norm(fused["port_two"][0][-1, :3] - gt[-1, :3])
    assert np.isfinite(err_ref) and err_ref < err_chain, (err_chain,
                                                          err_ref)


def _sharded_problem(rng, W=6, K=64):
    """tests/test_ba.py's problem with the observations grouped by
    landmark, and the D shards of it (obs_lm local to each)."""
    problem, _, _ = make_problem(rng, W=W, K=K)
    per = K // D
    op = np.asarray(problem.obs_pose).reshape(W, K)
    ox = np.asarray(problem.obs_xyz).reshape(W, K, 3)
    obs_p = op.T.reshape(-1).astype(np.int32)             # lm-major
    obs_x = ox.transpose(1, 0, 2).reshape(-1, 3)
    obs_l = np.repeat(np.arange(K), W).astype(np.int32)
    whole = jba.BAProblem(
        np.asarray(problem.poses), np.asarray(problem.landmarks), obs_p,
        obs_l, obs_x, np.ones((W * K,), np.float32),
        np.asarray(problem.anchor))
    sharded = whole._replace(obs_lm=obs_l % per)
    shards = []
    for r in range(D):
        o = slice(r * per * W, (r + 1) * per * W)
        shards.append(tuple(np.asarray(f) for f in (
            whole.poses, whole.landmarks[r * per:(r + 1) * per], obs_p[o],
            (obs_l % per)[o], obs_x[o], whole.obs_w[o], whole.anchor)))
    return whole, sharded, shards


def test_solve_ba_sharded_over_two_ranks_matches_jax(tmp_path, rng):
    whole, sharded, shards = _sharded_problem(rng)
    mesh = Mesh(np.array(jax.devices()[:D]), ("data",))
    jposes, jlms, jcost = jba.solve_ba_sharded(
        jba.BAProblem(*map(jnp.asarray, sharded)), mesh, iters=6)
    ref, _ = jba.solve_ba(jba.BAProblem(*map(jnp.asarray, whole)), iters=6)
    got = run_ranks("ba_sharded", tmp_path, shards=shards, iters=6)
    for r in range(D):
        for a, b in zip(got[r], got[0]):
            np.testing.assert_array_equal(a, b)
    poses, lms, cost = got[0]
    np.testing.assert_allclose(poses, np.asarray(jposes), rtol=0,
                               atol=POSE_TOL)
    np.testing.assert_allclose(lms, np.asarray(jlms), rtol=0, atol=LM_TOL)
    assert abs(cost - float(jcost)) <= COST_RTOL * float(jcost)
    # and the sharded solve is the unsharded one (tests/test_ba.py)
    np.testing.assert_allclose(poses, np.asarray(ref.poses), atol=2e-3)
    np.testing.assert_allclose(lms, np.asarray(ref.landmarks), atol=2e-3)


def test_solve_ba_sharded_without_a_group_is_solve_ba(rng):
    """One process, the whole problem: the same Gauss-Newton steps as
    ``solve_ba``, bit for bit."""
    import torch
    from rslo_tpu_torch.pgo import ba as pba
    whole, _, _ = _sharded_problem(rng)
    prob = pba.BAProblem(*(torch.tensor(np.asarray(f)) for f in whole))
    poses, lms, _ = pba.solve_ba_sharded(prob, None, iters=6)
    ref, _ = pba.solve_ba(prob, iters=6)
    np.testing.assert_array_equal(poses.numpy(), ref.poses.numpy())
    np.testing.assert_array_equal(lms.numpy(), ref.landmarks.numpy())
