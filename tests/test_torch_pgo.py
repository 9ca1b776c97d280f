"""Port pose-graph optimization and windowed refinement
(rslo_tpu_torch.pgo.pose_graph, .refine) against the JAX package on the
same seeded numpy inputs, on the CPU.

Tolerances: the residuals, the Gauss-Newton system (H, g) within 1e-5
relative (the same f32 ops; XLA and torch sum the products in another
order); solved poses, translations within 1e-4 and quaternions (up to
sign) within 1e-5, final costs within 1e-4 relative (8 steps of a
Cholesky solve in f32 carry those orderings forward); the numpy parts
of refine.py bit-equal."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_same, tt

from rslo_tpu import geometry as G
from rslo_tpu.pgo import pose_graph as jpg
from rslo_tpu.pgo import refine as jref
from rslo_tpu_torch.geometry import calc_vo
from rslo_tpu_torch.pgo import pose_graph as ppg
from rslo_tpu_torch.pgo import refine as pref

T_TOL = 1e-4
Q_TOL = 1e-5
COST_RTOL = 1e-4
HI = jax.lax.Precision.HIGHEST
OFFSETS = [(0, 1), (0, 2), (1, 2)]


def _qexp_np(v):
    n = np.linalg.norm(v)
    return np.concatenate([[np.cos(n)], v * np.sin(n) / max(n, 1e-12)])


def _noisy_pose(p, rng, t_noise, r_noise):
    p = p.astype(np.float32).copy()
    p[:3] += rng.normal(0, t_noise, 3)
    p[3:] = G.np_compose_pose(
        np.concatenate([[0, 0, 0], p[3:]])[None],
        np.concatenate([[0, 0, 0], _qexp_np(rng.normal(0, r_noise, 3))]
                       )[None])[0, 3:]
    return p


def _trajectory(n):
    odoms = np.zeros((n, 7), np.float32)
    odoms[:, 3] = 1.0
    odoms[1:, 0] = 1.0          # 1 m/frame forward
    odoms[1:, 6] = 0.01         # slight yaw per frame
    odoms[1:, 3] = np.sqrt(1 - 0.01 ** 2)
    return G.odom_to_abs_pose(odoms)


def _graph(n=12, seed=0, loops=True):
    """A noisy chain of n poses with loop edges and mixed information."""
    rng = np.random.default_rng(seed)
    gt = _trajectory(n)
    odoms = G.np_calc_vo(gt[:-1], gt[1:]).astype(np.float32)
    noisy = np.stack([_noisy_pose(o, rng, 0.05, 0.01) for o in odoms])
    le = np.array([[0, 5], [2, 9], [3, n - 1]], np.int32)
    lm = np.stack([_noisy_pose(m, rng, 0.01, 0.002)
                   for m in G.np_calc_vo(gt[le[:, 0]], gt[le[:, 1]])])
    li = np.stack([np.diag(rng.uniform(1, 20, 6)) for _ in le]).astype(
        np.float32)
    if not loops:
        le = lm = li = None
    j = jpg.chain_graph(jnp.asarray(noisy), 2.0,
                        *(None if a is None else jnp.asarray(a)
                          for a in (le, lm, li)))
    p = ppg.chain_graph(tt(noisy), 2.0,
                        *(None if a is None else tt(a) for a in (le, lm, li)))
    return j, p


def _close_poses(got, want):
    np.testing.assert_allclose(got[..., :3], want[..., :3], rtol=0,
                               atol=T_TOL)
    dq = np.minimum(np.abs(got[..., 3:] - want[..., 3:]).max(-1),
                    np.abs(got[..., 3:] + want[..., 3:]).max(-1))
    assert dq.max() <= Q_TOL, dq.max()


@pytest.mark.parametrize("loops", [True, False])
def test_chain_graph_matches_jax(loops):
    (jp0, jg), (pp0, pg) = _graph(loops=loops)
    np.testing.assert_array_equal(pp0.numpy(), np.asarray(jp0))
    for a, b in zip(pg, jg):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_edge_residual_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(3, 40, 4)).astype(np.float32)
    t = rng.normal(0, 5, size=(3, 40, 3)).astype(np.float32)
    p = np.concatenate([t, q / np.linalg.norm(q, axis=-1, keepdims=True)],
                       -1)
    got = ppg.edge_residual(tt(p[0]), tt(p[1]), tt(p[2])).numpy()
    want = np.asarray(jpg.edge_residual(*map(jnp.asarray, p)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 *
                               np.abs(want).max())
    # a consistent edge has a zero residual
    r0 = ppg.edge_residual(tt(p[0]), tt(p[1]), calc_vo(tt(p[0]), tt(p[1])))
    assert np.abs(r0.numpy()).max() < 1e-4


def _jax_normal_equations(poses, graph):
    """H and g of one step of rslo_tpu/pgo/pose_graph.py::
    optimize_pose_graph (its lines, outside the jit)."""
    N = poses.shape[0]
    delta0 = jnp.zeros((N, 6), poses.dtype)
    r = jpg._residuals(delta0, poses, graph)
    J = jax.jacfwd(lambda d: jpg._residuals(d, poses, graph))(delta0)
    E = r.shape[0]
    J = J.reshape(E * 6, N * 6)
    Lam = graph.info
    r_w = jnp.einsum('eab,eb->ea', Lam, r, precision=HI).reshape(-1)
    J_w = jnp.einsum('eab,ebn->ean', Lam, J.reshape(E, 6, N * 6),
                     precision=HI).reshape(E * 6, N * 6)
    return (jnp.dot(J.T, J_w, precision=HI), jnp.dot(J.T, r_w, precision=HI))


def test_gauss_newton_system_matches_jax():
    (jp0, jg), (pp0, pg) = _graph()
    H, g = ppg._normal_equations(pp0, pg)
    Hj, gj = map(np.asarray, _jax_normal_equations(jp0, jg))
    assert H.shape == (72, 72) and g.shape == (72,)
    for got, want in ((H.numpy(), Hj), (g.numpy(), gj)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.isfinite(H.numpy()).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_optimize_pose_graph_matches_jax(seed):
    (jp0, jg), (pp0, pg) = _graph(seed=seed)
    want, wcost = jpg.optimize_pose_graph(jp0, jg, iters=8)
    got, gcost = ppg.optimize_pose_graph(pp0, pg, iters=8)
    _close_poses(got.numpy(), np.asarray(want))
    assert abs(float(gcost) - float(wcost)) <= COST_RTOL * float(wcost)
    # the anchor stays put and the solve moved the rest
    np.testing.assert_array_equal(got[0].numpy(), pp0[0].numpy())
    assert np.abs(got.numpy() - pp0.numpy()).max() > 1e-3


def test_consistent_graph_is_a_fixed_point():
    """Zero residuals: qlog at identity inside the Jacobian stays finite
    and the solve leaves the poses where they are."""
    gt = _trajectory(8)
    odoms = G.np_calc_vo(gt[:-1], gt[1:]).astype(np.float32)
    p0, graph = ppg.chain_graph(tt(odoms))
    H, g = ppg._normal_equations(p0, graph)
    assert np.isfinite(H.numpy()).all() and np.abs(g.numpy()).max() < 1e-5
    got, cost = ppg.optimize_pose_graph(p0, graph, iters=3)
    np.testing.assert_allclose(got.numpy(), p0.numpy(), atol=1e-5)
    assert float(cost) < 1e-9


def test_failed_factorization_keeps_the_last_finite_poses():
    """A chain of relative motions of ~2 km (an untrained network's
    predictions, fused): H's rotation blocks are ~1e7 times its
    translation blocks, too ill-conditioned for f32.  JAX's solver
    returns NaN poses (then the KITTI metrics' SVD raises); the port's
    factorization passes but its steps raise the cost by orders of
    magnitude (kilometres from the optimum in one step).  The port
    takes no step that multiplies the cost by more than DIVERGED: the
    consistent chain stays at its initial poses, up to the rounding of
    km-scale f32 coordinates."""
    rng = np.random.default_rng(0)
    n = 31
    ax = rng.normal(size=(n, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    ang = rng.uniform(0, 0.5, (n, 1))
    odoms = np.concatenate([rng.normal(0, 2000.0, (n, 3)), np.cos(ang / 2),
                            np.sin(ang / 2) * ax], 1).astype(np.float32)
    jp0, jg = jpg.chain_graph(jnp.asarray(odoms), 1.0)
    want, wcost = jpg.optimize_pose_graph(jp0, jg, iters=3)
    assert not np.isfinite(np.asarray(want)).any()
    pp0, pg = ppg.chain_graph(tt(odoms), 1.0)
    zeros = torch.zeros((n + 1, 6))
    cost0 = float(ppg._cost(ppg._residuals(zeros, pp0, pg), pg.info))
    got, cost = ppg.optimize_pose_graph(pp0, pg, iters=3)
    np.testing.assert_allclose(got[:, :3].numpy(), pp0[:, :3].numpy(),
                               rtol=0, atol=1e-2)
    np.testing.assert_allclose(got[:, 3:].numpy(), pp0[:, 3:].numpy(),
                               rtol=0, atol=1e-5)
    assert float(cost) <= ppg.DIVERGED * cost0


def _window_preds(n, seed, dup_noise=True, r2_noise=0.003):
    """Per-window (0,1), (0,2), (1,2) motions of a noisy trajectory, as
    tests/test_refine.py makes them (fewer frames)."""
    rng = np.random.default_rng(seed)
    gt = _trajectory(n)
    starts = list(range(0, n - 2))
    fixed = {}
    preds = []
    for s in starts:
        row = []
        for (i, j) in OFFSETS:
            key = (s + i, s + j)
            if dup_noise or key not in fixed:
                m = G.np_calc_vo(gt[key[0]][None], gt[key[1]][None])[0]
                fixed[key] = _noisy_pose(
                    m, rng, 0.03, r2_noise if j - i > 1 else 0.003)
            row.append(fixed[key].copy())
        preds.append(np.stack(row))
    weights = rng.uniform(0.5, 2.0, size=(len(starts), 3)).astype(
        np.float32)
    return starts, np.stack(preds), weights


@pytest.mark.parametrize("weighted", [True, False])
def test_window_pairs_to_edges_bit_equal(weighted):
    starts, preds, weights = _window_preds(20, 2)
    w = weights if weighted else None
    assert_same(pref.window_pairs_to_edges(starts, OFFSETS, preds, w),
                jref.window_pairs_to_edges(starts, OFFSETS, preds, w))


@pytest.mark.parametrize("dup_noise", [True, False])
def test_duplicate_pair_variance_bit_equal(dup_noise):
    starts, preds, _ = _window_preds(20, 3, dup_noise=dup_noise)
    got = pref.duplicate_pair_variance(starts, OFFSETS, preds)
    assert got == jref.duplicate_pair_variance(starts, OFFSETS, preds)
    assert got[0] is not None


@pytest.mark.parametrize("dup", ["measured", "degenerate", "none",
                                 "no_triples"])
def test_calibrate_pair_info_bit_equal(dup):
    starts, preds, weights = _window_preds(
        20, 4, dup_noise=dup != "degenerate", r2_noise=0.02)
    E, M, W = jref.window_pairs_to_edges(starts, OFFSETS, preds, weights)
    if dup == "no_triples":        # consecutive edges only: uniform info
        keep = (E[:, 1] - E[:, 0]) == 1
        E, M, W = E[keep], M[keep], W[keep]
    dv = (jref.duplicate_pair_variance(starts, OFFSETS, preds)
          if dup in ("measured", "degenerate") else None)
    got = pref.calibrate_pair_info(E, M, W, dup_var=dv)
    want = jref.calibrate_pair_info(E, M, W, dup_var=dv)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("calibrated", [True, False])
def test_fuse_window_odometry_matches_jax(calibrated):
    """Three overlapping windows of 14 frames over a 30-frame trajectory,
    with calibrated information or scalar weights."""
    n = 30
    starts, preds, weights = _window_preds(n, 5, r2_noise=0.02)
    E, M, W = jref.window_pairs_to_edges(starts, OFFSETS, preds, weights)
    info = None
    if calibrated:
        dv = jref.duplicate_pair_variance(starts, OFFSETS, preds)
        info = jref.calibrate_pair_info(E, M, W, dup_var=dv)
    kw = dict(window=14, overlap=4, iters=8, pair_info=info)
    want = jref.fuse_window_odometry(E, M, n, W, **kw)
    got = pref.fuse_window_odometry(E, M, n, W, device="cpu", **kw)
    assert got.shape == want.shape == (n, 7) and got.dtype == want.dtype
    _close_poses(got, want)
    chained = G.odom_to_abs_pose(np.concatenate(
        [[[0, 0, 0, 1, 0, 0, 0]], M[(E[:, 1] - E[:, 0]) == 1]]).astype(
            np.float32))
    assert np.abs(got - chained).max() > 1e-3     # the windows were solved


def test_entry_points_default_to_the_card():
    """The refinement entry points run on the card unless the caller
    passes device="cpu"; run_eval_refined takes its eval step's device
    and the solvers their tensors'."""
    from rslo_tpu_torch.eval import runner
    from rslo_tpu_torch.pgo import ba_bridge, loop_closure
    for fn in (pref.fuse_window_odometry, ba_bridge.refine_window_ba,
               ba_bridge.window_ba_problem, loop_closure.close_loops):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for fn in (runner.run_eval_refined, ppg.optimize_pose_graph):
        assert "device" not in inspect.signature(fn).parameters
