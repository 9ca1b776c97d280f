"""Port run_eval_refined (rslo_tpu_torch.eval.runner) against the JAX
package's, on the CPU: both runners get the same windows of the
synthetic 3-frame split and the same per-window predictions (the
ground-truth pair motions with seeded noise; for the covariance BA also
the same voxel points, covariance parameters and masks), JAX's on a
one-device mesh.  The fused, BA-refined and loop-closed trajectories
(read where each runner draws them) are held to the pose-graph
tolerance of tests/test_torch_pgo.py, translations within 1e-4 and
quaternions (up to sign) within 1e-5; each metric the port reports is
JAX's evaluate_sequence of the port's trajectory, bit for bit; the
chained trajectory, pure numpy on the same predictions, is bit-equal
where no BA moved them.

With BA, the BA-refined pair motions are held to BA's pose tolerance
(1e-5, tests/test_torch_ba.py), and the fused quaternions to 1e-4, not
1e-5: BA makes each window's three motions consistent, so the
cycle-closure rotations that calibrate_pair_info reads are at the
resolution of its f32 ``2 arccos(|q.q'|)`` (one ulp of the dot near 1
is ~3.5e-4 rad).  An ulp of difference in the BA output then moves the
2-step class's rotation information by ~1.5% (75.25 against 76.36 in
the refine_ba_raw case), in JAX as in the port, and the fused
quaternions by up to 1.8e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torch_port_helpers import to_port

from rslo_tpu.cli import _synthetic_dataset as jax_synthetic
from rslo_tpu.config.schema import PipelineCfg
from rslo_tpu.eval import runner as jrunner
from rslo_tpu.eval import trajectory as jtraj
from rslo_tpu.eval.kitti_odometry import evaluate_sequence
from rslo_tpu.pgo import refine as jrefine
from rslo_tpu_torch.cli import _synthetic_dataset
from rslo_tpu_torch.eval import runner as prunner
from rslo_tpu_torch.eval import trajectory as ptraj

T_TOL = 1e-4
Q_TOL = 1e-5
BA_TOL = 1e-5
Q_TOL_AFTER_BA = 1e-4
N_VOX = 1200
# (name, run_eval_refined keywords, windows)
FLAGS = {
    "refine": (dict(), 12),
    "refine_ba": (dict(use_ba=True, cov=True), 4),
    "refine_ba_raw": (dict(use_ba=True, ba_points=512), 4),
    # every window is a scene of its own, so no revisit scores 0.8: a
    # threshold of 0.3 makes candidates, which ICP measures and the
    # pose graph takes as loop edges
    "refine_loops": (dict(use_loops=True, loop_min_separation=4,
                          loop_points=512, loop_score_threshold=0.3), 12),
}


def _cfg():
    # the KITTI range: the synthetic scenes keep most of their scale, so
    # the trajectories run long enough for the segment metrics
    cfg = PipelineCfg()
    return cfg.replace(data=dataclasses.replace(cfg.data, seq_length=3,
                                                max_points=4096))


def _window_outputs(sample, k):
    """Window k's predictions: the pair motions with seeded noise; voxel
    points (the first N_VOX points of each frame, a seeded mask),
    network-like covariance parameters."""
    rng = np.random.default_rng(100 + k)
    odom = np.asarray(sample["odometry"], np.float32).copy()
    odom[:, :3] += rng.normal(0, 0.05, odom[:, :3].shape)
    odom[:, 3:] += rng.normal(0, 0.004, odom[:, 3:].shape)
    odom[:, 3:] /= np.linalg.norm(odom[:, 3:], axis=-1, keepdims=True)
    pts = np.stack([f[:N_VOX, :3] for f in sample["points"]])[None]
    cov = rng.normal(size=pts.shape[:-1] + (7,)).astype(np.float32)
    cov[..., :3] = np.where(cov[..., :3] > 0, cov[..., :3] + 1,
                            np.exp(cov[..., :3])) * 0.05
    msk = rng.uniform(size=pts.shape[:-1]) > 0.2
    return odom[None], pts.astype(np.float32), cov, msk


def _capture(monkeypatch, module, edges_module):
    """Record the trajectories a runner draws (plots go nowhere) and the
    window predictions it expands into edges."""
    seen = {"preds": []}

    def draw(variants, gt_abs, title="", save_path=None):
        seen[title] = ({k: np.array(v) for k, v in variants.items()},
                       np.array(gt_abs))

    to_edges = edges_module.window_pairs_to_edges

    def edges(starts, offsets, preds, *args):
        seen["preds"].append(np.array(preds))
        return to_edges(starts, offsets, preds, *args)

    monkeypatch.setattr(module, "draw_trajectories", draw)
    monkeypatch.setattr(edges_module, "window_pairs_to_edges", edges)
    return seen


@pytest.fixture(scope="module", params=list(FLAGS))
def runs(request):
    name = request.param
    kw, n = FLAGS[name]
    kw = dict(kw)
    cov = kw.pop("cov", False)
    cfg = _cfg()
    pcfg = to_port(cfg)
    jds = jax_synthetic(cfg, "train", n_windows=n)
    pds = _synthetic_dataset(pcfg, "train", n_windows=n)
    outs = [_window_outputs(jds[k], k) for k in range(n)]
    mp = pytest.MonkeyPatch()
    try:
        jseen = _capture(mp, jtraj, jrefine)
        pseen = _capture(mp, ptraj, prunner)
        calls = {"jax": 0, "port": 0}

        def jstep(params, stats, batch):
            k = calls["jax"]
            calls["jax"] += 1
            return jnp.asarray(outs[k][0])

        def jstep_cov(params, stats, batch):
            k = calls["jax"]
            calls["jax"] += 1
            return tuple(jnp.asarray(a) for a in outs[k])

        def pstep(batch):
            assert batch["points"].shape == (1, 3, 4096, 7)
            k = calls["port"]
            calls["port"] += 1
            return torch.from_numpy(outs[k][0])

        def pstep_cov(batch):
            k = calls["port"]
            calls["port"] += 1
            return tuple(torch.from_numpy(a) for a in outs[k])

        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        common = dict(max_windows=n, window=8, overlap=2, iters=8,
                      plot_dir="unused", **kw)
        want = jrunner.run_eval_refined(
            None, {"params": {}}, jds, cfg, mesh, jstep,
            eval_step_cov=jstep_cov if cov else None, **common)
        got = prunner.run_eval_refined(
            pstep, pds, pcfg, eval_step_cov=pstep_cov if cov else None,
            **common)
    finally:
        mp.undo()
    assert calls == {"jax": n, "port": n}
    return dict(name=name, want=want, got=got, jseen=jseen, pseen=pseen,
                n=n)


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) and k not in (
        "segments", "speed_bins") else None for k, v in d.items()}


def test_refined_keys_match_jax(runs):
    got, want = runs["got"], runs["want"]
    assert _keys(got) == _keys(want)
    assert got["_meta"]["windows"] == want["_meta"]["windows"] == runs["n"]
    assert got["_meta"]["refined"] is True
    seq = got["seq_00"]
    assert ("loop_closed" in seq) == (runs["name"] == "refine_loops")
    if runs["name"] == "refine_loops":
        assert seq["n_loops"] == runs["want"]["seq_00"]["n_loops"] >= 1
        assert seq["loop_keyframes"] == want["seq_00"]["loop_keyframes"]


def _close_poses(got, want, q_tol=Q_TOL):
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=0, atol=T_TOL)
    dq = np.minimum(np.abs(got[:, 3:] - want[:, 3:]).max(-1),
                    np.abs(got[:, 3:] + want[:, 3:]).max(-1))
    assert dq.max() <= q_tol, dq.max()


def _trajectories(seen):
    (variants, gt), = (v for k, v in seen.items() if k != "preds")
    return variants, gt


def test_window_predictions_match_jax(runs):
    """The pair motions the fusion takes: the eval step's own, or BA's
    refinement of them."""
    # the first expansion is the predictions', the second the ground
    # truth's
    got, want = runs["pseen"]["preds"][0], runs["jseen"]["preds"][0]
    assert len(runs["pseen"]["preds"]) == len(runs["jseen"]["preds"]) == 2
    assert got.shape == want.shape == (runs["n"], 3, 7)
    if "ba" in runs["name"]:
        np.testing.assert_allclose(got, want, rtol=0, atol=BA_TOL)
        assert np.abs(got - _window_outputs_all(runs["n"])).max() > 1e-4
    else:
        np.testing.assert_array_equal(got, want)


def _window_outputs_all(n):
    ds = jax_synthetic(_cfg(), "train", n_windows=n)
    return np.stack([_window_outputs(ds[k], k)[0][0] for k in range(n)])


def test_refined_trajectories_match_jax(runs):
    pvar, pgt = _trajectories(runs["pseen"])
    jvar, jgt = _trajectories(runs["jseen"])
    assert list(pvar) == list(jvar)
    np.testing.assert_array_equal(pgt, jgt)
    ba = "ba" in runs["name"]
    for name in jvar:
        if name == "chained" and not ba:
            np.testing.assert_array_equal(pvar[name], jvar[name])
        else:
            _close_poses(pvar[name], jvar[name],
                         Q_TOL_AFTER_BA if ba else Q_TOL)
    # the fusion moved the trajectory off the chain
    assert np.abs(pvar["refined"] - pvar["chained"]).max() > 1e-3


def test_refined_metrics_are_jax_metrics_of_the_trajectories(runs):
    pvar, pgt = _trajectories(runs["pseen"])
    seq = runs["got"]["seq_00"]
    for name, traj in pvar.items():
        want = evaluate_sequence(traj, pgt)
        np.testing.assert_equal(seq[name], want)
        for key in ("t_rel_pct", "r_rel_deg_per_100m", "ate_rmse_m"):
            assert np.isfinite(seq[name][key]), (name, key)
    if "ba" not in runs["name"]:
        np.testing.assert_equal(seq["chained"],
                                runs["want"]["seq_00"]["chained"])
