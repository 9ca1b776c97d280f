"""Port the numpy pose helpers (rslo_tpu_torch.geometry.transforms), the
KITTI metrics (eval.kitti_odometry), the trajectory plots
(eval.trajectory) and the CLI's best-checkpoint record
(cli.update_best_checkpoint) against the JAX package: the same numpy
code on the same arrays, so every output is bit-equal (NaN equal to
NaN)."""
import functools
import json

import numpy as np
import pytest

from rslo_tpu import geometry as G
from rslo_tpu.cli import update_best_checkpoint as jax_update_best
from rslo_tpu.eval import kitti_odometry as JK
from rslo_tpu.eval import trajectory as JT
from rslo_tpu_torch import geometry as PG
from rslo_tpu_torch.cli import update_best_checkpoint
from rslo_tpu_torch.eval import kitti_odometry as PK
from rslo_tpu_torch.eval import trajectory as PT

from torch_port_helpers import assert_same


def random_poses(rng, n):
    t = rng.normal(size=(n, 3)) * 3
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([t, q], axis=1).astype(np.float32)


def straight_odoms(n=1500, step=1.0):
    """Forward motion along x at `step` m/frame (tests/test_eval_metrics)."""
    odoms = np.zeros((n, 7), np.float32)
    odoms[:, 3] = 1.0
    odoms[1:, 0] = step
    return odoms


def random_trajectory(n=300, seed=7):
    """A 300-frame drive with yaw, pitch and roll, and a noisy copy of
    it: absolute (gt, pred) poses."""
    rng = np.random.default_rng(seed)
    odoms = np.zeros((n, 7), np.float32)
    odoms[1:, 0] = rng.uniform(0.5, 1.5, n - 1)
    odoms[1:, 1:3] = rng.normal(0, 0.05, (n - 1, 2))
    half = rng.normal(0, 0.01, (n - 1, 3))
    half[:, 2] += 0.02 * np.sin(np.arange(n - 1) / 20.0)
    q = np.concatenate([np.ones((n - 1, 1)), half], axis=1)
    odoms[1:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    odoms[0, 3] = 1.0
    noisy = odoms.copy()
    noisy[1:, :3] += rng.normal(0, 0.02, (n - 1, 3))
    dq = noisy[1:, 3:] + rng.normal(0, 0.002, (n - 1, 4))
    noisy[1:, 3:] = dq / np.linalg.norm(dq, axis=1, keepdims=True)
    return G.odom_to_abs_pose(odoms), G.odom_to_abs_pose(noisy)


# each helper on seeded arrays of its shape: (name, args builder)
HELPERS = {
    "np_compose_pose": lambda r: (random_poses(r, 16), random_poses(r, 16)),
    "np_invert_pose": lambda r: (random_poses(r, 16),),
    "np_calc_vo": lambda r: (random_poses(r, 16), random_poses(r, 16)),
    "matrix_to_quat_np": lambda r: (G.quat_to_matrix_np(
        random_poses(r, 1)[0, 3:]),),
    "quat_to_matrix_np": lambda r: (random_poses(r, 1)[0, 3:],),
    "expand_rigid": lambda r: (r.normal(size=(3, 4)),),
    "RT_to_tq": lambda r: (G.tq_to_RT(random_poses(r, 1)),),
    "tq_to_RT": lambda r: (random_poses(r, 1), True),
    "cam_pose_to_lidar": lambda r: (G.tq_to_RT(random_poses(r, 1)),
                                    G.tq_to_RT(random_poses(r, 1))),
    "odom_to_abs_pose": lambda r: (random_poses(r, 40),),
    "umeyama_alignment": lambda r: (r.normal(size=(50, 3)),
                                    r.normal(size=(50, 3)), True),
    "ate_rmse": lambda r: (random_poses(r, 50), random_poses(r, 50)),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_pose_helpers_bit_equal(name):
    for seed in range(4):
        args = HELPERS[name](np.random.default_rng(seed))
        assert_same(getattr(PG, name)(*args), getattr(G, name)(*args),
                    name)


@pytest.mark.parametrize("branch", range(4))
def test_matrix_to_quat_branches_bit_equal(branch):
    """Each of the four branches of the trace test (trace > 0, then the
    largest diagonal entry x, y or z)."""
    half = [np.array([1.0, 0.1, 0.2, 0.3]), np.array([0.1, 1.0, 0.2, 0.3]),
            np.array([0.1, 0.2, 1.0, 0.3]), np.array([0.1, 0.2, 0.3, 1.0])]
    R = G.quat_to_matrix_np(half[branch])
    np.testing.assert_array_equal(PG.matrix_to_quat_np(R),
                                  G.matrix_to_quat_np(R))


@functools.lru_cache(maxsize=None)
def _cases():
    gt = G.odom_to_abs_pose(straight_odoms())
    gt_98 = G.odom_to_abs_pose(straight_odoms(step=0.98))
    gt_1050 = G.odom_to_abs_pose(straight_odoms(1050))
    offset = G.odom_to_abs_pose(straight_odoms(200))
    shifted = offset.copy()
    shifted[:, 0] += 5.0
    rand_gt, rand_pred = random_trajectory()
    return {
        "perfect": (gt, gt),
        "scale_error": (gt_98, gt),
        "devkit_segments": (gt_1050, gt_1050),
        "rigid_offset": (shifted, offset),
        # shorter than every standard segment: the path-scaled fallback
        "short_scaled": (rand_pred[:40], rand_gt[:40]),
        "too_short_nan": (rand_pred[:2], rand_gt[:2]),
        "random_300": (rand_pred, rand_gt),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_evaluate_sequence_bit_equal(case):
    pred, gt = _cases()[case]
    assert_same(PK.evaluate_sequence(pred, gt), JK.evaluate_sequence(pred, gt))
    assert_same(PK.sequence_errors(pred, gt), JK.sequence_errors(pred, gt))


def test_random_trajectory_has_standard_segments():
    pred, gt = _cases()["random_300"]
    out = PK.evaluate_sequence(pred, gt)
    assert out["n_segments"] > 0 and not out["segments_scaled"]
    assert np.isfinite(out["t_rel_pct"]) and out["t_rel_pct"] > 0


def test_draw_trajectories_bit_equal(tmp_path):
    pred, gt = _cases()["random_300"]
    np.testing.assert_array_equal(
        PT.draw_trajectory(pred, gt, title="seq 00",
                           save_path=str(tmp_path / "p.png")),
        JT.draw_trajectory(pred, gt, title="seq 00"))
    assert (tmp_path / "p.png").exists()
    variants = {"chained": pred, "refined": gt + 0.1}
    np.testing.assert_array_equal(PT.draw_trajectories(variants, gt),
                                  JT.draw_trajectories(variants, gt))


NAN = float("nan")
# the sequence of tests/test_checkpoint.py::test_best_checkpoint_nan_proof
BEST_CASES = [
    ("all-NaN eval writes nothing", 100, {"t_rel_pct": NAN}),
    ("fallback key", 200, {"t_rel_pct": NAN, "frame_t_err_m": 0.9}),
    ("worse fallback keeps the record", 300, {"frame_t_err_m": 1.5}),
    ("primary key wins outright", 400,
     {"t_rel_pct": 55.0, "frame_t_err_m": 1.2}),
    ("improvement on the primary key", 500, {"t_rel_pct": 40.0}),
    ("worse primary key keeps the record", 600, {"t_rel_pct": 47.0}),
    ("NaN-poisoned record replaced", 700, {"t_rel_pct": 90.0}),
]


@pytest.mark.parametrize("upto", range(1, len(BEST_CASES) + 1),
                         ids=[c[0] for c in BEST_CASES])
def test_update_best_checkpoint_matches_jax(upto, tmp_path):
    """Replay the cases up to ``upto`` in a port dir and a JAX dir: the
    same return values and the same best_ckpt.json after each."""
    dirs = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    for d in dirs.values():
        d.mkdir()
    for _, step, avg in BEST_CASES[:upto]:
        if step == 700:
            for d in dirs.values():
                (d / "best_ckpt.json").write_text(
                    '{"step": 1, "metric": NaN, "metric_name": '
                    '"t_rel_pct"}')
        got = update_best_checkpoint(dirs["port"], step, avg)
        want = jax_update_best(dirs["jax"], step, avg)
        assert got == want
        files = [d / "best_ckpt.json" for d in dirs.values()]
        assert files[0].exists() == files[1].exists()
        if files[0].exists():
            assert files[0].read_text() == files[1].read_text()
    expect = {100: None, 200: 200, 300: 200, 400: 400, 500: 500, 600: 500,
              700: 700}[BEST_CASES[upto - 1][1]]
    rec = dirs["port"] / "best_ckpt.json"
    assert (json.loads(rec.read_text())["step"] if rec.exists()
            else None) == expect
