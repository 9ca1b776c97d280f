"""Port loop closing (rslo_tpu_torch.pgo.loop_closure) against the JAX
package on the same seeded numpy inputs (tests/test_loop_closure.py's
structured synthetic world), on the CPU.

The descriptor is bit-equal; the shifted-cosine scores within 1e-6 (the
same f32 products, summed in another order) with the same best shifts;
loop pairs equal.  ICP: JAX associates through its XLA nn_search, which
expands the distance as |s|^2 - 2 s.t + |t|^2, where the port's search
(B3 on the card, its plain version here) is exact, so 0-1 of 3000
indices differ an iteration; the pose is held within 1e-4, the residual
within 1e-4, the inlier fraction within 1/N, and no index is compared."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import tt

from rslo_tpu.geometry import (np_compose_pose, np_invert_pose,
                               odom_to_abs_pose, quat_to_matrix_np)
from rslo_tpu.pgo import loop_closure as jlc
from rslo_tpu.utils.synthetic import synth_cloud
from rslo_tpu_torch.pgo import loop_closure as plc

T_TOL = 1e-4
Q_TOL = 1e-5


def make_world(seed=3, n=40000, extent=40.0):
    return synth_cloud(np.random.default_rng(seed), n_points=n,
                       extent=extent)


def local_cloud(world, pose, n_keep=3000):
    """Crop the world around a sensor pose and express it locally."""
    rel = world[:, :3] - pose[:3]
    loc = rel @ quat_to_matrix_np(pose[3:])
    idx = np.argsort(np.linalg.norm(loc[:, :2], axis=1))[:n_keep]
    return loc[idx].astype(np.float32)


def yaw_pose_np(yaw, t=(0.0, 0.0, 0.0)):
    return np.array([t[0], t[1], t[2], np.cos(yaw / 2), 0, 0,
                     np.sin(yaw / 2)], np.float32)


@pytest.fixture(scope="module")
def clouds():
    world = make_world()
    psi = 2 * np.pi * 9 / 60
    poses = [yaw_pose_np(0.0), yaw_pose_np(psi, t=(0.6, -0.4, 0.0)),
             yaw_pose_np(0.0, t=(30.0, 20.0, 0.0)),
             yaw_pose_np(0.5, t=(0.8, -0.5, 0.1))]
    return [local_cloud(world, p) for p in poses]


@pytest.mark.parametrize("max_radius", [25.0, 70.0])
def test_polar_descriptor_bit_equal(clouds, max_radius):
    rng = np.random.default_rng(0)
    for c in clouds:
        mask = rng.uniform(size=len(c)) > 0.1
        got = plc.polar_descriptor(tt(c), tt(mask), max_radius=max_radius)
        want = jlc.polar_descriptor(jnp.asarray(c), jnp.asarray(mask),
                                    max_radius=max_radius)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.shape == (20, 60) and float(got.max()) > 0


def test_shift_similarity_matches_jax(clouds):
    mask = np.ones(len(clouds[0]), bool)
    dj = [jlc.polar_descriptor(jnp.asarray(c), jnp.asarray(mask),
                               max_radius=25.0) for c in clouds]
    dp = [plc.polar_descriptor(tt(c), tt(mask), max_radius=25.0)
          for c in clouds]
    want_s, want_h = jlc.shift_similarity(dj[1], jnp.stack([dj[0], dj[2],
                                                            dj[3]]))
    got_s, got_h = plc.shift_similarity(dp[1], torch.stack([dp[0], dp[2],
                                                            dp[3]]))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    assert got_s[0] > 0.9 and int(got_h[0]) == 9     # the revisit, 9 sectors
    np.testing.assert_allclose(
        plc.ring_key(torch.stack(dp)).numpy(),
        np.asarray(jlc.ring_key(jnp.stack(dj))), rtol=0, atol=1e-6)
    shifts = np.arange(60)
    np.testing.assert_array_equal(
        plc.shift_to_yaw(torch.from_numpy(shifts), 60).numpy(),
        np.asarray(jlc.shift_to_yaw(jnp.asarray(shifts), 60)))
    yaws = np.linspace(-3, 3, 13).astype(np.float32)
    np.testing.assert_allclose(plc.yaw_pose(tt(yaws)).numpy(),
                               np.asarray(jlc.yaw_pose(jnp.asarray(yaws))),
                               rtol=0, atol=1e-6)   # cos and sin, an ulp


def test_detect_loops_matches_jax():
    """A seeded descriptor sequence that revisits its start: the pairs
    (after the ring-key prefilter's stable sort) are JAX's."""
    rng = np.random.default_rng(8)
    base = rng.uniform(0, 3, size=(6, 20, 60)).astype(np.float32)
    seq = [base[k % 6] + rng.normal(0, 0.3, (20, 60)).astype(np.float32)
           for k in range(24)]
    seq = np.abs(np.stack([np.roll(d, k, axis=-1)
                           for k, d in enumerate(seq)])).astype(np.float32)
    want = jlc.detect_loops(jnp.asarray(seq), min_separation=5,
                            score_threshold=0.9)
    got = plc.detect_loops(tt(seq), min_separation=5, score_threshold=0.9)
    np.testing.assert_array_equal(got.pairs, want.pairs)
    assert len(got.pairs) >= 10
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.yaws, want.yaws)
    short = plc.detect_loops(torch.zeros(10, 20, 60), min_separation=50)
    assert short.pairs.shape == (0, 2) and short.pairs.dtype == np.int32


def test_icp_align_matches_jax(clouds):
    psi = 0.5
    ci, cj = clouds[3], clouds[0]
    mask = np.ones(len(cj), bool)
    mask[::7] = False
    want = jlc.icp_align(jnp.asarray(ci), jnp.asarray(mask), jnp.asarray(cj),
                         jnp.asarray(mask), jlc.yaw_pose(jnp.asarray(-psi)),
                         iters=10, gate=2.0)
    got = plc.icp_align(tt(ci), tt(mask), tt(cj), tt(mask),
                        plc.yaw_pose(torch.tensor(-psi)), iters=10, gate=2.0)
    pose, res, frac = (x.numpy() for x in got)
    wpose, wres, wfrac = (np.asarray(x) for x in want)
    np.testing.assert_allclose(pose[:3], wpose[:3], rtol=0, atol=T_TOL)
    np.testing.assert_allclose(pose[3:], wpose[3:], rtol=0, atol=T_TOL)
    assert abs(float(res) - float(wres)) <= 1e-4
    assert abs(float(frac) - float(wfrac)) <= 1.0 / mask.sum()
    # and it recovered T_{i<-j}
    expect = np_compose_pose(np_invert_pose(
        yaw_pose_np(psi, t=(0.8, -0.5, 0.1))[None]), yaw_pose_np(0.0)[None])
    np.testing.assert_allclose(pose[:3], expect[0, :3], atol=0.15)


def test_icp_align_searches_once_an_iteration(monkeypatch):
    """Each ICP iteration makes one call of the chamfer search wrapper
    (``ops.chamfer.nn_search``: one B3 launch on a card), with a leading
    pair axis of 1; nothing in the refinement package names the plain
    search, so no CUDA tensor is routed around the kernel."""
    import pathlib
    from rslo_tpu_torch import pgo
    calls = []
    search = plc.nn_search

    def counting(src, *args):
        calls.append(src.shape)
        return search(src, *args)

    monkeypatch.setattr(plc, "nn_search", counting)
    c = tt(make_world(n=4000)[:500, :3])
    m = torch.ones(500, dtype=torch.bool)
    plc.icp_align(c, m, c, m, plc.yaw_pose(torch.tensor(0.1)), iters=6)
    assert calls == [(1, 500, 3)] * 6
    sources = sorted(pathlib.Path(pgo.__path__[0]).glob("*.py"))
    assert len(sources) == 7        # sharded.py since the data-parallel port
    for path in sources:
        assert "nn_search_plain" not in path.read_text(), path


def _loop_trajectory(n_frames, radius=15.0):
    """Closed circular trajectory; the last frame re-visits the first."""
    poses = []
    for k in range(n_frames):
        ang = 2 * np.pi * k / (n_frames - 1)
        poses.append(yaw_pose_np(ang + np.pi / 2,
                                 (radius * np.cos(ang) - radius,
                                  radius * np.sin(ang), 0.0)))
    return np.stack(poses)


def test_close_loops_matches_jax():
    """tests/test_loop_closure.py::test_close_loops_corrects_drift with
    17 poses and clouds of 2000 points."""
    world = make_world(n=60000, extent=45.0)
    gt = _loop_trajectory(17)
    n = len(gt)
    clouds = [local_cloud(world, p, n_keep=2000) for p in gt]
    odoms = np_compose_pose(np_invert_pose(gt[:-1]), gt[1:])
    odoms = np_compose_pose(odoms, np.tile(yaw_pose_np(0.006), (n - 1, 1)))
    kw = dict(min_separation=10, score_threshold=0.85, loop_info=50.0)
    want, wc = jlc.close_loops(odoms, clouds, **kw)
    got, gc = plc.close_loops(odoms, clouds, device="cpu", **kw)
    np.testing.assert_array_equal(gc.pairs, wc.pairs)
    assert len(gc.pairs) >= 1
    np.testing.assert_allclose(gc.scores, wc.scores, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=0, atol=T_TOL)
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=0, atol=T_TOL)
    chain = odom_to_abs_pose(np.concatenate(
        [[[0, 0, 0, 1, 0, 0, 0]], odoms]).astype(np.float32))
    e_chain = np.linalg.norm(chain[-1, :3] - gt[-1, :3])
    e_opt = np.linalg.norm(got[-1, :3] - gt[-1, :3])
    assert e_chain > 0.3 and e_opt < 0.5 * e_chain, (e_chain, e_opt)
