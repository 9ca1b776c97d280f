"""The port's voxel feature encoders (rslo_tpu_torch.models.vfe) against
the JAX package's registry, each on the same point stacks; OdomNet on
point-stack examples (the VFE inside the net) with the cross-normal
VFE, ``normal_gt`` included; and the point-stack path with the mean VFE
against the mean path inside the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (jax_variables, np_, port_cfg, tiny_scans,
                                to_jax, to_port, tt)

from rslo_tpu.config.registry import get as jax_registry
from rslo_tpu.data.prepare import prepare_example as jax_prepare
from rslo_tpu.data.prepare import voxelizer_config as jax_vcfg
from rslo_tpu.eval.streaming import StreamingOdometry as JaxStreaming
from rslo_tpu.models import vfe as _jax_vfe  # noqa: F401  (registers)
from rslo_tpu.models.net import OdomNet as JaxOdomNet
from rslo_tpu.ops.voxelize import VoxelizerConfig as JaxVcfg
from rslo_tpu.ops.voxelize import voxelize as jax_voxelize
from rslo_tpu_torch.convert import load_flax_variables
from rslo_tpu_torch.data.prepare import prepare_example, voxelizer_config
from rslo_tpu_torch.eval.streaming import StreamingOdometry
from rslo_tpu_torch.models.net import OdomNet
from rslo_tpu_torch.models.vfe import VFES
from rslo_tpu_torch.train.step import eval_step

# per-voxel means of <= 10 float32 points: the port adds rank by rank,
# XLA in its own order; a unit-normal division on top
VFE_TOL = dict(rtol=1e-6, atol=1e-6)
# the net in f32: convs differ in summation order only
NET_TOL = dict(rtol=1e-5, atol=1e-5)


def _stacks(seed=0, n=3000):
    """Point stacks of 10-column points (x, y, z, intensity, 3 network
    normals, 3 supervision normals), several points a voxel, some masked
    and some out of range."""
    rng = np.random.default_rng(seed)
    cells = rng.uniform(-3, 3, size=(300, 3)) * [1, 1, 0.2]
    xyz = cells[rng.integers(0, 300, n)] + rng.uniform(0, 0.08, (n, 3))
    xyz[:100] *= 3                                   # out of range
    pts = np.concatenate([xyz, rng.uniform(0, 1, (n, 1)),
                          rng.normal(size=(n, 6))], 1).astype(np.float32)
    cfg = JaxVcfg(point_cloud_range=(-3.2, -3.2, -0.8, 3.2, 3.2, 0.8),
                  voxel_size=(0.1, 0.1, 0.1), max_points=10, max_voxels=512)
    vox = jax_voxelize(jnp.asarray(pts), jnp.asarray(rng.random(n) < 0.9),
                       cfg)
    assert int(np.asarray(vox.num_points).max()) == 10
    assert int(vox.num_voxels) == 512
    return np.array(vox.voxels), np.array(vox.num_points)


@pytest.mark.parametrize("name,n_feat", [
    ("SimpleVoxelXYZINormal", 7), ("SimpleVoxelXYZINormal", 10),
    ("SimpleVoxelXYZNormal", 6), ("SimpleVoxel", 4),
    ("SimpleVoxelXYZINormalNormalGT", 10), ("SimpleVoxelRadius", 4),
    ("SimpleVoxelXYZINormalNormalize", 7),
    ("SimpleVoxelBoundXYZINormal", 7), ("SimpleVoxelBoundXYZINormal", 10)])
def test_vfe_matches_jax(name, n_feat):
    voxels, num = _stacks()
    # an empty slot and a slot whose nearest points tie
    voxels[3], num[3] = 0.0, 0
    voxels[5, 1] = voxels[5, 0]
    want = jax.jit(lambda v, n: jax_registry("vfe", name)(v, n, n_feat))(
        jnp.asarray(voxels), jnp.asarray(num))
    got = VFES[name](tt(voxels), tt(num), n_feat)
    assert set(VFES) == {
        "SimpleVoxelXYZINormal", "SimpleVoxelXYZNormal", "SimpleVoxel",
        "SimpleVoxelXYZINormalNormalGT", "SimpleVoxelRadius",
        "SimpleVoxelXYZINormalNormalize", "SimpleVoxelBoundXYZINormal"}
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want) == 2
    else:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(np_(g), np.asarray(w), **VFE_TOL)
        assert np.isfinite(np_(g)).all()


def _cross_scans(seed, L):
    """tiny_scans with three supervision-normal columns appended."""
    rng = np.random.default_rng(seed)
    return [np.concatenate([s, rng.normal(size=(len(s), 3)).astype(
        np.float32)], 1) for s in tiny_scans(seed, L)]


def test_odomnet_with_the_normal_gt_vfe_matches_jax():
    cfg = port_cfg("f32")
    cfg = cfg.replace(vfe=dataclasses.replace(
        cfg.vfe, name="SimpleVoxelXYZINormalNormalGT",
        num_input_features=10))
    scans = np.stack(_cross_scans(31, 2))
    mask = np.ones(scans.shape[:2], bool)
    jnet = JaxOdomNet(cfg)
    ex = jax_prepare(jnp.asarray(scans), jnp.asarray(mask), jax_vcfg(cfg))
    assert "voxels" in ex and ex["voxels"].shape[-1] == 10
    variables = jax_variables(jnet, 0, ex, train=False)
    ref = jax.jit(lambda v, e: jnet.apply(v, e, train=False))(
        to_jax(variables), ex)

    pcfg = to_port(cfg)
    net = load_flax_variables(OdomNet(pcfg), variables).eval()
    pex = prepare_example(tt(scans), tt(mask), voxelizer_config(pcfg))
    with torch.no_grad():
        out = net(pex)
    for key in ("odometry", "tq_map", "t_conf", "q_conf"):
        np.testing.assert_allclose(np_(out[key]), np_(ref[key]),
                                   err_msg=key, **NET_TOL)
    for key in ("voxel_features", "normal_gt", "voxel_covs"):
        assert len(out[key]) == len(ref[key]) == 2, key
        for t in range(2):
            np.testing.assert_allclose(np_(out[key][t]), np_(ref[key][t]),
                                       err_msg=f"{key}[{t}]", **NET_TOL)
    assert out["voxel_features"][0].shape[1] == 7
    assert float(np.abs(np_(ref["odometry"])[:, :3]).max()) > 1e-2


def test_point_stacks_with_the_mean_vfe_equal_the_mean_path():
    """Inside the port the mean VFE on the stacks rounds exactly as the
    mean path: the same rank-by-rank sums and the same divides."""
    cfg = to_port(port_cfg("f32"))
    scans = np.stack(tiny_scans(32, 2))
    mask = tt(np.ones(scans.shape[:2], bool))
    vcfg = voxelizer_config(cfg)
    stacks = prepare_example(tt(scans), mask, vcfg)
    mean = prepare_example(tt(scans), mask, vcfg, mean_mode=True)
    for t in range(2):
        f = VFES["SimpleVoxelXYZINormal"](stacks["voxels"][t],
                                          stacks["num_points"][t], 7)
        assert torch.equal(f, mean["voxel_features"][t])
    for key in ("num_points", "coords", "voxel_mask"):
        assert torch.equal(stacks[key], mean[key]), key


def test_eval_step_and_stream_with_a_point_stack_vfe_match_jax():
    """A VFE other than the mean one takes the point-stack path in the
    eval step (the net's VFE) and in the stream (which, as JAX's,
    encodes each scan with the mean VFE's function)."""
    cfg = port_cfg("f32")
    cfg = cfg.replace(vfe=dataclasses.replace(
        cfg.vfe, name="SimpleVoxelBoundXYZINormal"))
    scans = tiny_scans(33, 3)
    pts = np.stack(scans[:2])
    mask = np.ones(pts.shape[:2], bool)
    jnet = JaxOdomNet(cfg)
    ex = jax_prepare(jnp.asarray(pts), jnp.asarray(mask), jax_vcfg(cfg))
    variables = jax_variables(jnet, 2, ex, train=False)
    ref = jax.jit(lambda v, e: jnet.apply(v, e, train=False))(
        to_jax(variables), ex)
    pcfg = to_port(cfg)
    net = load_flax_variables(OdomNet(pcfg), variables)
    got = eval_step(net, {"points": pts[None], "point_mask": mask[None]},
                    pcfg, device="cpu")
    np.testing.assert_allclose(np_(got[0]), np_(ref["odometry"]),
                               **NET_TOL)
    jstream = JaxStreaming(jnet, to_jax(variables), cfg)
    stream = StreamingOdometry(net, pcfg, "cpu")
    for scan in scans:
        np.testing.assert_allclose(stream.push(scan), jstream.push(scan),
                                   **NET_TOL)
    assert len(stream.trajectory) == 3
