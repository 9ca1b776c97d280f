"""Port OdomNet and StreamingOdometry (rslo_tpu_torch.models.net,
eval.streaming) against the JAX package: the two-frame forward, the
streaming poses over 3 scans, and streaming == two-frame inside the
port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (jax_variables, np_, port_cfg, tiny_scans,
                                to_jax, to_port, tt)

from rslo_tpu.data.prepare import prepare_example as jax_prepare
from rslo_tpu.data.prepare import voxelizer_config as jax_vcfg
from rslo_tpu.eval.streaming import StreamingOdometry as JaxStreaming
from rslo_tpu.models.net import OdomNet as JaxOdomNet
from rslo_tpu_torch.convert import load_flax_variables
from rslo_tpu_torch.data.prepare import prepare_example, voxelizer_config
from rslo_tpu_torch.eval.streaming import StreamingOdometry
from rslo_tpu_torch.models.net import OdomNet

# as in test_torch_middle / test_torch_bev_net: f32 differs in sum order
# only; bf16 rounds at other places through the whole slice
TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
       "bf16": dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture(scope="module", params=["f32", "bf16"])
def setup(request):
    """(cfg, 3 scans, JAX net, its 2-scan example, variables, port net)."""
    precision = request.param
    cfg = port_cfg(precision)
    scans = tiny_scans(21, 3)
    jnet = JaxOdomNet(cfg)
    ex = jax_prepare(jnp.asarray(np.stack(scans[:2])),
                     jnp.ones((2, len(scans[0])), bool), jax_vcfg(cfg),
                     mean_mode=True)
    variables = jax_variables(jnet, 0, ex, train=False)
    net = load_flax_variables(OdomNet(to_port(cfg)), variables).eval()
    return precision, cfg, scans, jnet, ex, variables, net


def _port_forward(net, cfg, scans):
    ex = prepare_example(tt(np.stack(scans)),
                         torch.ones(len(scans), len(scans[0]),
                                    dtype=torch.bool),
                         voxelizer_config(to_port(cfg)), mean_mode=True)
    with torch.no_grad():
        return net(ex)


def test_two_frame_forward_matches_jax(setup):
    precision, cfg, scans, jnet, ex, variables, net = setup
    ref = jax.jit(lambda v, e: jnet.apply(v, e, train=False))(
        to_jax(variables), ex)
    out = _port_forward(net, cfg, scans[:2])
    tol = TOL[precision]
    for key in ("odometry", "tq_map", "t_conf", "q_conf"):
        np.testing.assert_allclose(np_(out[key]), np_(ref[key]),
                                   err_msg=key, **tol)
    for t in range(2):
        np.testing.assert_allclose(np_(out["voxel_covs"][t]),
                                   np_(ref["voxel_covs"][t]), **tol)
    assert float(np.abs(np_(ref["odometry"])[:, :3]).max()) > 1e-2


def test_streaming_matches_jax_and_two_frame(setup):
    precision, cfg, scans, jnet, _, variables, net = setup
    jstream = JaxStreaming(jnet, to_jax(variables), cfg)
    stream = StreamingOdometry(net, to_port(cfg), "cpu")
    for scan in scans:
        ref = jstream.push(scan)
        pose = stream.push(scan)
        np.testing.assert_allclose(pose, ref, **TOL[precision])
    assert len(stream.trajectory) == 3

    # inside the port, streaming's first pose is the two-frame forward's
    # vote on the same scans: the same ops in the same order
    two = np_(_port_forward(net, cfg, scans[:2])["odometry"])[0]
    np.testing.assert_allclose(stream.trajectory[1], two,
                               rtol=1e-6, atol=1e-6)
