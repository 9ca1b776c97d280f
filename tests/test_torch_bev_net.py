"""Port BEVOdomNet (rslo_tpu_torch.models.bev_net) against the JAX
package on the same pair input and weights: odometry, tq map,
confidences, pyramid and input mask."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (jax_variables, np_, port_cfg, to_jax,
                                to_port, tt)

from rslo_tpu.models.bev_net import BEVOdomNet as JaxBEV
from rslo_tpu_torch.convert import load_flax_variables
from rslo_tpu_torch.models.bev_net import BEVOdomNet

# f32: convs differ in summation order only.  bf16: both sides round
# conv outputs to bf16 (2^-8 relative), at other places (torch may add
# the bias before rounding), through ~20 conv layers.
TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
       "bf16": dict(rtol=5e-2, atol=5e-2)}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_bev_net_matches_jax(precision):
    cfg = port_cfg(precision)
    pc_range = cfg.voxelizer.point_cloud_range
    rng = np.random.default_rng(11)
    # two pairs of a 24 x 40 BEV: odd sizes (3 x 5) at the bottom level
    # take the symmetric SAME padding, even ones the (0, 1) padding
    x = rng.normal(size=(2, 24, 40, 2 * cfg.odom.num_input_features))
    x[:, rng.random((24, 40)) < 0.4] = 0.0      # empty cells
    x = x.astype(np.float32)
    jmod = JaxBEV(cfg.odom, pc_range)
    variables = jax_variables(jmod, 1, jnp.asarray(x), train=False)
    ref = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(
        to_jax(variables), jnp.asarray(x))

    mod = load_flax_variables(BEVOdomNet(to_port(cfg).odom, pc_range),
                              variables)
    with torch.no_grad():
        out = mod.eval()(tt(x))
    tol = TOL[precision]
    for key in ("odometry", "tq_map", "t_conf", "q_conf", "input_mask"):
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(np_(out[key]), np_(ref[key]),
                                   err_msg=key, **tol)
    assert len(out["pyramid"]) == len(ref["pyramid"]) == 3
    for i, ((a, am), (b, bm)) in enumerate(zip(out["pyramid"],
                                               ref["pyramid"])):
        np.testing.assert_allclose(np_(a), np_(b), err_msg=f"map {i}",
                                   **tol)
        np.testing.assert_allclose(np_(am), np_(bm), err_msg=f"mask {i}",
                                   **tol)
    # the vote is a real function of the input, not the identity bias
    assert float(np.abs(np_(ref["odometry"])[:, :3]).max()) > 1e-2


def test_tq_heads_start_at_the_identity_pose():
    """Torch twin of the tq heads' identity-bias landmine (JAX's
    ``identity_pose_bias``): at init every 7-channel tq head's bias is
    [0,0,0, 1,0,0,0] in both packages, the same heads on both sides; on
    an all-empty input the vote's quaternion is finite and non-zero and
    its gradient finite (a zero bias would normalize q = 0)."""
    from rslo_tpu_torch.models.net import OdomNet
    cfg = port_cfg("f32")
    pc_range = cfg.voxelizer.point_cloud_range
    x = np.zeros((2, 16, 16, 2 * cfg.odom.num_input_features), np.float32)
    jmod = JaxBEV(cfg.odom, pc_range)
    variables = jax.jit(lambda k, a: jmod.init(k, a, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    params = variables["params"]
    jax_heads = sorted(k for k, v in params.items()
                       if "bias" in v and v["bias"].shape == (7,))
    identity = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
    assert len(jax_heads) >= 3
    for k in jax_heads:
        np.testing.assert_array_equal(np.asarray(params[k]["bias"]),
                                      identity, k)
    net = OdomNet(to_port(cfg), torch.Generator().manual_seed(0))
    port_heads = sorted(n for n, m in net.bev_net.named_children()
                        if isinstance(m, torch.nn.Conv2d) and
                        m.out_channels == 7)
    assert port_heads == jax_heads
    for k in port_heads:
        np.testing.assert_array_equal(
            np_(getattr(net.bev_net, k).bias), identity, k)

    def jax_q(p):
        return jmod.apply({"params": p,
                           "batch_stats": variables["batch_stats"]},
                          jnp.asarray(x), train=False)["odometry"][:, 3:]
    jq = np.asarray(jax.jit(jax_q)(params))
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jax_q(p))))(params)
    assert all(np.isfinite(np.asarray(g)).all()
               for g in jax.tree.leaves(jg))
    out = net.bev_net.eval()(tt(x))
    q = out["odometry"][:, 3:]
    q.sum().backward()
    for qq in (np_(q), jq):
        assert np.isfinite(qq).all()
        assert (np.linalg.norm(qq, axis=1) > 0.5).all()
    for name, p in net.bev_net.named_parameters():
        assert p.grad is None or torch.isfinite(p.grad).all(), name
