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
