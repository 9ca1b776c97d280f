"""Cross-rank BatchNorm of the PyTorch port (utils/mesh_axis.py and the
sync BNs that use it) against the JAX package under ``shard_map`` on two
of the eight virtual CPU devices.

Two gloo ranks on the CPU (tests/torch_dist_workers.py) each run one
train-mode forward and backward of the same module with the "data" axis
bound, on inputs of their own: the BEV net's ``Norm`` ("sync_bn": the
mean of the ranks' moments), the semi-global BN (the same mean, in its
running-statistics update), the sparse middle's ``MaskedBatchNorm`` and
the dense middle's ``DenseMaskedBN`` (with ``sync``: the sum of the
ranks' n, sum(x) and sum(x^2), where the two ranks hold different
numbers of valid rows).  L = sum(y * cot) on each rank; each rank's
output, running statistics and gradients (input and parameters) are
held against JAX device r's, whose gradients flow through the
transpose of its ``psum`` (``check_vma=False``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from torch_dist_workers import run_ranks
from torch_port_helpers import jax_variables

from rslo_tpu.models.bev_net import Norm as JaxNorm
from rslo_tpu.models.middle import MaskedBatchNorm as JaxMaskedBN
from rslo_tpu.models.middle_dense import DenseMaskedBN as JaxDenseBN
from rslo_tpu.models.semiglobal_bn import SemiGlobalSyncBN as JaxSemiGlobal
from rslo_tpu_torch.convert import state_dict_from_flax
from rslo_tpu_torch.utils import mesh_axis

D = 2
C = 8
# f32 on both sides; the moments' sums run in other orders, so every
# output, statistic and gradient agrees to a few ulps of its array's
# largest entry (observed <= 3.1e-7 of it)
TOL = 2e-6


def _cases(rng):
    """(JAX module, its argument shapes) and the port's constructor, by
    case; every rank's input, mask and cotangent."""
    nhwc = (2, 6, 5, C)
    cases = {}
    for name, jmod, kind, kw, shape, perm in (
            ("norm", JaxNorm(bn_type="sync_bn"), "norm",
             dict(num_features=C, bn_type="sync_bn"), nhwc, (0, 3, 1, 2)),
            ("semiglobal", JaxSemiGlobal(), "semiglobal",
             dict(num_features=C), nhwc, (0, 3, 1, 2)),
            ("masked", JaxMaskedBN(sync=True), "masked",
             dict(num_features=C, sync=True), (50, C), (0, 1)),
            ("dense", JaxDenseBN(sync=True), "dense",
             dict(num_features=C, sync=True), (1, 3, 4, 5, C),
             (0, 4, 1, 2, 3))):
        x = rng.normal(0.5, 2.0, (D,) + shape).astype(np.float32)
        cot = rng.normal(0, 1, (D,) + shape).astype(np.float32)
        if kind == "masked":
            # unequal valid rows: 37 on rank 0, 21 on rank 1
            mask = np.zeros((D, shape[0]), bool)
            mask[0, rng.permutation(shape[0])[:37]] = True
            mask[1, rng.permutation(shape[0])[:21]] = True
            jmask, pmask = mask, mask
        elif kind == "dense":
            occ = (rng.uniform(size=(D, 1) + shape[1:4] + (1,)) <
                   np.array([0.7, 0.3])[:, None, None, None, None, None]
                   ).astype(np.float32)
            jmask, pmask = occ, occ[..., 0][:, :, None]
        else:
            jmask = pmask = None
        cases[name] = (jmod, kind, kw, x, jmask, pmask, cot, perm)
    return cases


def _jax_side(jmod, x, mask, cot):
    """Device r's output, statistics and gradients under shard_map."""
    args0 = (jnp.asarray(x[0]),) + (() if mask is None else
                                    (jnp.asarray(mask[0]),))
    variables = jax_variables(jmod, 0, *args0, train=False)
    mesh = Mesh(np.array(jax.devices()[:D]), ("data",))
    has_mask = mask is not None

    def dev(params, stats, x, mask, cot):
        args = (mask[0],) if has_mask else ()

        def loss(params, x):
            y, mut = jmod.apply({"params": params, "batch_stats": stats},
                                x, *args, train=True,
                                mutable=["batch_stats"])
            return jnp.sum(y * cot[0]), (y, mut["batch_stats"])

        (_, (y, st)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, x[0])
        return jax.tree.map(lambda a: a[None], (y, st, gx, gp))

    fn = jax.jit(jax.shard_map(
        dev, mesh=mesh, in_specs=(P(), P(), P("data"), P("data"),
                                  P("data")),
        out_specs=P("data"), check_vma=False))
    m = mask if has_mask else np.zeros((D, 1), np.float32)
    y, st, gx, gp = jax.tree.map(np.asarray, fn(
        variables["params"], variables["batch_stats"], jnp.asarray(x),
        jnp.asarray(m), jnp.asarray(cot)))
    return variables, y, st, gx, gp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(12)
    want, cases = {}, {}
    for name, (jmod, kind, kw, x, jmask, pmask, cot, perm) in \
            _cases(rng).items():
        variables, y, st, gx, gp = _jax_side(jmod, x, jmask, cot)
        want[name] = (y, st, gx, gp, perm)
        px = np.ascontiguousarray(np.stack([a.transpose(perm) for a in x]))
        pc = np.ascontiguousarray(np.stack([a.transpose(perm)
                                            for a in cot]))
        cases[name] = (kind, kw, state_dict_from_flax(variables), px, pmask,
                       pc)
    got = run_ranks("sync_bn", tmp_path_factory.mktemp("sync_bn"),
                    cases=cases)
    return want, got


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("name", ["norm", "semiglobal", "masked", "dense"])
def test_sync_bn_matches_jax_on_two_ranks(runs, name):
    want, got = runs
    y, st, gx, gp, perm = want[name]
    inv = tuple(np.argsort(perm))
    for r in range(D):
        out = got[r][name]
        _close(out["y"].transpose(inv), y[r], f"{name} rank {r} output")
        for k, v in st.items():
            _close(out["stats"][k], v[r], f"{name} rank {r} stats {k}")
        _close(out["dx"].transpose(inv), gx[r], f"{name} rank {r} dx")
        for k, v in gp.items():
            _close(out["dp"][k], v[r], f"{name} rank {r} d{k}")
    # the statistics came from both ranks: the same on each
    for k in st:
        np.testing.assert_array_equal(got[0][name]["stats"][k],
                                      got[1][name]["stats"][k])


def test_psum_gradient_is_the_all_reduced_cotangent(tmp_path):
    """L = sum(pmean(x * x)) over ranks holding [1, 2] and [2, 2]: the
    gradients are [2, 4] and [4, 4] (JAX's under shard_map), not each
    rank's own share."""
    x = np.array([[1.0, 2.0], [2.0, 2.0]], np.float32)
    for r, (loss, grad) in enumerate(run_ranks("psum_grad", tmp_path,
                                               x=x)):
        assert float(loss) == 6.5
        np.testing.assert_array_equal(grad, [[2.0, 4.0], [4.0, 4.0]][r])


def test_axis_binding_outside_a_step():
    """Outside ``bind_axis`` no reduction happens; a name that is not a
    mesh axis raises, inside or outside."""
    import torch
    assert not mesh_axis.axis_present("data")
    t = torch.arange(3.0)
    assert mesh_axis.pmean_if_present(t, "data") is t
    assert mesh_axis.psum_if_present(t, "data") is t
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh_axis.axis_present("bogus")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh_axis.pmean_if_present(t, "date")
