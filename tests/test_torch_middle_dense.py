"""Port DenseMiddleCov (rslo_tpu_torch.models.middle_dense) against the
JAX package at the grid of tests/test_middle_dense.py (41 x 16 x 16,
channels 4/4/8/8, 128 voxels of which 28 are padding): the BEV, the
covariance parameters, the gradients of a fixed linear loss and the
new running statistics, in train and eval mode, with and without the
encoder's BN.

The JAX module hard-codes a bfloat16 grid.  The exact comparison runs
it in float32 by handing its module a ``jnp`` whose ``bfloat16`` is
float32 (``_F32Jnp``), against the port's ``dtype=torch.float32``; the
shipped bfloat16 is compared too, at bf16 tolerances."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_variables, np_, to_jax, tt

import rslo_tpu.models.middle_dense as jmd
from rslo_tpu.config.schema import MiddleCfg
from rslo_tpu_torch.config.schema import MiddleCfg as PortMiddleCfg
from rslo_tpu_torch.convert import (flax_path, load_flax_variables,
                                    to_flax_leaf)
from rslo_tpu_torch.models import middle_dense as md

SHAPE = (41, 16, 16)
V = 128
# f32: convs and masked sums in other orders; gradients pass through
# the chain twice: GRAD_REL of each leaf's largest entry plus NOISE of
# the largest of all (tests/test_torch_train_step.py's bound).  bf16:
# both sides round every conv and BN output to bf16 (2^-8), at other
# places, through 20 layers (and see ``_limit``).  The bias of a conv that a train-mode BN
# follows has a zero gradient in exact arithmetic: on both sides it is
# the cancelling sum over a level's cells, held below ZERO of the
# largest gradient of all.
TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
       "bf16": dict(rtol=5e-2, atol=5e-2)}
GRAD_REL, NOISE = 1e-4, 1e-6
BF16_GRAD_FLOOR = 2 ** -8
ZERO = {"f32": 1e-5, "bf16": 1e-2}
STAT_TOL = {"f32": dict(rtol=1e-5, atol=1e-6),
            "bf16": dict(rtol=5e-2, atol=5e-3)}


class _F32Jnp:
    """``jax.numpy`` with ``bfloat16`` standing for float32."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def _data():
    rng = np.random.default_rng(0)
    coords = np.stack([rng.integers(0, 40, V), rng.integers(0, 16, V),
                       rng.integers(0, 16, V)], -1).astype(np.int32)
    # unique active voxels; padding rows are -1, as the voxelizer pads
    _, first = np.unique(coords[:100], axis=0, return_index=True)
    vmask = np.zeros(V, bool)
    vmask[np.sort(first)] = True
    coords[~vmask] = -1
    feats = rng.normal(size=(V, 7)).astype(np.float32)
    feats[~vmask] = 0.0
    return feats, coords, vmask


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _jax_run(jmod, variables, args, w_bev, w_cov):
    """JAX's train-mode value_and_grad of the linear loss (outputs,
    gradients, new statistics) and its eval-mode outputs."""
    def loss(params):
        (bev, cov), mut = jmod.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *args, True, mutable=["batch_stats"])
        return jnp.sum(bev * w_bev) + jnp.sum(cov * w_cov), \
            (bev, cov, mut["batch_stats"])
    (val, (bev, cov, stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(to_jax(variables["params"]))
    eval_bev, eval_cov = jax.jit(lambda v: jmod.apply(v, *args, False))(
        to_jax(variables))
    return jax.tree.map(np_, dict(
        loss=val, bev=bev, cov=cov, stats=stats, grads=grads,
        eval_bev=eval_bev, eval_cov=eval_cov))


def _limit(want, base, other):
    """``base``, or in bf16 (``other`` = JAX's f32 result) twice the
    largest distance of JAX's bf16 result from its own f32 one, which
    train-mode statistics set (their f32 sums round to bf16 either way
    of a tie and later BNs amplify that): a port within it rounds no
    worse than JAX does."""
    if other is None:
        return base
    return np.maximum(base, 2 * float(np.abs(want - other).max()))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("bn_type", ["none", "bn"])
def test_dense_middle_matches_jax(bn_type, precision, monkeypatch):
    cfg = MiddleCfg(channels=(4, 4, 8, 8), bn_type=bn_type)
    feats, coords, vmask = _data()
    args = (jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(vmask))
    jmod = jmd.DenseMiddleCov(cfg, SHAPE)
    variables = jax_variables(jmod, 2, *args, train=False)
    rng = np.random.default_rng(1)
    w_bev = rng.normal(size=(2, 2, 16)).astype(np.float32)
    w_cov = rng.normal(size=(V, 7)).astype(np.float32)
    run = (jmod, variables, args, w_bev, w_cov)
    ref = _jax_run(*run) if precision == "bf16" else None
    with monkeypatch.context() as mp:
        mp.setattr(jmd, "jnp", _F32Jnp())
        ref32 = _jax_run(*run)
    if ref is None:
        ref, ref32 = ref32, None

    def other(*path):
        return None if ref32 is None else _get(ref32, path)

    dtype = torch.float32 if precision == "f32" else torch.bfloat16
    pcfg = PortMiddleCfg(channels=(4, 4, 8, 8), bn_type=bn_type)
    mod = load_flax_variables(md.DenseMiddleCov(pcfg, SHAPE, dtype),
                              variables)
    targs = (tt(feats), tt(coords), tt(vmask))
    tol = TOL[precision]

    def close(got, key):
        want = ref[key]
        lim = _limit(want, tol["atol"] + tol["rtol"] * np.abs(want),
                     other(key))
        err = np.abs(np_(got) - want)
        assert (err <= lim).all(), (key, float(err.max()))

    with torch.no_grad():
        bev, cov = mod.eval()(*targs)
    assert bev.shape == (2, 2, 16) and cov.shape == (V, 7)
    close(bev, "eval_bev")
    close(cov, "eval_cov")
    assert not cov[~tt(vmask)].any()

    bev, cov = mod.train()(*targs)
    loss = (bev * tt(w_bev)).sum() + (cov * tt(w_cov)).sum()
    loss.backward()
    close(bev, "bev")
    close(cov, "cov")
    close(loss.detach(), "loss")
    top = max(float(np.abs(g).max()) for _, g in _flat(ref["grads"]))
    layers = [n for n, m in mod.named_children()]
    bn_fed = {f"{a}.bias" for a, b in zip(layers, layers[1:])
              if b.startswith("DenseMaskedBN")}
    assert len(bn_fed) == 5 + 14 * (bn_type != "none")
    seen = set()
    sq = np.zeros(3)       # |port - jax f32|^2, |jax - jax f32|^2, |f32|^2
    for name, p in mod.named_parameters():
        col, path = flax_path(name, p.dim())
        assert col == "params"
        seen.add(path)
        want = _get(ref["grads"], path)
        got = to_flax_leaf(name, p.grad)
        if name in bn_fed:
            for g in (got, want):
                assert float(np.abs(g).max()) <= ZERO[precision] * top, name
            continue
        if ref32 is not None:
            exact = other("grads", *path)
            sq += [np.sum((got - exact) ** 2), np.sum((want - exact) ** 2),
                   np.sum(exact ** 2)]
            continue
        err = float(np.abs(got - want).max())
        assert err <= GRAD_REL * float(np.abs(want).max()) + NOISE * top, \
            (name, err)
    if ref32 is not None:
        # bf16 gradients carry the rounding of every layer twice: each
        # side is held by its distance from JAX's f32 gradients, the
        # port's no more than twice JAX's (relative L2 over all leaves)
        e_port, e_jax = np.sqrt(sq[:2] / sq[2])
        assert e_port <= 2 * e_jax + BF16_GRAD_FLOOR, (e_port, e_jax)
    assert seen == {p for p, _ in _flat(ref["grads"])}
    n_stats = 0
    for name, b in mod.named_buffers():
        col, path = flax_path(name, b.dim())
        assert col == "batch_stats"
        want = _get(ref["stats"], path)
        st = STAT_TOL[precision]
        lim = _limit(want, st["atol"] + st["rtol"] * np.abs(want),
                     other("stats", *path))
        err = np.abs(np_(b) - want)
        assert (err <= lim).all(), (name, float(err.max()))
        n_stats += 1
    assert n_stats == len(list(_flat(ref["stats"]))) == \
        2 * (5 + 14 * (bn_type != "none"))


def test_masked_bn_backward_matches_autograd():
    """The train-mode masked BN (checkpointed, so its backward
    recomputes the formula) against autograd through the plain formula,
    in float64, on a grid with inactive cells and a constant channel
    (variance 0); the running statistics move by the batch's."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(1.0, 2.0, (1, 3, 4, 5, 6)))
    occ = torch.tensor((rng.random((1, 1, 4, 5, 6)) < 0.6).astype(float))
    x = x * occ
    x[:, 2] = 0.7 * occ[:, 0]
    scale = torch.tensor(rng.normal(1, 0.2, 3))
    bias = torch.tensor(rng.normal(0, 0.2, 3))
    gy = torch.tensor(rng.normal(size=x.shape))

    def plain(x, scale, bias):
        dims, v = (0, 2, 3, 4), (1, -1, 1, 1, 1)
        n = torch.sum(occ) + 1e-6
        mean = torch.sum(x * occ, dims) / n
        var = torch.clamp(torch.sum(x * x * occ, dims) / n - mean * mean,
                          min=0.0)
        y = (x - mean.view(v)) * torch.rsqrt(var.view(v) + 1e-3)
        return (y * scale.view(v) + bias.view(v)) * occ, mean, var

    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    want_y, mean, var = plain(*leaves)
    want = torch.autograd.grad(want_y, leaves, gy)
    bn = md.DenseMaskedBN(3).double().train()
    with torch.no_grad():
        bn.scale.copy_(scale)
        bn.bias.copy_(bias)
    xl = x.clone().requires_grad_()
    y = bn(xl, occ)
    np.testing.assert_allclose(y.detach().numpy(),
                               want_y.detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(bn.mean.numpy(),
                               0.01 * mean.detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(bn.var.numpy(),
                               0.99 + 0.01 * var.detach().numpy(),
                               rtol=1e-12)
    got = torch.autograd.grad(y, (xl, bn.scale, bn.bias), gy)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-9,
                                   atol=1e-12)


def test_masked_bn_backward_keeps_only_its_input():
    """What the checkpoint is for: autograd through the plain formula
    keeps f32 copies of the whole grid for the backward; the train-mode
    masked BN keeps no more than its bf16 input and per-channel vectors
    (the occupancy is shared with the convs)."""
    rng = np.random.default_rng(5)
    occ = torch.tensor((rng.random((1, 1, 6, 8, 8)) < 0.5)
                       .astype(np.float32))
    x = (torch.tensor(rng.normal(size=(1, 16, 6, 8, 8))) * occ).to(
        torch.bfloat16).requires_grad_()
    grid = x.numel()

    def saved_bytes(fn):
        kept = []

        def pack(t):
            if t.data_ptr() != occ.data_ptr():
                kept.append(t.numel() * t.element_size())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn()
        return sum(kept)

    bn = md.DenseMaskedBN(16).train()
    ours = saved_bytes(lambda: bn(x, occ))

    def plain():
        xf = x.float()
        n = torch.sum(occ) + 1e-6
        mean = torch.sum(xf * occ, (0, 2, 3, 4)) / n
        var = torch.sum(xf * xf * occ, (0, 2, 3, 4)) / n - mean * mean
        v = (1, -1, 1, 1, 1)
        y = (xf - mean.view(v)) * torch.rsqrt(var.view(v) + 1e-3)
        return ((y * bn.scale.view(v) + bn.bias.view(v)) * occ).to(x.dtype)
    assert ours <= 2 * grid + 1024
    assert saved_bytes(plain) >= 3 * 4 * grid


def test_transposed_conv_padding_follows_jax():
    """The JAX transposed conv's explicit (k-1-p, k-1-p + extra)
    padding as torch's output_padding, at even and odd fine sizes."""
    rng = np.random.default_rng(3)
    for fine in ((5, 8, 10), (6, 7, 9)):
        coarse = tuple((s + 2 - 3) // 2 + 1 for s in fine)
        x = rng.normal(size=(1,) + coarse + (3,)).astype(np.float32)
        occ = (rng.random((1,) + fine + (1,)) < 0.5).astype(np.float32)
        jmod = jmd.DenseConvTranspose(4, out_shape=fine)
        variables = jax_variables(jmod, 4, jnp.asarray(x), jnp.asarray(occ))
        ref = jmod.apply(to_jax(variables), jnp.asarray(x), jnp.asarray(occ))
        mod = load_flax_variables(md.DenseConvTranspose(3, 4), variables)
        out = mod(tt(x).permute(0, 4, 1, 2, 3),
                  tt(occ).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        np.testing.assert_allclose(np_(out), np_(ref), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="output padding"):
        mod.output_padding((3, 3, 3), (9, 9, 9))


def test_odomnet_still_refuses_dense_middle():
    """No JAX entry point builds DenseMiddleCov, and neither does the
    port's OdomNet."""
    from torch_port_helpers import port_cfg, to_port
    from rslo_tpu_torch.models.net import OdomNet
    cfg = port_cfg("f32")
    cfg = cfg.replace(middle=dataclasses.replace(cfg.middle,
                                                 name="DenseMiddleCov"))
    with pytest.raises(NotImplementedError, match="DenseMiddleCov"):
        OdomNet(to_port(cfg))


def test_convert_round_trips_the_new_leaves():
    """Every tensor of a dense middle and of a BEV net with every option
    goes to its flax collection, path and layout and back unchanged:
    5-D conv weights are ``params`` ``kernel`` leaves (weight-decayed),
    the eight semi-global statistics are ``batch_stats``."""
    from rslo_tpu_torch.convert import is_flax_kernel, state_dict_from_flax
    from rslo_tpu_torch.models.bev_net import BEVOdomNet
    from torch_port_helpers import port_cfg, to_port
    from test_torch_bev_options import VARIANTS
    cfg = to_port(port_cfg("f32"))
    gen = torch.Generator().manual_seed(0)
    mods = [md.DenseMiddleCov(PortMiddleCfg(channels=(4, 4, 8, 8),
                                            bn_type="bn"), SHAPE)]
    for v in ("variant_a", "fc", "fire", "bottleneck"):
        mods.append(BEVOdomNet(dataclasses.replace(cfg.odom, **VARIANTS[v]),
                               cfg.voxelizer.point_cloud_range))
    for mod in mods:
        sd = {k: torch.rand(t.shape, generator=gen)
              for k, t in mod.state_dict().items()}
        tree = {}
        for name, t in sd.items():
            col, path = flax_path(name, t.dim())
            node = tree.setdefault(col, {})
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = to_flax_leaf(name, t)
            if t.dim() == 5:
                assert col == "params" and path[-1] == "kernel", name
                assert is_flax_kernel(name, 5)
                assert node[path[-1]].shape == t.shape[2:] + t.shape[1::-1]
            if ".SemiGlobalSyncBN_0." in name and \
                    path[-1] not in ("scale", "bias"):
                assert col == "batch_stats", name
        back = state_dict_from_flax(tree)
        assert set(back) == set(sd)
        for k in sd:
            assert torch.equal(back[k], sd[k]), k
        load_flax_variables(mod, tree)
