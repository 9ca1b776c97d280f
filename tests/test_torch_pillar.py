"""Port PillarMiddleCov (rslo_tpu_torch.models.middle_pillar) and the
pillar OdomNet against the JAX package on the same seeded inputs and
weights (carried by ``convert.py``, strict): the pillar image bit for
bit, the z one-hot, the middle's BEV and covariances, the two-frame
forward, the weight-decay and ``group_lr_mult`` masks, the dense
layers' init, and one train step's loss terms and gradients.

The pillar convs compute in bfloat16 on both sides (the JAX module
hard-codes it), rounding at other places: XLA's CPU convs keep other
intermediate precisions than torch's, so single entries land a few
bf16 ulps apart after 10 layers.  Floats are held to the tolerance the
bf16 tests of the sparse middle and the BEV net use."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from torch_port_helpers import (jax_variables, np_, port_cfg, tiny_scans,
                                to_jax, to_port, tt)
from test_torch_train_step import pallas_nn_search

import rslo_tpu.losses.consistency as jax_consistency
import rslo_tpu.models.middle_pillar as jax_pillar_mod
from rslo_tpu.config.schema import grid_size
from rslo_tpu.data.prepare import prepare_example as jax_prepare
from rslo_tpu.data.prepare import voxelizer_config as jax_vcfg
from rslo_tpu.losses.objective import compute_objective as jax_objective
from rslo_tpu.models.middle_pillar import PillarMiddleCov as JaxPillar
from rslo_tpu.models.net import OdomNet as JaxOdomNet
from rslo_tpu.train import optim as jax_optim
from rslo_tpu_torch.config.schema import MiddleCfg
from rslo_tpu_torch.convert import (flax_path, load_flax_variables,
                                    state_dict_from_flax, to_flax_leaf)
from rslo_tpu_torch.models.middle_pillar import (Conv2dBNRelu,
                                                 PillarMiddleCov,
                                                 same_conv2d, z_onehot)
from rslo_tpu_torch.parallel.spatial import pad_same, same_pad
from rslo_tpu_torch.models.net import OdomNet
from rslo_tpu_torch.train import optim
from rslo_tpu_torch.train.loop import make_optimizer
from rslo_tpu_torch.train.state import TrainState
from rslo_tpu_torch.train.step import loss_and_grads

BF16_TOL = dict(rtol=5e-2, atol=5e-2)
# the train step: loss terms through the bf16 middle agree to ~1e-5
# relative (observed); held to 1e-3.  Gradients pass the bf16 convs'
# backward, so each leaf's relative L2 error is held to GRAD_FACTOR
# times the port's own sensitivity (the relative L2 change of that
# leaf's gradient when every weight is scaled by 1 + 2^-10 * N(0, 1),
# which flips the bf16 rounding of some weights) plus GRAD_ABS; the
# error reached 0.6 of that sensitivity at most (observed, middle
# biases), BEV leaves ~1e-3 of it.  A wrong gradient is off by O(1).
STEP_LOSS_TOL = dict(rtol=1e-3, atol=1e-4)
GRAD_JITTER, GRAD_FACTOR, GRAD_ABS = 2.0 ** -10, 2.0, 1e-3


def pillar_cfg(precision="f32", middle_bn="none", z_voxel=None):
    """The tiny test config with the pillar middle; ``z_voxel`` sets
    the z voxel size (0.16 m gives 10 z bins, whose bands 8 and 9 have
    no one-hot class)."""
    cfg = port_cfg(precision, middle_bn=middle_bn)
    vox = cfg.voxelizer
    if z_voxel is not None:
        vs = tuple(vox.voxel_size[:2]) + (z_voxel,)
        vox = dataclasses.replace(vox, voxel_size=vs)
    return cfg.replace(voxelizer=vox, middle=dataclasses.replace(
        cfg.middle, name="PillarMiddleCov"))


def _sparse_shape(cfg):
    nx, ny, nz = grid_size(cfg.voxelizer)
    return (nz + 1, ny, nx)


def _frames(cfg, L, seed=3, n=4000):
    scans = tiny_scans(seed, L, n)
    ex = jax_prepare(jnp.asarray(np.stack(scans)),
                     jnp.ones((L, len(scans[0])), bool), jax_vcfg(cfg),
                     mean_mode=True)
    return scans, ex


class _RecordConcat:
    """Stands in for ``jnp`` inside the JAX pillar module and records
    the parts of its first ``concatenate``: the float32 pillar image's
    [occupancy, mean feature, mean z, count * 0.1]."""

    def __init__(self, parts):
        self.parts = parts

    def __getattr__(self, name):
        if name != "concatenate":
            return getattr(jnp, name)

        def concatenate(xs, axis=0):
            if not self.parts:
                self.parts.extend(xs)
            return jnp.concatenate(xs, axis=axis)
        return concatenate


@pytest.fixture(scope="module", params=[None, 0.16],
                ids=["zbins40", "zbins10"])
def middle_case(request):
    """One frame through the JAX middle (jitted, bf16 as shipped): its
    outputs and its recorded pillar image parts."""
    cfg = pillar_cfg(z_voxel=request.param)
    _, ex = _frames(cfg, 1, n=1200)     # some voxel rows are padding
    f, c, m = ex["voxel_features"][0], ex["coords"][0], ex["voxel_mask"][0]
    jmod = JaxPillar(cfg.middle, _sparse_shape(cfg))
    variables = jax_variables(jmod, 0, f, c, m, False)
    parts = []

    def run(v, *a):
        parts.clear()
        out = jmod.apply(v, *a, False)
        return out, list(parts)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pillar_mod, "jnp", _RecordConcat(parts))
        (bev, cov), image = jax.jit(run)(to_jax(variables), f, c, m)
    mod = load_flax_variables(PillarMiddleCov(to_port(cfg).middle,
                                              _sparse_shape(cfg)), variables)
    return dict(cfg=cfg, inputs=(f, c, m), bev=bev, cov=cov,
                image=[np.asarray(p) for p in image], mod=mod)


def test_pillar_image_bit_equal(middle_case):
    f, c, m = middle_case["inputs"]
    img = middle_case["mod"].pillar_image(tt(f), tt(c), tt(m)).numpy()
    occ, feat_mean, zmean, cnt = middle_case["image"]
    zbins = _sparse_shape(middle_case["cfg"])[0] - 1
    assert occ.shape[-1] == zbins and img.shape[-1] == zbins + 7 + 2
    n_feat = feat_mean.shape[-1]
    for name, got, want in (
            ("occupancy", img[..., :zbins], occ),
            ("feat_mean", img[..., zbins:zbins + n_feat], feat_mean),
            ("zmean", img[..., zbins + n_feat:-1], zmean),
            ("count", img[..., -1:], cnt)):
        np.testing.assert_array_equal(got, want, err_msg=name)
    # pillars hold several voxels, and the invalid voxels' spare row is
    # dropped: the count is the number of valid voxels
    assert cnt.max() >= 0.2 and np.isclose(cnt.sum() * 10,
                                            float(np.sum(m)), rtol=1e-5)


def test_z_onehot_matches_jax():
    """Bands >= 8 (zbins not a multiple of 8) give zero rows, as
    jax.nn.one_hot does."""
    for zbins in (10, 12, 40, 7, 17):
        pz = np.arange(zbins, dtype=np.int32)
        want = jax.nn.one_hot(jnp.asarray(pz) // max(zbins // 8, 1), 8)
        got = z_onehot(tt(pz), zbins)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(z_onehot(tt(np.array([8, 9])), 10).sum()) == 0.0


def test_pillar_middle_matches_jax(middle_case):
    """BEV (ny/8, nx/8, 2 c3) and covariances (V, 7), bf16 convs; with
    the decoder skipped the BEV is bit-equal and no cov comes back."""
    f, c, m = (tt(x) for x in middle_case["inputs"])
    mod = middle_case["mod"]
    with torch.no_grad():
        bev, cov = mod(f, c, m)
        bev_only, none = mod(f, c, m, with_cov=False)
    want_bev, want_cov = middle_case["bev"], middle_case["cov"]
    assert bev.dtype == cov.dtype == torch.float32
    assert bev.shape == want_bev.shape == (16, 16, 32)
    assert cov.shape == want_cov.shape
    np.testing.assert_allclose(np_(bev), np_(want_bev), **BF16_TOL)
    np.testing.assert_allclose(np_(cov), np_(want_cov), **BF16_TOL)
    assert none is None and torch.equal(bev_only, bev)
    valid = np.asarray(middle_case["inputs"][2])
    assert (np_(cov)[valid][:, :3] > 0).all()
    assert (np_(cov)[~valid] == 0).all() and (~valid).any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(12, 16), (12, 15), (11, 16), (11, 15)],
                         ids=["even", "even_odd", "odd_even", "odd"])
def test_same_padding_inside_the_conv(hw, stride, dtype):
    """The pads folded into the conv (``same_conv2d``, and through it
    ``Conv2dBNRelu``) against ``pad_same`` then an unpadded conv, both
    on one channels_last map (the CPU's NCHW and NHWC convs sum in
    other orders): bit for bit where the pads are symmetric, within
    1e-6 where the zero first tap of a (0, 1) pad may reorder the sum,
    in float32; ``BF16_TOL`` for the bfloat16 module."""
    g = torch.Generator().manual_seed(sum(hw) + stride)
    x = torch.randn((1, 6) + hw, generator=g).contiguous(
        memory_format=torch.channels_last)
    conv = Conv2dBNRelu(6, 5, stride)
    with torch.no_grad():
        conv.Conv_0.bias.normal_(generator=g)
    w, b = conv.Conv_0.weight.detach(), conv.Conv_0.bias.detach()
    if dtype == "f32":
        got = same_conv2d(x, w, stride)
        want = F.conv2d(pad_same(x, 3, stride), w, None, stride)
        assert got.shape == want.shape
        symmetric = all(len(set(same_pad(n, 3, stride))) == 1 for n in hw)
        if symmetric:
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-6)
        return
    xb = x.to(torch.bfloat16)
    with torch.no_grad():
        got = conv(xb)
    want = F.relu(F.conv2d(pad_same(xb, 3, stride),
                           w.to(torch.bfloat16), None, stride)
                  + b.to(torch.bfloat16).view(1, -1, 1, 1))
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **BF16_TOL)


class _RecordLayouts(TorchFunctionMode):
    """Records each ``F.conv2d``'s input map and stride and each
    ``F.pad``'s input."""

    def __init__(self):
        super().__init__()
        self.conv_inputs, self.pad_inputs = [], []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is F.conv2d:
            self.conv_inputs.append((args[0], args[3]))
        elif func is F.pad:
            self.pad_inputs.append(args[0])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("grid,with_cov", [((64, 48), True),
                                           ((64, 48), False),
                                           ((45, 27), False)],
                         ids=["even", "even_no_decoder", "odd_no_decoder"])
def test_pillar_middle_reads_channels_last_maps(grid, with_cov):
    """Every conv of the pillar middle reads a channels_last map that
    no op copied for it: ``F.pad`` pads only the kernels of the
    stride-2 convs on an even size, never a map; 12 convs a frame, 10
    without the decoder."""
    ny, nx = grid
    mod = PillarMiddleCov(MiddleCfg(name="PillarMiddleCov",
                                    channels=(8, 8, 16, 16)),
                          (11, ny, nx))
    g = torch.Generator().manual_seed(ny)
    V = 300
    coords = torch.stack([torch.randint(0, 10, (V,), generator=g),
                          torch.randint(0, ny, (V,), generator=g),
                          torch.randint(0, nx, (V,), generator=g)], 1)
    feats = torch.randn(V, 7, generator=g)
    vmask = torch.rand(V, generator=g) < 0.9
    rec = _RecordLayouts()
    with torch.no_grad(), rec:
        bev, cov = mod(feats, coords, vmask, with_cov=with_cov)
    n_convs = 12 if with_cov else 10
    assert len(rec.conv_inputs) == n_convs
    assert all(x.is_contiguous(memory_format=torch.channels_last)
               for x, _ in rec.conv_inputs)
    uneven = [x for x, s in rec.conv_inputs
              if any(same_pad(n, 3, s) == (0, 1) for n in x.shape[-2:])]
    assert len(uneven) == (3 if grid == (64, 48) else 2)
    assert len(rec.pad_inputs) == len(uneven)
    assert all(p.shape[-2:] == (3, 3) and p.shape[0] in (16, 32)
               for p in rec.pad_inputs)
    assert bev.shape == (-(-ny // 8), -(-nx // 8), 32)
    assert bev.is_contiguous() and (cov is not None) == with_cov


@pytest.mark.parametrize("middle_bn", ["none", "bn"])
def test_pillar_odomnet_forward_matches_jax(middle_bn):
    """Two frames through the pillar OdomNet (eval mode, f32 BEV net):
    odometry, tq map, confidences and covariances."""
    cfg = pillar_cfg(middle_bn=middle_bn)
    _, ex = _frames(cfg, 2, seed=4)
    jnet = JaxOdomNet(cfg)
    variables = jax_variables(jnet, 1, ex, train=False)
    ref = jax.jit(lambda v, e: jnet.apply(v, e, train=False))(
        to_jax(variables), ex)
    net = load_flax_variables(OdomNet(to_port(cfg)), variables)
    with torch.no_grad():
        out = net({k: tt(v) for k, v in ex.items()})
    for key in ("odometry", "tq_map", "t_conf", "q_conf"):
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(np_(out[key]), np_(ref[key]),
                                   err_msg=key, **BF16_TOL)
    for t in range(2):
        np.testing.assert_allclose(np_(out["voxel_covs"][t]),
                                   np_(ref["voxel_covs"][t]), **BF16_TOL)
    assert float(np.abs(np_(ref["odometry"])[:, :3]).max()) > 1e-3


@pytest.fixture(scope="module")
def pillar_net():
    cfg = pillar_cfg(middle_bn="bn")
    _, ex = _frames(cfg, 2)
    jnet = JaxOdomNet(cfg)
    variables = jax_variables(jnet, 2, ex, train=False)
    return cfg, variables


def test_convert_maps_every_leaf_once(pillar_net):
    """Every flax leaf of the pillar OdomNet is one port tensor (strict
    load), 2-D dense kernels transposed, and back again."""
    cfg, variables = pillar_net
    sd = state_dict_from_flax(variables)
    net = load_flax_variables(OdomNet(to_port(cfg)), variables)
    assert set(sd) == set(net.state_dict())
    dense = variables["params"]["middle"]["Dense_0"]["kernel"]
    assert dense.ndim == 2
    np.testing.assert_array_equal(
        net.middle.Dense_0.weight.detach().numpy(), dense.T)
    for name, t in net.state_dict().items():
        col, path = flax_path(name, t.dim())
        want = variables[col]
        for k in path:
            want = want[k]
        np.testing.assert_array_equal(to_flax_leaf(name, t), want)


def _updates(ocfg, train_cfg, trainable, *grads):
    """The JAX optimizer's first updates for each gradient tree, as
    {path: update} dicts."""
    tx = jax_optim.build_optimizer(ocfg, train_cfg)
    run = jax.jit(lambda p, *gs: [tx.update(g, tx.init(p), p)[0]
                                  for g in gs])
    return [dict(_leaves(jax.tree.map(np.asarray, u)))
            for u in run(trainable, *grads)]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_decay_and_lr_mult_masks_match_jax(pillar_net):
    """The port's decay mask (flax ``kernel`` leaves, the dense layers'
    weights among them) and ``group_lr_mult`` labels, leaf by leaf,
    against what the JAX optimizer does: with zero gradients only the
    decayed leaves move; a multiplier of 0 stops the leaves it labels.
    JAX labels a leaf by the top-level key of the trainable tree
    ("params" or "alphas"), not by its module."""
    cfg, variables = pillar_net
    pcfg = to_port(cfg)
    net = load_flax_variables(OdomNet(pcfg), variables)
    trainable = {"params": variables["params"],
                 "alphas": {"rot": np.float32(-2.5),
                            "trans": np.float32(0.5)}}
    names = {("params",) + flax_path(n, p.dim())[1]: n
             for n, p in net.named_parameters()}
    names.update({("alphas", k): f"alphas.{k}" for k in ("rot", "trans")})
    zeros = jax.tree.map(np.zeros_like, trainable)
    ones = jax.tree.map(np.ones_like, trainable)
    ocfg = dataclasses.replace(cfg.optimizer, weight_decay=1.0)
    decayed, base = _updates(ocfg, cfg.train, trainable, zeros, ones)
    assert set(names) == set(decayed)
    opt = make_optimizer(pcfg, net)
    got = {path: opt.decays(names[path]) for path in decayed}
    assert got == {p: bool(np.any(u != 0)) for p, u in decayed.items()}
    assert got[("params", "middle", "Dense_1", "kernel")]
    assert not got[("params", "middle", "Dense_1", "bias")]
    for mults, n_scaled in (((("alpha", 0.0), ("middle", 0.0)), 2),
                            ((("s", 0.0), ("alphas", 2.0)), len(base))):
        (scaled,) = _updates(dataclasses.replace(ocfg, group_lr_mult=mults),
                             cfg.train, trainable, ones)
        want = {p: not np.array_equal(scaled[p], base[p]) for p in base}
        pocfg = dataclasses.replace(pcfg.optimizer, group_lr_mult=mults)
        got = {p: optim.group_label(pocfg, names[p]) != "default"
               for p in base}
        assert got == want and sum(want.values()) == n_scaled, mults


def test_dense_init_is_flax_lecun_normal():
    """nn.Linear weights: truncated normal at fan_in = in_features
    (flax Dense's lecun_normal); zero biases."""
    cfg = to_port(pillar_cfg())
    cfg = cfg.replace(middle=dataclasses.replace(
        cfg.middle, channels=(64, 32, 64, 64)))
    net = OdomNet(cfg, torch.Generator().manual_seed(0))
    w = net.middle.Dense_0.weight.detach()       # (32, 64 + 8 + 7)
    assert w.shape == (32, 79)
    std = np.sqrt(1.0 / 79)
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    np.testing.assert_allclose(float(w.std()), std, rtol=0.1)
    assert not net.middle.Dense_1.bias.detach().any()
    assert not net.middle.Conv2dBNRelu_3.Conv_0.bias.detach().any()


def _window(cfg, L=3):
    scans = tiny_scans(5, L)
    rng = np.random.default_rng(5)
    odom = np.zeros((L * (L - 1) // 2, 7), np.float32)
    odom[:, :3] = rng.normal(0, 0.05, (len(odom), 3))
    odom[:, 3] = 1.0
    return {"points": np.stack(scans),
            "point_mask": np.ones((L, len(scans[0])), bool),
            "odometry": odom}


def _port_step(cfg, variables, batch, jitter=None):
    pcfg = to_port(cfg)
    net = load_flax_variables(OdomNet(pcfg), variables)
    if jitter is not None:
        with torch.no_grad():
            for p in net.parameters():
                p.mul_(1 + jitter * torch.randn(
                    p.shape, generator=torch.Generator().manual_seed(
                        p.numel())))
    state = TrainState.create(net, make_optimizer(pcfg, net),
                              {"rot": -2.5, "trans": 0.0})
    out, grads = loss_and_grads(state, {k: tt(v) for k, v in batch.items()},
                                pcfg, warmup=False)
    return ({k: float(v) for k, v in out.aux.items()},
            {k: g.detach().double() for k, g in grads.items()})


def test_pillar_train_step_matches_jax():
    """One self-supervised step of the pillar OdomNet (train-mode BN in
    the BEV net off, as in test_torch_train_step.py): loss terms and
    per-leaf gradients against jax.value_and_grad of the same loss."""
    cfg = pillar_cfg()
    cfg = cfg.replace(odom=dataclasses.replace(cfg.odom, bn_type="none"))
    batch = _window(cfg)
    ex = jax_prepare(jnp.asarray(batch["points"]),
                     jnp.asarray(batch["point_mask"]), jax_vcfg(cfg),
                     mean_mode=True)
    ex["odometry"] = jnp.asarray(batch["odometry"])
    jnet = JaxOdomNet(cfg)
    variables = jax_variables(jnet, 0, ex, train=False)

    def loss_fn(trainable, example):
        preds, _ = jnet.apply(
            {"params": trainable["params"],
             "batch_stats": variables.get("batch_stats", {})},
            example, train=True, mutable=["batch_stats"])
        out = jax_objective(preds, example, trainable["alphas"], cfg.loss,
                            cfg.voxelizer.point_cloud_range, warmup=False)
        return out.total, out.aux

    trainable = to_jax({"params": variables["params"],
                        "alphas": {"rot": np.float32(-2.5),
                                   "trans": np.float32(0.0)}})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_consistency, "nn_search", pallas_nn_search)
        (_, aux), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(trainable, ex)
    aux = {k: float(v) for k, v in aux.items()}
    got_aux, got = _port_step(cfg, variables, batch)
    _, jittered = _port_step(cfg, variables, batch, GRAD_JITTER)
    for key, want in aux.items():
        np.testing.assert_allclose(got_aux[key], want, err_msg=key,
                                   **STEP_LOSS_TOL)
    assert aux["consistency_loss"] != 0.0
    top = max(float(g.norm()) for g in got.values())
    checked = 0
    for name, g in got.items():
        if name.startswith("alphas."):
            want = grads["alphas"][name.split(".", 1)[1]]
        else:
            want = grads["params"]
            for k in flax_path(name, g.dim())[1]:
                want = want[k]
        want = torch.as_tensor(np.asarray(want, np.float64))
        g_flax = torch.as_tensor(to_flax_leaf(name, g), dtype=torch.float64)
        j_flax = torch.as_tensor(to_flax_leaf(name, jittered[name]),
                                 dtype=torch.float64)
        if float(want.norm()) < 1e-6 * top:
            continue
        err = float((g_flax - want).norm() / want.norm())
        sens = float((j_flax - g_flax).norm() / g_flax.norm())
        assert err <= GRAD_FACTOR * sens + GRAD_ABS, (name, err, sens)
        checked += 1
    assert checked > 20
