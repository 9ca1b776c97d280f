"""The port's spatial and tensor parallelism of the BEV stage
(rslo_tpu_torch/parallel/) against JAX's single-device forward and the
port's one-process forward: the twin of tests/test_spatial.py.

Four gloo ranks on the CPU (tests/torch_dist_workers.py::run_ranks, one
start for every case) form a 4 x 1, a 2 x 2 and a 1 x 4 grid, and ranks
0-2 a 1 x 3 grid: SP over 4 ranks (4 x 1), and SP over 2, TP over 2 and
SP x TP over 2 x 2 (the 2 x 2 grid's columns or rows, or both).  The
tiny config is widened along x to a 48-column BEV, 6 chunks of 8: 24/24
over 2 ranks and the uneven 16/16/8/8 over 4 (the shipped 176 columns
go 48/48/40/40).

The layouts GSPMD pads: the tiny config itself (16 columns, 2 chunks)
over SP4 (8/8/0/0: two ranks without columns), TP4 and SP x TP, as
tests/test_spatial.py runs it; 24 columns over SP4 (8/8/8/0) in train
mode; TP3 (the tiny widths 16, 32, 64 split 6/5/5, 11/11/10, 22/21/21)
with rank 3 outside the grid; and TP4 of bottleneck blocks whose inner
width 2 leaves two ranks without a channel.  In float32
the split forwards hold JAX's single-device forward to
tests/test_spatial.py's tolerance and the port's one-process forward to
SPLIT_TOL; on the CPU they come out bit-equal to it in bfloat16 and
within 3.6e-7 in float32 (the width changes the convs' blocking), and
within 9.4e-5 of JAX (the pillar middle's bf16 convs).

The semi-global BN runs in train mode under SP2, SP4, TP2 and SP x TP
(its statistics move in train mode only), against JAX's single-device
forward and statistics; the spatial gate's 7 x 7 conv over SP4 at the
encoder's last stage (2/2/1/1 columns) needs a halo of 3, wider than a
neighbour's share."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from torch_port_helpers import jax_variables, np_, port_cfg, to_jax, to_port

from rslo_tpu.data.prepare import prepare_example as jax_prepare
from rslo_tpu.data.prepare import voxelizer_config as jax_vcfg
from rslo_tpu.models.net import OdomNet as JaxOdomNet
from rslo_tpu_torch.convert import (flax_path, load_flax_variables,
                                    to_flax_leaf)
from rslo_tpu_torch.data.prepare import prepare_example, voxelizer_config
from rslo_tpu_torch.models.net import OdomNet
from rslo_tpu_torch.parallel.spatial import bev_constraint, split_widths
from rslo_tpu_torch.parallel.tensor import channel_range
from rslo_tpu_torch.utils.mesh_axis import bind_axis

JAX_TOL = dict(rtol=2e-3, atol=2e-4)        # tests/test_spatial.py's
SPLIT_TOL = dict(rtol=1e-5, atol=1e-6)      # against the port, one process
# train mode: the batch moments are sums over the ranks divided by the
# global count where the one-process BN takes torch.mean; the tiny
# input's batch-statistics BN amplifies that rounding (observed 7.6e-6)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)
KEYS = ("odometry", "tq_map", "t_conf", "q_conf", "input_mask")
WIDE_X = 19.2          # x range +-19.2 m at 0.1 m: 384 voxels, BEV W 48
TINY_X = 6.4           # the tiny config's own: BEV W 16
X24 = 9.6              # BEV W 24


def wide_cfg(precision="f32", middle="SparseMiddleCov", x=WIDE_X, **odom):
    """The tiny config of tests/test_model.py with the x range +-``x``
    (widened by default; JAX's schema), with ``odom`` overrides."""
    cfg = port_cfg(precision)
    pr = (-x,) + cfg.voxelizer.point_cloud_range[1:3] + (x,) + \
        cfg.voxelizer.point_cloud_range[4:]
    return cfg.replace(
        voxelizer=dataclasses.replace(cfg.voxelizer, point_cloud_range=pr),
        middle=dataclasses.replace(cfg.middle, name=middle),
        odom=dataclasses.replace(cfg.odom, **odom))


def wide_scans(seed, n=4000, x=WIDE_X):
    """Two (n, 7) scans spread over the x range +-``x``."""
    rng = np.random.default_rng(seed)
    base = np.stack([rng.uniform(-x + 0.5, x - 0.5, n),
                     rng.uniform(-6, 6, n)], 1).astype(np.float32)
    return [np.concatenate(
        [base + t * 0.05, rng.uniform(-0.7, 0.7, (n, 1)),
         rng.uniform(0, 1, (n, 1)), rng.normal(size=(n, 3))],
        1).astype(np.float32) for t in range(2)]


def _state(net):
    return {k: v.numpy().copy() for k, v in net.state_dict().items()}


def _perturbed(net, seed):
    """The port's seeded init with every float tensor, the BN
    statistics included, scaled by 1 + 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    return {k: (v * (1 + 0.1 * rng.normal(size=v.shape))).astype(v.dtype)
            if v.dtype.kind == "f" else v for k, v in _state(net).items()}


def _forward(net, ex, train=False):
    net.train(train)
    with torch.no_grad():
        out = net({k: torch.tensor(v) for k, v in ex.items()})
    net.eval()
    return {k: np_(out[k]) for k in KEYS} | {
        "pyramid": [(np_(a), np_(b)) for a, b in out["pyramid"]]}


def _flax_variables(state):
    """The flax variables of a port state dict (``convert.py``'s
    mapping, inverted)."""
    tree = {}
    for name, v in state.items():
        col, path = flax_path(name, v.ndim)
        node = tree.setdefault(col, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = to_flax_leaf(name, torch.tensor(v))
    return tree


def _jax_and_port(cfg, pts, mask, seed, train):
    """JAX's single-device forward of ``cfg`` on the scans ``pts`` and
    the port's one-process forward, both on the port's seeded init with
    every float tensor perturbed (no JAX init to compile): (JAX's
    preds, its moved statistics as the port net's buffers (train mode)
    or None, (config JSON, state), the port's example, its outputs, its
    buffers after the forward (train mode) or None)."""
    jnet = JaxOdomNet(cfg)
    jex = jax_prepare(jnp.asarray(pts), jnp.asarray(mask), jax_vcfg(cfg),
                      mean_mode=True)
    net = OdomNet(to_port(cfg), torch.Generator().manual_seed(seed))
    state = _perturbed(net, seed)
    net.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    variables = _flax_variables(state)
    preds, stats = jax.jit(lambda v, e: jnet.apply(
        v, e, train=train, mutable=["batch_stats"]))(to_jax(variables), jex)
    jbuf = None
    if train:
        moved = load_flax_variables(OdomNet(to_port(cfg)), dict(
            params=variables["params"],
            batch_stats=jax.tree.map(np.asarray, stats["batch_stats"])))
        jbuf = {k: v.numpy().copy() for k, v in
                moved.bev_net.named_buffers()}
    ex = prepare_example(torch.tensor(pts), torch.tensor(mask),
                         voxelizer_config(to_port(cfg)), mean_mode=True)
    ex = {k: v.numpy() for k, v in ex.items()}
    ref = _forward(net, ex, train=train)
    buf = ({k: v.numpy().copy() for k, v in net.bev_net.named_buffers()}
           if train else None)
    return preds, jbuf, (to_port(cfg).to_json(), state), ex, ref, buf


# the layouts GSPMD pads: (net key, x range, middle, odom overrides,
# train mode)
PADDED = {
    "narrow_S": (TINY_X, "SparseMiddleCov", {}, False),
    "narrow_P": (TINY_X, "PillarMiddleCov", {}, False),
    "x24_train": (X24, "SparseMiddleCov", {}, True),
    "narrow_bottleneck": (TINY_X, "SparseMiddleCov", dict(
        block_type="bottleneck", num_filters=(8, 8, 16)), False),
    "narrow_sgbn": (TINY_X, "SparseMiddleCov",
                    dict(bn_type="semiglobal_sync_bn"), True),
}


OPTIONS = {
    "options": dict(layer_nums=(2, 2, 2), conv_type="sparse_conv",
                    use_se=True, use_sa=True, conf_type="linear",
                    multi_level_odom=True, use_svd=True),
    "fire": dict(block_type="fire", layer_nums=(2, 2, 2)),
    "bottleneck": dict(block_type="bottleneck"),
    "fc": dict(dense_predict=False),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's and the port's one-process forwards, and every split case
    from one start of 4 ranks."""
    scans = wide_scans(7)
    pts = np.stack(scans)
    mask = np.ones(pts.shape[:2], bool)
    nets, examples, ref, jref = {}, {}, {}, {}
    for middle in ("SparseMiddleCov", "PillarMiddleCov"):
        cfg = wide_cfg(middle=middle)
        jnet = JaxOdomNet(cfg)
        jex = jax_prepare(jnp.asarray(pts), jnp.asarray(mask), jax_vcfg(cfg),
                          mean_mode=True)
        variables = jax_variables(jnet, 3, jex, train=False)
        jref[middle] = jax.jit(lambda v, e: jnet.apply(v, e, train=False))(
            to_jax(variables), jex)
        net = load_flax_variables(OdomNet(to_port(cfg)), variables)
        ex = prepare_example(torch.tensor(pts), torch.tensor(mask),
                             voxelizer_config(to_port(cfg)), mean_mode=True)
        examples[middle] = {k: v.numpy() for k, v in ex.items()}
        nets[middle] = (to_port(cfg).to_json(), _state(net))
        ref[middle] = _forward(net, examples[middle])
        if middle == "SparseMiddleCov":
            ref["train"] = _forward(net, examples[middle], train=True)
            ref["train_buffers"] = {k: v.numpy().copy() for k, v in
                                    net.bev_net.named_buffers()}
    ex = examples["SparseMiddleCov"]
    jex = jax_prepare(jnp.asarray(pts), jnp.asarray(mask),
                      jax_vcfg(wide_cfg()), mean_mode=True)
    # the semi-global BN in train mode, and the spatial gate (eval):
    # JAX's single-device forward (and statistics) and the port's one
    # process, on JAX's perturbed weights
    for name, odom, train in (("sgbn", dict(bn_type="semiglobal_sync_bn"),
                               True),
                              ("sa", dict(use_sa=True), False)):
        cfg = wide_cfg(**odom)
        jnet = JaxOdomNet(cfg)
        variables = jax_variables(jnet, 4, jex, train=False)
        preds, stats = jax.jit(lambda v, e: jnet.apply(
            v, e, train=train, mutable=["batch_stats"]))(
                to_jax(variables), jex)
        jref[name] = preds
        net = load_flax_variables(OdomNet(to_port(cfg)), variables)
        nets[name] = (to_port(cfg).to_json(), _state(net))
        ref[name] = _forward(net, ex, train=train)
        if train:
            moved = load_flax_variables(OdomNet(to_port(cfg)), dict(
                params=variables["params"],
                batch_stats=jax.tree.map(np.asarray, stats["batch_stats"])))
            jref[name + "_buffers"] = {k: v.numpy().copy() for k, v in
                                       moved.bev_net.named_buffers()}
    bf = to_port(wide_cfg("bf16"))
    net = OdomNet(bf, torch.Generator().manual_seed(1))
    nets["bf16"] = (bf.to_json(), _perturbed(net, 1))
    net.load_state_dict({k: torch.tensor(v)
                         for k, v in nets["bf16"][1].items()})
    ref["bf16"] = _forward(net, ex)
    for name, odom in OPTIONS.items():
        cfg = to_port(wide_cfg(**odom))
        net = OdomNet(cfg, torch.Generator().manual_seed(2))
        nets[name] = (cfg.to_json(), _perturbed(net, 2))
        net.load_state_dict({k: torch.tensor(v)
                             for k, v in nets[name][1].items()})
        ref[name] = _forward(net, ex)
    for key, (x, middle, odom, train) in PADDED.items():
        pts = np.stack(wide_scans(7, x=x))
        (jref[key], jref[key + "_buffers"], nets[key], examples[key],
         ref[key], ref[key + "_buffers"]) = _jax_and_port(
            wide_cfg(middle=middle, x=x, **odom), pts,
            np.ones(pts.shape[:2], bool), 3, train)
    S, P = "SparseMiddleCov", "PillarMiddleCov"
    cases = [("sp2_sparse", S, S, (2, 2), ["space"], False),
             ("sp2_pillar", P, P, (2, 2), ["space"], False),
             ("sp4_sparse", S, S, (4, 1), ["space"], False),
             ("sp4_pillar", P, P, (4, 1), ["space"], False),
             ("tp2", S, S, (2, 2), ["model"], False),
             ("sptp", S, S, (2, 2), ["space", "model"], False),
             ("sptp_bf16", "bf16", S, (2, 2), ["space", "model"], False),
             ("sp4_train", S, S, (4, 1), ["space"], True),
             ("sptp_train", S, S, (2, 2), ["space", "model"], True),
             ("sp2_sgbn", "sgbn", S, (2, 2), ["space"], True),
             ("sp4_sgbn", "sgbn", S, (4, 1), ["space"], True),
             ("tp2_sgbn", "sgbn", S, (2, 2), ["model"], True),
             ("sptp_sgbn", "sgbn", S, (2, 2), ["space", "model"], True),
             ("sp4_sa", "sa", S, (4, 1), ["space"], False)] + [
        (f"sptp_{name}", name, S, (2, 2), ["space", "model"], False)
        for name in OPTIONS] + [
        ("sp4_narrow_S", "narrow_S", "narrow_S", (4, 1), ["space"], False),
        ("sp4_narrow_P", "narrow_P", "narrow_P", (4, 1), ["space"], False),
        ("tp4_narrow_S", "narrow_S", "narrow_S", (1, 4), ["model"], False),
        ("sptp_narrow_S", "narrow_S", "narrow_S", (2, 2),
         ["space", "model"], False),
        ("tp3_narrow_S", "narrow_S", "narrow_S", (1, 3), ["model"], False),
        ("sp4_x24_train", "x24_train", "x24_train", (4, 1), ["space"],
         True),
        ("tp4_narrow_bottleneck", "narrow_bottleneck", "narrow_bottleneck",
         (1, 4), ["model"], False),
        ("sp4_narrow_sgbn", "narrow_sgbn", "narrow_sgbn", (4, 1), ["space"],
         True)]
    rng = np.random.default_rng(5)
    halo = [(f"k{k}s{s}", rng.normal(size=(1, 4, 5, 40)).astype(np.float32),
             rng.normal(size=(6, 4, k, k)).astype(np.float32), k, s)
            for k, s in ((3, 2), (1, 2), (3, 1))]
    grad = rng.normal(size=(4, 4, 3)).astype(np.float32)
    ranks = workers.run_ranks("bev_splits", tmp_path_factory.mktemp("sp"),
                              world=4, nets=nets, examples=examples,
                              cases=cases, halo=halo, grad=grad,
                              grad_sizes=GRAD_SIZES)
    return dict(ranks=ranks, ref=ref, jref=jref, halo=halo, grad=grad)


GRAD_SIZES = (3, 2, 1, 0)


def _check(ranks, case, want, keys=KEYS, **tol):
    for r, res in enumerate(ranks):
        got = res[case]
        for key in keys:
            np.testing.assert_allclose(got[key], want[key], **tol,
                                       err_msg=f"{case} rank {r}: {key}")
        if "pyramid" in want:
            assert len(got["pyramid"]) == len(want["pyramid"])
            for (a, b), (c, d) in zip(got["pyramid"], want["pyramid"]):
                np.testing.assert_allclose(a, c, **tol)
                np.testing.assert_allclose(b, d, **tol)


@pytest.mark.parametrize("ranks_", [2, 4])
@pytest.mark.parametrize("middle", ["SparseMiddleCov", "PillarMiddleCov"])
def test_spatial_forward_matches_single_device(runs, middle, ranks_):
    case = f"sp{ranks_}_{'sparse' if middle[0] == 'S' else 'pillar'}"
    _check(runs["ranks"], case, runs["ref"][middle], **SPLIT_TOL)
    jref = {k: np_(runs["jref"][middle][k])
            for k in ("odometry", "tq_map", "t_conf")}
    _check(runs["ranks"], case, jref, keys=jref, **JAX_TOL)
    assert runs["ranks"][0][case]["tq_map"].shape[2] == 48


def test_model_parallel_forward_matches_single_device(runs):
    _check(runs["ranks"], "tp2", runs["ref"]["SparseMiddleCov"],
           **SPLIT_TOL)
    jref = {k: np_(runs["jref"]["SparseMiddleCov"][k])
            for k in ("odometry", "tq_map", "t_conf")}
    _check(runs["ranks"], "tp2", jref, keys=jref, **JAX_TOL)


def test_spatial_model_2d_forward_matches_single_device(runs):
    _check(runs["ranks"], "sptp", runs["ref"]["SparseMiddleCov"],
           **SPLIT_TOL)
    jref = {k: np_(runs["jref"]["SparseMiddleCov"][k])
            for k in ("odometry", "tq_map", "t_conf")}
    _check(runs["ranks"], "sptp", jref, keys=jref, **JAX_TOL)


def test_bf16_split_matches_one_process(runs):
    """The deployed bfloat16 compute, SP x TP (the grouped first conv,
    the decoder's concat of split channels)."""
    _check(runs["ranks"], "sptp_bf16", runs["ref"]["bf16"], **SPLIT_TOL)


@pytest.mark.parametrize("case", ["sp4_train", "sptp_train"])
def test_train_mode_split_matches_one_process(runs, case):
    """Train mode: the BN batch moments summed over the space ranks,
    the running statistics updated whole on every rank."""
    _check(runs["ranks"], case, runs["ref"]["train"],
           keys=("odometry", "tq_map", "t_conf"), **TRAIN_TOL)
    for r, res in enumerate(runs["ranks"]):
        for k, v in runs["ref"]["train_buffers"].items():
            np.testing.assert_allclose(res[case]["buffers"][k], v,
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{case} rank {r}: {k}")


@pytest.mark.parametrize("name", list(OPTIONS))
def test_split_bev_options_match_one_process(runs, name):
    """SP x TP with the BEV options: normalized convs, SE and spatial
    attention, linear confidence, per-level and SVD votes; fire and
    bottleneck blocks; the FC head."""
    _check(runs["ranks"], f"sptp_{name}", runs["ref"][name], **SPLIT_TOL)


@pytest.mark.parametrize("k, s", [(3, 2), (1, 2), (3, 1)])
def test_halo_pads_at_inner_edges(runs, k, s):
    """A conv and the -inf mask max-pool on each rank's columns of a
    16/8/8/8 split equal the unsplit op's columns: stride-2 SAME pads
    (0, 1), so only a right halo; k 1 stride 2 none; k 3 stride 1 one
    each side."""
    from rslo_tpu_torch.models import bev_net
    _, x, w, _, _ = next(c for c in runs["halo"] if c[0] == f"k{k}s{s}")
    conv = torch.nn.Conv2d(4, 6, k, s, bias=False)
    conv.weight.data = torch.tensor(w)
    xt = torch.tensor(x)
    with torch.no_grad():
        full = bev_net._conv(conv, xt).numpy()
        pool = bev_net.max_pool_mask(xt[:, :1], k, s).numpy()
    got = [r[f"k{k}s{s}"] for r in runs["ranks"]]
    assert got[0]["widths"] == (16, 8, 8, 8)
    np.testing.assert_array_equal(np.concatenate([g["y"] for g in got], -1),
                                  full)
    np.testing.assert_array_equal(
        np.concatenate([g["pool"] for g in got], -1), pool)


@pytest.mark.parametrize("case", ["sp2_sgbn", "sp4_sgbn", "tp2_sgbn",
                                  "sptp_sgbn", "sp4_narrow_sgbn"])
def test_semiglobal_bn_split_matches_single_device(runs, case):
    """Train mode: the statistics of the whole map (over SP the sums
    over every rank's columns divided by the global count, the shares
    being uneven over 4, or on the tiny config's 16 columns 8/8/0/0,
    two ranks summing nothing; over TP the moments of every channel
    gathered), all eight buffers updated whole on every rank; the
    forward normalizes with them."""
    key = "narrow_sgbn" if "narrow" in case else "sgbn"
    jref = {k: np_(runs["jref"][key][k])
            for k in ("odometry", "tq_map", "t_conf")}
    _check(runs["ranks"], case, jref, keys=jref, **JAX_TOL)
    _check(runs["ranks"], case, runs["ref"][key],
           keys=("odometry", "tq_map", "t_conf"), **TRAIN_TOL)
    want = runs["jref"][key + "_buffers"]
    assert sum("SemiGlobalSyncBN_0" in k for k in want) >= 8
    for r, res in enumerate(runs["ranks"]):
        assert set(res[case]["buffers"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(res[case]["buffers"][k], v,
                                       **JAX_TOL,
                                       err_msg=f"{case} rank {r}: {k}")


def test_halo_wider_than_a_share_matches_single_device(runs):
    """The spatial gate's 7 x 7 conv at the last encoder stage of SP4 on
    48 columns (2/2/1/1: a halo of 3 reaches two ranks away) against
    JAX's single-device forward and the port's one process; and
    halo_pad itself on a 4/4/2/2 split: each rank's padded columns are
    the slice of the globally padded map."""
    _check(runs["ranks"], "sp4_sa", runs["ref"]["sa"], **SPLIT_TOL)
    jref = {k: np_(runs["jref"]["sa"][k])
            for k in ("odometry", "tq_map", "t_conf")}
    _check(runs["ranks"], "sp4_sa", jref, keys=jref, **JAX_TOL)
    full = np.concatenate([[-1.0] * 3, np.arange(12.0), [-1.0] * 3])
    starts = (0, 4, 8, 10)
    for r, res in enumerate(runs["ranks"]):
        n = (4, 4, 2, 2)[r]
        np.testing.assert_array_equal(res["halo_wide"][0, 0],
                                      full[starts[r]:starts[r] + n + 6])


def test_gather_gradient_is_the_all_reduced_share(runs):
    """L = sum_r sum(gather(x) * c_r) over the space axis of 4 ranks:
    dL/dx_r = sum_q c_q[r], the transpose of the all-gather."""
    c = runs["grad"]
    for r, res in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(
            res["grad"]["gathered"],
            np.broadcast_to(np.arange(4.0, dtype=np.float32)[:, None],
                            (4, 3)))
        np.testing.assert_allclose(res["grad"]["dx"],
                                   sum(c[q][r] for q in range(4)),
                                   rtol=1e-6, atol=1e-6)


def test_split_widths_chunks_and_refusals():
    """Chunks of 8 columns, the first ranks one more; fewer chunks than
    ranks leave the last ranks none (GSPMD pads there); a width that is
    no multiple of 8 is refused, as the unsplit forward refuses it."""
    assert split_widths(176, 2, 8) == (88, 88)
    assert split_widths(176, 4, 8) == (48, 48, 40, 40)
    assert split_widths(48, 4, 8) == (16, 16, 8, 8)
    assert split_widths(16, 4, 8) == (8, 8, 0, 0)
    assert split_widths(24, 4, 8) == (8, 8, 8, 0)
    assert split_widths(8, 2, 8) == (8, 0)
    with pytest.raises(ValueError, match="multiple"):
        split_widths(20, 2, 8)


def test_refused_options_and_no_context(runs):
    """The two splits GSPMD pads, which the port now takes: a channel
    count the model ranks do not divide goes in uneven slices, the
    first ranks one channel more (128 over 3: 43/43/42), none where
    there are fewer channels than ranks; a grid over a subset of the
    ranks (the 1 x 3 grid of ranks 0-2) leaves the others outside, with
    no axis; outside a split the hook returns the pair tensor itself."""
    for n, c, want in ((3, 128, (43, 43, 42)), (3, 16, (6, 5, 5)),
                       (4, 2, (1, 1, 0, 0)), (2, 16, (8, 8))):
        got = []
        for r in range(n):
            with bind_axis("model", None, n, rank=r):
                got.append(channel_range(c))
        assert [hi - lo for lo, hi in got] == list(want)
        assert [lo for lo, _ in got] == [sum(want[:r]) for r in range(n)]
    assert [res["grid13"] for res in runs["ranks"]] == [(0, 0), (0, 1),
                                                         (0, 2), None]
    x = torch.zeros(1, 16, 48, 64)
    assert bev_constraint(x) is x


@pytest.mark.parametrize("case", ["sp4_narrow_S", "sp4_narrow_P",
                                  "tp4_narrow_S", "sptp_narrow_S",
                                  "tp3_narrow_S"])
def test_padded_layouts_match_single_device(runs, case):
    """JAX's own case, tests/test_spatial.py's tiny config unwidened (16
    columns): SP4 (8/8/0/0) for both middles, TP4 and SP x TP 2 x 2;
    and TP3 on the 1 x 3 grid of ranks 0-2 at widths 3 does not divide
    (rank 3 outside it runs nothing).  Against JAX's single-device
    forward and the port's one process, on every rank of the grid."""
    key = case.split("_", 1)[1]
    ranks = runs["ranks"]
    if case.startswith("tp3"):
        assert ranks[3][case] is None
        ranks = ranks[:3]
    _check(ranks, case, runs["ref"][key], **SPLIT_TOL)
    jref = {k: np_(runs["jref"][key][k])
            for k in ("odometry", "tq_map", "t_conf")}
    _check(ranks, case, jref, keys=jref, **JAX_TOL)
    assert ranks[0][case]["tq_map"].shape[2] == 16


def test_empty_share_meets_the_batch_moments(runs):
    """24 columns over SP4 (8/8/8/0) in train mode: rank 3 sums no
    column into the batch moments, which divide by the global count;
    the maps against JAX's single-device train-mode forward and the
    port's one process, the running statistics against the latter."""
    case, key = "sp4_x24_train", "x24_train"
    jref = {k: np_(runs["jref"][key][k])
            for k in ("odometry", "tq_map", "t_conf")}
    _check(runs["ranks"], case, jref, keys=jref, **JAX_TOL)
    _check(runs["ranks"], case, runs["ref"][key],
           keys=("odometry", "tq_map", "t_conf"), **TRAIN_TOL)
    assert runs["ranks"][0][case]["tq_map"].shape[2] == 24
    for r, res in enumerate(runs["ranks"]):
        for k, v in runs["ref"][key + "_buffers"].items():
            np.testing.assert_allclose(res[case]["buffers"][k], v,
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{case} rank {r}: {k}")


def test_channel_slices_may_be_empty(runs):
    """TP4 of bottleneck blocks at num_filters (8, 8, 16): the inner
    width 2 goes 1/1/0/0, so two ranks compute no channel of those
    convs and BNs yet join every gather; a 1-channel map is a slice on
    every rank.  Against JAX's single-device forward and the port's one
    process."""
    case, key = "tp4_narrow_bottleneck", "narrow_bottleneck"
    _check(runs["ranks"], case, runs["ref"][key], **SPLIT_TOL)
    jref = {k: np_(runs["jref"][key][k])
            for k in ("odometry", "tq_map", "t_conf")}
    _check(runs["ranks"], case, jref, keys=jref, **JAX_TOL)


def test_halo_past_an_empty_share(runs):
    """halo_pad of 3 columns each side on a 4/4/0/0 split of an
    8-column map: rank 1's right halo finds no column to its right and
    takes the pad value; rank 2, holding none, still gets its halos
    (rank 1's last 3 columns, then the pad); each rank's padded columns
    are the slice of the globally padded map."""
    full = np.concatenate([[-1.0] * 3, np.arange(8.0), [-1.0] * 3])
    for r, res in enumerate(runs["ranks"]):
        n, start = (4, 4, 0, 0)[r], (0, 4, 8, 8)[r]
        np.testing.assert_array_equal(res["halo_empty"][0, 0],
                                      full[start:start + n + 6])


def test_uneven_gather_gradient_is_the_unpadded_share(runs):
    """gather_shares over shares of 3/2/1/0 elements: the gather is the
    shares in rank order, and dL/dx_r the all-reduced cotangent's slice
    of rank r, unpadded (none for the empty share)."""
    c = runs["grad"].reshape(4, -1)[:, :sum(GRAD_SIZES)]
    starts = np.cumsum((0,) + GRAD_SIZES)
    want = np.repeat(np.arange(4.0), GRAD_SIZES)
    for r, res in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(res["grad_uneven"]["gathered"], want)
        np.testing.assert_allclose(res["grad_uneven"]["dx"],
                                   c.sum(0)[starts[r]:starts[r + 1]],
                                   rtol=1e-6, atol=1e-6)
