"""The port's spatial and tensor parallelism of the BEV stage
(rslo_tpu_torch/parallel/) against JAX's single-device forward and the
port's one-process forward: the twin of tests/test_spatial.py.

Four gloo ranks on the CPU (tests/torch_dist_workers.py::run_ranks, one
start for every case) form a 4 x 1 and a 2 x 2 grid: SP over 4 ranks
(4 x 1), and SP over 2, TP over 2 and SP x TP over 2 x 2 (the 2 x 2
grid's columns or rows, or both).  The tiny config is widened along x
to a 48-column BEV, 6 chunks of 8: 24/24 over 2 ranks and the uneven
16/16/8/8 over 4 (the shipped 176 columns go 48/48/40/40).  In float32
the split forwards hold JAX's single-device forward to
tests/test_spatial.py's tolerance and the port's one-process forward to
SPLIT_TOL; on the CPU they come out bit-equal to it in bfloat16 and
within 3.6e-7 in float32 (the width changes the convs' blocking), and
within 9.4e-5 of JAX (the pillar middle's bf16 convs)."""
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
from rslo_tpu_torch.convert import load_flax_variables
from rslo_tpu_torch.data.prepare import prepare_example, voxelizer_config
from rslo_tpu_torch.models.net import OdomNet
from rslo_tpu_torch.parallel.spatial import (bev_constraint, halo_pad,
                                             make_spatial_forward,
                                             split_widths)
from rslo_tpu_torch.parallel.tensor import (make_model_forward,
                                            make_spatial_model_forward)
from rslo_tpu_torch.utils.mesh_axis import bind_axis

JAX_TOL = dict(rtol=2e-3, atol=2e-4)        # tests/test_spatial.py's
SPLIT_TOL = dict(rtol=1e-5, atol=1e-6)      # against the port, one process
# train mode: the batch moments are sums over the ranks divided by the
# global count where the one-process BN takes torch.mean; the tiny
# input's batch-statistics BN amplifies that rounding (observed 7.6e-6)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)
KEYS = ("odometry", "tq_map", "t_conf", "q_conf", "input_mask")
WIDE_X = 19.2          # x range +-19.2 m at 0.1 m: 384 voxels, BEV W 48


def wide_cfg(precision="f32", middle="SparseMiddleCov", **odom):
    """The tiny config of tests/test_model.py widened along x (JAX's
    schema), with ``odom`` overrides."""
    cfg = port_cfg(precision)
    pr = (-WIDE_X,) + cfg.voxelizer.point_cloud_range[1:3] + (WIDE_X,) + \
        cfg.voxelizer.point_cloud_range[4:]
    return cfg.replace(
        voxelizer=dataclasses.replace(cfg.voxelizer, point_cloud_range=pr),
        middle=dataclasses.replace(cfg.middle, name=middle),
        odom=dataclasses.replace(cfg.odom, **odom))


def wide_scans(seed, n=4000):
    """Two (n, 7) scans spread over the widened range."""
    rng = np.random.default_rng(seed)
    base = np.stack([rng.uniform(-WIDE_X + 0.5, WIDE_X - 0.5, n),
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
    S, P = "SparseMiddleCov", "PillarMiddleCov"
    cases = [("sp2_sparse", S, S, (2, 2), ["space"], False),
             ("sp2_pillar", P, P, (2, 2), ["space"], False),
             ("sp4_sparse", S, S, (4, 1), ["space"], False),
             ("sp4_pillar", P, P, (4, 1), ["space"], False),
             ("tp2", S, S, (2, 2), ["model"], False),
             ("sptp", S, S, (2, 2), ["space", "model"], False),
             ("sptp_bf16", "bf16", S, (2, 2), ["space", "model"], False),
             ("sp4_train", S, S, (4, 1), ["space"], True),
             ("sptp_train", S, S, (2, 2), ["space", "model"], True)] + [
        (f"sptp_{name}", name, S, (2, 2), ["space", "model"], False)
        for name in OPTIONS]
    rng = np.random.default_rng(5)
    halo = [(f"k{k}s{s}", rng.normal(size=(1, 4, 5, 40)).astype(np.float32),
             rng.normal(size=(6, 4, k, k)).astype(np.float32), k, s)
            for k, s in ((3, 2), (1, 2), (3, 1))]
    grad = rng.normal(size=(4, 4, 3)).astype(np.float32)
    ranks = workers.run_ranks("bev_splits", tmp_path_factory.mktemp("sp"),
                              world=4, nets=nets, examples=examples,
                              cases=cases, halo=halo, grad=grad)
    return dict(ranks=ranks, ref=ref, jref=jref, halo=halo, grad=grad)


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


def test_halo_wider_than_a_share_raises_on_every_rank(runs):
    """A halo of 3 columns on the 4/4/2/2 split of a level: the ranks
    holding 4 columns raise with those holding 2, so none is left in
    the halo's collective."""
    for r, res in enumerate(runs["ranks"]):
        msg = res["halo_refusal"]
        assert msg is not None, f"rank {r} did not raise"
        assert "halo of 3 columns" in msg and "(4, 4, 2, 2)" in msg, msg


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
    assert split_widths(176, 2, 8) == (88, 88)
    assert split_widths(176, 4, 8) == (48, 48, 40, 40)
    assert split_widths(48, 4, 8) == (16, 16, 8, 8)
    with pytest.raises(ValueError, match="fewer than the 4 ranks"):
        split_widths(16, 4, 8)
    with pytest.raises(ValueError, match="multiple"):
        split_widths(20, 2, 8)


def test_refused_options_and_no_context():
    """The semi-global BN has no split (ValueError naming it); a halo
    wider than some rank's columns (the spatial gate's 7 x 7 conv at the
    encoder's last stage over too many ranks) raises before any
    collective, on a rank that holds enough columns itself; outside a split the hook returns the pair tensor
    itself."""
    cfg = to_port(wide_cfg(bn_type="semiglobal_sync_bn"))
    net = OdomNet(cfg)
    for make in (make_spatial_forward, make_model_forward,
                 make_spatial_model_forward):
        with pytest.raises(ValueError, match="semiglobal_sync_bn"):
            make(net, None)
    with bind_axis("space", None, 4, rank=1), \
            pytest.raises(ValueError, match="halo of 3 columns"):
        halo_pad(torch.zeros(1, 2, 3, 3), (3, 3, 2, 2), 3, 3, 0.0)
    x = torch.zeros(1, 16, 48, 64)
    assert bev_constraint(x) is x
