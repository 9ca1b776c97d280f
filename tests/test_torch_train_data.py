"""Port the training data path against the JAX package, bit for bit:
the augmentations (``data/augment.py``), the random-stride train fetch
(``KittiWindowDataset.sample``), the ``TrainSampler`` index stream (with
and without ``review_cycle``, and resumed at ``last_iter``), the
training ``DataLoader``'s batch stream with every augmentation on, the
int16 transfer's ``dequantize_points``, and the parameter surgery's
leaf selection over the flax paths of a pillar ``OdomNet``.  The
datasets read a stub store: every frame is a seeded function of its
sequence and index."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (assert_same, jax_variables, port_cfg,
                                to_port, tt)

from rslo_tpu.config.schema import DataCfg as JaxDataCfg
from rslo_tpu.data import augment as JA
from rslo_tpu.data import dataset as JD
from rslo_tpu.data import loader as JL
from rslo_tpu.data.prepare import dequantize_points as jax_dequantize
from rslo_tpu.models.net import OdomNet as JaxOdomNet
from rslo_tpu.utils import param_surgery as JS
from rslo_tpu_torch.config.schema import DataCfg
from rslo_tpu_torch.convert import load_flax_variables
from rslo_tpu_torch.data import augment as PA
from rslo_tpu_torch.data import dataset as PD
from rslo_tpu_torch.data import loader as PL
from rslo_tpu_torch.data.prepare import dequantize_points
from rslo_tpu_torch.models.net import OdomNet
from rslo_tpu_torch.utils import param_surgery as PS

N_FRAMES = {0: 9, 1: 6}


class StubReader:
    """A sequence of N_FRAMES[seq] frames: 200-400 points of 7
    columns, a camera pose drifting forward and turning, a fixed
    calibration and one hier cloud."""

    def __init__(self, root, seq):
        self.seq = seq
        self.n_frames = N_FRAMES[seq]

    def frame(self, i, cross_normals=False):
        rng = np.random.default_rng((self.seq, i))
        n = int(rng.integers(200, 400))
        pts = rng.normal(0, 5, (n, 10 if cross_normals else 7))
        c, s = np.cos(0.05 * i), np.sin(0.05 * i)
        pose = np.array([[c, 0, s, 0.2 * i], [0, 1, 0, 0.01 * i],
                         [-s, 0, c, 0.9 * i]])
        tr = np.array([[0, -1, 0, 0.1], [0, 0, -1, -0.05], [1, 0, 0, 0.3]])
        return {"points": pts.astype(np.float32), "pose": pose, "Tr": tr,
                "hier_lidar_points_normals_0.1":
                    rng.normal(size=(50, 6)).astype(np.float32)}


@pytest.fixture
def stub_store(monkeypatch):
    monkeypatch.setattr(PD, "SequenceReader", StubReader)
    monkeypatch.setattr(JD, "SequenceReader", StubReader)


def _cfgs(**kw):
    kw = dict(root="stub", train_sequences=(0, 1), val_sequences=(1,),
              **kw)
    return DataCfg(**kw), JaxDataCfg(**kw)


def _sample(seed, n_cols=7, L=3, hier=True):
    """A window of L frames with poses, odometry and hier clouds."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((L, 7), np.float32)
    poses[:, :3] = np.cumsum(rng.normal(0, 1, (L, 3)), 0)
    q = rng.normal(size=(L, 4)) * [1, 0.1, 0.1, 0.3] + [3, 0, 0, 0]
    poses[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    s = {"points": [rng.normal(0, 5, (100 + 10 * t, n_cols)).astype(
            np.float32) for t in range(L)],
         "pose_seq": poses, "odometry": JD.generate_cyc_vo(poses),
         "seq": 0, "frames": list(range(L))}
    if hier:
        s["hier_points"] = [rng.normal(size=(30, 6)).astype(np.float32)
                            for _ in range(L)]
    return s


def test_pose_helpers_bit_equal():
    rng = np.random.default_rng(1)
    for _ in range(20):
        odom = rng.normal(size=7).astype(np.float32)
        odom[3:] /= np.linalg.norm(odom[3:])
        th = rng.uniform(-np.pi, np.pi)
        Rz = np.array([[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        assert_same(PA.flip_odometry(odom), JA.flip_odometry(odom))
        assert_same(PA.rotate_odometry(odom, Rz),
                    JA.rotate_odometry(odom, Rz))
        q0, q1 = odom[3:].astype(np.float64), rng.normal(size=4)
        q1 /= np.linalg.norm(q1)
        for u in (-0.5, 0.0, 0.3, 1.2):
            assert_same(PA._slerp(q0, q1, u), JA._slerp(q0, q1, u))
        assert_same(PA._slerp(q0, q0, 0.4), JA._slerp(q0, q0, 0.4))


@pytest.mark.parametrize("n_cols", [6, 7, 10])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augmentations_bit_equal(seed, n_cols):
    """Each augmentation, then all three in the loader's order, on
    copies of one sample with one rng seed each side."""
    base = _sample(seed, n_cols, hier=n_cols != 10)
    chains = {
        "flip": lambda m, s, r: m.random_flip_y(s, r),
        "yaw": lambda m, s, r: m.random_yaw(s, r, np.pi),
        "interp": lambda m, s, r: m.pose_interp_aug(s, r, 0.5),
        "all": lambda m, s, r: m.pose_interp_aug(
            m.random_yaw(m.random_flip_y(s, r), r, np.pi), r, 0.5)}
    for name, fn in chains.items():
        got = fn(PA, copy.deepcopy(base), np.random.default_rng(seed))
        want = fn(JA, copy.deepcopy(base), np.random.default_rng(seed))
        assert_same(got, want, name)
    # the draws do something: some seed flips, every yaw moves points
    moved = chains["yaw"](PA, copy.deepcopy(base),
                          np.random.default_rng(seed))
    assert not np.array_equal(moved["points"][0], base["points"][0])


@pytest.mark.parametrize("skip", [2, 3, -2])
def test_window_sample_bit_equal(stub_store, skip):
    """The random-stride fetch: stride from 1..skip (or the signed
    range), frames clamped at the sequence end."""
    pcfg, jcfg = _cfgs(skip=skip, load_hier_points=True)
    got = PD.KittiWindowDataset(pcfg, "train")
    want = JD.KittiWindowDataset(jcfg, "train")
    assert got.supports_random_skip and want.supports_random_skip
    assert got.index == want.index and len(got) > 0
    frames = set()
    for i in range(len(want)):
        for seed in range(3):
            a = got.sample(i, np.random.default_rng((seed, i)))
            b = want.sample(i, np.random.default_rng((seed, i)))
            assert_same(a, b, f"window {i} seed {seed}")
            frames.add(tuple(a["frames"]))
    # more than one stride is drawn
    assert len({f[1] - f[0] for f in frames}) > 1


@pytest.mark.parametrize("review_cycle", [-1.0, 0.5, 1.0])
@pytest.mark.parametrize("batch", [1, 2])
def test_train_sampler_stream_bit_equal(review_cycle, batch):
    """The index stream over 4 epochs of 7 items, and the stream
    resumed at last_iter = 2, 5 and 9 equal to the uninterrupted one."""
    n, steps = 7, 14

    def take(mod, last_iter, k):
        it = iter(mod.TrainSampler(n, steps, batch, seed=3,
                                   last_iter=last_iter,
                                   review_cycle=review_cycle))
        return [next(it) for _ in range(k)]

    full = take(PL, -1, steps * batch)
    assert full == take(JL, -1, steps * batch)
    assert sorted(full[:n]) == list(range(n)) or review_cycle > 0
    for last in (2, 5, 9):
        rest = steps * batch - (last + 1) * batch
        resumed = take(PL, last, rest)
        assert resumed == take(JL, last, rest)
        assert resumed == full[(last + 1) * batch:]


def _first_batches(loader, k):
    out = []
    for b in loader:
        out.append(b)
        if len(out) == k:
            break
    loader.close()
    return out


@pytest.mark.parametrize("last_iter", [-1, 3])
def test_train_loader_stream_bit_equal(stub_store, last_iter):
    """Six batches of 2 windows: random stride, flip, yaw and pose
    interpolation on, clouds over the capacity (seeded subsample) and
    int16 transfer; the stream with 4 worker threads equals JAX's and
    the 1-thread stream (the per-fetch rngs fix it)."""
    kw = dict(skip=2, random_skip=True, random_flip_y=True,
              yaw_aug_rad=float(np.pi), pose_interp_ratio=0.5,
              max_points=256, quantize_transfer=True, review_cycle=0.5)
    pcfg, jcfg = _cfgs(**kw)
    pds = PD.KittiWindowDataset(pcfg, "train")
    jds = JD.KittiWindowDataset(jcfg, "train")
    got = _first_batches(PL.DataLoader(pds, pcfg, 2, 20, seed=4,
                                       last_iter=last_iter,
                                       num_workers=4), 6)
    want = _first_batches(JL.DataLoader(jds, jcfg, 2, 20, seed=4,
                                        last_iter=last_iter), 6)
    assert_same(got, want)
    one = _first_batches(PL.DataLoader(pds, pcfg, 2, 20, seed=4,
                                       last_iter=last_iter,
                                       num_workers=1), 6)
    assert_same(got, one)
    assert got[0]["points"].dtype == np.int16
    assert got[0]["points"].shape == (2, 3, 256, 7)


def test_eval_loader_in_order(stub_store):
    """train=False: the dataset in order, no augmentation, strided
    subsample."""
    pcfg, jcfg = _cfgs(max_points=256, yaw_aug_rad=1.0)
    got = _first_batches(PL.DataLoader(
        PD.KittiWindowDataset(pcfg, "val"), pcfg, 1, 0, train=False), 50)
    want = _first_batches(JL.DataLoader(
        JD.KittiWindowDataset(jcfg, "val"), jcfg, 1, 0, train=False), 50)
    assert_same(got, want)
    assert len(got) == N_FRAMES[1] - 1


def test_dequantize_points_bit_equal():
    rng = np.random.default_rng(7)
    pts = rng.normal(0, 30, (2, 500, 7)).astype(np.float32)
    pts[..., 3:] = np.clip(pts[..., 3:] / 30, -1, 1)
    q = PL.quantize_points(pts)
    assert_same(q, JL.quantize_points(pts))
    got = dequantize_points(tt(q))
    want = np.asarray(jax_dequantize(jnp.asarray(q)))
    assert got.dtype == torch.float32
    assert_same(got.numpy(), want)
    assert np.abs(got.numpy()[..., :3] - pts[..., :3]).max() <= \
        0.5 * PL.QUANT_POS_SCALE + 1e-6
    f = tt(pts)
    assert dequantize_points(f) is f


@pytest.fixture(scope="module")
def pillar_trees():
    """A pillar OdomNet's flax variables and the port net carrying
    them."""
    cfg = port_cfg("f32", middle_bn="bn")
    cfg = cfg.replace(middle=dataclasses.replace(cfg.middle,
                                                 name="PillarMiddleCov"))
    jnet = JaxOdomNet(cfg)
    L, V = 2, cfg.voxelizer.max_voxels
    ex = {"voxel_features": jnp.zeros((L, V, 7)),
          "num_points": jnp.zeros((L, V), jnp.int32),
          "coords": jnp.full((L, V, 3), -1, jnp.int32),
          "voxel_mask": jnp.zeros((L, V), bool)}
    variables = jax_variables(jnet, 0, ex, train=False)
    net = load_flax_variables(OdomNet(to_port(cfg)), variables)
    return variables, net


@pytest.mark.parametrize("include,exclude", [
    (None, None), ("bev_net", None), ("middle", "Dense"),
    (None, "Norm|bias"), ("kernel$", "bev_net/ConfidenceHead"),
    ("Conv2dBNRelu_1[01]", None), ("nothing-matches", None)])
def test_param_surgery_selects_the_same_leaves(pillar_trees, include,
                                               exclude):
    variables, net = pillar_trees
    for col, named in (("params", dict(net.named_parameters())),
                       ("batch_stats", dict(net.named_buffers()))):
        flat = PS.flatten(named, col)
        assert set(flat) == set(JS.flatten(variables[col]))
        got = PS.filter_params(flat, include, exclude)
        want = JS.filter_params(variables[col], include, exclude)
        assert sorted(got) == sorted(want), col
        mask = PS.freeze_mask(named, include or "^$")
        want_mask = JS.flatten(JS.freeze_mask(variables[col],
                                              include or "^$"))
        assert {k: v for k, v in zip(PS.flatten(named, col),
                                     (mask[n] for n in named))} == want_mask


def test_param_surgery_rename_and_load(pillar_trees):
    """rename_params keys, load_pretrained's loaded list (shape
    mismatches skipped or raised) and the copied values, against
    JAX's on the same trees."""
    variables, net = pillar_trees
    params = variables["params"]
    rename = {r"^middle/Conv2dBNRelu_(\d)/": r"middle/Block_\1/",
              r"Dense_(\d)": r"Head_\1"}
    got = PS.rename_params(PS.flatten(dict(net.named_parameters())),
                           rename)
    want = JS.flatten(JS.rename_params(params, rename))
    assert sorted(got) == sorted(want)

    # a "pretrained" tree: every leaf + 1, Dense_1's kernel reshaped
    src = jax.tree.map(lambda a: a + 1.0, params)
    src["middle"]["Dense_1"]["kernel"] = np.zeros((3, 3), np.float32)
    fresh = OdomNet(net.cfg)
    named = dict(fresh.named_parameters())
    src_port = {k: torch.from_numpy(np.array(v)) for k, v in
                PS.flatten({n: p.detach() + 1.0 for n, p in
                            net.named_parameters()}).items()}
    src_port["middle/Dense_1/kernel"] = torch.zeros(3, 3)
    for kw in (dict(include="middle"), dict(exclude="bev_net/Conv_")):
        loaded = PS.load_pretrained(PS.flatten(named), src_port,
                                    strict_shapes=False, **kw)
        _, want_loaded = JS.load_pretrained(params, src,
                                            strict_shapes=False, **kw)
        assert sorted(loaded) == sorted(want_loaded)
        assert "middle/Dense_1/kernel" not in loaded
        for k in loaded:
            assert torch.equal(PS.flatten(named)[k], src_port[k])
    with pytest.raises(ValueError, match="shape mismatch"):
        PS.load_pretrained(PS.flatten(named), src_port)
    with pytest.raises(ValueError, match="shape mismatch"):
        JS.load_pretrained(params, src)
