"""The port's data-parallel training (train/distributed.py, the
data-parallel ``train_step``, ``Trainer`` and the ``train`` verb over a
process group) against the JAX package's ``make_train_step`` on a
2-device mesh, on the CPU.

Two gloo ranks (tests/torch_dist_workers.py) take two post-warmup steps
at the tiny f32 config with ``sync_bn`` in the middle's encoder, each
on a sample of its own, from JAX's (perturbed)
initial variables; JAX's step sees the same two samples as its
device batch.  Each step's loss terms and ``grad_norm``, the parameters
and the BN statistics after it are held to tests/test_torch_train_step
.py's tolerances, and the two replicas are bit-equal after every step.
Then the ``train`` verb in two ranks launched as ``torchrun`` launches
them: one checkpoint and one event stream (rank 0's), and each rank
trains on JAX device r's rows of the 2-sample batches.  Last, how
``initialize_multihost`` reads SLURM's and torchrun's environment,
checked without forming a group."""
import dataclasses
import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from torch_dist_workers import run_ranks
from torch_port_helpers import jax_variables, port_cfg, tiny_scans, to_port
from test_torch_train_step import (LOSS_TOL, PARAM_ATOL, STAT_TOL, _flat,
                                   _get, pallas_nn_search)

import rslo_tpu.losses.consistency as jax_consistency
from rslo_tpu.cli import _synthetic_dataset as jax_synthetic
from rslo_tpu.data.loader import DataLoader as JaxLoader
from rslo_tpu.data.prepare import prepare_example as jax_prepare
from rslo_tpu.data.prepare import voxelizer_config as jax_vcfg
from rslo_tpu.models.net import OdomNet as JaxOdomNet
from rslo_tpu.train import optim as jax_optim
from rslo_tpu.train.state import TrainState as JaxTrainState
from rslo_tpu.train.step import make_train_step
from rslo_tpu_torch.convert import flax_path, load_flax_variables, to_flax_leaf
from rslo_tpu_torch.models.net import OdomNet
from rslo_tpu_torch.train import optim
from rslo_tpu_torch.train.distributed import (Rendezvous, initialize_multihost,
                                              resolve_rendezvous)

D = 2
L = 3
N_STEPS = 2
ALPHAS = {"rot": -2.5, "trans": 0.0}
STAT_DRIFT = 1e-4


def dp_cfg():
    """tests/test_torch_train_step.py's step config (weight decay 10, so
    a wrong decay mask shows) with ``sync_bn`` in the middle's encoder.
    Its BEV net has no BN, as there: train-mode BN over the tiny BEV
    makes the BEV gradients ill-conditioned in both frameworks (with the
    BEV net's ``sync_bn`` the two sides' ``grad_norm`` of ~375 differ by
    2e-4 of it, above the step's bound), which would hide a real fault;
    tests/test_torch_sync_bn.py holds the BEV ``Norm``'s cross-rank
    statistics and gradients on their own."""
    cfg = port_cfg("f32", middle_bn="sync_bn")
    return cfg.replace(
        odom=dataclasses.replace(cfg.odom, bn_type="none"),
        optimizer=dataclasses.replace(cfg.optimizer, weight_decay=10.0),
        train=dataclasses.replace(cfg.train, steps=40))


def _batches():
    """N_STEPS device batches of D samples: (D, L, N, F) points."""
    out = []
    for k in range(N_STEPS):
        rows = []
        for r in range(D):
            rng = np.random.default_rng(20 + 2 * k + r)
            odom = np.zeros((L * (L - 1) // 2, 7), np.float32)
            odom[:, :3] = rng.normal(0, 0.05, (len(odom), 3))
            odom[:, 3] = 1.0
            scans = tiny_scans(20 + 2 * k + r, L)
            rows.append({"points": np.stack(scans),
                         "point_mask": np.ones((L, len(scans[0])), bool),
                         "odometry": odom})
        out.append({key: np.stack([row[key] for row in rows])
                    for key in rows[0]})
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    cfg = dp_cfg()
    batches = _batches()
    jnet = JaxOdomNet(cfg)
    ex = jax_prepare(jnp.asarray(batches[0]["points"][0]),
                     jnp.asarray(batches[0]["point_mask"][0]),
                     jax_vcfg(cfg), mean_mode=True)
    ex["odometry"] = jnp.asarray(batches[0]["odometry"][0])
    variables = jax_variables(jnet, 0, ex, train=False)
    tx = jax_optim.build_optimizer(cfg.optimizer, cfg.train)
    mesh = Mesh(np.array(jax.devices()[:D]), ("data",))
    # placed as JAX's Trainer places them, so the step compiles once
    state = jax.device_put(
        JaxTrainState.create(jax.tree.map(jnp.asarray, variables), tx,
                             ALPHAS), NamedSharding(mesh, P()))
    want = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_consistency, "nn_search", pallas_nn_search)
        step = make_train_step(jnet, tx, cfg, mesh, warmup=False)
        for b in batches:
            state, aux = step(state, jax.device_put(
                b, NamedSharding(mesh, P("data"))))
            want.append(jax.tree.map(np.asarray, dict(
                aux=aux, params=state.params, alphas=state.alphas,
                stats=state.batch_stats)))

    pcfg = to_port(cfg)
    net = load_flax_variables(OdomNet(pcfg), variables)
    got = run_ranks("train_steps", tmp_path_factory.mktemp("dp_train"),
                    cfg_json=pcfg.to_json(), state=net.state_dict(),
                    batches=batches, alphas=ALPHAS, steps=N_STEPS)
    return want, got


def test_replicas_stay_bit_equal(steps):
    _, got = steps
    for k in range(N_STEPS):
        for part in ("params", "stats", "metrics"):
            a, b = got[0][k][part], got[1][k][part]
            assert list(a) == list(b)
            for name in a:
                np.testing.assert_array_equal(a[name], b[name],
                                              err_msg=(k, part, name))


def test_loss_terms_and_grad_norm_match_jax(steps):
    want, got = steps
    for k in range(N_STEPS):
        aux, metrics = want[k]["aux"], got[0][k]["metrics"]
        assert set(metrics) == set(aux)
        for key, val in aux.items():
            np.testing.assert_allclose(metrics[key], val, err_msg=(k, key),
                                       **LOSS_TOL)
        assert aux["consistency_loss"] != 0.0
    # the averaged gradients' norm passes the clip at 10 at step 1
    assert want[0]["aux"]["grad_norm"] > 10.0


def test_params_and_statistics_match_jax(steps):
    """Adam moves each entry by ~lr a step, so where the two sides'
    gradients agree the parameters agree to PARAM_ATOL; an entry whose
    gradient is f32 noise around zero (a conv bias a train-mode BN
    follows) moves by up to lr either way, so fewer than 2% of the
    entries may differ by up to 2 * sum(lr)
    (tests/test_torch_train_step.py's rule).  The statistics after step
    1 are held to STAT_TOL (observed 1.8e-7 of each array's largest
    value); step 2's read the parameters step 1 moved, noise-driven
    entries included (such a bias shifts the batch mean of the BN after
    its conv by as much), so they are held to STAT_DRIFT of each array's
    largest value (observed 2.2e-5)."""
    want, got = steps
    lr = optim.onecycle_lr(to_port(dp_cfg()).optimizer, dp_cfg().train.steps)
    for k in range(N_STEPS):
        lr_sum = sum(float(lr(i)) for i in range(k + 1))
        ref = {"params": want[k]["params"], "alphas": want[k]["alphas"]}
        n_loose = n_all = 0
        for name, p in got[0][k]["params"].items():
            if name.startswith("alphas."):
                path = ("alphas", name.split(".", 1)[1])
            else:
                path = ("params",) + flax_path(name, p.ndim)[1]
            err = np.abs(to_flax_leaf(name, torch.from_numpy(p)) -
                         _get(ref, path))
            assert (err <= 2 * lr_sum).all(), (k + 1, name, err.max())
            n_loose += int(np.sum(err > PARAM_ATOL))
            n_all += err.size
        assert n_loose < 0.02 * n_all, (k + 1, n_loose, n_all)
        paths = {p for p, _ in _flat(want[k]["stats"])}
        for name, b in got[0][k]["stats"].items():
            col, path = flax_path(name, b.ndim)
            assert col == "batch_stats" and path in paths
            stat = _get(want[k]["stats"], path)
            tol = STAT_TOL if k == 0 else dict(
                rtol=0, atol=STAT_DRIFT * float(np.abs(stat).max()))
            np.testing.assert_allclose(b, stat, err_msg=(k + 1, name), **tol)
        assert len(paths) == len(got[0][k]["stats"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_verb_over_two_ranks(tmp_path):
    """The verb as ``torchrun --nproc_per_node 2`` runs it: every rank
    trains on its row of JAX's 2-sample batches, the eval hook runs over
    both ranks, and rank 0 alone writes the checkpoint, the logs and the
    event stream."""
    base = port_cfg("f32", middle_bn="sync_bn")
    cfg = base.replace(
        data=dataclasses.replace(base.data, max_points=4096),
        train=dataclasses.replace(base.train, steps_per_eval=2,
                                  display_step=1))
    (tmp_path / "cfg.json").write_text(to_port(cfg).to_json())
    model = tmp_path / "model"
    argv = ["train", "--config", str(tmp_path / "cfg.json"), "--model_dir",
            str(model), "--synthetic", "--steps", "2", "--device", "cpu"]
    env = dict(RANK="{rank}", LOCAL_RANK="{rank}", WORLD_SIZE=D,
               MASTER_ADDR="127.0.0.1", MASTER_PORT=_free_port())
    (tmp_path / "ranks").mkdir()
    got = run_ranks("train_verb", tmp_path / "ranks", group=False, env=env,
                    argv=argv)
    loader = JaxLoader(jax_synthetic(cfg, "train"), cfg.data, D,
                       cfg.train.steps, train=True, seed=cfg.train.seed)
    try:
        jax_batches = [next(iter(loader)) for _ in range(2)]
    finally:
        loader.close()
    for r in range(D):
        assert got[r]["step"] == 2 and len(got[r]["points"]) == 2
        for k in range(2):
            np.testing.assert_array_equal(got[r]["points"][k],
                                          jax_batches[k]["points"][r])
        for name, v in got[0]["params"].items():
            np.testing.assert_array_equal(got[r]["params"][name], v)
        assert [s for s, _ in got[r]["history"]] == [1, 2]
    assert sorted(p.name for p in (model / "ckpt").iterdir()) == \
        ["step_2.pt"]
    assert len(list((model / "tb").iterdir())) == 1
    log = (model / "log.txt").read_text()
    assert log.count("model initialized") == 1
    assert len((model / "log.json.lst").read_text().splitlines()) == 3
    assert json.loads((model / "best_ckpt.json").read_text())["step"] == 2


def test_initialize_multihost_resolution(monkeypatch):
    """Explicit arguments, then SLURM (more than one task; JAX's parse of
    the head node, port 8898), then torchrun's variables (any world
    size), else no group; nothing is formed here."""
    assert resolve_rendezvous({}) is None
    assert resolve_rendezvous({"SLURM_NTASKS": "1", "SLURM_PROCID": "0"}) \
        is None
    slurm = {"SLURM_NTASKS": "4", "SLURM_NODELIST": "gpu[03-06],gpu9",
             "SLURM_PROCID": "2", "SLURM_LOCALID": "1"}
    assert resolve_rendezvous(slurm) == Rendezvous("tcp://gpu03:8898", 4,
                                                   2, 1)
    torchrun = {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
                "MASTER_ADDR": "10.1.2.3", "MASTER_PORT": "29500"}
    assert resolve_rendezvous(torchrun) == Rendezvous(
        "tcp://10.1.2.3:29500", 2, 1, 1)
    one = dict(torchrun, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    assert resolve_rendezvous(one) == Rendezvous("tcp://10.1.2.3:29500", 1,
                                                 0, 0)
    # SLURM before torchrun; explicit arguments before both
    assert resolve_rendezvous({**torchrun, **slurm}).init_method == \
        "tcp://gpu03:8898"
    assert resolve_rendezvous({**torchrun, **slurm}, "file:///tmp/r", 3,
                              0) == Rendezvous("file:///tmp/r", 3, 0, 1)
    with pytest.raises(ValueError, match="num_processes"):
        resolve_rendezvous({}, "host:1")
    for k in ("RANK", "WORLD_SIZE", "SLURM_NTASKS"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost(device="cpu") is False
    assert not dist.is_initialized()


def test_chip_smoke_tiny_config_is_this_config():
    """chip_smoke.py's phase 23c runs the data-parallel step on the card
    and the CPU at this file's config, built there in the port's schema
    (the script imports no JAX)."""
    import chip_smoke
    from rslo_tpu_torch.config.schema import PipelineCfg
    assert chip_smoke.tiny_config(PipelineCfg).to_json() == \
        to_port(dp_cfg()).to_json()


def test_single_process_mesh():
    """With no group the data mesh is this process alone: rank 0 of 1 on
    the given device, and the host's batch is this rank's."""
    from rslo_tpu_torch.train.distributed import (
        global_data_mesh, host_local_batch_to_global, is_rank0,
        local_device_count)
    mesh = global_data_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    assert mesh.device == torch.device("cpu")
    assert is_rank0() and local_device_count() == 1
    batch = {"points": np.ones((2, 3), np.float32), "meta": [(0, ())]}
    got = host_local_batch_to_global(batch, mesh)
    assert list(got) == ["points"] and got["points"].shape == (2, 3)
