"""Rank processes for the data-parallel tests of the PyTorch port
(tests/test_torch_sync_bn.py, test_torch_dp_train.py,
test_torch_dp_eval.py, test_torch_sharded_pgo.py).

``run_ranks`` starts ``world`` fresh interpreters, one a rank, that run
a function of this module on the CPU with one thread each, in a gloo
group that meets at a ``file://`` rendezvous under the test's temporary
directory (the tests run side by side), and returns what each rank's
function returned.  A rank that fails, or a run that outlasts its
timeout (a hung collective), fails the test; every child is killed
before ``run_ranks`` returns.  This module imports torch and the port,
never JAX, so the children never load it.
"""
from __future__ import annotations

import os
import subprocess
import sys
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def run_ranks(fn: str, tmp_path, world: int = 2, timeout: float = TIMEOUT_S,
              env: dict | None = None, group: bool = True, **kwargs):
    """Run ``fn(mesh, **kwargs)`` of this module in ``world`` ranks (with
    ``group=False`` the function gets ``rank, world`` instead of a mesh
    and forms no group: it stands for a launcher's child).  ``env``
    entries are set in every child, and a ``{rank}`` in a value is the
    child's rank.  Returns the ranks' results in rank order."""
    tmp_path = str(tmp_path)
    rdv = f"file://{tmp_path}/rendezvous"
    procs, outs = [], []
    for rank in range(world):
        spec = os.path.join(tmp_path, f"spec{rank}.pt")
        out = os.path.join(tmp_path, f"out{rank}.pt")
        torch.save(dict(fn=fn, rank=rank, world=world, rdv=rdv,
                        group=group, kwargs=kwargs, out=out), spec)
        child_env = dict(os.environ, OMP_NUM_THREADS="1",
                         PYTHONPATH=os.pathsep.join(
                             [REPO, os.path.join(REPO, "tests")]))
        child_env.update({k: str(v).format(rank=rank)
                          for k, v in (env or {}).items()})
        code = ("import torch_dist_workers as w; "
                f"w._child({spec!r})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, env=child_env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{fn}: the ranks did not finish within "
                             f"{timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{fn} rank {rank}:\n{log[-6000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


def _child(spec_path: str):
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    try:
        fn = globals()[spec["fn"]]
        if not spec["group"]:
            result = fn(spec["rank"], spec["world"], **spec["kwargs"])
        else:
            import torch.distributed as dist

            from rslo_tpu_torch.train.distributed import (
                global_data_mesh, initialize_multihost)
            assert initialize_multihost(spec["rdv"], spec["world"],
                                        spec["rank"], device="cpu")
            try:
                result = fn(global_data_mesh("cpu"), **spec["kwargs"])
            finally:
                dist.destroy_process_group()
        torch.save(result, spec["out"])
    except BaseException:
        traceback.print_exc()
        sys.exit(1)


def _np(t):
    return t.detach().cpu().numpy().copy()


# -- the sync BNs (tests/test_torch_sync_bn.py) ---------------------------

def psum_grad(mesh, x):
    """L = sum(pmean(x * x)) on this rank's row of x; returns (L,
    dL/dx)."""
    from rslo_tpu_torch.utils.mesh_axis import bind_axis, pmean_if_present
    xt = torch.tensor(x[mesh.rank], requires_grad=True)
    with bind_axis("data", mesh.group, mesh.size):
        loss = torch.sum(pmean_if_present(xt * xt, "data"))
        loss.backward()
    return _np(loss), _np(xt.grad)


def sync_bn(mesh, cases):
    """Each case: (module kind, constructor keywords, state dict, this
    rank's input, mask (or None) and output cotangent).  Train mode, the
    "data" axis bound: L = sum(y * cot); returns per case y, the
    module's buffers after the step, dL/dx and dL/dparams by name."""
    from rslo_tpu_torch.models.bev_net import Norm
    from rslo_tpu_torch.models.middle import MaskedBatchNorm
    from rslo_tpu_torch.models.middle_dense import DenseMaskedBN
    from rslo_tpu_torch.models.semiglobal_bn import SemiGlobalSyncBN
    from rslo_tpu_torch.utils.mesh_axis import bind_axis
    kinds = {"norm": Norm, "semiglobal": SemiGlobalSyncBN,
             "masked": MaskedBatchNorm, "dense": DenseMaskedBN}
    out = {}
    for name, (kind, kw, state, x, mask, cot) in cases.items():
        m = kinds[kind](**kw)
        m.load_state_dict(state)
        m.train()
        xt = torch.tensor(x[mesh.rank], requires_grad=True)
        args = () if mask is None else (torch.tensor(mask[mesh.rank]),)
        with bind_axis("data", mesh.group, mesh.size):
            y = m(xt, *args)
            torch.sum(y * torch.tensor(cot[mesh.rank])).backward()
        out[name] = dict(y=_np(y),
                         stats={k: _np(v) for k, v in m.named_buffers()},
                         dx=_np(xt.grad),
                         dp={k: _np(p.grad) for k, p in
                             m.named_parameters()})
    return out


# -- the data-parallel train step and verb (test_torch_dp_train.py) -------

def train_steps(mesh, cfg_json, state, batches, alphas, steps):
    """``steps`` data-parallel train steps (post-warmup) from ``state``
    (the model's state dict) on this rank's batches; per step the
    metrics, every trainable and every buffer."""
    from rslo_tpu_torch.config.schema import PipelineCfg
    from rslo_tpu_torch.models.net import OdomNet
    from rslo_tpu_torch.train.loop import make_optimizer
    from rslo_tpu_torch.train.state import TrainState
    from rslo_tpu_torch.train.step import train_step
    cfg = PipelineCfg.from_json(cfg_json)
    net = OdomNet(cfg)
    net.load_state_dict(state)
    opt = make_optimizer(cfg, net)
    st = TrainState.create(net, opt, alphas)
    out = []
    for k in range(steps):
        batch = {key: torch.tensor(v[mesh.rank])
                 for key, v in batches[k].items()}
        st, metrics = train_step(st, batch, cfg, opt, warmup=False,
                                 mesh=mesh)
        out.append(dict(
            metrics={key: float(v) for key, v in metrics.items()},
            params={key: _np(p) for key, p in st.trainable().items()},
            stats={key: _np(b) for key, b in net.named_buffers()}))
    return out


def train_verb(rank, world, argv):
    """The ``train`` verb as a launcher's child runs it (the group comes
    from the environment); returns the raw points of each step's batch
    and the rank's history."""
    from rslo_tpu_torch import cli
    from rslo_tpu_torch.train import loop
    seen, fits = [], []
    step, fit = loop.train_step, loop.Trainer.fit

    def recording(state, batch, *a, **k):
        seen.append(_np(batch["points"]))
        return step(state, batch, *a, **k)

    def recording_fit(self, *a, **k):
        fits.append(self)
        return fit(self, *a, **k)

    loop.train_step, loop.Trainer.fit = recording, recording_fit
    state = cli.main(argv)
    params = {k: _np(v) for k, v in state.model.state_dict().items()}
    return dict(points=seen, history=fits[0].history, params=params,
                step=state.step)


# -- rank-sharded evaluation (test_torch_dp_eval.py) ----------------------

def evaluate(mesh, cfg_json, model_dir, runs):
    """``eval_runs`` over the mesh, each rank in its own model dir."""
    from rslo_tpu_torch.config.schema import PipelineCfg
    return eval_runs(PipelineCfg.from_json(cfg_json),
                     f"{model_dir}/rank{mesh.rank}", runs, mesh)


def eval_runs(cfg, model_dir, runs, mesh=None):
    """Each run: (name, "plain" or "refined", windows, keywords) through
    ``run_eval`` / ``run_eval_refined`` on the synthetic split with the
    seeded initial net of a CPU ``Trainer``, over ``mesh`` (None: this
    process alone, the reference)."""
    import dataclasses

    from rslo_tpu_torch.cli import _synthetic_dataset
    from rslo_tpu_torch.eval.runner import run_eval, run_eval_refined
    from rslo_tpu_torch.train.loop import Trainer
    trainer = Trainer(cfg, model_dir, device="cpu", mesh=mesh)
    trainer.init_state()
    out = {}
    for name, kind, windows, kw in runs:
        if kind == "plain":
            ds = _synthetic_dataset(cfg, "val", n_windows=windows)
            out[name] = run_eval(trainer.eval_fn(), ds, cfg, None,
                                 mesh=mesh)
        else:
            cfg3 = cfg.replace(data=dataclasses.replace(cfg.data,
                                                        seq_length=3))
            ds = _synthetic_dataset(cfg3, "train", n_windows=windows)
            cov = (trainer.eval_fn(with_cov=True) if kw.get("use_ba")
                   else None)
            out[name] = run_eval_refined(trainer.eval_fn(), ds, cfg, None,
                                         eval_step_cov=cov, mesh=mesh,
                                         **kw)
    trainer.logger.close()
    return out


# -- the sharded pose graph and BA (test_torch_sharded_pgo.py) ------------

def fuse_sharded(mesh, E, M, n, W, kw):
    from rslo_tpu_torch.pgo.sharded import fuse_windows_sharded
    return fuse_windows_sharded(E, M, n, W, mesh=mesh, device="cpu", **kw)


def ba_sharded(mesh, shards, iters):
    """This rank's shard of a BA problem (numpy fields of
    ``BAProblem``) -> (poses, every landmark, cost)."""
    from rslo_tpu_torch.pgo.ba import BAProblem, solve_ba_sharded
    prob = BAProblem(*(torch.tensor(np.asarray(f))
                       for f in shards[mesh.rank]))
    poses, lms, cost = solve_ba_sharded(prob, mesh, iters=iters)
    return _np(poses), _np(lms), float(cost)


# -- the split BEV stage (test_torch_spatial.py) ----------------------------

def bev_splits(mesh, nets, examples, cases, halo, grad):
    """Each case: (name, net key, example key, grid (space, model), axes
    ("space", "model" or both), train).  ``nets`` maps a key to (config
    JSON, state dict), ``examples`` to numpy arrays.  Builds the 4 x 1
    and 2 x 2 grids of the 4 ranks, runs each case's split forward
    (``parallel/``) under no_grad, and returns per case the outputs (and
    in train mode the BEV net's buffers after it); plus ``halo``'s
    cases: (name, NCHW input, conv weight, kernel, stride) as a stride-k
    conv through ``bev_net._conv`` on this rank's columns of a 4-rank
    width split; ``halo_refusal``: the ValueError's message of a halo
    wider than some ranks' share; and ``grad``: L = sum(gather(x_r) * grad[r]) over the
    4-rank space axis with x_r = r, its gather and dL/dx_r."""
    from rslo_tpu_torch.config.schema import PipelineCfg
    from rslo_tpu_torch.models import bev_net
    from rslo_tpu_torch.models.net import OdomNet
    from rslo_tpu_torch.parallel.spatial import (_active, _Split,
                                                 bev_constraint,
                                                 make_spatial_forward)
    from rslo_tpu_torch.parallel.tensor import (make_model_forward,
                                                make_spatial_model_forward)
    from rslo_tpu_torch.utils.mesh_axis import (all_gather_if_present,
                                                bind_axis, grid_mesh)
    grids = {(4, 1): grid_mesh(4, 1), (2, 2): grid_mesh(2, 2)}
    makers = {("space",): make_spatial_forward,
              ("model",): make_model_forward,
              ("space", "model"): make_spatial_model_forward}
    out = {}
    for name, key, ex_key, grid, axes, train in cases:
        cfg_json, state = nets[key]
        net = OdomNet(PipelineCfg.from_json(cfg_json))
        net.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
        fwd = makers[tuple(axes)](net, grids[tuple(grid)], train=train)
        ex = {k: torch.tensor(v) for k, v in examples[ex_key].items()}
        with torch.no_grad():
            preds = fwd(ex)
        res = {k: _np(preds[k].float()) for k in (
            "odometry", "tq_map", "t_conf", "q_conf", "input_mask")}
        res["pyramid"] = [(_np(a.float()), _np(b.float()))
                          for a, b in preds["pyramid"]]
        if train:
            res["buffers"] = {k: _np(v) for k, v in
                              net.bev_net.named_buffers()}
        out[name] = res
    g = grids[(4, 1)]
    for name, x, w, k, s in halo:
        conv = torch.nn.Conv2d(w.shape[1], w.shape[0], k, s, bias=False)
        conv.weight.data = torch.tensor(w)
        x = torch.tensor(x)
        split = _Split(True, False, 8)
        with bind_axis("space", g.space_group, g.space, g.space_index), \
                _active(split):
            local = bev_constraint(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            out[name] = dict(y=_np(bev_net._conv(conv, local)),
                             pool=_np(bev_net.max_pool_mask(
                                 local[:, :1], k, s)),
                             widths=split.widths)
    # a 7 x 7 gate (halo 3) at the stride-4 level of the 16/16/8/8 split,
    # 4/4/2/2 columns: every rank raises, those holding 4 too, before
    # any collective (a rank left in it would hang)
    with bind_axis("space", g.space_group, g.space, g.space_index), \
            _active(_Split(True, False, 8)):
        local = bev_constraint(torch.zeros(1, 2, 48, 1))
        try:
            bev_net._pad_same(torch.zeros(1, 1, 2, local.shape[2] // 4), 7, 1)
            out["halo_refusal"] = None
        except ValueError as e:
            out["halo_refusal"] = str(e)
    x = torch.full((3,), float(g.space_index), requires_grad=True)
    with bind_axis("space", g.space_group, g.space, g.space_index):
        y = all_gather_if_present(x, "space")
        torch.sum(y * torch.tensor(grad[g.space_index])).backward()
    out["grad"] = dict(gathered=_np(y), dx=_np(x.grad))
    return out
