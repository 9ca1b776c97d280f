"""The port's ``train`` verb end to end on the CPU (``--device cpu``,
``--synthetic``) at the tiny test config with the pillar middle and the
accuracy recipe's data path (random stride, flip, yaw and pose
interpolation, int16 transfer): two legs resumed from a checkpoint
against one uninterrupted run (the same windows; the augmentation draws
of a loader count its fetches from its own start, in the JAX package
too, so the second leg's batches are those of a loader made at
``last_iter``), the periodic eval's best checkpoint and
its preserved copy, ``evaluate --ckpt_step best`` after the best step
was pruned, and a rulebook run warm-started from the pillar run's
``bev_net`` (as tests/test_warmstart.py does across middles in JAX)."""
import dataclasses
import itertools
import json
import shutil

import numpy as np
import pytest
import torch

from torch_port_helpers import port_cfg, to_port

from rslo_tpu_torch import cli
from rslo_tpu_torch.data import loader as PL
from rslo_tpu_torch.train import loop
from rslo_tpu_torch.train.checkpoint import CheckpointManager

STEPS, LEG, EVAL_EVERY = 4, 2, 2


def _cfg(middle="PillarMiddleCov", **train):
    cfg = port_cfg("bf16")
    return to_port(cfg.replace(
        middle=dataclasses.replace(cfg.middle, name=middle),
        data=dataclasses.replace(
            cfg.data, skip=2, random_skip=True, pose_interp_ratio=0.5,
            yaw_aug_rad=float(np.pi), max_points=4096,
            quantize_transfer=True),
        loss=dataclasses.replace(cfg.loss, warmup_steps=1, icp_iter=6),
        train=dataclasses.replace(cfg.train, steps_per_eval=EVAL_EVERY,
                                  **train)))


def _train(cfg_path, model_dir, *extra):
    return cli.main(["train", "--config", str(cfg_path), "--model_dir",
                     str(model_dir), "--synthetic", "--device", "cpu",
                     *extra])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The pillar recipe trained to STEPS twice: in two legs (stopped
    at LEG, then resumed) and in one run that keeps 1 checkpoint; the
    batches each run's train steps saw and the windows its loader
    fetched."""
    root = tmp_path_factory.mktemp("train_cli")
    (root / "cfg.json").write_text(_cfg().to_json())
    (root / "cfg_keep1.json").write_text(
        _cfg(checkpoint_max_keep=1).to_json())
    seen = {"legs": [], "whole": []}
    fetched = {"legs": [], "whole": []}
    key = {}
    made = itertools.count()
    step, fetch = loop.train_step, PL.DataLoader._fetch_one
    init = PL.DataLoader.__init__

    def recording(state, batch, *a, **k):
        seen[key["run"]].append(batch["points"].cpu().numpy().copy())
        return step(state, batch, *a, **k)

    def numbered_init(self, *a, **k):
        # numbered before the loader's thread starts fetching
        self._made_no = next(made)
        init(self, *a, **k)

    def recording_fetch(self, idx, seq_no=0):
        # fetches run on the loader's thread pool, so they land here in
        # thread order: keep the loader and its stream position
        fetched[key["run"]].append((self._made_no, seq_no, idx))
        return fetch(self, idx, seq_no)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "train_step", recording)
        mp.setattr(PL.DataLoader, "__init__", numbered_init)
        mp.setattr(PL.DataLoader, "_fetch_one", recording_fetch)
        key["run"] = "legs"
        first = _train(root / "cfg.json", root / "legs", "--steps",
                       str(STEPS), "--leg_until", str(LEG))
        last = _train(root / "cfg.json", root / "legs", "--steps",
                      str(STEPS))
        key["run"] = "whole"
        whole = _train(root / "cfg_keep1.json", root / "whole", "--steps",
                       str(STEPS))
    # each loader's windows in its stream order, the loaders in the
    # order they were made
    fetched = {run: [idx for _, _, idx in sorted(rec)]
               for run, rec in fetched.items()}
    return dict(root=root, seen=seen, fetched=fetched,
                steps=(first.step, last.step, whole.step))


def _loader_batches(last_iter, n):
    """The first n batches of the train verb's loader made at
    ``last_iter`` (the synthetic train split of the recipe)."""
    cfg = _cfg()
    loader = PL.DataLoader(cli._synthetic_dataset(cfg, "train"), cfg.data,
                           1, STEPS, seed=cfg.train.seed,
                           last_iter=last_iter)
    out = []
    for b in loader:
        out.append(b["points"][0])
        if len(out) == n:
            break
    loader.close()
    return out


def test_legs_resume_the_run(runs):
    """The second leg resumes at the checkpoint and at the window where
    the first stopped: both runs train on the same windows; the first
    leg's batches are the uninterrupted run's, the second leg's those of
    a loader made at last_iter = LEG - 1."""
    assert runs["steps"] == (LEG, STEPS, STEPS)
    legs, whole = runs["seen"]["legs"], runs["seen"]["whole"]
    assert len(legs) == len(whole) == STEPS
    assert legs[0].dtype == np.int16              # the int16 transfer
    for a, b in zip(legs[:LEG], whole[:LEG]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(legs[LEG:], _loader_batches(LEG - 1, STEPS - LEG)):
        np.testing.assert_array_equal(a, b)
    # the windows trained on (each loader fetches ahead of the steps)
    f_legs, f_whole = runs["fetched"]["legs"], runs["fetched"]["whole"]
    n_first = f_legs.index(f_whole[LEG], LEG)
    assert f_legs[:LEG] == f_whole[:LEG]
    assert f_legs[n_first:n_first + STEPS - LEG] == f_whole[LEG:STEPS]
    root = runs["root"]
    got = torch.load(root / "legs" / "ckpt" / f"step_{STEPS}.pt",
                     weights_only=False)
    assert got["step"] == STEPS and got["opt_state"]["count"] == STEPS
    log = (root / "legs" / "log.txt").read_text()
    assert f"restored checkpoint at step {LEG}" in log
    assert f"done at step {LEG}" in log and f"done at step {STEPS}" in log


def test_best_checkpoint_written_and_preserved(runs):
    for run in ("legs", "whole"):
        d = runs["root"] / run
        best = json.loads((d / "best_ckpt.json").read_text())
        assert best["step"] in range(EVAL_EVERY, STEPS + 1, EVAL_EVERY)
        assert best["metric_name"] in ("t_rel_pct", "frame_t_err_m")
        kept = sorted(p.name for p in (d / "ckpt_best").iterdir())
        assert kept == [f"step_{best['step']}.pt"]
        evals = [json.loads(line) for line in
                 (d / "log.json.lst").read_text().splitlines()
                 if "eval/frame_t_err_m" in line]
        assert [e["step"] for e in evals] == [2, 4]
    # the run that keeps one checkpoint pruned every step but the last
    assert sorted(p.name for p in (runs["root"] / "whole" / "ckpt")
                  .glob("step_*.pt")) == [f"step_{STEPS}.pt"]


def test_evaluate_best_after_pruning(runs, tmp_path):
    """evaluate --ckpt_step best reads the best step from ckpt_best/
    when ckpt/ no longer holds it."""
    d = tmp_path / "run"
    shutil.copytree(runs["root"] / "whole", d)
    best = json.loads((d / "best_ckpt.json").read_text())["step"]
    (d / "ckpt" / f"step_{best}.pt").unlink(missing_ok=True)
    res = cli.main(["evaluate", "--config",
                    str(runs["root"] / "cfg_keep1.json"), "--model_dir",
                    str(d), "--synthetic", "--max_windows", "3",
                    "--ckpt_step", "best", "--device", "cpu"])
    assert res["_meta"]["windows"] == 3
    assert np.isfinite(res["avg"]["frame_t_err_m"])
    assert f"restored checkpoint at step {best}" in (d / "log.txt"
                                                      ).read_text()


def test_checkpoint_restore_falls_back_to_best(tmp_path):
    """max_to_keep=1 prunes step 1; preserve(1) kept it in ckpt_best/,
    and restore(step=1) reads it from there."""
    cfg = _cfg(checkpoint_max_keep=1)
    tr = loop.Trainer(cfg, str(tmp_path), device="cpu")
    state = tr.init_state()
    state.step = 1
    tr.ckpt.save(1, state)
    tr.ckpt.preserve(1)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    state.step = 2
    tr.ckpt.save(2, state)
    assert tr.ckpt.all_steps() == [2]
    back = tr.ckpt.restore(state, step=1)
    assert back.step == 1
    for k, v in want.items():
        assert torch.equal(back.model.state_dict()[k], v), k
    tr.ckpt.preserve(2)
    assert sorted(p.name for p in (tmp_path / "ckpt_best").iterdir()) == [
        "step_2.pt"]
    raw = CheckpointManager.restore_raw_from(str(tmp_path))
    assert raw["step"] == 2
    tr.logger.close()


def test_warm_start_rulebook_from_pillar(runs, tmp_path):
    """--pretrained with --pretrained_include bev_net: at step 0 every
    bev_net tensor (parameters and BN statistics) is the pillar run's
    and the loss alphas too; the sparse middle keeps its seeded init."""
    root = runs["root"]
    (tmp_path / "cfg.json").write_text(_cfg("SparseMiddleCov").to_json())
    start = {}
    fit = loop.Trainer.fit

    def recording_fit(self, batches, state, **kw):
        start["model"] = {k: v.clone() for k, v in
                          state.model.state_dict().items()}
        start["alphas"] = {k: v.detach().clone()
                           for k, v in state.alphas.items()}
        return fit(self, batches, state, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop.Trainer, "fit", recording_fit)
        _train(tmp_path / "cfg.json", tmp_path / "warm", "--steps", "1",
               "--pretrained", str(root / "legs"),
               "--pretrained_include", "bev_net")
    pillar = CheckpointManager.restore_raw_from(str(root / "legs"))
    fresh = loop.Trainer(_cfg("SparseMiddleCov"), str(tmp_path / "fresh"),
                         device="cpu")
    seeded = fresh.init_state().model.state_dict()
    fresh.logger.close()
    bev = [k for k in start["model"] if k.startswith("bev_net.")]
    assert len(bev) > 50
    for k in bev:
        assert torch.equal(start["model"][k], pillar["model"][k]), k
    assert any(not torch.equal(seeded[k], pillar["model"][k]) for k in bev)
    middle = [k for k in start["model"] if k.startswith("middle.")]
    assert middle and not set(middle) & set(pillar["model"])
    for k in middle:
        assert torch.equal(start["model"][k], seeded[k]), k
    for k, v in pillar["alphas"].items():
        assert torch.equal(start["alphas"][k], v), k
    log = (tmp_path / "warm" / "log.txt").read_text()
    n_params = sum(1 for k in bev if not k.endswith((".mean", ".var")))
    assert f"warm-started {n_params} param + {len(bev) - n_params} stat" \
        in log
