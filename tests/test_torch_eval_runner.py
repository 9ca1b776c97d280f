"""Port run_eval (rslo_tpu_torch.eval.runner), Trainer.fit's eval hook
and the CLI evaluate verb (rslo_tpu_torch.cli) against the JAX package:
JAX's run_eval on a one-device mesh and the port's, in float32, on the
synthetic val split of tests/test_eval_runner.py::test_run_eval_plain
(10 windows) with the same weights."""
import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torch_port_helpers import (assert_same, jax_variables, port_cfg,
                                to_jax, to_port)

from rslo_tpu.cli import _synthetic_dataset as jax_synthetic
from rslo_tpu.data.loader import collate as jax_collate
from rslo_tpu.data.prepare import prepare_example as jax_prepare
from rslo_tpu.data.prepare import voxelizer_config as jax_vcfg
from rslo_tpu.eval.runner import run_eval as jax_run_eval
from rslo_tpu.models.net import OdomNet as JaxOdomNet
from rslo_tpu.train.step import make_eval_step
from rslo_tpu_torch.cli import _synthetic_dataset, main, \
    update_best_checkpoint
from rslo_tpu_torch.convert import load_flax_variables
from rslo_tpu_torch.data.loader import collate
from rslo_tpu_torch.eval.runner import run_eval
from rslo_tpu_torch.models.net import OdomNet
from rslo_tpu_torch.train.loop import Trainer
from rslo_tpu_torch.train.step import eval_step

# tests/test_torch_net_streaming.py's f32 tolerance: sum order only
TOL = dict(rtol=1e-5, atol=1e-5)
N_WINDOWS = 10
# _meta's clock readings differ from run to run
CLOCK = ("elapsed_s", "frames_per_s")


def eval_cfg():
    cfg = port_cfg("f32")
    return cfg.replace(data=dataclasses.replace(cfg.data, seq_length=2,
                                                max_points=4096))


class Recorder:
    """An eval step that keeps what it returns, as numpy."""

    def __init__(self, step):
        self.step, self.outs = step, []

    def __call__(self, *args):
        out = self.step(*args)
        self.outs.append(np.asarray(out.numpy() if isinstance(
            out, torch.Tensor) else out))
        return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's and the port's run_eval on the same windows and weights,
    with the per-window odometry each eval step returned."""
    cfg = eval_cfg()
    jds = jax_synthetic(cfg, "val", n_windows=N_WINDOWS)
    jnet = JaxOdomNet(cfg)
    b0 = jax_collate([jds[0]], cfg.data)
    ex0 = jax_prepare(jnp.asarray(b0["points"][0]),
                      jnp.asarray(b0["point_mask"][0]), jax_vcfg(cfg),
                      mean_mode=True)
    variables = jax_variables(jnet, 0, ex0, train=False)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jstep = Recorder(make_eval_step(jnet, cfg, mesh))
    want = jax_run_eval(jnet, to_jax(variables), jds, cfg, mesh, jstep,
                        max_windows=N_WINDOWS)
    pcfg = to_port(cfg)
    net = load_flax_variables(OdomNet(pcfg), variables)
    pstep = Recorder(functools.partial(eval_step, net, cfg=pcfg,
                                       device="cpu"))
    plots = tmp_path_factory.mktemp("plots")
    got = run_eval(pstep, _synthetic_dataset(pcfg, "val", N_WINDOWS), pcfg,
                   max_windows=N_WINDOWS, plot_dir=str(plots))
    return dict(cfg=cfg, want=want, got=got, jax_odom=np.stack(jstep.outs),
                odom=np.stack(pstep.outs), plots=plots, variables=variables)


def test_run_eval_odometry_matches_jax(runs):
    assert runs["odom"].shape == runs["jax_odom"].shape == (N_WINDOWS, 1,
                                                             1, 7)
    np.testing.assert_allclose(runs["odom"], runs["jax_odom"], **TOL)


def test_run_eval_keys_match_jax(runs):
    def keys(d):
        return {k: keys(v) if isinstance(v, dict) and k != "segments"
                and k != "speed_bins" else None for k, v in d.items()}
    assert keys(runs["got"]) == keys(runs["want"])
    assert runs["got"]["_meta"]["windows"] == N_WINDOWS
    assert list(runs["got"]) == ["_meta", "seq_00", "avg"]


def _without_clock(res):
    return {k: ({m: v for m, v in d.items() if m not in CLOCK}
                if k == "_meta" else d) for k, d in res.items()}


def test_metric_pipeline_bit_equal_on_jax_predictions(runs):
    """The port's run_eval fed JAX's per-window odometry gives JAX's
    results exactly (all but the clock)."""
    pcfg = to_port(runs["cfg"])
    preds = iter(runs["jax_odom"])
    got = run_eval(lambda batch: torch.from_numpy(next(preds)),
                   _synthetic_dataset(pcfg, "val", N_WINDOWS), pcfg,
                   max_windows=N_WINDOWS)
    assert_same(_without_clock(got), _without_clock(runs["want"]))
    assert got["_meta"]["frames_per_s"] > 0


def test_frame_errors_match_jax(runs):
    """The port's own per-frame errors against JAX's.  Each odometry
    component is within a = atol + rtol * |x| of JAX's, so the mean
    translation error moves by at most sqrt(3) * max a; for the rotation,
    2 * acos(|<p, g>| / |p|) is twice the angle between unit
    quaternions, a metric, so it moves by at most 4 * asin(|dp| / 2)
    with |dp| <= 2 * 2 * max a (4 components, then the normalization by
    |p| ~ 1), plus the float32 rounding of the cosine before the acos,
    sqrt(2 * 2^-23) rad at most."""
    got, want = runs["got"]["avg"], runs["want"]["avg"]
    odom = runs["jax_odom"][:, 0, 0]
    a_t = TOL["atol"] + TOL["rtol"] * np.abs(odom[:, :3]).max()
    a_q = TOL["atol"] + TOL["rtol"] * np.abs(odom[:, 3:]).max()
    t_tol = math.sqrt(3) * a_t + 1e-7
    q_tol = math.degrees(4 * math.asin(2 * 2 * a_q / 2)
                         + math.sqrt(2 * 2.0 ** -23))
    assert abs(got["frame_t_err_m"] - want["frame_t_err_m"]) <= t_tol
    assert abs(got["frame_q_err_deg"] - want["frame_q_err_deg"]) <= q_tol
    assert got["frame_t_err_m"] > 10 * t_tol
    assert got["frame_q_err_deg"] > 10 * q_tol


def test_run_eval_writes_the_plot(runs):
    assert (runs["plots"] / "traj_00.png").exists()


def _write_cfg(tmp_path, cfg):
    p = tmp_path / "cfg.json"
    p.write_text(cfg.to_json())
    return str(p)


def _evaluate(cfg_path, model_dir, *extra):
    return main(["evaluate", "--config", cfg_path, "--model_dir",
                 str(model_dir), "--synthetic", "--device", "cpu",
                 "--max_windows", "4", *extra])


def test_cli_evaluate_fresh_model(runs, tmp_path, capsys):
    """No checkpoint: the seeded initial weights; eval_results.json is
    written and printed, with JAX's keys."""
    pcfg = to_port(runs["cfg"])
    res = _evaluate(_write_cfg(tmp_path, pcfg), tmp_path / "m")
    printed = capsys.readouterr().out
    on_disk = json.loads((tmp_path / "m" / "eval_results.json").read_text())
    assert list(on_disk) == list(runs["want"]) == list(res)
    assert json.dumps(res, indent=2, default=str) in printed
    assert on_disk["_meta"]["windows"] == 4
    assert np.isfinite(on_disk["avg"]["frame_t_err_m"])
    assert (tmp_path / "m" / "plots" / "traj_00.png").exists()
    # the same windows through run_eval with the trainer's initial net
    trainer = Trainer(pcfg, str(tmp_path / "other"), "cpu")
    trainer.init_state()
    again = run_eval(trainer.eval_fn(), _synthetic_dataset(pcfg, "val", 32),
                     pcfg, max_windows=4)
    trainer.logger.close()
    assert_same(_without_clock(again), _without_clock(res))


def _train_batches(pcfg, n):
    ds = _synthetic_dataset(pcfg, "train", n_windows=n)
    for i in range(n):
        b = collate([ds[i]], pcfg.data)
        yield {k: b[k][0] for k in ("points", "point_mask", "odometry")}


def test_cli_evaluate_checkpoints(runs, tmp_path):
    """Trainer.fit with an eval hook at every step (run_eval on the
    train-mode net, then update_best_checkpoint), as the JAX CLI's train
    verb wires it; then the CLI evaluates step 1, the best step and the
    latest, each equal to what the hook saw at that step."""
    cfg = runs["cfg"]
    pcfg = to_port(cfg.replace(
        data=dataclasses.replace(cfg.data, seq_length=3),
        train=dataclasses.replace(cfg.train, steps_per_eval=1,
                                  display_step=1)))
    mdir = tmp_path / "m"
    trainer = Trainer(pcfg, str(mdir), "cpu")
    state = trainer.init_state()
    seen = {}

    def eval_hook(tr, st, step_i):
        assert tr.net.training
        res = run_eval(tr.eval_fn(), _synthetic_dataset(pcfg, "val", 32),
                       pcfg, tr.logger, max_windows=4)
        assert tr.net.training
        seen[step_i] = _without_clock(res)
        update_best_checkpoint(mdir, step_i, res["avg"])

    trainer.fit(_train_batches(pcfg, 2), state, eval_hook=eval_hook,
                max_steps=2)
    assert sorted(seen) == [1, 2] and trainer.ckpt.all_steps() == [1, 2]
    assert len(trainer.history) == 2
    trainer.logger.close()
    best = json.loads((mdir / "best_ckpt.json").read_text())["step"]
    cfg_path = _write_cfg(tmp_path, pcfg)
    for flag, step in ((("--ckpt_step", "1"), 1),
                       (("--ckpt_step", "best"), best), ((), 2)):
        res = _evaluate(cfg_path, mdir, *flag)
        assert_same(_without_clock(res), seen[step])
    assert (seen[1]["avg"]["frame_t_err_m"] !=
            seen[2]["avg"]["frame_t_err_m"])
    assert "restored checkpoint at step 2" in (mdir / "log.txt").read_text()


# the keys of rslo_tpu/eval/runner.py::run_eval_refined's result
# (tests/test_torch_eval_refined.py holds the whole structure to JAX's)
REFINED_KEYS = {"_meta": ["windows", "elapsed_s", "refined"],
                "seq_00": ["refined", "chained"]}
LOOP_KEYS = ["loop_closed", "n_loops", "loop_keyframes"]


@pytest.mark.parametrize("flag", ["--refine", "--refine_ba",
                                  "--refine_loops"])
def test_cli_refined_evaluate(flag, tmp_path, capsys, monkeypatch):
    """The refined evaluation through the verb on 4 synthetic 3-frame
    windows (the seeded initial weights, on the CPU): JAX's keys,
    finite metrics, the plot and eval_results.json; the loop flags reach
    close_loops."""
    from rslo_tpu_torch.eval import runner
    seen = []
    close_loops = runner.close_loops

    def recording(*args, **kw):
        seen.append(kw)
        return close_loops(*args, **kw)

    monkeypatch.setattr(runner, "close_loops", recording)
    res = _evaluate(_write_cfg(tmp_path, to_port(eval_cfg())),
                    tmp_path / "m", flag, "--loop_min_separation", "3",
                    "--loop_score_threshold", "0.95")
    on_disk = json.loads((tmp_path / "m" / "eval_results.json").read_text())
    want = dict(REFINED_KEYS)
    if flag == "--refine_loops":
        want["seq_00"] = want["seq_00"] + LOOP_KEYS
    assert {k: list(v) for k, v in on_disk.items()} == want
    assert list(res) == list(on_disk)
    assert on_disk["_meta"]["windows"] == 4 and on_disk["_meta"]["refined"]
    for name in want["seq_00"][:2] + want["seq_00"][2:3]:
        assert np.isfinite(on_disk["seq_00"][name]["ate_rmse_m"]), name
    if flag == "--refine_loops":
        assert on_disk["seq_00"]["loop_keyframes"] == 6
        assert on_disk["seq_00"]["n_loops"] >= 0
        assert [(kw["min_separation"], kw["score_threshold"],
                 kw["device"].type) for kw in seen] == [(3, 0.95, "cpu")]
    else:
        assert not seen
    assert (tmp_path / "m" / "plots" / "traj_refined_00.png").exists()
    assert "refined eval: 4 windows" in capsys.readouterr().out


def test_cli_best_without_record_exits(tmp_path):
    with pytest.raises(SystemExit, match="best_ckpt.json"):
        _evaluate(_write_cfg(tmp_path, to_port(eval_cfg())), tmp_path,
                  "--ckpt_step", "best")
