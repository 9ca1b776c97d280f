"""Command-line entry point of the port (counterpart of
``rslo_tpu/cli.py``; only the ``evaluate`` verb is ported so far):

    python -m rslo_tpu_torch.cli evaluate --config cfg.json --model_dir runs/x

It evaluates the model dir's latest checkpoint (``--ckpt_step N`` or
``best`` for another; the seeded initial weights where there is none)
on the val split, writes ``eval_results.json`` into the model dir and
prints it.  ``--synthetic`` swaps the KITTI store for the generated
scene.  The run is on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
from pathlib import Path

import numpy as np


def _load_cfg(path: str | None):
    from .config.schema import PipelineCfg
    if path is None:
        return PipelineCfg()
    return PipelineCfg.from_json(Path(path).read_text())


def _synthetic_dataset(cfg, split: str, n_windows: int = 64):
    """Dataset-shaped object over the synthetic scene."""
    from .data.dataset import generate_cyc_vo
    from .geometry.transforms import np_compose_pose
    from .utils.synthetic import synth_sequence

    L = cfg.data.seq_length if split == "train" else 2
    pr = cfg.voxelizer.point_cloud_range
    # scale the synthetic scene to the configured range so tiny test
    # configs still get meaningful voxel occupancy
    scale = min(abs(pr[0]), abs(pr[1]), pr[3], pr[4]) / 60.0
    zscale = min(abs(pr[2]), pr[5]) / 3.0

    class SynthDataset:
        def __len__(self):
            return n_windows

        def __getitem__(self, idx):
            frames, gts = synth_sequence(seed=idx, n_frames=L,
                                         n_points=cfg.data.max_points)
            if scale < 0.99:
                frames = [f.copy() for f in frames]
                for f in frames:
                    f[:, :2] *= scale
                    f[:, 2] = (f[:, 2] + 1.7) * zscale - 0.5 * zscale
                gts = gts.copy()
                gts[:, :2] *= scale
                gts[:, 2] *= zscale
            poses = [np.array([0, 0, 0, 1, 0, 0, 0], np.float32)]
            for g in gts:
                poses.append(np_compose_pose(poses[-1], g))
            poses = np.stack(poses)
            return {
                "points": frames,
                "pose_seq": poses,
                "odometry": generate_cyc_vo(poses),
                "seq": 0,
                "frames": list(range(idx, idx + L)),
            }

    return SynthDataset()


def update_best_checkpoint(model_dir, step_i: int, avg: dict):
    """NaN-proof best-checkpoint selection.  Primary key t_rel_pct,
    fallback frame_t_err_m when segment metrics are unavailable
    (``average_errors`` returns NaN for too-short trajectories, and NaN
    must never pin the best record).

    Returns the (metric_name, value) written, or None if not better.
    """
    def _finite(x):
        try:
            return x is not None and math.isfinite(float(x))
        except (TypeError, ValueError):
            return False

    if _finite(avg.get("t_rel_pct")):
        key_name, key = "t_rel_pct", float(avg["t_rel_pct"])
    elif _finite(avg.get("frame_t_err_m")):
        key_name, key = "frame_t_err_m", float(avg["frame_t_err_m"])
    else:
        return None  # nothing finite to rank on

    best_p = Path(model_dir) / "best_ckpt.json"
    prev = json.loads(best_p.read_text()) if best_p.exists() else None
    if prev is None or not _finite(prev.get("metric")):
        better = True  # replace missing or NaN-poisoned records
    elif prev.get("metric_name") != key_name:
        # metric availability changed; the primary key wins outright
        better = key_name == "t_rel_pct"
    else:
        better = key < float(prev["metric"])
    if not better:
        return None
    best_p.write_text(json.dumps(
        {"step": int(step_i), "metric": key, "metric_name": key_name,
         "avg": {k: float(v) for k, v in avg.items()}}))
    return key_name, key


def cmd_evaluate(args) -> dict:
    if args.refine or args.refine_ba or args.refine_loops:
        raise NotImplementedError(
            "--refine, --refine_ba and --refine_loops (run_eval_refined: "
            "pose-graph fusion, bundle adjustment, loop closing) are not "
            "ported yet: ROADMAP A12")
    from .data.dataset import DATASETS
    from .eval.runner import run_eval
    from .train.loop import Trainer

    cfg = _load_cfg(args.config)
    if args.synthetic:
        dataset = _synthetic_dataset(cfg, "val", n_windows=32)
    else:
        dataset = DATASETS[cfg.data.dataset](cfg.data, "val", seq_length=2)
    ckpt_step, best = args.ckpt_step, None
    if ckpt_step == "best":
        best_p = Path(args.model_dir) / "best_ckpt.json"
        if not best_p.exists():
            raise SystemExit("--ckpt_step best: no best_ckpt.json in "
                             f"{args.model_dir} (train with periodic "
                             "eval first)")
        best = json.loads(best_p.read_text())
        ckpt_step = int(best["step"])
    elif ckpt_step is not None:
        ckpt_step = int(ckpt_step)
    trainer = Trainer(cfg, args.model_dir, device=args.device)
    try:
        if best is not None:
            trainer.logger.log_text(
                f"evaluating best checkpoint: step {ckpt_step} "
                f"({best['metric_name']}={best['metric']:.3f})")
        trainer.init_state(ckpt_step=ckpt_step)
        plot_dir = str(Path(args.model_dir) / "plots")
        if importlib.util.find_spec("matplotlib") is None:
            trainer.logger.log_text("matplotlib is not installed: "
                                    "trajectory plots skipped")
            plot_dir = None
        results = run_eval(trainer.eval_fn(), dataset, cfg, trainer.logger,
                           max_windows=args.max_windows, plot_dir=plot_dir)
    finally:
        trainer.logger.close()
    print(json.dumps(results, indent=2, default=str))
    out = Path(args.model_dir) / "eval_results.json"
    out.write_text(json.dumps(results, indent=1, default=str))
    return results


def main(argv=None):
    p = argparse.ArgumentParser(prog="rslo_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("evaluate")
    e.add_argument("--config", default=None)
    e.add_argument("--model_dir", required=True)
    e.add_argument("--synthetic", action="store_true")
    e.add_argument("--max_windows", type=int, default=None)
    e.add_argument("--ckpt_step", default=None,
                   help="evaluate a specific checkpoint step, or 'best' "
                        "(periodic-val model selection via "
                        "best_ckpt.json; default: latest)")
    e.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    for flag in ("--refine", "--refine_ba", "--refine_loops"):
        e.add_argument(flag, action="store_true",
                       help="not ported yet (ROADMAP A12): raises")
    e.set_defaults(fn=cmd_evaluate)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
