"""Command-line entry points of the port (counterpart of
``rslo_tpu/cli.py``; the ``create_hdf5``, ``train``, ``evaluate`` and
``bench`` verbs):

    python -m rslo_tpu_torch.cli create_hdf5 --kitti_root KITTI --out all.h5
    python -m rslo_tpu_torch.cli train --config cfg.json --model_dir runs/x
    python -m rslo_tpu_torch.cli evaluate --config cfg.json --model_dir runs/x
    python -m rslo_tpu_torch.cli bench

``create_hdf5`` builds the HDF5 store from a raw KITTI odometry tree on
the host (normals by the native ``native/prep.cpp`` build).
``train`` trains on the train split from the model dir's latest
checkpoint (or a fresh or warm-started state), with a periodic eval
that keeps the best checkpoint.  ``evaluate`` evaluates the model dir's
latest checkpoint (``--ckpt_step N`` or ``best`` for another; the
seeded initial weights where there is none) on the val split, writes
``eval_results.json`` into the model dir and prints it; ``--refine``,
``--refine_ba`` and ``--refine_loops`` evaluate 3-frame windows fused
by the pose graph (with bundle adjustment, with loop closing).
``--synthetic`` swaps the KITTI store for the generated scene.
``bench`` prints the JSON line of ``rslo_tpu_torch/bench.py`` (the
root ``bench.py``'s keys, measured on the port).  ``train``,
``evaluate`` and ``bench`` run on the CUDA card unless ``--device cpu``
is given, and ``train`` and ``evaluate`` run data-parallel over every
process of a ``torchrun`` or SLURM launch (one process per card;
``train/distributed.py``):

    torchrun --nproc_per_node 8 -m rslo_tpu_torch.cli train --config cfg.json --model_dir runs/x
"""
from __future__ import annotations

import argparse
import dataclasses
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


def _plot_dir(logger, path: str):
    """``path``, or None (with one log line) where matplotlib is
    missing."""
    if importlib.util.find_spec("matplotlib") is None:
        logger.log_text("matplotlib is not installed: trajectory plots "
                        "skipped")
        return None
    return path


def cmd_create_hdf5(args):
    from .data.hdf5_store import create_hdf5
    create_hdf5(args.kitti_root, args.out,
                sequences=[int(s) for s in args.sequences.split(",")],
                cross_normal_radius=args.cross_normal_radius,
                max_frames=args.max_frames)


def cmd_train(args):
    """Train one card for ``--steps`` (or the config's), resuming from
    the model dir's latest checkpoint and the data stream where it left
    off; with ``--leg_until`` stop at that step while the schedule and
    the stream still span the whole run.  Every ``steps_per_eval`` steps
    a checkpoint is written and the val split evaluated (256 windows);
    the best step by ``update_best_checkpoint`` is recorded in
    ``best_ckpt.json`` and copied to ``ckpt_best/``.  Under ``torchrun``
    or SLURM the run is data-parallel over D processes, as JAX's over D
    devices: each rank collates JAX's D-sample batch and trains on its
    own row, and rank 0 alone writes the logs, events and
    checkpoints."""
    import torch
    import torch.distributed as dist

    from .data.dataset import DATASETS
    from .data.loader import DataLoader
    from .train.distributed import global_data_mesh, initialize_multihost
    from .train.loop import Trainer, shard_batch
    from .train.step import prepare_batch

    formed = initialize_multihost(device=args.device)
    mesh = global_data_mesh(args.device)
    cfg = _load_cfg(args.config)
    if args.steps:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    steps=args.steps))
    trainer = Trainer(cfg, args.model_dir, mesh=mesh,
                      self_supervised=not args.supervised)
    trainer.logger.log_text(f"config:\n{cfg.to_json()}")
    if args.synthetic:
        dataset = _synthetic_dataset(cfg, "train")
    else:
        dataset = DATASETS[cfg.data.dataset](cfg.data, "train")
    # resume the data stream where the checkpoint left it
    resume_step = trainer.ckpt.latest_step() or 0
    loader = DataLoader(dataset, cfg.data, mesh.size, cfg.train.steps,
                        train=True, seed=cfg.train.seed,
                        last_iter=resume_step - 1)

    try:
        stream = iter(loader)
        first = shard_batch(next(stream), mesh)
        state = trainer.init_state(
            pretrained=args.pretrained,
            pretrained_include=args.pretrained_include,
            pretrained_exclude=args.pretrained_exclude)

        def batches():
            yield first
            for b in stream:
                yield shard_batch(b, mesh)

        if args.synthetic:
            eval_ds = _synthetic_dataset(cfg, "val", n_windows=16)
        else:
            try:
                # KITTI metrics are over consecutive frames: the periodic
                # val walk pins skip=1 whatever stride training uses
                eval_ds = DATASETS[cfg.data.dataset](
                    dataclasses.replace(cfg.data, skip=1), "val",
                    seq_length=2)
            except Exception:
                eval_ds = None

        def eval_hook(tr, st, step_i):
            if eval_ds is None:
                return
            from .eval.runner import run_eval
            res = run_eval(tr.eval_fn(), eval_ds, cfg, tr.logger,
                           max_windows=256, mesh=mesh, plot_dir=_plot_dir(
                               tr.logger,
                               f"{args.model_dir}/plots/step_{step_i}"))
            if not tr.rank0:
                return
            if "avg" in res:
                tr.logger.log_metrics({"eval": res["avg"]}, step_i)
                # evaluate --ckpt_step best reads this back
                written = update_best_checkpoint(args.model_dir, step_i,
                                                 res["avg"])
                if written is not None:
                    tr.ckpt.preserve(step_i)  # survives max_to_keep
                    tr.logger.log_text(
                        f"new best checkpoint: step {step_i} "
                        f"({written[0]}={written[1]:.3f})")
            # the tq-map, confidence and input-mask images of an
            # eval-mode forward on the first batch
            was_training = tr.net.training
            try:
                tr.net.eval()
                with torch.no_grad():
                    raw = {k: torch.as_tensor(v).to(tr.device)
                           for k, v in first.items()}
                    preds = tr.net(prepare_batch(raw, cfg), with_cov=False)
                tq = preds["tq_map"][0].float()
                for tag, img in (
                        ("tq_map/translation_norm",
                         torch.linalg.norm(tq[..., :3], dim=-1)),
                        ("conf/translation", preds["t_conf"][0, ..., 0]),
                        ("conf/rotation", preds["q_conf"][0, ..., 0]),
                        ("feature_mask", preds["input_mask"][0, ..., 0])):
                    tr.logger.log_image(tag, img.float().cpu().numpy(),
                                        step_i)
            except Exception as e:      # never let images stop training
                tr.logger.log_text(f"image logging failed: {e}")
            finally:
                tr.net.train(was_training)

        state = trainer.fit(batches(), state, eval_hook=eval_hook,
                            max_steps=args.leg_until or args.steps)
        trainer.logger.log_text(f"done at step {state.step}")
    finally:
        loader.close()
        trainer.logger.close()
        if formed:
            dist.destroy_process_group()
    return state


def cmd_evaluate(args) -> dict:
    """Under ``torchrun`` or SLURM the windows are sharded over the
    ranks (``eval/runner.py``); every rank returns the results, rank 0
    alone writes them."""
    import torch.distributed as dist

    from .data.dataset import DATASETS
    from .eval.runner import run_eval, run_eval_refined
    from .train.distributed import global_data_mesh, initialize_multihost
    from .train.loop import Trainer

    formed = initialize_multihost(device=args.device)
    mesh = global_data_mesh(args.device)
    cfg = _load_cfg(args.config)
    refine = args.refine or args.refine_ba or args.refine_loops
    # the refined evaluation fuses the redundant pairs of 3-frame windows
    seq_len = 3 if refine else 2
    if args.synthetic:
        cfg2 = cfg.replace(data=dataclasses.replace(cfg.data,
                                                    seq_length=seq_len))
        dataset = _synthetic_dataset(
            cfg2, "train" if seq_len == 3 else "val", n_windows=32)
    else:
        dataset = DATASETS[cfg.data.dataset](cfg.data, "val",
                                             seq_length=seq_len)
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
    trainer = Trainer(cfg, args.model_dir, mesh=mesh)
    try:
        if best is not None:
            trainer.logger.log_text(
                f"evaluating best checkpoint: step {ckpt_step} "
                f"({best['metric_name']}={best['metric']:.3f})")
        trainer.init_state(ckpt_step=ckpt_step)
        plot_dir = (_plot_dir(trainer.logger,
                              str(Path(args.model_dir) / "plots"))
                    if trainer.rank0 else None)
        if refine:
            results = run_eval_refined(
                trainer.eval_fn(), dataset, cfg, trainer.logger,
                max_windows=args.max_windows, use_ba=args.refine_ba,
                use_loops=args.refine_loops,
                loop_min_separation=args.loop_min_separation,
                loop_score_threshold=args.loop_score_threshold,
                eval_step_cov=(trainer.eval_fn(with_cov=True)
                               if args.refine_ba else None),
                plot_dir=plot_dir, mesh=mesh)
        else:
            results = run_eval(trainer.eval_fn(), dataset, cfg,
                               trainer.logger, max_windows=args.max_windows,
                               plot_dir=plot_dir, mesh=mesh)
    finally:
        trainer.logger.close()
        if formed:
            dist.destroy_process_group()
    if trainer.rank0:
        print(json.dumps(results, indent=2, default=str))
        out = Path(args.model_dir) / "eval_results.json"
        out.write_text(json.dumps(results, indent=1, default=str))
    return results


def cmd_bench(args):
    from .bench import main as bench_main
    return bench_main(device=args.device)


def main(argv=None):
    p = argparse.ArgumentParser(prog="rslo_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("create_hdf5")
    c.add_argument("--kitti_root", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--sequences", default=",".join(str(i)
                                                   for i in range(11)))
    c.add_argument("--max_frames", type=int, default=None)
    c.add_argument("--cross_normal_radius", type=float, default=None,
                   help="also store coarser-scale normals "
                        "(lidar_cross_normals) for the crossnorm dataset")
    c.set_defaults(fn=cmd_create_hdf5)

    t = sub.add_parser("train")
    t.add_argument("--config", default=None)
    t.add_argument("--model_dir", required=True)
    t.add_argument("--steps", type=int, default=None)
    t.add_argument("--leg_until", type=int, default=None,
                   help="stop this process at the given step while the "
                        "LR schedule/loader still span the full --steps "
                        "run (the next process resumes from the "
                        "checkpoint)")
    t.add_argument("--synthetic", action="store_true")
    t.add_argument("--supervised", action="store_true")
    t.add_argument("--pretrained", default=None,
                   help="warm-start from another run's model dir "
                        "(shape-matching leaves only)")
    t.add_argument("--pretrained_include", default=None)
    t.add_argument("--pretrained_exclude", default=None)
    t.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    t.set_defaults(fn=cmd_train)

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
    e.add_argument("--refine", action="store_true",
                   help="fuse the pair motions of 3-frame windows with "
                        "pose-graph refinement")
    e.add_argument("--refine_ba", action="store_true",
                   help="refine with geometric bundle adjustment "
                        "(landmark tracks from the network's voxel points, "
                        "whitened by its covariances)")
    e.add_argument("--refine_loops", action="store_true",
                   help="close trajectory loops (polar-descriptor "
                        "place recognition + ICP edges + pose graph)")
    e.add_argument("--loop_min_separation", type=int, default=50,
                   help="frames between a loop's two ends, at least")
    e.add_argument("--loop_score_threshold", type=float, default=0.8,
                   help="descriptor similarity a loop candidate needs")
    e.set_defaults(fn=cmd_evaluate)

    b = sub.add_parser("bench")
    b.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
