"""Accuracy proxy on the PyTorch port: train and evaluate odometry
quality end to end on the raycast synthetic world, through
``rslo_tpu_torch`` alone (the twin of ``scripts/accuracy_proxy.py``,
which drives the JAX package; the stages, flags, sequences, config and
artifact names are that script's).

There are no real KITTI scans, so a persistent 3D world rendered with
occlusion, viewpoint and noise realism (``rslo_tpu_torch/utils/
world.py``) is written as a KITTI raw tree and pushed through the
port's pipeline (store build -> self-supervised train -> evaluate),
which reports t_rel / r_rel / ATE through the KITTI evaluator.  Train
(seqs 0/1, curves at 8 and 11 m/s; with ``RSLO_PROXY_SEQSET=v4`` also
seqs 2/3, loops in both directions) and val (seq 7, a loop at 8 m/s)
are rendered from the SAME world, so the val number measures
generalization across trajectory shape, viewpoints, occlusion and
motion, not across scene content or sensor domain.

The store is the package's directory store (``create_hdf5`` with an
``--out`` that does not end in ``.h5``; no h5py needed), where JAX's
script writes ``proxy.h5``.  Its sequences are independent, so
``build --seqs S`` renders and stores only those sequences, and one
process a sequence can run in parallel.

Stages (composable):
  python scripts/torch_accuracy_proxy.py build              # render + store
  python scripts/torch_accuracy_proxy.py train --middle PillarMiddleCov \\
      --steps 3000 [--supervised]
  python scripts/torch_accuracy_proxy.py eval --middle PillarMiddleCov
  python scripts/torch_accuracy_proxy.py report             # table stdout

``train`` and ``eval`` run on the CUDA card unless ``--device cpu`` is
given.  Artifacts go under ``RSLO_PROXY_ROOT`` (default
``$TMPDIR/rslo_proxy_torch``): the tree, the store ``proxy_store/``,
``model_<tag>/`` run dirs, ``train_<middle>.json``,
``eval_<middle>.json`` and ``result_<tag>.json``.
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

ROOT = Path(os.environ.get("RSLO_PROXY_ROOT",
                           Path(tempfile.gettempdir()) / "rslo_proxy_torch"))
TREE = ROOT / "kitti_tree"
STORE = ROOT / "proxy_store"

# seq id -> (frames, pattern, speed m/s).  Lengths sized so the
# standard KITTI 100-300 m segments fit (0.8-1.1 m/frame).
# RSLO_PROXY_SEQSET=v4 adds loop-pattern training sequences (sustained
# turning in both directions: seq 2 counter-clockwise, seq 3 clockwise).
if os.environ.get("RSLO_PROXY_SEQSET") == "v4":
    SEQS = {0: (350, "curve", 8.0), 1: (350, "curve", 11.0),
            2: (400, "loop", 9.5), 3: (400, "loop_cw", 7.0),
            7: (500, "loop", 8.0)}
    TRAIN_SEQS = (0, 1, 2, 3)
else:
    SEQS = {0: (350, "curve", 8.0), 1: (350, "curve", 11.0),
            7: (500, "loop", 8.0)}
    TRAIN_SEQS = (0, 1)
VAL_SEQS = (7,)


def base_cfg(middle: str, steps: int):
    from rslo_tpu_torch.config.schema import PipelineCfg
    cfg = PipelineCfg()
    cfg = cfg.replace(
        middle=dataclasses.replace(cfg.middle, name=middle),
        data=dataclasses.replace(
            cfg.data, root=str(STORE), train_sequences=TRAIN_SEQS,
            val_sequences=VAL_SEQS, eval_train_sequences=(0,),
            num_workers=2,
            # magnitude diversity (train time only): slerp pose
            # interpolation and a random window stride (skip=2 makes
            # strides {1, 2}) break the constant-speed prior
            skip=2, random_skip=True, pose_interp_ratio=0.5,
            # global-yaw augmentation: decorrelates absolute scene
            # heading from the rotation targets
            yaw_aug_rad=float(np.pi),
            # proxy frames hold ~50k points: half the cap, int16 transfer
            max_points=65536, quantize_transfer=True),
        train=dataclasses.replace(cfg.train, steps=steps,
                                  steps_per_eval=max(steps // 4, 250),
                                  display_step=50),
        # proxy-scale self-supervision: at a few thousand steps the
        # warmup must be short and the inner ICP must correct most of
        # the prediction error in one step
        loss=dataclasses.replace(cfg.loss,
                                 warmup_steps=min(300, steps // 10),
                                 icp_iter=6),
    )
    return cfg


def cmd_build(args):
    """Render (optionally one seq per process: --seqs 0) and store those
    sequences (--h5_only: store them without rendering)."""
    from rslo_tpu_torch.cli import main
    from rslo_tpu_torch.utils.world import write_kitti_tree
    TREE.mkdir(parents=True, exist_ok=True)
    seqs = (SEQS if args.seqs is None else
            {int(s): SEQS[int(s)] for s in args.seqs.split(",")})
    if not args.h5_only:
        t0 = time.perf_counter()
        gt = write_kitti_tree(TREE, seqs, world_seed=args.world_seed,
                              progress=True,
                              speed_profile=args.profile)
        n = sum(v[0] for v in seqs.values())
        print(f"rendered {n} frames in "
              f"{(time.perf_counter() - t0) * 1e3 / n:.1f} ms a frame",
              flush=True)
        np.savez(ROOT / f"gt_poses_{'_'.join(map(str, seqs))}.npz",
                 **{f"seq{k}": v[0] for k, v in gt.items()})
    # a directory store's sequences are independent: --seqs writes only
    # those (e.g. a val-only store in a fresh RSLO_PROXY_ROOT with a
    # different --world_seed: the scene-generalization probe)
    main(["create_hdf5", "--kitti_root", str(TREE), "--out", str(STORE),
          "--sequences", ",".join(str(s) for s in seqs)])
    print("proxy store ready:", STORE, flush=True)


def _model_dir(middle, supervised, tag=""):
    t = middle + ("_sup" if supervised else "") + (f"_{tag}" if tag else "")
    return str(ROOT / f"model_{t}")


def cmd_train(args):
    from rslo_tpu_torch.cli import main
    cfg = base_cfg(args.middle, args.steps)
    if getattr(args, "no_aug", False):
        # controlled-aug ablation: consecutive windows, no flip, no pose
        # interpolation
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, skip=1, random_skip=False, pose_interp_ratio=0.0,
            random_flip_y=False, yaw_aug_rad=0.0))
    if getattr(args, "no_quantize", False):
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, quantize_transfer=False,
            max_points=131072))
    if args.remat is not None:
        cfg = cfg.replace(middle=dataclasses.replace(
            cfg.middle, remat=bool(args.remat)))
    if getattr(args, "steps_per_eval", None):
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, steps_per_eval=args.steps_per_eval))
    if args.engine:
        cfg = cfg.replace(middle=dataclasses.replace(
            cfg.middle, engine=args.engine))
    cfg_path = ROOT / f"train_{args.middle}.json"
    cfg_path.write_text(cfg.to_json())
    argv = ["train", "--config", str(cfg_path),
            "--model_dir", _model_dir(args.middle, args.supervised,
                                      args.tag)]
    if args.leg_until:
        argv += ["--leg_until", str(args.leg_until)]
    if args.supervised:
        argv.append("--supervised")
    if args.init_from:
        argv += ["--pretrained", args.init_from]
    return main(argv + ["--device", args.device])


def cmd_eval(args):
    from rslo_tpu_torch.cli import main
    cfg = base_cfg(args.middle, 100)
    if args.engine:
        cfg = cfg.replace(middle=dataclasses.replace(
            cfg.middle, engine=args.engine))
    # eval walks CONSECUTIVE frames (the KITTI metric's semantics); the
    # train-time stride/interp knobs must not leak into val
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, skip=1, random_skip=False, pose_interp_ratio=0.0))
    cfg_path = ROOT / f"eval_{args.middle}.json"
    cfg_path.write_text(cfg.to_json())
    mdir = _model_dir(args.middle, args.supervised, args.tag)
    argv = ["evaluate", "--config", str(cfg_path), "--model_dir", mdir]
    if args.ckpt_step:
        argv += ["--ckpt_step", str(args.ckpt_step)]
    if args.refine:
        argv.append("--refine")
    if args.refine_loops:
        argv.append("--refine_loops")
        argv += ["--loop_min_separation", "40"]
    if getattr(args, "refine_ba", False):
        argv.append("--refine_ba")
    if getattr(args, "max_windows", None):
        argv += ["--max_windows", str(args.max_windows)]
    main(argv + ["--device", args.device])
    # the evaluate verb writes eval_results.json into the model dir
    res = json.loads((Path(mdir) / "eval_results.json").read_text())
    tag = args.middle + ("_sup" if args.supervised else "")
    if args.tag:
        tag += f"_{args.tag}"
    if args.ckpt_step:
        tag += f"_s{args.ckpt_step}"
    if args.refine:
        tag += "_refine"
    if args.refine_loops:
        tag += "_loops"
    if getattr(args, "refine_ba", False):
        tag += "_ba"
    if getattr(args, "max_windows", None):
        tag += f"_w{args.max_windows}"
    out = ROOT / f"result_{tag}.json"
    out.write_text(json.dumps(res, indent=1))
    print("saved", out, flush=True)
    return res


def cmd_report(args):
    rows = []

    def _mean(vals):
        vals = [v for v in vals if v is not None]
        return sum(vals) / len(vals) if vals else None

    for f in sorted(ROOT.glob("result_*.json")):
        tag = f.stem[len("result_"):]
        res = json.loads(f.read_text())
        avg = res.get("avg")
        if avg is not None:
            rows.append((tag, avg.get("t_rel_pct"),
                         avg.get("r_rel_deg_per_100m"),
                         avg.get("ate_rmse_m")))
            continue
        # refined-eval layout: per-seq {chained, refined, loop_closed}
        seqs = [v for k, v in res.items() if k.startswith("seq_")]
        for mode in ("chained", "refined", "loop_closed"):
            sub = [s[mode] for s in seqs if mode in s]
            if not sub:
                continue
            rows.append((f"{tag}:{mode}",
                         _mean([m.get("t_rel_pct") for m in sub]),
                         _mean([m.get("r_rel_deg_per_100m")
                                for m in sub]),
                         _mean([m.get("ate_rmse_m") for m in sub])))
    print(f"{'variant':36s} {'t_rel %':>8s} {'r_rel d/100m':>12s} "
          f"{'ATE m':>8s}")
    for tag, t, r, a in rows:
        fmt = lambda v: "-" if v is None else f"{v:.3f}"
        print(f"{tag:36s} {fmt(t):>8s} {fmt(r):>12s} {fmt(a):>8s}")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build")
    b.add_argument("--world_seed", type=int, default=0)
    b.add_argument("--seqs", default=None,
                   help="comma list; render only these (parallel use)")
    b.add_argument("--h5_only", action="store_true",
                   help="store the sequences without rendering them")
    b.add_argument("--profile", default="walk",
                   choices=("walk", "varied", "urban"),
                   help="speed profile; 'varied' = urban-drive "
                        "magnitude diversity (use a fresh "
                        "RSLO_PROXY_ROOT so other artifacts survive)")
    b.set_defaults(fn=cmd_build)
    t = sub.add_parser("train")
    t.add_argument("--middle", default="PillarMiddleCov")
    t.add_argument("--steps", type=int, default=3000)
    t.add_argument("--supervised", action="store_true")
    t.add_argument("--remat", type=int, default=None)
    t.add_argument("--engine", default=None,
                   help="middle engine override (rulebook|band|tiles)")
    t.add_argument("--tag", default="",
                   help="model-dir suffix for config experiments")
    t.add_argument("--leg_until", type=int, default=None)
    t.add_argument("--steps_per_eval", type=int, default=None,
                   help="periodic-eval interval override")
    t.add_argument("--no_quantize", action="store_true",
                   help="f32 transfer + 131072-pt cap")
    t.add_argument("--no_aug", action="store_true",
                   help="skip=1, no flip/interp/random-skip")
    t.add_argument("--init_from", default=None,
                   help="model dir to warm-start from (param surgery)")
    t.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    t.set_defaults(fn=cmd_train)
    e = sub.add_parser("eval")
    e.add_argument("--middle", default="PillarMiddleCov")
    e.add_argument("--supervised", action="store_true")
    e.add_argument("--refine", action="store_true")
    e.add_argument("--refine_loops", action="store_true")
    e.add_argument("--refine_ba", action="store_true",
                   help="geometric BA per window; run as its OWN eval "
                        "(BA-refined pair motions replace preds)")
    e.add_argument("--max_windows", type=int, default=None)
    e.add_argument("--engine", default=None,
                   help="middle engine override (rulebook|band|tiles)")
    e.add_argument("--ckpt_step", default=None,
                   help="step number or 'best' (best_ckpt.json)")
    e.add_argument("--tag", default="")
    e.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    e.set_defaults(fn=cmd_eval)
    r = sub.add_parser("report")
    r.set_defaults(fn=cmd_report)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
