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

The store: where h5py is installed, ``build`` writes ``proxy.h5`` with
the ``create_hdf5`` verb.  Where it is not, ``build`` writes one
``proxy_XX.npz`` a sequence beside where ``proxy.h5`` would be (every
frame's ``build_frame_record``, the poses and ``Tr``), and ``train``
and ``eval`` read it through ``NpzSequenceReader``, which keeps
``SequenceReader``'s contract.  ``build --seqs S`` renders (and, for
the npz store, builds) only those sequences, so one process a sequence
can run in parallel.

Stages (composable):
  python scripts/torch_accuracy_proxy.py build              # render + store
  python scripts/torch_accuracy_proxy.py train --middle PillarMiddleCov \\
      --steps 3000 [--supervised]
  python scripts/torch_accuracy_proxy.py eval --middle PillarMiddleCov
  python scripts/torch_accuracy_proxy.py report             # table stdout

``train`` and ``eval`` run on the CUDA card unless ``--device cpu`` is
given.  Artifacts go under ``RSLO_PROXY_ROOT`` (default
``$TMPDIR/rslo_proxy_torch``): the tree, the store, ``model_<tag>/``
run dirs, ``train_<middle>.json``, ``eval_<middle>.json`` and
``result_<tag>.json``.
"""
import argparse
import contextlib
import dataclasses
import importlib.util
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
H5 = ROOT / "proxy.h5"

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
            cfg.data, root=str(H5), train_sequences=TRAIN_SEQS,
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


def store_kind() -> str:
    """"h5" where h5py is installed, else "npz"."""
    return "h5" if importlib.util.find_spec("h5py") is not None else "npz"


def npz_path(h5_path, seq: int) -> Path:
    """The npz store's file of ``seq``, beside ``h5_path``."""
    return Path(h5_path).parent / f"proxy_{seq:02d}.npz"


def write_npz_store(seqs, tree=None, h5_path=None):
    """One ``proxy_XX.npz`` a sequence of the KITTI tree: every frame's
    ``build_frame_record`` (what the ``create_hdf5`` verb stores) as one
    array a dataset with the frames' row counts, the poses (n, 12) and
    ``Tr`` (12,), as ``create_hdf5`` writes them."""
    from rslo_tpu_torch.data.hdf5_store import build_frame_record
    from rslo_tpu_torch.data.kitti_io import (list_frames, read_calib,
                                              read_poses, read_velodyne,
                                              sequence_paths)
    tree = TREE if tree is None else tree
    h5_path = H5 if h5_path is None else h5_path
    for seq in seqs:
        velo_dir, seq_dir, pose_file = sequence_paths(tree, seq)
        frames = list_frames(velo_dir)
        n = len(frames)
        Tr = read_calib(seq_dir)["Tr"].reshape(-1)
        poses = (read_poses(pose_file)[:n] if pose_file is not None
                 else np.tile(np.eye(3, 4).reshape(1, 3, 4), (n, 1, 1)))
        t0 = time.perf_counter()
        recs = []
        for i, fr in enumerate(frames):
            recs.append({k: np.asarray(v, np.float32) for k, v in
                         build_frame_record(read_velodyne(fr)).items()})
            if i % 100 == 0:
                print(f"seq {seq:02d}: {i}/{n}", flush=True)
        arrays = {"poses": poses.reshape(n, 12), "Tr": Tr}
        for k in recs[0]:
            arrays[f"rec__{k}"] = np.concatenate([r[k] for r in recs])
            arrays[f"len__{k}"] = np.array([len(r[k]) for r in recs],
                                           np.int64)
        out = npz_path(h5_path, seq)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, out)
        print(f"seq {seq:02d}: {n} records in "
              f"{(time.perf_counter() - t0) * 1e3 / max(n, 1):.1f} ms a "
              f"frame -> {out}", flush=True)


_NPZ = {}


class NpzSequenceReader:
    """Random access to one sequence's frames in the npz store, with
    ``data/hdf5_store.py::SequenceReader``'s contract: constructed from
    the config's store path and a sequence, ``n_frames`` and
    ``frame(i, cross_normals)`` returning what ``SequenceReader`` reads
    from ``create_hdf5``'s store of the same tree.  A file is loaded
    once a process."""

    def __init__(self, h5_path, seq: int):
        self.path, self.seq = h5_path, seq
        f = str(npz_path(h5_path, seq).resolve())
        if f not in _NPZ:
            with np.load(f) as z:
                data = {k: z[k] for k in z.files}
            starts = {k[len("len__"):]: np.concatenate(
                [[0], np.cumsum(v)]) for k, v in data.items()
                if k.startswith("len__")}
            _NPZ[f] = (data, starts)
        self._data, self._starts = _NPZ[f]
        self.n_frames = len(self._data["poses"])

    def _rows(self, key, i):
        lo, hi = self._starts[key][i:i + 2]
        return self._data[f"rec__{key}"][lo:hi].copy()

    def frame(self, i: int, cross_normals: bool = False) -> dict:
        pts = self._rows("lidar_points", i)
        nrm = self._rows("lidar_normals", i)
        if cross_normals and "lidar_cross_normals" in self._starts:
            cols = [pts, self._rows("lidar_cross_normals", i), nrm]
        else:
            cols = [pts, nrm]
        out = {"points": np.concatenate(cols, axis=1),
               "pose": self._data["poses"][i].reshape(3, 4).copy(),
               "Tr": self._data["Tr"].reshape(3, 4).copy()}
        for k in self._starts:
            if k.startswith("hier_"):
                out[k] = self._rows(k, i)
        return out


@contextlib.contextmanager
def store_readers():
    """The datasets read the npz store while the block runs, where the
    store is npz."""
    from rslo_tpu_torch.data import dataset
    if store_kind() == "h5":
        yield
        return
    saved = dataset.SequenceReader
    dataset.SequenceReader = NpzSequenceReader
    try:
        yield
    finally:
        dataset.SequenceReader = saved


def cmd_build(args):
    """Render (optionally one seq per process: --seqs 0) + build the
    store (h5: after all renders, or --h5_only; npz: the rendered
    sequences, or all of --seqs with --h5_only)."""
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
    if store_kind() == "npz":
        write_npz_store(seqs)
        print("proxy store ready:", ", ".join(
            str(npz_path(H5, s)) for s in seqs), flush=True)
    elif args.seqs is None or args.h5_only:
        from rslo_tpu_torch.cli import main
        # --seqs + --h5_only builds a store restricted to those
        # sequences (e.g. a val-only store in a fresh RSLO_PROXY_ROOT
        # with a different --world_seed: the scene-generalization probe)
        main(["create_hdf5", "--kitti_root", str(TREE), "--out", str(H5),
              "--sequences", ",".join(str(s) for s in seqs)])
        print("proxy store ready:", H5, flush=True)


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
    with store_readers():
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
    with store_readers():
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
    b.add_argument("--h5_only", action="store_true")
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
