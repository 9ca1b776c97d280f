"""Benchmark: steady-state two-frame odometry inference throughput on the
KITTI-scale workload, one card, for both middles (counterpart of the
root ``bench.py``, which drives the JAX package):

  * pillar  — PillarMiddleCov;
  * sparse  — SparseMiddleCov (engine from the schema default, or
    ``RSLO_BENCH_ENGINE``).

    python -m rslo_tpu_torch.cli bench [--device cuda]

Prints ONE JSON line with the JAX bench's keys and no others:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "middle": "PillarMiddleCov", "sparse_fps": M, "sparse_engine": "..."}
(``sparse_skipped`` instead when the sparse stage failed or the budget
was spent; ``streaming_fps`` and ``sparse_streaming_fps`` with
``RSLO_BENCH_STREAMING`` set).  The weights are the seeded random init
(``torch.Generator`` seed 0); the scans ``utils/synthetic.py``'s at
``PipelineCfg()``'s full KITTI-scale defaults.

Env, as the JAX bench: RSLO_BENCH_MIDDLE=PillarMiddleCov|SparseMiddleCov
restricts to one middle (which then gives the headline);
RSLO_BENCH_ENGINE overrides the sparse engine; RSLO_BENCH_BUDGET
(seconds, default 1500) skips the sparse stage once the pillar stage
has spent it; RSLO_BENCH_STREAMING adds the streaming numbers;
RSLO_BAND_MIN_CHANNELS and RSLO_PLAN_LOOKUP set the middle's
``band_min_channels`` and ``plan_lookup`` (a lookup the port does not
have raises, as the schema's users do).

Timing: JAX chains the iterates inside one jit, each input perturbed
by the carry so that XLA cannot fold the chain.  Here the iterates are
a loop of eager forwards with the same ``+ acc * 1e-30`` perturbation
(``acc`` stays on the card, so no iterate waits for the host), timed
from one ``torch.cuda.synchronize()`` to the next after a warm-up
iterate, with no CUDA graph.  The forwards skip the covariance decoder
(``with_cov=False``), whose output the bench discards: XLA drops it
from JAX's jitted forward the same way.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from .config.schema import PipelineCfg
from .data.prepare import mean_vfe_ok, prepare_example, voxelizer_config
from .models.net import OdomNet
from .models.vfe import simple_voxel_xyzi_normal
from .utils.synthetic import synth_sequence

# the JAX bench's baseline: RSLO-class sparse-conv LiDAR odometry nets
# run ~8-12 fps on P100/V100-era GPUs; conservative baseline 10 fps
BASELINE_FPS = 10.0


def _bench_cfg(cfg: Optional[PipelineCfg], middle: str,
               engine: str) -> PipelineCfg:
    cfg = cfg or PipelineCfg()
    mc = int(os.environ.get("RSLO_BAND_MIN_CHANNELS",
                            cfg.middle.band_min_channels))
    pl = os.environ.get("RSLO_PLAN_LOOKUP", cfg.middle.plan_lookup)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, seq_length=2),
        middle=dataclasses.replace(cfg.middle, name=middle, engine=engine,
                                   band_min_channels=mc, plan_lookup=pl))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log(msg: str):
    print(msg, file=sys.stderr, flush=True)


@torch.no_grad()
def bench_middle(middle: str, engine: str, n_iter: int = 16,
                 cfg: Optional[PipelineCfg] = None,
                 device="cuda") -> float:
    """Steady-state two-frame forward fps for one middle config: each
    iterate prepares both frames (voxelize) and runs the whole net."""
    dev = torch.device(device)
    cfg = _bench_cfg(cfg, middle, engine)
    vcfg = voxelizer_config(cfg)
    mean_mode = mean_vfe_ok(cfg)
    frames, _ = synth_sequence(seed=0, n_frames=2,
                               n_points=cfg.data.max_points)
    pts = torch.as_tensor(np.stack(frames), device=dev)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    t0 = time.time()
    net = OdomNet(cfg, torch.Generator().manual_seed(0)).to(dev).eval()
    _log(f"# [{middle}/{engine}] init: {time.time() - t0:.1f}s")

    def forward(p):
        ex = prepare_example(p, mask, vcfg, mean_mode=mean_mode)
        return net(ex, with_cov=False)["odometry"]

    def chain():
        acc = torch.zeros((), device=dev)
        for _ in range(n_iter):
            acc = acc + torch.sum(forward(pts + acc * 1e-30).float())
        return acc

    t0 = time.time()
    forward(pts).cpu()
    _log(f"# [{middle}/{engine}] first forward: {time.time() - t0:.1f}s")
    chain().cpu()
    _sync(dev)
    t0 = time.time()
    chain()
    _sync(dev)
    dt = (time.time() - t0) / n_iter
    return 1.0 / dt  # one new frame per step in odometry streaming


@torch.no_grad()
def bench_streaming(middle: str, engine: str, T: int = 8,
                    n_iter: int = 4, cfg: Optional[PipelineCfg] = None,
                    device="cuda") -> float:
    """Deployment-shaped streaming throughput: each frame is voxelized
    and encoded ONCE and paired with the cached previous frame's BEV
    (``eval/streaming.py``'s semantics), over T frames, n_iter times;
    frames a second."""
    dev = torch.device(device)
    cfg = _bench_cfg(cfg, middle, engine)
    vcfg = voxelizer_config(cfg)
    mean_mode = mean_vfe_ok(cfg)
    net = OdomNet(cfg, torch.Generator().manual_seed(0)).to(dev).eval()
    frames, _ = synth_sequence(seed=0, n_frames=T + 1,
                               n_points=cfg.data.max_points)
    pts = torch.as_tensor(np.stack(frames), device=dev)    # (T+1, N, 7)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)

    def features(p, m):
        ex = prepare_example(p[None], m[None], vcfg, mean_mode=mean_mode)
        if mean_mode:
            f = ex["voxel_features"][0]
        else:       # a non-mean VFE config: the stream's mean encoding
            f = simple_voxel_xyzi_normal(ex["voxels"][0],
                                         ex["num_points"][0],
                                         cfg.vfe.num_input_features)
        return net.frame_features(f, ex["coords"][0], ex["voxel_mask"][0],
                                  with_cov=False)[0]

    def stream():
        bev, acc = features(pts[0], mask[0]), torch.zeros((), device=dev)
        for t in range(1, T + 1):
            new = features(pts[t], mask[t])
            acc = acc + torch.sum(net.pair_predict(bev, new)["odometry"][0])
            bev = new
        return acc                                  # one scalar to fetch

    t0 = time.time()
    stream().cpu()
    _log(f"# [stream {middle}] first run: {time.time() - t0:.1f}s")
    _sync(dev)
    t0 = time.time()
    for _ in range(n_iter):
        stream()
    _sync(dev)
    dt = (time.time() - t0) / (n_iter * T)
    return 1.0 / dt


def main(device="cuda"):
    only = os.environ.get("RSLO_BENCH_MIDDLE")
    sparse_engine = os.environ.get("RSLO_BENCH_ENGINE",
                                   PipelineCfg().middle.engine)
    # the pillar headline always lands; the sparse stage is skipped once
    # the budget is spent and never takes the line down with an exception
    budget = float(os.environ.get("RSLO_BENCH_BUDGET", 1500))
    t_start = time.time()
    rec = {}
    sparse_skipped = None
    if only in (None, "PillarMiddleCov"):
        # the pillar middle has no sparse engine; pass the default
        rec["pillar"] = bench_middle("PillarMiddleCov",
                                     PipelineCfg().middle.engine,
                                     device=device)
    if only in (None, "SparseMiddleCov"):
        elapsed = time.time() - t_start
        if "pillar" in rec and elapsed > budget:
            sparse_skipped = (f"budget: {elapsed:.0f}s elapsed > "
                              f"{budget:.0f}s")
        else:
            try:
                rec["sparse"] = bench_middle("SparseMiddleCov",
                                             sparse_engine, device=device)
            except Exception as e:       # keep the headline alive
                if "pillar" not in rec:
                    raise
                sparse_skipped = f"{type(e).__name__}: {e}"
        if sparse_skipped:
            _log(f"# sparse stage skipped: {sparse_skipped}")

    headline = "pillar" if "pillar" in rec else "sparse"
    fps = rec[headline]
    line = {
        "metric": "two_frame_odometry_inference",
        "value": round(fps, 3),
        "unit": "frames/s/chip",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "middle": ("PillarMiddleCov" if headline == "pillar"
                   else "SparseMiddleCov"),
    }
    if "sparse" in rec and headline == "pillar":
        line["sparse_fps"] = round(rec["sparse"], 3)
        line["sparse_engine"] = sparse_engine
    elif sparse_skipped:
        line["sparse_skipped"] = sparse_skipped
    if os.environ.get("RSLO_BENCH_STREAMING"):
        if only in (None, "PillarMiddleCov"):
            line["streaming_fps"] = round(
                bench_streaming("PillarMiddleCov",
                                PipelineCfg().middle.engine,
                                device=device), 3)
        if only in (None, "SparseMiddleCov"):
            line["sparse_streaming_fps"] = round(
                bench_streaming("SparseMiddleCov", sparse_engine,
                                device=device), 3)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
