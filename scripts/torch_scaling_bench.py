"""Data-parallel scaling harness on the PyTorch port (the twin of
``scripts/scaling_bench.py``, which drives the JAX package): the same
per-rank batch on 1 vs N ranks; reports step time and scaling
efficiency (ideal = flat).

    python scripts/torch_scaling_bench.py [world_sizes_csv] [--device cpu]

(default ``1,8``).  The configuration is the JAX script's: the tiny
``PillarMiddleCov`` model with the BEV net's ``sync_bn``,
``max_loss_points`` 2048, two frames of 8192 points from
``synth_sequence(seed=0)``, warmup steps (identity rotation); one
warm-up step, then ``n_steps`` timed.  Every rank takes the same batch,
so the loss does not depend on the world size.

World 1 forms no process group (JAX's one-device mesh has nothing to
reduce either).  A world of N > 1 is N processes, one a rank, meeting at
a ``file://`` rendezvous: NCCL when every rank has a card of its own,
gloo when ranks must share a card (NCCL takes one rank a card) and on
``--device cpu``.  Ranks sharing one card measure the path (the sync BN
and gradient all-reduces, host-staged by gloo), not scaling; scaling is
measured with one card a rank.
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

N_POINTS = 8192
ALPHAS = {"rot": -2.5, "trans": 0.0}
TIMEOUT_S = 600


def bench_cfg():
    """The JAX script's configuration, in the port's schema."""
    from rslo_tpu_torch.config.schema import (DataCfg, LossCfg, MiddleCfg,
                                              OdomCfg, PipelineCfg,
                                              VoxelizerCfg)
    return PipelineCfg(
        voxelizer=VoxelizerCfg(
            point_cloud_range=(-6.4, -6.4, -0.8, 6.4, 6.4, 0.8),
            voxel_size=(0.1, 0.1, 0.04), max_points_per_voxel=4,
            max_voxels=2048),
        middle=MiddleCfg(name="PillarMiddleCov",
                         level_capacities=(2048, 2048, 1024, 512),
                         channels=(8, 8, 16, 16)),
        odom=OdomCfg(num_input_features=32, layer_nums=(1, 1, 1),
                     num_filters=(16, 16, 32),
                     num_upsample_filters=(16, 16, 16),
                     bn_type="sync_bn"),
        loss=LossCfg(max_loss_points=2048),
        data=DataCfg(seq_length=2, max_points=N_POINTS),
    )


def bench_batch():
    """Every rank's batch: two frames of ``synth_sequence(seed=0)`` and
    their ground-truth motion, numpy."""
    from rslo_tpu_torch.utils.synthetic import synth_sequence
    frames, gts = synth_sequence(seed=0, n_frames=2, n_points=N_POINTS)
    return {"points": np.stack(frames),
            "point_mask": np.ones((2, N_POINTS), bool),
            "odometry": np.asarray(gts[:1])}


def backend_for(world, device):
    """The group's backend: gloo on the CPU and where ranks must share a
    card, NCCL where every rank has its own."""
    if world == 1:
        return None
    if torch.device(device).type == "cpu" or \
            world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def _counts():
    from rslo_tpu_torch.ops import band_conv as bc
    from rslo_tpu_torch.ops.chamfer import nn_search
    from rslo_tpu_torch.ops.dma_gather import (gather_matmul,
                                               gather_matmul_dgrad,
                                               row_gather)
    fns = {"gather_matmul": gather_matmul,
           "gather_matmul_dgrad": gather_matmul_dgrad,
           "row_gather": row_gather, "nn_search": nn_search,
           "band_matmul": bc.band_matmul,
           "band_matmul_dgrad": bc.band_matmul_dgrad,
           "band_gather": bc.band_gather}
    return {k: f.launches for k, f in fns.items()}


def run_steps(mesh, n_steps, variables=None, cfg=None):
    """One warm-up step, then ``n_steps`` timed ones, on ``mesh`` (a
    ``DataMesh``; its group None for one process).  Returns this rank's
    seconds a step, the warm-up step's loss, the last loss and the
    kernel launches."""
    from rslo_tpu_torch.convert import load_flax_variables
    from rslo_tpu_torch.models.net import OdomNet
    from rslo_tpu_torch.train.loop import make_optimizer
    from rslo_tpu_torch.train.state import TrainState
    from rslo_tpu_torch.train.step import train_step
    cfg = bench_cfg() if cfg is None else cfg
    dev = mesh.device
    net = OdomNet(cfg, torch.Generator().manual_seed(0))
    if variables is not None:
        load_flax_variables(net, variables)
    net = net.to(dev)
    opt = make_optimizer(cfg, net)
    state = TrainState.create(net, opt, ALPHAS)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in bench_batch().items()}
    group = mesh if mesh.group is not None else None
    before = _counts()
    state, m = train_step(state, batch, cfg, opt, warmup=True, mesh=group)
    first = float(m["loss"])  # kernel load, cuDNN plans; a barrier
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, m = train_step(state, batch, cfg, opt, warmup=True,
                              mesh=group)
        loss = float(m["loss"])
    dt = (time.perf_counter() - t0) / n_steps
    after = _counts()
    return {"dt": dt, "first_loss": first, "loss": loss,
            "launches": {k: after[k] - before[k] for k in after}}


def _rank(spec_path):
    """One rank of a world N > 1, in its own process."""
    import torch.distributed as dist
    from rslo_tpu_torch.train.distributed import (global_data_mesh,
                                                  initialize_multihost)
    from rslo_tpu_torch.config.schema import PipelineCfg
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = spec["tf32"]
    initialize_multihost(spec["rdv"], spec["world"], spec["rank"],
                         device=spec["device"], backend=spec["backend"])
    try:
        out = run_steps(global_data_mesh(spec["device"]), spec["n_steps"],
                        spec["variables"], PipelineCfg.from_json(spec["cfg"]))
    finally:
        dist.destroy_process_group()
    torch.save(out, spec["out"])


def bench(world, n_steps=6, device="cuda", variables=None, cfg=None):
    """``run_steps``' result (rank 0's) and the backend, for a world of
    ``world`` ranks.  ``variables`` (flax-layout numpy) replaces the
    seeded initial weights, ``cfg`` the JAX script's configuration.
    The ranks of a world N > 1 take the caller's TF32 settings, so every
    world computes in the same arithmetic."""
    from rslo_tpu_torch.train.distributed import DataMesh
    cfg = bench_cfg() if cfg is None else cfg
    backend = backend_for(world, device)
    if world == 1:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        return {**run_steps(DataMesh(None, 0, 1, dev), n_steps, variables,
                            cfg), "backend": backend}
    with tempfile.TemporaryDirectory() as tmp:
        procs, outs = [], []
        for rank in range(world):
            dev = device if torch.device(device).type == "cpu" else (
                f"cuda:{rank}" if backend == "nccl" else "cuda:0")
            spec = os.path.join(tmp, f"spec{rank}.pt")
            outs.append(os.path.join(tmp, f"out{rank}.pt"))
            torch.save(dict(rdv=f"file://{tmp}/rendezvous", world=world,
                            rank=rank, device=dev, backend=backend,
                            n_steps=n_steps, variables=variables,
                            cfg=cfg.to_json(), out=outs[-1],
                            tf32=(torch.backends.cuda.matmul.allow_tf32,
                                  torch.backends.cudnn.allow_tf32)), spec)
            env = dict(os.environ, OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--rank_spec", spec], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"scaling bench world {world} rank "
                                   f"{rank} failed:\n{log[-6000:]}")
        return {**torch.load(outs[0], weights_only=False),
                "backend": backend}


def main(ns, device="cuda", n_steps=6):
    base = None
    results = {}
    for n in ns:
        r = bench(n, n_steps, device)
        dt, loss = r["dt"], r["loss"]
        if base is None:
            base = dt
        eff = base / dt
        shared = (" ranks sharing one card: the path, not scaling"
                  if r["backend"] == "gloo" and device != "cpu" else "")
        print(f"devices={n}: {dt*1e3:.1f} ms/step (samples/s "
              f"{n/dt:.2f}, efficiency {eff*100:.0f}%) loss={loss:.3f} "
              f"backend={r['backend'] or 'none'}{shared}", flush=True)
        results[n] = r
    return results


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("world_sizes", nargs="?", default="1,8")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--rank_spec", help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.rank_spec:
        return _rank(a.rank_spec)
    return main([int(x) for x in a.world_sizes.split(",")], a.device)


if __name__ == "__main__":
    cli()
