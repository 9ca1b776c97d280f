"""Closed-loop training on one card, as ``Trainer.fit`` drives it: the
train data path (a directory store built at set-up through the program's
``create_hdf5`` from a KITTI tree of seeded scans, read by its
``DataLoader``) feeds ``train/step.py::train_step`` post-warmup, one
step after another.

Parameters (``workloads/<cell>.json``): ``frames_per_seq`` frames in each
of the configuration's train sequences, ``n_points`` points a scan in a
scene of ``extent`` metres (default 60),
``check_steps`` steps the reference follows, ``trace_steps`` steps the
profiler traces after the window.

The object the window drives is set up once: its first ``check_steps``
steps go through the window's own call and feed.  After the window the
reference builds the same windows itself from the raw tree (read,
normals, pair motions, flip: ``rslo_ref/data/window.py``), holds the
program's batches to them, and follows the steps from the same weights
on its own batches.
"""
from __future__ import annotations

import dataclasses
import gc
import time

from harness import counts as counts_mod
from harness import judge, peaks, scenes, weights
from harness.record import Record
from harness.refpath import ref as load_ref
from harness.trace import DeviceClock, trace_steps


def program_cfg(pipeline: dict, store: str):
    from rslo_tpu_torch.config.schema import PipelineCfg
    cfg = PipelineCfg.from_dict(pipeline)
    return cfg.replace(data=dataclasses.replace(cfg.data, root=str(store)))


def make_store(ctx):
    """The traffic's set-up: the KITTI tree of seeded scans and the
    directory store the loader reads, built through the program's
    ``create_hdf5``.  Returns the program's and the reference's
    configurations and the tree."""
    from rslo_tpu_torch.data.hdf5_store import create_hdf5
    p = ctx.cell.params
    pcfg = ctx.cell.pipeline
    seqs = list(pcfg["data"]["train_sequences"])
    tree = scenes.write_kitti_tree(ctx.tmpdir / "tree", ctx.seed, seqs,
                                   p["frames_per_seq"], p["n_points"],
                                   p.get("extent", 60.0))
    store = ctx.tmpdir / "store"
    create_hdf5(str(tree), str(store), sequences=seqs, progress=False)
    return (program_cfg(pcfg, store),
            load_ref().config.schema.PipelineCfg.from_dict(pcfg), tree)


def make_loader(cfg, seed, mesh):
    """The program's train loader over the store, seeded by the run."""
    from rslo_tpu_torch.data.dataset import DATASETS
    from rslo_tpu_torch.data.loader import DataLoader
    return DataLoader(DATASETS[cfg.data.dataset](cfg.data, "train"),
                      cfg.data, mesh.size, cfg.train.steps, train=True,
                      seed=seed, last_iter=-1)


def run(ctx):
    import torch
    from rslo_tpu_torch.models.net import OdomNet
    from rslo_tpu_torch.train.distributed import DataMesh
    from rslo_tpu_torch.train.loop import (device_prefetch, make_optimizer,
                                           shard_batch)
    from rslo_tpu_torch.train.state import TrainState
    from rslo_tpu_torch.train.step import train_step

    p = ctx.cell.params
    dev = ctx.device
    ref = load_ref()
    rec = Record(kind="train")
    cfg, ref_cfg, tree = make_store(ctx)

    # the object the window drives, from the benchmark's seeded weights
    w0 = weights.make_weights(
        weights.shapes_model(ref.models.net.OdomNet, ref_cfg), ctx.seed, dev)
    net = weights.build(OdomNet, cfg, w0, dev).train()
    optimizer = make_optimizer(cfg, net)
    state = TrainState.create(
        net, optimizer, {"rot": cfg.loss.rotation_init_alpha,
                         "trans": cfg.loss.translation_init_alpha})
    mesh = DataMesh(None, 0, 1, dev)
    loader = make_loader(cfg, ctx.seed, mesh)
    stream = iter(loader)
    waits = []
    host_batches = []          # the batches the reference or counts read
    metas = []                 # (sequence, frames) of each kept batch
    keep = [True]

    def host_iter():
        while True:
            t0 = time.perf_counter()
            b = next(stream)
            waits.append((time.perf_counter() - t0) * 1e3)
            meta = b["meta"][mesh.rank]
            b = shard_batch(b, mesh)
            if keep[0]:
                host_batches.append(b)
                metas.append(meta)
            yield b

    batches = device_prefetch(host_iter(), dev)
    metrics_of = []

    def step():
        nonlocal state
        batch = next(batches)
        state, metrics = train_step(state, batch, cfg, optimizer,
                                    warmup=False, self_supervised=True,
                                    mesh=mesh)
        metrics_of.append(metrics["loss"])

    # the first steps: the reference follows them
    n_check = int(p["check_steps"])
    prog = {"p0": {k: v.detach().clone()
                   for k, v in state.trainable().items()},
            "b1": float(optimizer.b1(0))}
    mid = judge.FirstOutputs(net.middle, cfg.data.seq_length)
    for i in range(n_check):
        step()
        if i == 0:
            prog["mid1"] = mid.remove()
            prog["mu1"] = {k: v.detach().clone()
                           for k, v in state.opt_state.mu.items()}
    prog["p3"] = {k: v.detach().clone() for k, v in state.trainable().items()}
    prog["loss"] = [float(x) for x in metrics_of[:n_check]]
    check_batches = host_batches[:n_check]
    check_metas = metas[:n_check]
    keep[0] = False
    if dev.type == "cuda":
        torch.cuda.synchronize()

    # the window
    waits.clear()
    # the device clock of an untraced run: its trace of the card slows
    # the host, so a traced run reads the host's clock without it
    clock = DeviceClock(torch)
    if not ctx.trace:
        clock.start()
    t0 = time.perf_counter()
    rec.setup_s = t0 - ctx.t_start
    n = 0
    while time.perf_counter() - t0 < ctx.seconds:
        step()
        n += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rec.window_s = time.perf_counter() - t0
    clock.stop()
    if not ctx.trace:
        ctx.say(str(clock))
    rec.window_busy_s, rec.window_ops = clock.busy_s, clock.n_ops
    rec.steps = n
    rec.spans_ms["data_wait"] = list(waits)

    traced = []
    if ctx.trace:
        keep[0] = True
        k0 = len(host_batches)
        rec.trace = trace_steps(step, int(p["trace_steps"]), torch)
        traced = host_batches[k0:]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        rec.peak_bytes = torch.cuda.max_memory_allocated(dev)
    loader.close()
    del state, net, optimizer, batches, metrics_of
    host_batches = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference builds the check batches and follows the first steps
    t_ref = time.perf_counter()
    ref_batches, windows_ok = judge.ref_train_batches(
        ref, ref_cfg, tree, check_metas, check_batches)
    data = judge.data_numbers(check_batches, ref_batches, windows_ok)
    t_data = time.perf_counter() - t_ref
    refr = judge.ref_train_steps(ref, ref_cfg, w0, ref_batches, dev,
                                 n_check)
    numbers, detail = judge.train_numbers(prog, refr)
    numbers.update(data)
    ctx.say(f"reference: {n_check} batches in {t_data:.1f} s, {n_check} "
            f"steps in {time.perf_counter() - t_ref - t_data:.1f} s; "
            f"windows {check_metas}; {detail}")
    del refr, prog
    if traced:
        rec.counts = train_counts(ref, ref_cfg, w0, traced, dev, ctx)
    correct, rows = judge.verdict(numbers, ctx.cell.limits)
    ctx.say(f"readings: {numbers}")
    ctx.say(f"window: {n} steps in {rec.window_s:.3f} s; set-up "
            f"{rec.setup_s:.3f} s")
    return {"record": rec, "correct": correct, "checks": rows,
            "numbers": numbers, "detail": detail,
            "attempted": n, "failed": 0}


def control(ctx, n_steps: int):
    """The control's readings: the reference computed in fp8 put in the
    program's place for the cell's first steps, judged as the program's
    are (no window: the readings are the first steps').  Both sides
    train on the reference's batches of the windows (and flips) the
    program's loader draws for the seed, so the data numbers read 0."""
    from rslo_tpu_torch.train.distributed import DataMesh
    from rslo_tpu_torch.train.loop import shard_batch
    from harness.lower import fp8_reference
    ref = load_ref()
    cfg, ref_cfg, tree = make_store(ctx)
    mesh = DataMesh(None, 0, 1, ctx.device)
    loader = make_loader(cfg, ctx.seed, mesh)
    stream = iter(loader)
    raw = [next(stream) for _ in range(n_steps)]
    loader.close()
    batches, oks = judge.ref_train_batches(
        ref, ref_cfg, tree, [b["meta"][0] for b in raw],
        [shard_batch(b, mesh) for b in raw])
    w0 = weights.make_weights(
        weights.shapes_model(ref.models.net.OdomNet, ref_cfg), ctx.seed,
        ctx.device)
    want = judge.ref_train_steps(ref, ref_cfg, w0, batches, ctx.device,
                                 n_steps)
    with fp8_reference(ref):
        got = judge.ref_train_steps(ref, ref_cfg, w0, batches, ctx.device,
                                    n_steps)
    numbers, detail = judge.train_numbers(got, want)
    numbers.update(judge.data_numbers(batches, batches, oks))
    return numbers, detail


def train_counts(ref, ref_cfg, w0, traced, dev, ctx):
    import torch
    net = weights.build(ref.models.net.OdomNet, ref_cfg, w0, dev)
    alphas = {"rot": torch.tensor(ref_cfg.loss.rotation_init_alpha,
                                  device=dev),
              "trans": torch.tensor(ref_cfg.loss.translation_init_alpha,
                                    device=dev)}
    items = []
    for i, b in enumerate(traced):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in b.items()}
        items.append(counts_mod.train_counts(ref, net, alphas, ref_cfg,
                                             batch))
        if i == 0:
            counts_mod.report_sites(ctx.say, counts_mod.level_sites(
                ref, ref_cfg, batch["points"][0], batch["point_mask"][0]))
    c = counts_mod.mean_counts(items)
    ctx.say(f"counts: model {c.model_flops / 1e9:.3f} GFLOP a step; "
            f"gather-GEMM bound "
            f"{c.gather_gemm_bound_s(peaks) / c.per * 1e3:.4f} ms a step; "
            f"nn_search bound "
            f"{c.nn_search_bound_s(peaks) / c.per * 1e3:.4f} ms a step")
    return c
