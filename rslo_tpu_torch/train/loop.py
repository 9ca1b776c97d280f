"""Training loop (counterpart of ``rslo_tpu/train/loop.py``): state
from the seed or the latest checkpoint, then the step loop with the
host-side warmup switch, periodic checkpoints and an eval hook.  Metrics
go to ``Trainer.logger`` (text, json-lines, TensorBoard events) and are
kept in ``Trainer.history``.  ``init_state`` can warm-start from another
run (``utils/param_surgery.py``).  Over a data mesh of several ranks
(``train/distributed.py``) each rank runs this loop on its own samples
with the data-parallel step; rank 0's state is broadcast at the start,
and only rank 0 writes logs, events and checkpoints."""
from __future__ import annotations

import functools
import time
from pathlib import Path
from typing import Iterable, Optional

import torch

from ..config.schema import PipelineCfg
from ..convert import is_flax_kernel
from ..models.net import OdomNet
from ..utils.logging import MetricLogger
from ..utils.param_surgery import flatten, load_pretrained
from ..utils.timing import span
from .checkpoint import CheckpointManager
from .distributed import DataMesh, broadcast_
from .optim import build_optimizer
from .state import TrainState
from .step import eval_step, train_step


def device_prefetch(batches: Iterable[dict], device):
    """Move each batch's tensors to ``device`` (non-blocking from
    pinned host memory where the batch is numpy)."""
    for b in batches:
        with span("h2d"):
            out = {k: torch.as_tensor(v).to(device, non_blocking=True)
                   for k, v in b.items() if k != "meta"}
        yield out


def shard_batch(batch: dict, mesh: DataMesh) -> dict:
    """This rank's sample of a collated batch of ``mesh.size`` rows (row
    ``mesh.rank`` of each array, "meta" dropped): JAX's sharding of the
    batch over the "data" axis, with the rows of the other ranks read
    and thrown away, so every rank sees the batch stream JAX's devices
    see."""
    return {k: v[mesh.rank] for k, v in batch.items() if k != "meta"}


def make_optimizer(cfg: PipelineCfg, model: torch.nn.Module):
    """``build_optimizer`` for ``model``'s parameters plus the alphas,
    with weight decay on the flax ``kernel`` leaves only."""
    params = dict(model.named_parameters())
    return build_optimizer(
        cfg.optimizer, cfg.train,
        decays=lambda n: n in params and is_flax_kernel(n, params[n].dim()))


class Trainer:
    """``mesh`` is the data mesh (default: this process alone on
    ``device``); with one, the trainer runs on the mesh's device and
    rank 0 alone writes."""

    def __init__(self, cfg: PipelineCfg, model_dir: str, device="cuda",
                 self_supervised: bool = True,
                 mesh: Optional[DataMesh] = None):
        self.cfg = cfg
        self.model_dir = Path(model_dir)
        if mesh is None:
            mesh = DataMesh(None, 0, 1, torch.device(device))
        self.mesh = mesh
        self.device = mesh.device
        self.rank0 = mesh.rank == 0
        self.self_supervised = self_supervised
        self.logger = MetricLogger(model_dir, enabled=self.rank0)
        self.ckpt = CheckpointManager(str(self.model_dir / "ckpt"),
                                      cfg.train.checkpoint_max_keep)
        self.history = []        # (step, {metric: float})
        self.net = None
        self.optimizer = None

    def init_state(self, pretrained: Optional[str] = None,
                   pretrained_include: Optional[str] = None,
                   pretrained_exclude: Optional[str] = None,
                   ckpt_step: Optional[int] = None) -> TrainState:
        """A fresh state from ``cfg.train.seed``, or the checkpoint at
        ``ckpt_step`` (the latest one when there is any).  Without a
        checkpoint, ``pretrained`` (another run's model dir) warm-starts
        the state from that run's latest checkpoint: the parameters and
        BN statistics whose flax paths pass the include/exclude regexes
        and whose shapes match, and the loss alphas.  Over a mesh, every
        rank then takes rank 0's state (JAX's replicated ``device_put``)."""
        state = self._init_state(pretrained, pretrained_include,
                                 pretrained_exclude, ckpt_step)
        if self.mesh.group is not None:
            # every tensor of the state and the two counters, as one
            # tensor on the mesh's device
            counters = torch.tensor([state.step, state.opt_state.count],
                                    device=self.device)
            broadcast_([*state.model.state_dict().values(),
                        *state.alphas.values(),
                        *state.opt_state.mu.values(),
                        *state.opt_state.nu.values(), counters], self.mesh)
            state.step, state.opt_state.count = map(int, counters.tolist())
        return state

    def _init_state(self, pretrained, pretrained_include,
                    pretrained_exclude, ckpt_step) -> TrainState:
        gen = torch.Generator().manual_seed(self.cfg.train.seed)
        self.net = OdomNet(self.cfg, gen).to(self.device).train()
        n_params = sum(p.numel() for p in self.net.parameters())
        self.logger.log_text(f"model initialized: {n_params / 1e6:.2f}M "
                             f"params")
        self.optimizer = make_optimizer(self.cfg, self.net)
        state = TrainState.create(
            self.net, self.optimizer,
            {"rot": self.cfg.loss.rotation_init_alpha,
             "trans": self.cfg.loss.translation_init_alpha})
        restored = self.ckpt.restore(state, step=ckpt_step)
        if restored is not None:
            self.logger.log_text(
                f"restored checkpoint at step {restored.step}")
            return restored
        if pretrained is not None:
            raw = self.ckpt.restore_raw_from(pretrained)
            loaded = load_pretrained(
                flatten(dict(self.net.named_parameters())),
                flatten(raw["model"]), pretrained_include,
                pretrained_exclude, strict_shapes=False)
            loaded_s = load_pretrained(
                flatten(dict(self.net.named_buffers()), "batch_stats"),
                flatten(raw["model"], "batch_stats"), pretrained_include,
                pretrained_exclude, strict_shapes=False)
            with torch.no_grad():
                for k, v in raw.get("alphas", {}).items():
                    state.alphas[k].copy_(v)
            self.logger.log_text(
                f"warm-started {len(loaded)} param + {len(loaded_s)} "
                f"stat leaves from {pretrained}")
        return state

    def eval_fn(self, with_cov: bool = False):
        """``train.step.eval_step`` bound to this trainer's net, config
        and device: collated batch -> odometry (1, P, 7)."""
        if self.net is None:
            raise RuntimeError("Trainer.eval_fn needs init_state first")
        return functools.partial(eval_step, self.net, cfg=self.cfg,
                                 device=self.device, with_cov=with_cov)

    def fit(self, train_iter: Iterable[dict], state: TrainState,
            eval_hook=None, max_steps: Optional[int] = None) -> TrainState:
        """Train up to ``max_steps`` (``cfg.train.steps`` by default);
        every ``steps_per_eval`` steps save a checkpoint, then call
        ``eval_hook(trainer, state, step)`` (on every rank: the
        evaluation is sharded over them).  Over a mesh, ``train_iter``
        yields this rank's samples (``shard_batch``)."""
        cfg = self.cfg.train
        total = max_steps or cfg.steps
        t_last = time.time()
        step_i = state.step
        for batch in device_prefetch(train_iter, self.device):
            if step_i >= total:
                break
            warmup = (self.self_supervised and
                      step_i <= self.cfg.loss.warmup_steps)
            state, metrics = train_step(
                state, batch, self.cfg, self.optimizer, warmup=warmup,
                self_supervised=self.self_supervised, mesh=self.mesh)
            step_i += 1
            if step_i % cfg.display_step == 0 or step_i <= 1:
                row = {k: float(v) for k, v in metrics.items()}
                row["steptime_ms"] = ((time.time() - t_last) /
                                      max(cfg.display_step, 1) * 1e3)
                t_last = time.time()
                self.history.append((step_i, row))
                self.logger.log_metrics(row, step_i)
            if step_i % cfg.steps_per_eval == 0:
                self._save(step_i, state)
                if eval_hook is not None:
                    eval_hook(self, state, step_i)
            elif (cfg.checkpoint_interval and
                  step_i % cfg.checkpoint_interval == 0):
                self._save(step_i, state)
        self._save(state.step, state)
        return state

    def _save(self, step: int, state: TrainState):
        if self.rank0:
            self.ckpt.save(step, state)
