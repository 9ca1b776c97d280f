"""Single-card training loop (counterpart of
``rslo_tpu/train/loop.py``): state from the seed or the latest
checkpoint, then the step loop with the host-side warmup switch and
periodic checkpoints.  TensorBoard logging, warm-start surgery and the
CLI verb are not ported; metrics are kept in ``Trainer.history``."""
from __future__ import annotations

import time
from pathlib import Path
from typing import Iterable, Optional

import torch

from ..config.schema import PipelineCfg
from ..convert import is_flax_kernel
from ..models.net import OdomNet
from .checkpoint import CheckpointManager
from .optim import build_optimizer
from .state import TrainState
from .step import train_step


def device_prefetch(batches: Iterable[dict], device):
    """Move each batch's tensors to ``device`` (non-blocking from
    pinned host memory where the batch is numpy)."""
    for b in batches:
        yield {k: torch.as_tensor(v).to(device, non_blocking=True)
               for k, v in b.items() if k != "meta"}


def make_optimizer(cfg: PipelineCfg, model: torch.nn.Module):
    """``build_optimizer`` for ``model``'s parameters plus the alphas,
    with weight decay on the flax ``kernel`` leaves only."""
    params = dict(model.named_parameters())
    return build_optimizer(
        cfg.optimizer, cfg.train,
        decays=lambda n: n in params and is_flax_kernel(n, params[n].dim()))


class Trainer:
    def __init__(self, cfg: PipelineCfg, model_dir: str, device="cuda",
                 self_supervised: bool = True):
        self.cfg = cfg
        self.model_dir = Path(model_dir)
        self.device = torch.device(device)
        self.self_supervised = self_supervised
        self.ckpt = CheckpointManager(str(self.model_dir / "ckpt"),
                                      cfg.train.checkpoint_max_keep)
        self.history = []        # (step, {metric: float})
        self.optimizer = None

    def init_state(self, ckpt_step: Optional[int] = None) -> TrainState:
        """A fresh state from ``cfg.train.seed``, or the checkpoint at
        ``ckpt_step`` (the latest one when there is any)."""
        gen = torch.Generator().manual_seed(self.cfg.train.seed)
        net = OdomNet(self.cfg, gen).to(self.device).train()
        self.optimizer = make_optimizer(self.cfg, net)
        state = TrainState.create(
            net, self.optimizer,
            {"rot": self.cfg.loss.rotation_init_alpha,
             "trans": self.cfg.loss.translation_init_alpha})
        restored = self.ckpt.restore(state, step=ckpt_step)
        return state if restored is None else restored

    def fit(self, train_iter: Iterable[dict], state: TrainState,
            max_steps: Optional[int] = None) -> TrainState:
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
                self_supervised=self.self_supervised)
            step_i += 1
            if step_i % cfg.display_step == 0 or step_i <= 1:
                row = {k: float(v) for k, v in metrics.items()}
                row["steptime_ms"] = ((time.time() - t_last) /
                                      max(cfg.display_step, 1) * 1e3)
                t_last = time.time()
                self.history.append((step_i, row))
            if step_i % cfg.steps_per_eval == 0:
                self.ckpt.save(step_i, state)
            elif (cfg.checkpoint_interval and
                  step_i % cfg.checkpoint_interval == 0):
                self.ckpt.save(step_i, state)
        self.ckpt.save(state.step, state)
        return state
