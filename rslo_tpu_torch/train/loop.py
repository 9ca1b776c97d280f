"""Single-card training loop (counterpart of
``rslo_tpu/train/loop.py``): state from the seed or the latest
checkpoint, then the step loop with the host-side warmup switch,
periodic checkpoints and an eval hook.  Metrics go to ``Trainer.logger``
(text, json-lines, TensorBoard events) and are kept in
``Trainer.history``.  ``init_state`` can warm-start from another run
(``utils/param_surgery.py``)."""
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
from .checkpoint import CheckpointManager
from .optim import build_optimizer
from .state import TrainState
from .step import eval_step, train_step


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
        self.logger = MetricLogger(model_dir)
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
        and whose shapes match, and the loss alphas."""
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
        ``eval_hook(trainer, state, step)``."""
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
                self.logger.log_metrics(row, step_i)
            if step_i % cfg.steps_per_eval == 0:
                self.ckpt.save(step_i, state)
                if eval_hook is not None:
                    eval_hook(self, state, step_i)
            elif (cfg.checkpoint_interval and
                  step_i % cfg.checkpoint_interval == 0):
                self.ckpt.save(step_i, state)
        self.ckpt.save(state.step, state)
        return state
