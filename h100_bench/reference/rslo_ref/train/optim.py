"""Optimizer and learning-rate schedules (counterpart of
``rslo_tpu/train/optim.py``, which builds them from optax).

``build_optimizer`` gives the same update as the optax chain there:
global-norm clipping over every trainable leaf (parameters and loss
alphas together), Adam with b1 from the OneCycle momentum schedule,
b2 0.99 and eps 1e-8, decoupled weight decay on the flax ``kernel``
leaves only (the sparse-conv kernels and the dense conv weights, never
BN terms, biases or alphas), and a step of -lr from the OneCycle lr
schedule.  The schedules are evaluated at the optimizer's own update
count, as optax's ``inject_hyperparams`` does, and in f32 like the JAX
schedules.  ``group_lr_mult`` scales the final update of each trainable
whose label contains a key (the first such key) by that key's
multiplier, with the JAX package's labels: the top-level key of its
trainable tree {"params": ..., "alphas": ...}, i.e. "params" for every
model parameter and "alphas" for the loss alphas.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch

from ..config.schema import OptimizerCfg, TrainCfg

_F32 = torch.float32


def _cosine_ramp(a: float, b: float, frac: torch.Tensor) -> torch.Tensor:
    """a + (b - a) * 0.5 * (1 - cos(pi * frac)) in f32."""
    return a + (b - a) * 0.5 * (1 - torch.cos(math.pi * frac))


def onecycle_lr(cfg: OptimizerCfg, total_steps: int) -> Callable:
    """OneCycle lr: cosine warmup from lr_max/div to lr_max over
    pct_start of the steps, then cosine anneal to ~0."""
    lr_max = cfg.lr_max
    lr_start = lr_max / cfg.onecycle_div_factor
    warm = max(int(total_steps * cfg.onecycle_pct_start), 1)

    def sched(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=_F32)
        warm_f = torch.tensor(warm, dtype=_F32)
        up = _cosine_ramp(lr_start, lr_max, torch.minimum(step, warm_f) /
                          warm_f)
        t = torch.clamp((step - warm_f) / max(total_steps - warm, 1),
                        0.0, 1.0)
        down = lr_max * 0.5 * (1 + torch.cos(math.pi * t)) + 1e-8
        return torch.where(step < warm_f, up, down)

    return sched


def onecycle_momentum(cfg: OptimizerCfg, total_steps: int) -> Callable:
    """OneCycle momentum (Adam's b1): m0 -> m1 over the warmup, then
    back to m0."""
    m0, m1 = cfg.onecycle_moms
    warm = max(int(total_steps * cfg.onecycle_pct_start), 1)

    def sched(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=_F32)
        warm_f = torch.tensor(warm, dtype=_F32)
        up = _cosine_ramp(m0, m1, torch.minimum(step, warm_f) / warm_f)
        t = torch.clamp((step - warm_f) / max(total_steps - warm, 1),
                        0.0, 1.0)
        down = _cosine_ramp(m1, m0, t)
        return torch.where(step < warm_f, up, down)

    return sched


def exponential_decay_warmup(lr_init: float, decay_steps: int,
                             decay_rate: float, warmup_steps: int = 0,
                             staircase: bool = True) -> Callable:
    """Exponential decay with linear warmup (the reference's
    ExponentialDecayWarmup): lr_init * decay_rate ** (step / decay_steps,
    floored with ``staircase``), times min(step / warmup_steps, 1)."""
    def sched(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=_F32)
        p = step / decay_steps
        if staircase:
            p = torch.floor(p)
        lr = lr_init * torch.pow(torch.tensor(decay_rate, dtype=_F32), p)
        if warmup_steps > 0:
            lr = lr * torch.clamp(step / warmup_steps, 0.0, 1.0)
        return lr
    return sched


def manual_stepping(boundaries, rates) -> Callable:
    """Piecewise-constant lr (ManualStepping): ``rates[i]`` from
    ``boundaries[i - 1]`` on."""
    def sched(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=_F32)
        lr = torch.tensor(rates[0], dtype=_F32)
        for b, r in zip(boundaries, rates[1:]):
            lr = torch.where(step >= b, torch.tensor(r, dtype=_F32), lr)
        return lr
    return sched


@dataclasses.dataclass
class AdamState:
    """Update count and Adam moments, keyed by trainable name."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @classmethod
    def from_state_dict(cls, d: dict) -> "AdamState":
        return cls(int(d["count"]), dict(d["mu"]), dict(d["nu"]))


def group_label(cfg: OptimizerCfg, name: str) -> str:
    """The ``group_lr_mult`` key whose multiplier scales the update of
    the trainable ``name`` (``alphas.<key>`` for a loss alpha), or
    "default" for none: the first key contained in the top-level key of
    the JAX package's trainable tree, "params" or "alphas"."""
    top = "alphas" if name.startswith("alphas.") else "params"
    for key, _ in cfg.group_lr_mult:
        if key in top:
            return key
    return "default"


class OneCycleAdamW:
    """The optax chain of the JAX package's ``build_optimizer`` on a
    dict of named tensors.  ``decays(name)`` says whether a trainable
    takes weight decay."""

    def __init__(self, cfg: OptimizerCfg, train_cfg: TrainCfg,
                 decays: Callable[[str], bool]):
        self.cfg = cfg
        self.lr = onecycle_lr(cfg, train_cfg.steps)
        self.b1 = onecycle_momentum(cfg, train_cfg.steps)
        self.b2 = 0.99
        self.eps = 1e-8
        self.decays = decays
        self.mults = dict(cfg.group_lr_mult)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(0, {k: torch.zeros_like(p) for k, p in
                             params.items()},
                         {k: torch.zeros_like(p) for k, p in
                          params.items()})

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor],
             state: AdamState) -> torch.Tensor:
        """Update ``params`` and ``state`` in place from ``grads``;
        returns the global gradient norm (before clipping)."""
        dev = next(iter(params.values())).device
        g_norm = torch.sqrt(sum(torch.sum(g.float() * g.float())
                                for g in grads.values()))
        max_norm = self.cfg.grad_clip_norm
        clip = g_norm >= max_norm
        lr = self.lr(state.count).to(dev)
        b1 = self.b1(state.count).to(dev)
        count = state.count + 1
        bc1 = 1 - b1 ** count
        bc2 = 1 - torch.tensor(self.b2, dtype=_F32, device=dev) ** count
        for name, p in params.items():
            g = grads[name]
            g = torch.where(clip, g / g_norm * max_norm, g)
            mu = (1 - b1) * g + b1 * state.mu[name]
            nu = (1 - self.b2) * (g * g) + self.b2 * state.nu[name]
            state.mu[name], state.nu[name] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.decays(name):
                u = u + self.cfg.weight_decay * p
            u = -1.0 * lr * u
            label = group_label(self.cfg, name)
            if label != "default":
                u = u * self.mults[label]
            p.add_(u)
        state.count = count
        return g_norm


def build_optimizer(cfg: OptimizerCfg, train_cfg: TrainCfg,
                    decays: Callable[[str], bool]) -> OneCycleAdamW:
    """The JAX package's optimizer; ``decays(name)`` marks the flax
    ``kernel`` leaves."""
    if cfg.optimizer != "adam":
        raise NotImplementedError(f"optimizer {cfg.optimizer!r} is not "
                                  f"ported; only 'adam'")
    return OneCycleAdamW(cfg, train_cfg, decays)
