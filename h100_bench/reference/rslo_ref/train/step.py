"""The self-supervised train step on one card, as the program's
``train/step.py::train_step`` computes it without a data mesh: voxelize
on the device, forward with train-mode BN, the objective, the backward
and the OneCycle AdamW update (``make_optimizer`` is the program's
``train/loop.py::make_optimizer``)."""
from __future__ import annotations

from typing import Dict

import torch

from ..config.schema import PipelineCfg
from ..data.prepare import mean_vfe_ok, prepare_example, voxelizer_config
from ..losses.objective import compute_objective
from .optim import build_optimizer
from .state import TrainState


def is_flax_kernel(name: str, ndim: int) -> bool:
    """The leaves flax names ``kernel`` (sparse-conv kernels, conv and
    dense-layer weights): the only ones that take weight decay."""
    last = name.split(".")[-1]
    return last == "kernel" or (last == "weight" and ndim in (2, 4, 5))


def make_optimizer(cfg: PipelineCfg, model: torch.nn.Module):
    params = dict(model.named_parameters())
    return build_optimizer(
        cfg.optimizer, cfg.train,
        decays=lambda n: n in params and is_flax_kernel(n, params[n].dim()))


def prepare_batch(batch: Dict[str, torch.Tensor],
                  cfg: PipelineCfg) -> Dict[str, torch.Tensor]:
    example = prepare_example(batch["points"], batch["point_mask"],
                              voxelizer_config(cfg),
                              mean_mode=mean_vfe_ok(cfg))
    for k in ("odometry", "hier_points", "hier_mask"):
        if k in batch:
            example[k] = batch[k]
    return example


def loss_and_grads(state: TrainState, batch: Dict[str, torch.Tensor],
                   cfg: PipelineCfg, *, warmup: bool):
    model = state.model.train()
    example = prepare_batch(batch, cfg)
    preds = model(example)
    out = compute_objective(preds, example, state.alphas, cfg.loss,
                            cfg.voxelizer.point_cloud_range,
                            warmup=warmup, self_supervised=True)
    params = state.trainable()
    grads = torch.autograd.grad(out.total, list(params.values()),
                                allow_unused=True)
    return out, {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               cfg: PipelineCfg, optimizer, *, warmup: bool):
    """One step, in place; returns (state, metrics): the objective's aux
    terms, the alphas before the update and ``grad_norm``."""
    out, grads = loss_and_grads(state, batch, cfg, warmup=warmup)
    metrics = dict(out.aux)
    metrics.update({f"alpha_{k}": v.detach().clone()
                    for k, v in state.alphas.items()})
    metrics["grad_norm"] = optimizer.step(state.trainable(), grads,
                                          state.opt_state)
    state.step += 1
    return state, metrics
