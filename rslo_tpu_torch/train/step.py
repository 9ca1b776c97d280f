"""One train step on one card (counterpart of
``rslo_tpu/train/step.py::make_train_step``).

The batch holds raw padded points; voxelization runs on the device
inside the step.  The warmup phase (identity-R consistency and the
longer inner ICP) is the caller's host-side choice, as in the JAX
package.  Cross-card gradient and statistics averaging is not ported.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..config.schema import PipelineCfg
from ..data.prepare import mean_vfe_ok, prepare_example, voxelizer_config
from ..losses.objective import compute_objective
from .state import TrainState


def prepare_batch(batch: Dict[str, torch.Tensor],
                  cfg: PipelineCfg) -> Dict[str, torch.Tensor]:
    """Raw batch {"points" (L, N, F), "point_mask" (L, N), "odometry"
    (P, 7)} -> the model's mean-mode example."""
    if not mean_vfe_ok(cfg):
        raise NotImplementedError(
            f"VFE {cfg.vfe.name!r} is not ported; only the mean VFE")
    example = prepare_example(batch["points"], batch["point_mask"],
                              voxelizer_config(cfg), mean_mode=True)
    example["odometry"] = batch["odometry"]
    return example


def loss_and_grads(state: TrainState, batch: Dict[str, torch.Tensor],
                   cfg: PipelineCfg, *, warmup: bool,
                   self_supervised: bool = True):
    """Forward with train-mode BN (which updates the running
    statistics), objective and backward.  Returns (objective output,
    gradient of every trainable by name); a trainable the loss does not
    reach gets a zero gradient, as in JAX."""
    model = state.model.train()
    example = prepare_batch(batch, cfg)
    preds = model(example)
    out = compute_objective(preds, example, state.alphas, cfg.loss,
                            cfg.voxelizer.point_cloud_range,
                            warmup=warmup, self_supervised=self_supervised)
    params = state.trainable()
    grads = torch.autograd.grad(out.total, list(params.values()),
                                allow_unused=True)
    return out, {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               cfg: PipelineCfg, optimizer, *, warmup: bool,
               self_supervised: bool = True):
    """One step: ``loss_and_grads`` then the optimizer update.  Updates
    ``state`` in place and returns it with the metrics: the objective's
    aux terms, ``grad_norm`` and the alphas before the update
    (``alpha_<key>``)."""
    out, grads = loss_and_grads(state, batch, cfg, warmup=warmup,
                                self_supervised=self_supervised)
    metrics = dict(out.aux)
    metrics.update({f"alpha_{k}": v.detach().clone()
                    for k, v in state.alphas.items()})
    metrics["grad_norm"] = optimizer.step(state.trainable(), grads,
                                          state.opt_state)
    state.step += 1
    return state, metrics
