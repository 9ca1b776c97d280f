"""The train step and the eval step (counterparts of
``rslo_tpu/train/step.py::make_train_step`` and ``make_eval_step``).

The batch holds raw padded points; voxelization runs on the device
inside the step.  The warmup phase (identity-R consistency and the
longer inner ICP) is the caller's host-side choice, as in the JAX
package.  Given a data mesh of several ranks, the train step is JAX's
data-parallel ``shard_map`` step: each rank runs its own sample's
forward and backward with the "data" axis bound (so the sync BNs pool
their statistics), then every gradient and loss term is averaged over
the ranks, every rank applies the same update, and the BN running
statistics are averaged.  The eval step needs no collective: eval-mode
BN reads the running statistics.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from ..config.schema import PipelineCfg
from ..data.prepare import mean_vfe_ok, prepare_example, voxelizer_config
from ..losses.objective import compute_objective
from ..utils.mesh_axis import bind_axis
from ..utils.timing import span
from .distributed import pmean_
from .state import TrainState


def prepare_batch(batch: Dict[str, torch.Tensor],
                  cfg: PipelineCfg) -> Dict[str, torch.Tensor]:
    """Raw batch {"points" (L, N, F), "point_mask" (L, N), and for
    training "odometry" (P, 7) and optionally the hier clouds
    "hier_points" (L, Nh, 6), "hier_mask" (L, Nh)} -> the model's
    example: pre-encoded mean features for the mean VFE, the point
    stacks for any other (``mean_vfe_ok``), with the training keys
    carried along."""
    example = prepare_example(batch["points"], batch["point_mask"],
                              voxelizer_config(cfg),
                              mean_mode=mean_vfe_ok(cfg))
    for k in ("odometry", "hier_points", "hier_mask"):
        if k in batch:
            example[k] = batch[k]
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
    with span("objective"):
        out = compute_objective(preds, example, state.alphas, cfg.loss,
                                cfg.voxelizer.point_cloud_range,
                                warmup=warmup,
                                self_supervised=self_supervised)
    params = state.trainable()
    # the autograd engine's worker thread launches the backward's work
    # while this thread waits inside the span
    with span("backward"):
        grads = torch.autograd.grad(out.total, list(params.values()),
                                    allow_unused=True)
    return out, {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               cfg: PipelineCfg, optimizer, *, warmup: bool,
               self_supervised: bool = True, mesh=None):
    """One step: ``loss_and_grads`` then the optimizer update.  Updates
    ``state`` in place and returns it with the metrics: the objective's
    aux terms, ``grad_norm`` and the alphas before the update
    (``alpha_<key>``).  With ``mesh`` (``train/distributed.py::DataMesh``)
    of a process group, the data-parallel step: ``batch`` is this
    rank's sample; gradients and aux terms are averaged over the ranks
    before the update (``grad_norm`` is the averaged gradients'), the BN
    running statistics after it."""
    with span("train.step"):
        group = mesh.group if mesh is not None else None
        ctx = (bind_axis("data", group, mesh.size) if group is not None
               else contextlib.nullcontext())
        with ctx:
            out, grads = loss_and_grads(state, batch, cfg, warmup=warmup,
                                        self_supervised=self_supervised)
        metrics = dict(out.aux)
        if group is not None:
            metrics = {k: v.clone() for k, v in metrics.items()}
            pmean_(list(grads.values()) + list(metrics.values()), mesh)
        metrics.update({f"alpha_{k}": v.detach().clone()
                        for k, v in state.alphas.items()})
        with span("optimizer"):
            metrics["grad_norm"] = optimizer.step(state.trainable(), grads,
                                                  state.opt_state)
        if group is not None:
            with torch.no_grad():
                pmean_([b for b in state.model.buffers()
                        if b.is_floating_point()], mesh)
        state.step += 1
        return state, metrics


def eval_step(net: torch.nn.Module, batch: Dict[str, object],
              cfg: PipelineCfg, device="cuda", with_cov: bool = False):
    """The collated batch of one sample, {"points" (1, L, N, F),
    "point_mask" (1, L, N)} (numpy or tensors), -> odometry float32
    (1, P, 7) on ``device``; ``with_cov=True`` returns (odometry, voxel
    points (1, L, V, 3), covariance parameters (1, L, V, 7), voxel masks
    (1, L, V)), all float32 but the masks.  The net runs in eval mode
    (running BN statistics, which no forward moves) under
    ``torch.inference_mode``, and gets back the mode it was in: an eval
    hook runs in the middle of training.  Given pinned host tensors (as
    run_eval pins them), nothing here waits for the device."""
    raw = {}
    for k in ("points", "point_mask"):
        t = torch.as_tensor(batch[k])
        raw[k] = t.to(device, non_blocking=t.is_pinned())[0]
    was_training = net.training
    net.eval()
    try:
        with torch.inference_mode():
            preds = net(prepare_batch(raw, cfg), with_cov=with_cov)
            odom = preds["odometry"].float()[None]
            if not with_cov:
                return odom
            pts = torch.stack([f[:, :3].float()
                               for f in preds["voxel_features"]])
            covs = torch.stack([c.float() for c in preds["voxel_covs"]])
            msk = torch.stack(preds["voxel_masks"])
            return odom, pts[None], covs[None], msk[None]
    finally:
        net.train(was_training)
