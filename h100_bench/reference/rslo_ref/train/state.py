"""Train state (counterpart of ``rslo_tpu/train/state.py``): the model
(parameters and BN running statistics), the learned loss alphas, the
optimizer state and the step."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from .optim import AdamState


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    alphas: Dict[str, torch.Tensor]      # learned loss log-variances
    opt_state: AdamState
    step: int

    @classmethod
    def create(cls, model: nn.Module, optimizer,
               init_alphas: Dict[str, float]) -> "TrainState":
        dev = next(model.parameters()).device
        alphas = {k: torch.tensor(float(v), device=dev, requires_grad=True)
                  for k, v in init_alphas.items()}
        state = cls(model, alphas, None, 0)
        state.opt_state = optimizer.init(state.trainable())
        return state

    def trainable(self) -> Dict[str, torch.Tensor]:
        """Every trainable tensor by name: the model's parameters and
        the alphas (as ``alphas.<key>``)."""
        out = dict(self.model.named_parameters())
        out.update({f"alphas.{k}": v for k, v in self.alphas.items()})
        return out

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "alphas": {k: v.detach() for k, v in self.alphas.items()},
                "opt_state": self.opt_state.state_dict(),
                "step": self.step}

    def load_state_dict(self, d: dict):
        self.model.load_state_dict(d["model"])
        with torch.no_grad():
            for k, v in d["alphas"].items():
                self.alphas[k].copy_(v)
        self.opt_state = AdamState.from_state_dict(d["opt_state"])
        self.step = int(d["step"])
