"""Checkpoint store (counterpart of ``rslo_tpu/train/checkpoint.py``):
numbered step checkpoints written with ``torch.save``, ``latest``
resolution and max_to_keep pruning."""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 8):
        self.dir = Path(directory).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step}.pt"

    def all_steps(self):
        return sorted(int(p.stem[5:]) for p in self.dir.glob("step_*.pt"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state):
        """Write ``state.state_dict()`` at ``step`` (once per step), then
        prune the oldest beyond ``max_to_keep``."""
        if step in self.all_steps():
            return
        tmp = self.dir / f".step_{step}.{os.getpid()}.tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            self._path(old).unlink()

    def restore(self, state, step: Optional[int] = None):
        """Load the checkpoint at ``step`` (the latest by default) into
        ``state``; None when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        d = torch.load(self._path(step), map_location="cpu",
                       weights_only=False)
        dev = next(state.model.parameters()).device
        d["opt_state"]["mu"] = {k: v.to(dev) for k, v in
                                d["opt_state"]["mu"].items()}
        d["opt_state"]["nu"] = {k: v.to(dev) for k, v in
                                d["opt_state"]["nu"].items()}
        state.load_state_dict(d)
        return state
