"""Checkpoint store (counterpart of ``rslo_tpu/train/checkpoint.py``):
numbered step checkpoints written with ``torch.save``, ``latest``
resolution, max_to_keep pruning, a pruning-immune copy of the best
step in the sibling ``ckpt_best/``, and raw reads of another run's
latest checkpoint for warm starts."""
from __future__ import annotations

import os
import shutil
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
        return _steps(self.dir)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @property
    def best_dir(self) -> Path:
        return self.dir.parent / "ckpt_best"

    def preserve(self, step: int):
        """Copy a saved step into ``ckpt_best/``, which pruning never
        touches (max_to_keep may prune the best periodic-val step of a
        long run).  Keeps exactly one preserved step."""
        src = self._path(step)
        if not src.exists():
            return
        tmp = self.dir.parent / ".ckpt_best.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        shutil.copy2(src, tmp / src.name)
        shutil.rmtree(self.best_dir, ignore_errors=True)
        tmp.rename(self.best_dir)

    @staticmethod
    def restore_raw_from(path: str) -> dict:
        """Another run's latest checkpoint as its raw dict ("model",
        "alphas", "opt_state", "step"), for warm-start surgery across
        differing architectures.  ``path`` is a model dir or its
        ``ckpt/``."""
        p = Path(path)
        if (p / "ckpt").exists():
            p = p / "ckpt"
        steps = _steps(p)
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {p}")
        return torch.load(p / f"step_{steps[-1]}.pt", map_location="cpu",
                          weights_only=False)

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
        ``state``; None when there is none.  A step pruned from
        ``ckpt/`` is read from ``ckpt_best/`` when it is preserved
        there."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = self._path(step)
        if not path.exists() and (self.best_dir / path.name).exists():
            path = self.best_dir / path.name
        d = torch.load(path, map_location="cpu", weights_only=False)
        dev = next(state.model.parameters()).device
        d["opt_state"]["mu"] = {k: v.to(dev) for k, v in
                                d["opt_state"]["mu"].items()}
        d["opt_state"]["nu"] = {k: v.to(dev) for k, v in
                                d["opt_state"]["nu"].items()}
        state.load_state_dict(d)
        return state


def _steps(directory: Path):
    return sorted(int(p.stem[5:]) for p in directory.glob("step_*.pt"))
