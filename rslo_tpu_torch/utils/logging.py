"""Metric logging: text + json-lines + TensorBoard, rank-0 gated
(counterpart of ``rslo_tpu/utils/logging.py``): a logger built with
``enabled=False`` (every rank of a data-parallel run but rank 0) opens,
prints and writes nothing.  The TensorBoard events go through the
package's own writer (``utils/tb_writer.py``), so the ``tensorboard``
package is not needed."""
from __future__ import annotations

import json
import time
from pathlib import Path

from .tb_writer import EventWriter


class MetricLogger:
    def __init__(self, model_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.dir = Path(model_dir)
        if not enabled:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        self.txt = open(self.dir / "log.txt", "a")
        self.jsonl = open(self.dir / "log.json.lst", "a")
        self.tb = EventWriter(str(self.dir / "tb"))

    def log_text(self, msg: str, step: int | None = None):
        if not self.enabled:
            return
        stamp = time.strftime("%H:%M:%S")
        line = f"[{stamp}]{'' if step is None else f' step={step}'} {msg}"
        print(line, flush=True)
        self.txt.write(line + "\n")
        self.txt.flush()

    def log_image(self, tag: str, img, step: int):
        """img: (H, W) or (H, W, C) float array in [0, 1]-ish range.
        The PNG encoder (PIL, else matplotlib) is imported here."""
        if not self.enabled:
            return
        import numpy as np
        img = np.asarray(img, np.float32)
        lo, hi = float(img.min()), float(img.max())
        img = (img - lo) / (hi - lo + 1e-12)
        if img.ndim == 2:
            img = img[..., None]
        self.tb.add_image(tag, img, step, dataformats="HWC")

    def log_metrics(self, metrics: dict, step: int):
        if not self.enabled:
            return
        flat = _flatten(metrics)
        self.jsonl.write(json.dumps({"step": step, **flat}) + "\n")
        self.jsonl.flush()
        for k, v in flat.items():
            if isinstance(v, (int, float)):
                self.tb.add_scalar(k, v, step)
        disp = ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else
                         f"{k}={v}" for k, v in flat.items())
        self.log_text(disp, step)

    def close(self):
        if not self.enabled:
            return
        self.txt.close()
        self.jsonl.close()
        self.tb.close()


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            try:
                out[key] = float(v)
            except (TypeError, ValueError):
                out[key] = str(v)
    return out
