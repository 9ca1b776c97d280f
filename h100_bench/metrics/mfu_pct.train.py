"""mfu_pct.train: the model's operations a step (three forwards), counted
by the benchmark (``harness/counts.py``), over the window's time a step
and the bf16 peak (the configuration's compute dtype)."""
from harness import peaks


def read(rec):
    c = rec.counts
    if rec.kind != "train" or c is None or not rec.steps or \
            rec.trace is None or not rec.trace.n_device_ops:
        return None
    return 100.0 * c.model_flops / (rec.step_s() * peaks.PEAK_FLOPS["bf16"])
