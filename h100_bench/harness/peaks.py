"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit) and the least time a call could take (a copy
of the program's ``chip_smoke.py::bound_ms``)."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def bound_s(n_bytes: float, flops: float = 0.0, dtype: str = "bf16"):
    """The larger of the bytes over HBM's rate and the operations over
    the peak rate of their type, in seconds."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
