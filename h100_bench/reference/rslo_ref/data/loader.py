"""The int16 transfer scales of the program's ``data/loader.py``, which
``data/prepare.py::dequantize_points`` reads."""
from __future__ import annotations

import numpy as np

QUANT_POS_SCALE = 128.0 / 32767.0
QUANT_UNIT_SCALE = 1.0 / 32767.0


def quant_scale(n_features: int) -> np.ndarray:
    s = np.full((n_features,), QUANT_UNIT_SCALE, np.float32)
    s[:3] = QUANT_POS_SCALE
    return s
