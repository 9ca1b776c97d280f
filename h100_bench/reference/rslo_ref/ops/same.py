"""flax's ``padding="SAME"`` for NCHW convs and pools: asymmetric at
stride 2 on an even size (the pad goes (0, 1), not torch's (1, 1)), so
every conv and pool pads explicitly and then runs unpadded."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """flax's SAME padding (before, after) of a ``size``-long axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, s: int,
             value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor as flax/XLA ``padding="SAME"`` does."""
    ph = same_pad(x.shape[-2], k, s)
    pw = same_pad(x.shape[-1], k, s)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def same_op(op, x: torch.Tensor, k: int, s: int,
            value: float = 0.0) -> torch.Tensor:
    """``op`` (a conv or a pool of kernel ``k`` and stride ``s`` that
    pads nothing itself) over ``x`` padded as flax's SAME does."""
    return op(pad_same(x, k, s, value))
