"""Carry JAX/flax weights into the port.

``state_dict_from_flax`` maps a flax variables tree ``{"params": ...,
"batch_stats": ...}`` (nested dicts of numpy arrays) to the port's
``state_dict``.  The port's modules carry the flax module names, so a
leaf's dotted path is its torch name, with these layout changes:

  * flax ``nn.Conv`` kernels (the only 4-D leaves) go from HWIO
    (kh, kw, Cin/groups, Cout) to torch's OIHW (Cout, Cin/groups, kh, kw)
    and are named ``weight``;
  * flax ``nn.Dense`` kernels (the only 2-D ones) go from (in, out) to
    ``nn.Linear``'s (out, in) ``weight``;
  * the dense 3-D conv kernels (``models/middle_dense.py``, the only
    5-D ones) go from DHWIO (kd, kh, kw, Cin, Cout) to (Cout, Cin, kd,
    kh, kw) ``weight``, for the transposed convs too;
  * sparse-conv kernels stay (K, Cin, Cout);
  * BN ``scale``/``bias`` params and statistics (``mean``/``var``, and
    the semi-global BN's dynamic momenta, g^2 and probes) map one to
    one.

``load_flax_variables`` loads the result with ``strict=True``, so every
flax leaf is used exactly once and every torch tensor is set.
``flax_path`` and ``to_flax_leaf`` go the other way, from a torch name
and tensor to the flax collection, path and layout.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from .models.semiglobal_bn import STATS as _STATS


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, val


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected flax collections {sorted(unknown)}")
    for col in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(col, {})):
            arr = np.asarray(leaf, dtype=np.float32)
            if path[-1] == "kernel" and arr.ndim in _WEIGHT_NDIMS:
                path = path[:-1] + ("weight",)
                arr = arr.transpose(*_FROM_FLAX[arr.ndim])
            name = ".".join(path)
            if name in out:
                raise ValueError(f"flax leaf {col}/{'/'.join(path)} maps to "
                                 f"{name!r} twice")
            out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load flax variables into ``module`` (strict: every leaf used
    exactly once, no torch tensor left unset)."""
    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    return module


# flax kernel layout -> torch weight layout, by rank: conv HWIO -> OIHW,
# dense (in, out) -> (out, in), 3-D conv DHWIO -> OIDHW; and back
_FROM_FLAX = {4: (3, 2, 0, 1), 2: (1, 0), 5: (4, 3, 0, 1, 2)}
_TO_FLAX = {4: (2, 3, 1, 0), 2: (1, 0), 5: (2, 3, 4, 1, 0)}
_WEIGHT_NDIMS = tuple(_FROM_FLAX)


def flax_path(name: str, ndim: int) -> Tuple[str, Tuple[str, ...]]:
    """The flax (collection, path) of the port's tensor ``name`` with
    ``ndim`` dimensions: BN running statistics (``mean`` and ``var``,
    and the semi-global BN's six more) live in "batch_stats",
    everything else in "params"; a 4-D conv, 5-D 3-D conv or 2-D dense
    ``weight`` is a flax ``kernel``."""
    path = tuple(name.split("."))
    if path[-1] == "weight" and ndim in _WEIGHT_NDIMS:
        path = path[:-1] + ("kernel",)
    return ("batch_stats" if path[-1] in _STATS else "params"), path


def to_flax_leaf(name: str, tensor: torch.Tensor) -> np.ndarray:
    """The port's tensor as a numpy array in the flax layout of
    ``flax_path(name, tensor.dim())`` (OIHW conv weights -> HWIO, dense
    (out, in) -> (in, out), OIDHW -> DHWIO)."""
    arr = tensor.detach().float().cpu().numpy()
    if name.endswith(".weight") and arr.ndim in _WEIGHT_NDIMS:
        arr = arr.transpose(*_TO_FLAX[arr.ndim])
    return arr


def is_flax_kernel(name: str, ndim: int) -> bool:
    """True for the leaves flax names ``kernel`` (sparse-conv kernels,
    dense 2-D and 3-D conv weights and dense-layer weights): the only
    ones that take weight decay."""
    return flax_path(name, ndim)[1][-1] == "kernel"
