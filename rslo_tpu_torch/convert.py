"""Carry JAX/flax weights into the port.

``state_dict_from_flax`` maps a flax variables tree ``{"params": ...,
"batch_stats": ...}`` (nested dicts of numpy arrays) to the port's
``state_dict``.  The port's modules carry the flax module names, so a
leaf's dotted path is its torch name, with these layout changes:

  * flax ``nn.Conv`` kernels (the only 4-D leaves) go from HWIO
    (kh, kw, Cin/groups, Cout) to torch's OIHW (Cout, Cin/groups, kh, kw)
    and are named ``weight``;
  * sparse-conv kernels stay (K, Cin, Cout);
  * BN ``scale``/``bias`` params and ``mean``/``var`` statistics map
    one to one.

``load_flax_variables`` loads the result with ``strict=True``, so every
flax leaf is used exactly once and every torch tensor is set.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch
from torch import nn


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
            if path[-1] == "kernel" and arr.ndim == 4:
                path = path[:-1] + ("weight",)
                arr = arr.transpose(3, 2, 0, 1)
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
