"""Parameter surgery on the port's named tensors: regex include/exclude
filtering, key renaming, partial pretrained loading and freezing
(counterpart of ``rslo_tpu/utils/param_surgery.py``).

Every tensor is addressed by its flax path joined with "/" (the JAX
package's ``flatten`` keys, e.g. ``bev_net/ConvBNRelu_0/Conv_0/kernel``;
``convert.flax_path`` names it), so one ``--pretrained_include`` regex
selects the same leaves in both packages.  A flat tree here is a dict
{flax path: tensor} of one flax collection ("params" or
"batch_stats"); the tensors keep the port's layout.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional

import torch

from ..convert import flax_path


def flatten(tensors: Mapping[str, torch.Tensor],
            collection: str = "params") -> Dict[str, torch.Tensor]:
    """{torch name: tensor} -> {flax path: the same tensor} for the
    tensors of the flax ``collection``."""
    flat = {}
    for name, t in tensors.items():
        col, path = flax_path(name, t.dim())
        if col == collection:
            flat["/".join(path)] = t
    return flat


def filter_params(flat: Mapping[str, torch.Tensor],
                  include: Optional[str] = None,
                  exclude: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Keep the entries whose path matches ``include`` (if set) and does
    not match ``exclude`` (if set)."""
    out = {}
    for k, v in flat.items():
        if include is not None and re.search(include, k) is None:
            continue
        if exclude is not None and re.search(exclude, k) is not None:
            continue
        out[k] = v
    return out


def rename_params(flat: Mapping[str, torch.Tensor],
                  rename_map: Mapping[str, str]) -> Dict[str, torch.Tensor]:
    """Apply regex substitutions to every path (first match wins)."""
    out = {}
    for k, v in flat.items():
        nk = k
        for pat, rep in rename_map.items():
            nk2 = re.sub(pat, rep, nk)
            if nk2 != nk:
                nk = nk2
                break
        out[nk] = v
    return out


@torch.no_grad()
def load_pretrained(dst: Mapping[str, torch.Tensor],
                    pretrained: Mapping[str, torch.Tensor],
                    include: Optional[str] = None,
                    exclude: Optional[str] = None,
                    rename_map: Optional[Mapping[str, str]] = None,
                    strict_shapes: bool = True) -> List[str]:
    """Copy the matching ``pretrained`` entries into the tensors of the
    flat tree ``dst`` in place; returns the loaded paths.  A path whose
    shapes differ raises with ``strict_shapes``, else is skipped."""
    if rename_map:
        pretrained = rename_params(pretrained, rename_map)
    loaded = []
    for k, v in filter_params(pretrained, include, exclude).items():
        if k not in dst:
            continue
        if dst[k].shape != v.shape:
            if strict_shapes:
                raise ValueError(f"shape mismatch at {k}: "
                                 f"{tuple(dst[k].shape)} vs {tuple(v.shape)}")
            continue
        dst[k].copy_(v)
        loaded.append(k)
    return loaded


def freeze_mask(tensors: Mapping[str, torch.Tensor],
                frozen_pattern: str) -> Dict[str, bool]:
    """{torch name: True where its flax path matches the pattern}."""
    return {name: bool(re.search(frozen_pattern,
                                 "/".join(flax_path(name, t.dim())[1])))
            for name, t in tensors.items()}
