"""Seeded weights, made on the device in a few large calls and loaded by
name into the program's net and the reference's alike."""
from __future__ import annotations

from typing import Dict

import torch

# flax's truncated normal: N(0, 1) cut at +-2, over the cut normal's std
_TRUNC_STD = 0.87962566103423978


def init_std(name: str, shape) -> float:
    """flax's initializers by leaf: He-normal sparse-conv kernels (taps,
    Cin, Cout), LeCun-normal conv weights (Cout, Cin/groups, kh, kw) and
    dense weights (out, in)."""
    if name.endswith(".kernel") and len(shape) == 3:
        return (2.0 / (shape[0] * shape[1])) ** 0.5
    if len(shape) == 4:
        return (1.0 / (shape[1] * shape[2] * shape[3])) ** 0.5
    if len(shape) == 2:
        return (1.0 / shape[1]) ** 0.5
    raise ValueError(f"no initializer for {name} {tuple(shape)}")


def make_weights(model: torch.nn.Module, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``model`` (shapes only are read)
    made from ``seed``: one normal draw on the device for all weights,
    cut at +-2 and scaled per leaf; biases zero but the pose heads' (the
    identity pose), BN scales one, running means zero and variances
    one."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = list(model.named_parameters())
    multi = [(n, p.shape) for n, p in params if len(p.shape) > 1]
    total = sum(int(torch.Size(s).numel()) for _, s in multi)
    draw = torch.randn(total, generator=gen, device=device)
    draw = torch.clamp(draw, -2.0, 2.0) / _TRUNC_STD
    out, off = {}, 0
    for n, s in multi:
        k = int(torch.Size(s).numel())
        out[n] = (draw[off:off + k] * init_std(n, s)).reshape(s)
        off += k
    for n, p in params:
        if len(p.shape) > 1:
            continue
        leaf = n.split(".")[-1]
        if leaf == "scale":
            out[n] = torch.ones(p.shape, device=device)
        elif leaf == "bias":
            t = torch.zeros(p.shape, device=device)
            if n.startswith("bev_net.") and n.count(".") == 2 and \
                    tuple(p.shape) == (7,):
                t[3] = 1.0        # a 7-wide pose head: the identity pose
            out[n] = t
        else:
            raise ValueError(f"no initializer for {n} {tuple(p.shape)}")
    for n, b in model.named_buffers():
        leaf = n.split(".")[-1]
        if leaf == "mean":
            out[n] = torch.zeros(b.shape, device=device)
        elif leaf == "var":
            out[n] = torch.ones(b.shape, device=device)
        else:
            raise ValueError(f"no initializer for buffer {n}")
    return out


def build(net_cls, cfg, weights, device) -> torch.nn.Module:
    """``net_cls(cfg)`` built without drawing its own init (on the meta
    device), placed on ``device`` and loaded with ``weights``."""
    with torch.device("meta"):
        net = net_cls(cfg)
    net = net.to_empty(device=device)
    net.load_state_dict(weights, strict=True)
    return net


def shapes_model(net_cls, cfg) -> torch.nn.Module:
    """The net on the meta device: its leaves' names and shapes."""
    with torch.device("meta"):
        return net_cls(cfg)
