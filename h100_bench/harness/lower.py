"""The control: the reference computed one precision below the
configuration's bf16, as per-tensor scaled fp8 (e4m3): every operand of
a sparse conv that the reference rounds to bf16, and both operands of
every bf16 convolution and dense layer, are rounded through fp8 with a
scale that maps the tensor's largest magnitude to fp8's largest, 448."""
from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

FP8_MAX = 448.0
_OPS = ("conv2d", "conv_transpose2d", "linear", "conv3d")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through scaled fp8 e4m3, in its own dtype.  The
    gradient passes the rounding unchanged (the cast to fp8 has none of
    its own, so without this every leaf above a rounded operand would
    get no gradient and stay where it is)."""
    xf = x.float()
    amax = xf.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (xf.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return (xf + (q - xf.detach()).detach()).to(x.dtype)


class _Fp8Operands(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") in _OPS and len(args) >= 2 and \
                isinstance(args[0], torch.Tensor) and \
                args[0].dtype == torch.bfloat16:
            args = (fp8_round(args[0]), fp8_round(args[1])) + tuple(args[2:])
        return func(*args, **kwargs)


@contextlib.contextmanager
def fp8_reference(ref):
    """Within: the reference computes in scaled fp8 where the
    configuration says bf16."""
    mods = [ref.ops.sparse_conv, ref.ops.dma_gather]
    orig = [m.round_operand for m in mods]
    base = orig[0]

    def round_operand(x, compute_dtype):
        if compute_dtype == torch.bfloat16:
            return fp8_round(x.float()).to(torch.bfloat16).float()
        return base(x, compute_dtype)

    for m in mods:
        m.round_operand = round_operand
    try:
        with _Fp8Operands():
            yield
    finally:
        for m, f in zip(mods, orig):
            m.round_operand = f
