"""The sparse conv and its gradient in plain PyTorch: the contract of the
program's ``ops/dma_gather.py``, with each kernel replaced by its plain
version on every device.

  * ``gather_matmul`` is ``sparse_conv_apply``: ``out[v] = sum_k
    valid[v,k] * f[idx[v,k]] @ W[k]`` (+ bias, zeroed where ``out_mask``
    is false), operands rounded to the compute dtype, f32 sums;
  * ``gather_matmul_dgrad`` is ``sparse_conv_dgrad`` over the transposed
    rulebook;
  * ``row_gather`` is ``features[idx]``, with ``valid``/``compute_dtype``
    the d_W im2col (invalid taps zeroed, rounded);
  * ``sparse_conv`` is the differentiable conv with JAX's autodiff of
    ``sparse_conv_apply`` as its backward.
"""
from __future__ import annotations

from typing import Optional

import torch

from .precision import f32_matmul
from .sparse_conv import (ConvIndex, round_operand, sparse_conv_apply,
                          sparse_conv_dgrad)


def gather_matmul(features: torch.Tensor, idx: torch.Tensor,
                  valid: torch.Tensor, weights: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  out_mask: Optional[torch.Tensor] = None,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    return sparse_conv_apply(features, ConvIndex(idx, valid), weights, bias,
                             out_mask, compute_dtype)


def gather_matmul_dgrad(ct: torch.Tensor, idx_t: torch.Tensor,
                        valid_t: torch.Tensor, weights_t: torch.Tensor,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    return sparse_conv_dgrad(ct, ConvIndex(idx_t, valid_t), weights_t,
                             compute_dtype)


def row_gather(features: torch.Tensor, idx: torch.Tensor,
               check: bool = True, valid: Optional[torch.Tensor] = None,
               compute_dtype=None) -> torch.Tensor:
    g = features[idx.long()]
    if valid is not None:
        g = torch.where(valid[:, None], g, 0.0)
    if valid is not None or compute_dtype is not None:
        return round_operand(g, compute_dtype or torch.float32)
    return g


class _SparseConv(torch.autograd.Function):
    """``gather_matmul`` with JAX's autodiff of ``sparse_conv_apply`` as
    its backward (see the program's ``ops/dma_gather.py::_SparseConv``)."""

    @staticmethod
    def forward(ctx, features, weights, bias, rulebook, rulebook_t,
                flip_taps, out_mask, compute_dtype):
        ctx.save_for_backward(features, weights, rulebook.idx,
                              rulebook.valid, rulebook_t.idx,
                              rulebook_t.valid, out_mask)
        ctx.flip_taps = flip_taps
        ctx.compute_dtype = compute_dtype
        return gather_matmul(features, rulebook.idx, rulebook.valid,
                             weights, bias, out_mask, compute_dtype)

    @staticmethod
    def backward(ctx, ct):
        features, weights, idx, valid, idx_t, valid_t, out_mask = \
            ctx.saved_tensors
        ct = ct.contiguous()
        if out_mask is not None:
            ct = torch.where(out_mask[:, None], ct, 0.0)
        d_feat, d_w = sparse_conv_grads(
            features, weights, ConvIndex(idx, valid),
            ConvIndex(idx_t, valid_t), ctx.flip_taps, ct, ctx.compute_dtype,
            *ctx.needs_input_grad[:2])
        d_bias = ct.sum(0) if ctx.needs_input_grad[2] else None
        return d_feat, d_w, d_bias, None, None, None, None, None


def sparse_conv_grads(features: torch.Tensor, weights: torch.Tensor,
                      rulebook: ConvIndex, rulebook_t: ConvIndex,
                      flip_taps: bool, ct: torch.Tensor, compute_dtype,
                      need_features: bool = True,
                      need_weights: bool = True):
    """(d_features, d_W) for the output cotangent ``ct`` (already zeroed
    where ``out_mask`` is false); either is None when not needed."""
    d_feat = d_w = None
    if need_features:
        w_t = round_operand(weights, compute_dtype)
        if flip_taps:
            w_t = w_t.flip(0)
        d_feat = gather_matmul_dgrad(
            ct, rulebook_t.idx, rulebook_t.valid,
            w_t.transpose(1, 2).contiguous(), compute_dtype)
    if need_weights:
        V, K = rulebook.idx.shape
        Cin = features.shape[1]
        g = row_gather(features.contiguous(), rulebook.idx.reshape(-1),
                       check=False, valid=rulebook.valid.reshape(-1),
                       compute_dtype=compute_dtype)
        with f32_matmul():
            d_w = g.reshape(V, K * Cin).t() @ ct
        d_w = round_operand(d_w, compute_dtype).reshape(K, Cin, -1)
    return d_feat, d_w


def sparse_conv(features: torch.Tensor, rulebook: ConvIndex,
                rulebook_t: ConvIndex, weights: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_mask: Optional[torch.Tensor] = None,
                compute_dtype=torch.bfloat16,
                flip_taps: bool = False) -> torch.Tensor:
    return _SparseConv.apply(features, weights, bias, rulebook,
                             rulebook_t, flip_taps, out_mask,
                             compute_dtype)
