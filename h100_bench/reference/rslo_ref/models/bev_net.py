"""BEV odometry encoder/decoder with confidence voting (the plain copy
of ``rslo_tpu_torch/models/bev_net.py`` at the options the benchmark's
configurations run): basic blocks, plain mask convs, BN with the card's
own batch statistics (``bn_type`` "bn" or "sync_bn": one card holds
the batch), the masked softmax confidences, the dense tq map with deep
supervision, and the confidence-weighted vote.  Other options raise.

Public tensors keep the JAX layout — the pair input is (P, H, W, 2C)
and every output map is (P, H, W, C) — and the net converts to NCHW
only inside.  Every feature tensor travels with a validity mask; convs
propagate it by max-pooling, residual adds average the masks.

Convs and pools pad as flax's ``padding="SAME"`` (``ops/same.py``).
dtypes follow flax's promotion: a conv built with the net's compute
dtype (``MaskConv``, ``ConvBNRelu``) casts its input to it; heads
without a dtype (the tq and confidence 1x1 convs) compute in f32.

Submodules carry the flax auto-names of the reference (``BasicBlock_<i>``,
``ConvBNRelu_<i>``, ``Conv_<i>``, ...), as the program's do.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import OdomCfg
from ..geometry import decode_tq_map
from ..ops.same import same_op
from .middle import update_running_stats

# the options this copy runs: {field: allowed values}
SUPPORTED = {"conv_type": ("mask_conv",), "block_type": ("basic",),
             "conf_type": ("softmax",), "bn_type": ("none", "bn", "sync_bn"),
             "dense_predict": (True,), "use_svd": (False,),
             "use_se": (False,), "use_sa": (False,),
             "multi_level_odom": (False,)}


def identity_pose_bias(n: int = 7) -> torch.Tensor:
    """Bias of 7-channel tq heads: the identity pose [0,0,0, 1,0,0,0]."""
    b = torch.zeros(n)
    b[3] = 1.0
    return b


def max_pool_mask(mask: torch.Tensor, kernel: int,
                  stride: int) -> torch.Tensor:
    """Max-pool an (N, 1, H, W) mask with SAME padding."""
    return same_op(lambda m: F.max_pool2d(m, kernel, stride), mask, kernel,
                   stride, float("-inf"))


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``conv`` with SAME padding, computed in ``dtype`` (flax's
    ``dtype=``; the input's dtype when None)."""
    if dtype is not None:
        x = x.to(dtype)
    k, s = conv.kernel_size[0], conv.stride[0]
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    w = conv.weight.to(x.dtype)
    return same_op(lambda xp: F.conv2d(xp, w, b, s, 0, 1, conv.groups), x,
                   k, s)


class MaskConv(nn.Module):
    """Conv on features (no bias); the mask is max-pooled."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, stride,
                                groups=groups, bias=False)

    def forward(self, x, mask):
        k, s = self.Conv_0.kernel_size[0], self.Conv_0.stride[0]
        return _conv(self.Conv_0, x, self.dtype), max_pool_mask(mask, k, s)


class Norm(nn.Module):
    """BatchNorm, computed in f32 and cast back to the input dtype.
    Train mode normalizes with the statistics of the whole (N, H, W)
    batch, unmasked (biased variance), and updates the running
    statistics as 0.99 * old + 0.01 * batch; eval mode applies them.
    bn_type "none" is the identity."""

    def __init__(self, num_features: int, bn_type: str = "sync_bn",
                 eps: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        if bn_type not in SUPPORTED["bn_type"]:
            raise ValueError(f"bn_type {bn_type!r}: this copy runs "
                             f"{SUPPORTED['bn_type']}")
        self.bn_type = bn_type
        self.eps = eps
        self.momentum = momentum
        if bn_type != "none":
            self.scale = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
            self.register_buffer("mean", torch.zeros(num_features))
            self.register_buffer("var", torch.ones(num_features))

    def forward(self, x):
        if self.bn_type == "none":
            return x
        shape = (1, -1, 1, 1)
        xf = x.float()
        if self.training:
            dims = (0,) + tuple(range(2, xf.dim()))
            mean = torch.mean(xf, dim=dims)
            m2 = torch.mean(xf * xf, dim=dims)
            var = torch.maximum(m2 - mean * mean, torch.zeros_like(m2))
            update_running_stats(self, mean, var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) +
                                                  self.eps)
        y = y * self.scale.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class BasicBlock(nn.Module):
    """Mask-aware ResNet BasicBlock; the residual add averages masks."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 bn_type: str = "sync_bn", groups: int = 1, dtype=None):
        super().__init__()
        self.MaskConv_0 = MaskConv(in_features, features, 3, stride, groups,
                                   dtype)
        self.Norm_0 = Norm(features, bn_type)
        self.MaskConv_1 = MaskConv(features, features, 3, 1, dtype=dtype)
        self.Norm_1 = Norm(features, bn_type)
        self.downsample = stride != 1 or in_features != features
        if self.downsample:
            self.MaskConv_2 = MaskConv(in_features, features, 1, stride,
                                       groups, dtype)
            self.Norm_2 = Norm(features, bn_type)

    def forward(self, x, mask):
        y, m = self.MaskConv_0(x, mask)
        y = F.relu(self.Norm_0(y))
        y, m = self.MaskConv_1(y, m)
        y = self.Norm_1(y)
        if self.downsample:
            x, mask = self.MaskConv_2(x, mask)
            x = self.Norm_2(x)
        return F.relu(x + y), (mask + m) * 0.5


class ConvBNRelu(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 bn_type: str = "sync_bn", dtype=None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(in_features, features, kernel)
        self.Norm_0 = Norm(features, bn_type)

    def forward(self, x):
        return F.relu(self.Norm_0(_conv(self.Conv_0, x, self.dtype)))


class ConfidenceHead(nn.Module):
    """conv stack -> per-cell confidence, the masked spatial softmax in
    f32; ``tempered`` also returns the confidence of the same logits at
    that temperature, without gradient (it only weighs the pyramid
    loss)."""

    def __init__(self, in_features: int, bn_type: str = "sync_bn",
                 dtype=None):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(in_features, 64, 3, bn_type, dtype)
        self.ConvBNRelu_1 = ConvBNRelu(64, 32, 3, bn_type, dtype)
        self.Conv_0 = nn.Conv2d(32, 1, 1)

    def forward(self, x, extra_mask, temperature: float = 1.0,
                tempered=None):
        h = self.ConvBNRelu_1(self.ConvBNRelu_0(x))
        logit = _conv(self.Conv_0, h.float())
        B, _, H, W = logit.shape

        def finish(lg, T):
            masked = torch.where(extra_mask > 0, lg, -1000.0)
            flat = masked.reshape(B, H * W) / T
            return torch.softmax(flat, dim=-1).reshape(B, 1, H, W)

        conf = finish(logit, temperature)
        if tempered is None:
            return conf
        return conf, finish(logit.detach(), tempered)


def cycle_pairs(xs: Sequence[torch.Tensor]):
    """All ordered frame pairs (i < j), pair-major like the reference:
    returns (first, second) with the pair axis folded into batch.
    xs: list of (B, ...) tensors."""
    first, second = [], []
    L = len(xs)
    for i in range(L):
        for j in range(i + 1, L):
            first.append(xs[i])
            second.append(xs[j])
    f = torch.stack(first, dim=1)
    s = torch.stack(second, dim=1)
    return f.reshape((-1,) + f.shape[2:]), s.reshape((-1,) + s.shape[2:])


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class BEVOdomNet(nn.Module):
    """Encoder/decoder over a pair-concatenated BEV feature map."""

    def __init__(self, cfg: OdomCfg, point_cloud_range: tuple):
        super().__init__()
        for field, allowed in SUPPORTED.items():
            if getattr(cfg, field) not in allowed:
                raise ValueError(f"odom.{field}={getattr(cfg, field)!r}: "
                                 f"this copy runs {allowed}")
        self.cfg = cfg
        self.point_cloud_range = tuple(point_cloud_range)
        self.dtype = dt = (torch.bfloat16 if cfg.compute_dtype == "bf16"
                           else torch.float32)
        bn = cfg.bn_type
        n = dict.fromkeys(("BasicBlock", "ConvBNRelu", "Conv"), 0)

        def add(kind, module):
            self.add_module(f"{kind}_{n[kind]}", module)
            n[kind] += 1
            return module

        def block(cin, feats, stride, groups=1):
            return add("BasicBlock",
                       BasicBlock(cin, feats, stride, bn, groups, dtype=dt))

        cin = 2 * cfg.num_input_features
        self._stages = []
        for i, (n_blocks, stride, feats) in enumerate(zip(
                cfg.layer_nums, cfg.layer_strides, cfg.num_filters)):
            groups = cfg.first_conv_groups if i == 0 else 1
            blocks = [block(cin, feats, stride, groups)]
            blocks += [block(feats, feats, 1) for _ in range(n_blocks - 1)]
            skip = add("ConvBNRelu", ConvBNRelu(feats, feats, 3, bn, dt))
            self._stages.append((blocks, skip))
            cin = feats
        self._ups = []
        n_up = len(cfg.upsample_strides)
        for i, (stride, feats) in enumerate(zip(cfg.upsample_strides,
                                                cfg.num_upsample_filters)):
            cin = cin + cfg.num_filters[-(i + 1)]
            up = add("ConvBNRelu", ConvBNRelu(cin, feats, 3, bn, dt))
            head = None
            if cfg.use_deep_supervision and i < n_up - 1:
                head = (add("ConvBNRelu",
                            ConvBNRelu(feats, feats // 2, 3, bn, dt)),
                        add("Conv", nn.Conv2d(feats // 2, 7, 1)))
            self._ups.append((stride, up, head))
            cin = feats
        self._tq_head = (add("ConvBNRelu", ConvBNRelu(cin, 64, 3, bn, dt)),
                         add("ConvBNRelu", ConvBNRelu(64, 32, 3, bn, dt)),
                         add("Conv", nn.Conv2d(32, 7, 1)))
        self.ConfidenceHead_0 = ConfidenceHead(cin, bn, dt)
        self.ConfidenceHead_1 = ConfidenceHead(cin, bn, dt)

    def forward(self, x_pair: torch.Tensor) -> dict:
        """x_pair: (P, H, W, 2*C) concatenated frame-pair features."""
        cfg = self.cfg
        total_stride = 1
        for s in cfg.layer_strides:
            total_stride *= s
        H_in, W_in = x_pair.shape[1:3]
        if H_in % total_stride or W_in % total_stride:
            raise ValueError(
                f"BEV dims ({H_in}, {W_in}) must divide the encoder stride "
                f"product {total_stride}")
        dt = self.dtype
        input_mask = (torch.sum(torch.abs(x_pair), dim=-1, keepdim=True)
                      != 0).to(dt).permute(0, 3, 1, 2)
        x, m = x_pair.to(dt).permute(0, 3, 1, 2), input_mask

        skips = []
        for blocks, skip in self._stages:
            for blk in blocks:
                x, m = blk(x, m)
            skips.append(skip(x))

        # pyramid masks at decoder resolutions (coarse -> fine)
        py_masks = []
        p_mask = input_mask
        for i in range(len(cfg.upsample_strides) - 1):
            p_mask = max_pool_mask(p_mask, 3,
                                   cfg.upsample_strides[-(i + 1)])
            py_masks.append(p_mask)
        py_masks.reverse()

        py_preds = []
        for i, (stride, up, head) in enumerate(self._ups):
            x = torch.cat([x, skips[-(i + 1)]], dim=1)
            x = x.repeat_interleave(stride, 2).repeat_interleave(stride, 3)
            x = up(x)
            if head is not None:
                h_mod, conv = head
                py = _conv(conv, h_mod(x).float())
                pm = py_masks[i].float()
                py_preds.append((py * (pm > 0).float(), pm))

        cbr0, cbr1, conv = self._tq_head
        tq_map = _conv(conv, cbr1(cbr0(x)).float())
        q = tq_map[:, 3:]
        q = q / torch.sqrt(torch.sum(q * q, 1, keepdim=True) + 1e-16)
        tq_map = torch.cat([tq_map[:, :3], q], dim=1)

        t_conf, temp_t = self.ConfidenceHead_0(
            x, input_mask, tempered=cfg.conf_temperature)
        q_conf, temp_q = self.ConfidenceHead_1(
            x, input_mask, tempered=cfg.conf_temperature)
        temp_conf = torch.cat([temp_t, temp_q], dim=1)

        pyramid = py_preds + [(tq_map * input_mask, input_mask * temp_conf)]
        # cascade: each level's mask is modulated by the avg-pooled mask
        # of the next finer level (SAME padding, pad cells counted); a
        # 1-channel level mask broadcasts against the finer 2-channel one
        for p in range(2, len(pyramid) + 1):
            finer = pyramid[-(p - 1)][1]
            pooled = same_op(lambda m: F.avg_pool2d(m, 3, 2), finer, 3, 2)
            pyramid[-p] = (pyramid[-p][0], pyramid[-p][1] * pooled)
        pyramid = [(_nhwc(a), _nhwc(b)) for a, b in pyramid]

        tq_map, t_conf, q_conf = (_nhwc(tq_map), _nhwc(t_conf),
                                  _nhwc(q_conf))
        mask = _nhwc(input_mask)
        odom = self._vote(tq_map, t_conf, q_conf)
        return {
            "odometry": odom,                      # (P, 7) [t, q]
            "tq_map": tq_map,                      # (P, H, W, 7) local
            "t_conf": t_conf,
            "q_conf": q_conf,
            "pyramid": pyramid,                    # [(map, mask*conf), ...]
            "input_mask": mask,
        }

    def _vote(self, tq_map, t_w, q_w):
        """Confidence-weighted average of the decoded per-cell global
        poses; maps (P, H, W, C)."""
        g = decode_tq_map(tq_map, self.point_cloud_range)  # (P, H, W, 7)
        tw = torch.sum(t_w, dim=(1, 2)) + 1e-12
        qw = torch.sum(q_w, dim=(1, 2)) + 1e-12
        t = torch.sum(g[..., :3] * t_w, dim=(1, 2)) / tw
        q = torch.sum(g[..., 3:] * q_w, dim=(1, 2)) / qw
        q = q / torch.sqrt(torch.sum(q * q, -1, keepdim=True) + 1e-16)
        return torch.cat([t, q], dim=-1)
