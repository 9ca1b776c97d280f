"""BEV odometry encoder/decoder with confidence voting (counterpart of
``rslo_tpu/models/bev_net.py``; dense-predict path).

Public tensors keep the JAX layout — the pair input is (P, H, W, 2C)
and every output map is (P, H, W, C) — and the net converts to NCHW
only inside.  Every feature tensor travels with a validity mask; convs
propagate it by max-pooling, residual adds average the masks.

Convs follow flax's ``padding="SAME"``, which is asymmetric at stride
2 on an even size: the pad goes (0, 1), not torch's (1, 1), so every
conv and pool pads explicitly with :func:`_pad_same` and then runs
unpadded.  Heads without a dtype (the tq and confidence 1x1 convs)
compute in f32, as flax promotes them.

Submodules carry the flax auto-names of the reference (``BasicBlock_<i>``,
``ConvBNRelu_<i>``, ``Conv_<i>``, ...) so ``convert.py`` maps
parameters by name.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import OdomCfg
from ..geometry import decode_tq_map
from .middle import update_running_stats


def identity_pose_bias(n: int = 7) -> torch.Tensor:
    """Bias of 7-channel tq heads: the identity pose [0,0,0, 1,0,0,0]."""
    b = torch.zeros(n)
    b[3] = 1.0
    return b


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int,
              value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor as flax/XLA ``padding="SAME"`` does."""
    ph = _same_pad(x.shape[-2], k, s)
    pw = _same_pad(x.shape[-1], k, s)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def max_pool_mask(mask: torch.Tensor, kernel: int,
                  stride: int) -> torch.Tensor:
    """Max-pool an (N, 1, H, W) mask with SAME padding."""
    return F.max_pool2d(_pad_same(mask, kernel, stride, float("-inf")),
                        kernel, stride)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` with SAME padding, computed in ``x``'s dtype."""
    k, s = conv.kernel_size[0], conv.stride[0]
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(_pad_same(x, k, s), conv.weight.to(x.dtype), b,
                    s, 0, 1, conv.groups)


class MaskConv(nn.Module):
    """Conv on features (no bias) + max-pool on the validity mask."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, stride,
                                groups=groups, bias=False)

    def forward(self, x, mask):
        k, s = self.Conv_0.kernel_size[0], self.Conv_0.stride[0]
        return _conv(self.Conv_0, x), max_pool_mask(mask, k, s)


class Norm(nn.Module):
    """BatchNorm, computed in f32 and cast back to the input dtype.
    Train mode normalizes with the statistics of the whole (N, H, W)
    batch, unmasked (biased variance), and updates the running
    statistics as 0.99 * old + 0.01 * batch; eval mode applies them.
    bn_type "none" is the identity.  "bn" and "sync_bn" are the same on
    one card (cross-card statistics are not ported)."""

    def __init__(self, num_features: int, bn_type: str = "sync_bn",
                 eps: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        if bn_type not in ("none", "bn", "sync_bn"):
            raise NotImplementedError(f"bn_type={bn_type!r} is not ported")
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
            mean = torch.mean(xf, dim=(0, 2, 3))
            var = torch.mean(xf * xf, dim=(0, 2, 3)) - mean * mean
            var = torch.maximum(var, torch.zeros_like(var))
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
                 bn_type: str = "sync_bn", groups: int = 1):
        super().__init__()
        self.MaskConv_0 = MaskConv(in_features, features, 3, stride, groups)
        self.Norm_0 = Norm(features, bn_type)
        self.MaskConv_1 = MaskConv(features, features, 3, 1)
        self.Norm_1 = Norm(features, bn_type)
        self.downsample = stride != 1 or in_features != features
        if self.downsample:
            self.MaskConv_2 = MaskConv(in_features, features, 1, stride,
                                       groups)
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
                 bn_type: str = "sync_bn"):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, kernel)
        self.Norm_0 = Norm(features, bn_type)

    def forward(self, x):
        return F.relu(self.Norm_0(_conv(self.Conv_0, x)))


class ConfidenceHead(nn.Module):
    """conv stack -> per-cell confidence by masked spatial softmax;
    ``tempered`` also returns the softmax of the same logits at that
    temperature, without gradient (it only weighs the pyramid loss)."""

    def __init__(self, in_features: int, bn_type: str = "sync_bn"):
        super().__init__()
        self.ConvBNRelu_0 = ConvBNRelu(in_features, 64, 3, bn_type)
        self.ConvBNRelu_1 = ConvBNRelu(64, 32, 3, bn_type)
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
        unported = {"use_svd": cfg.use_svd,
                    "dense_predict=False (FC head)": not cfg.dense_predict,
                    "multi_level_odom": cfg.multi_level_odom,
                    "use_se": cfg.use_se, "use_sa": cfg.use_sa,
                    f"block_type={cfg.block_type!r}":
                        cfg.block_type != "basic",
                    f"conv_type={cfg.conv_type!r}":
                        cfg.conv_type != "mask_conv",
                    f"conf_type={cfg.conf_type!r}":
                        cfg.conf_type != "softmax"}
        missing = [k for k, v in unported.items() if v]
        if missing:
            raise NotImplementedError(
                f"BEVOdomNet options not ported yet: {missing}")
        self.cfg = cfg
        self.point_cloud_range = tuple(point_cloud_range)
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bf16"
                      else torch.float32)
        bn = cfg.bn_type
        n = {"BasicBlock": 0, "ConvBNRelu": 0, "Conv": 0}

        def add(kind, module):
            self.add_module(f"{kind}_{n[kind]}", module)
            n[kind] += 1
            return module

        cin = 2 * cfg.num_input_features
        self._stages = []
        for i, (n_blocks, stride, feats) in enumerate(zip(
                cfg.layer_nums, cfg.layer_strides, cfg.num_filters)):
            groups = cfg.first_conv_groups if i == 0 else 1
            blocks = [add("BasicBlock",
                          BasicBlock(cin, feats, stride, bn, groups))]
            blocks += [add("BasicBlock", BasicBlock(feats, feats, 1, bn))
                       for _ in range(n_blocks - 1)]
            skip = add("ConvBNRelu", ConvBNRelu(feats, feats, 3, bn))
            self._stages.append((blocks, skip))
            cin = feats
        self._ups = []
        n_up = len(cfg.upsample_strides)
        for i, (stride, feats) in enumerate(zip(cfg.upsample_strides,
                                                cfg.num_upsample_filters)):
            cin += cfg.num_filters[-(i + 1)]
            up = add("ConvBNRelu", ConvBNRelu(cin, feats, 3, bn))
            head = None
            if cfg.use_deep_supervision and i < n_up - 1:
                head = (add("ConvBNRelu",
                            ConvBNRelu(feats, feats // 2, 3, bn)),
                        add("Conv", nn.Conv2d(feats // 2, 7, 1)))
            self._ups.append((stride, up, head))
            cin = feats
        self._tq_head = (add("ConvBNRelu", ConvBNRelu(cin, 64, 3, bn)),
                         add("ConvBNRelu", ConvBNRelu(64, 32, 3, bn)),
                         add("Conv", nn.Conv2d(32, 7, 1)))
        self.ConfidenceHead_0 = ConfidenceHead(cin, bn)
        self.ConfidenceHead_1 = ConfidenceHead(cin, bn)

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
        # of the next finer level (SAME padding, pad cells counted)
        for p in range(2, len(pyramid) + 1):
            finer = pyramid[-(p - 1)][1]
            pooled = F.avg_pool2d(_pad_same(finer, 3, 2), 3, 2)
            pyramid[-p] = (pyramid[-p][0], pyramid[-p][1] * pooled)

        tq_map, t_conf, q_conf = _nhwc(tq_map), _nhwc(t_conf), _nhwc(q_conf)
        return {
            "odometry": self.aggregate(tq_map, t_conf, q_conf),  # (P, 7)
            "tq_map": tq_map,                      # (P, H, W, 7) local
            "t_conf": t_conf,
            "q_conf": q_conf,
            "pyramid": [(_nhwc(a), _nhwc(b)) for a, b in pyramid],
            "input_mask": _nhwc(input_mask),
        }

    def aggregate(self, tq_map, t_conf, q_conf):
        """Ego-motion vote: confidence-weighted average of the decoded
        per-cell global poses.  Maps are (P, H, W, C)."""
        g = decode_tq_map(tq_map, self.point_cloud_range)  # (P, H, W, 7)
        tw = torch.sum(t_conf, dim=(1, 2)) + 1e-12
        qw = torch.sum(q_conf, dim=(1, 2)) + 1e-12
        t = torch.sum(g[..., :3] * t_conf, dim=(1, 2)) / tw
        q = torch.sum(g[..., 3:] * q_conf, dim=(1, 2)) / qw
        q = q / torch.sqrt(torch.sum(q * q, -1, keepdim=True) + 1e-16)
        return torch.cat([t, q], dim=-1)
