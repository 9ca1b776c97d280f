"""BEV odometry encoder/decoder with confidence voting (counterpart of
``rslo_tpu/models/bev_net.py``): every option of the schema's
``OdomCfg`` (``bn_type``, ``conv_type``, ``block_type``, ``conf_type``,
``dense_predict``, ``use_svd``, ``use_se``, ``use_sa``,
``multi_level_odom``).

Public tensors keep the JAX layout — the pair input is (P, H, W, 2C)
and every output map is (P, H, W, C) — and the net converts to NCHW
only inside.  Every feature tensor travels with a validity mask; convs
propagate it by max-pooling (or, normalized, by their valid-tap count),
residual adds average the masks.

Convs follow flax's ``padding="SAME"``, which is asymmetric at stride
2 on an even size: the pad goes (0, 1), not torch's (1, 1), so every
conv and pool pads explicitly (``parallel/spatial.py::pad_same``) and
then runs unpadded.  dtypes follow flax's promotion: a conv built with
the net's compute dtype (``MaskConv``, ``ConvBNRelu``) casts its input
to it, so an f32 input (after an attention block, whose float32
parameters promote a bfloat16 input) goes back to bfloat16; heads
without a dtype (the tq and confidence 1x1 convs, the FC head) compute
in f32.

Submodules carry the flax auto-names of the reference (``BasicBlock_<i>``,
``FireBlock_<i>``, ``ConvBNRelu_<i>``, ``Conv_<i>``, ``Dense_<i>``, ...)
so ``convert.py`` maps parameters by name.

Under a split forward of ``rslo_tpu_torch/parallel/`` (from the pair
tensor's ``bev_constraint`` on) the layers split the map: SAME pads take
halos over the "space" axis (``parallel/spatial.py::pad_same``), convs
gather their input channels over "model" and compute their slice of the
output channels, the batch moments and spatial means sum over "space",
the confidence softmax and the output maps gather along W, and the vote
runs on the gathered maps on every rank.  A rank may hold no columns or
no channels of a map; it still joins every exchange.  Outside a split,
each of these paths is the unsplit op itself.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import OdomCfg
from ..geometry import (decode_tq_map, grid_cell_coords, hemisphere,
                        matrix_to_quat, qnormalize, rotate_vec_by_q,
                        weighted_kabsch)
from ..parallel.spatial import (batch_moments, gather_width, global_width,
                                local_columns, same_op, space_split)
from ..parallel.tensor import (bev_mean, channel_range, gather_channels,
                               holds_slice, local_channels, model_split)
from ..utils.mesh_axis import pmean_if_present
from .attention import SELayer, SpatialAttention
from .middle import update_running_stats
from .semiglobal_bn import SemiGlobalSyncBN


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


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype=None,
          replicated: bool = False) -> torch.Tensor:
    """``conv`` with SAME padding, computed in ``dtype`` (flax's
    ``dtype=``; the input's dtype when None).  Under a model split it
    computes this rank's slice of the output channels, or all of them
    for a ``replicated`` head."""
    if dtype is not None:
        x = x.to(dtype)
    k, s = conv.kernel_size[0], conv.stride[0]
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    if model_split():
        return _conv_model(conv, x, b, k, s, replicated)
    w = conv.weight.to(x.dtype)
    return same_op(lambda xp: F.conv2d(xp, w, b, s, 0, 1, conv.groups), x,
                   k, s)


def _conv_model(conv, x, b, k, s, replicated):
    """The model-split conv: the input's channels gathered (unless it
    holds them all), then output channels [lo, hi), group by group for
    a grouped conv, so that each slice reads its own group's inputs.  A
    rank without output channels computes the first and drops it (torch
    refuses an empty conv)."""
    if holds_slice(x, conv.in_channels):
        x = gather_channels(x, conv.in_channels)
    w = conv.weight.to(x.dtype)
    cout, g = w.shape[0], conv.groups
    lo, hi = (0, cout) if replicated else channel_range(cout)
    og, ig = cout // g, w.shape[1]

    def op(xp):
        if lo == hi:
            return F.conv2d(xp[:, :ig], w[:1], None if b is None else b[:1],
                            s)[:, :0]
        if (lo, hi) == (0, cout):
            return F.conv2d(xp, w, b, s, 0, 1, g)
        parts = []
        for gi in range(lo // og, (hi - 1) // og + 1):
            a, z = max(lo, gi * og), min(hi, (gi + 1) * og)
            parts.append(F.conv2d(xp[:, gi * ig:(gi + 1) * ig], w[a:z],
                                  None if b is None else b[a:z], s))
        return torch.cat(parts, dim=1)
    return same_op(op, x, k, s)


def _cat_channels(parts, channels, local: bool = True) -> torch.Tensor:
    """Channel concat of ``parts`` of ``channels`` channels each; under a
    model split, of the gathered parts, then this rank's slice of it
    (``local``) or the whole."""
    if not model_split():
        return torch.cat(parts, dim=1)
    full = torch.cat([gather_channels(p, c) for p, c in zip(parts, channels)],
                     dim=1)
    return local_channels(full) if local else full


class MaskConv(nn.Module):
    """Conv on features (no bias) + mask propagation.  Plain
    (``conv_type="mask_conv"``): the mask is max-pooled.  Normalized
    (``"sparse_conv"``): conv(x * mask) divided by the valid-tap count
    ``max(msum, 1)``, where msum is a frozen all-ones conv over the mask
    in the compute dtype, and the new mask is ``msum > 0``."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, dtype=None,
                 normalized: bool = False):
        super().__init__()
        self.dtype, self.normalized = dtype, normalized
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, stride,
                                groups=groups, bias=False)

    def forward(self, x, mask):
        k, s = self.Conv_0.kernel_size[0], self.Conv_0.stride[0]
        if not self.normalized:
            return _conv(self.Conv_0, x, self.dtype), \
                max_pool_mask(mask, k, s)
        y = _conv(self.Conv_0, x * mask.to(x.dtype), self.dtype)
        ones = torch.ones((1, 1, k, k), dtype=y.dtype, device=y.device)
        msum = same_op(lambda m: F.conv2d(m, ones, None, s),
                       mask.to(y.dtype), k, s)
        y = y / torch.clamp(msum, min=1.0)
        return y, (msum > 0).to(mask.dtype)


class Norm(nn.Module):
    """BatchNorm, computed in f32 and cast back to the input dtype.
    Train mode normalizes with the statistics of the whole (N, H, W)
    batch, unmasked (biased variance), and updates the running
    statistics as 0.99 * old + 0.01 * batch; eval mode applies them.
    bn_type "none" is the identity.  "sync_bn" averages the moments E[x]
    and E[x^2] over the ranks of the "data" axis inside a data-parallel
    step (``utils/mesh_axis.py``; elsewhere, as "bn" always, the
    statistics are the rank's own).  "semiglobal_sync_bn" is a
    ``SemiGlobalSyncBN_0`` submodule, as in JAX."""

    def __init__(self, num_features: int, bn_type: str = "sync_bn",
                 eps: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        if bn_type not in ("none", "bn", "sync_bn", "semiglobal_sync_bn"):
            raise ValueError(f"unknown bn_type {bn_type!r}")
        self.bn_type = bn_type
        self.eps = eps
        self.momentum = momentum
        if bn_type == "semiglobal_sync_bn":
            self.SemiGlobalSyncBN_0 = SemiGlobalSyncBN(num_features)
        elif bn_type != "none":
            self.scale = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
            self.register_buffer("mean", torch.zeros(num_features))
            self.register_buffer("var", torch.ones(num_features))

    def forward(self, x):
        if self.bn_type == "none":
            return x
        if self.bn_type == "semiglobal_sync_bn":
            return self.SemiGlobalSyncBN_0(x)
        shape = (1, -1, 1, 1)
        xf = x.float()
        c = self.scale.shape[0]
        # under a model split this rank's slice of the channels
        sliced = holds_slice(x, c)
        lo, hi = channel_range(c) if sliced else (0, c)
        if self.training:
            mean, m2 = batch_moments(xf)
            if self.bn_type == "sync_bn":
                mean = pmean_if_present(mean, "data")
                m2 = pmean_if_present(m2, "data")
            var = torch.maximum(m2 - mean * mean, torch.zeros_like(m2))
            if sliced:                  # the running statistics whole
                mean_all, var_all = (gather_channels(mean, c, 0),
                                     gather_channels(var, c, 0))
            else:
                mean_all, var_all = mean, var
            update_running_stats(self, mean_all, var_all)
        else:
            mean, var = self.mean[lo:hi], self.var[lo:hi]
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) +
                                                  self.eps)
        y = y * self.scale[lo:hi].view(shape) + self.bias[lo:hi].view(shape)
        return y.to(x.dtype)


class BasicBlock(nn.Module):
    """Mask-aware ResNet BasicBlock; the residual add averages masks.
    Optional SE and spatial attention on the residual branch (their
    float32 output makes the block's output float32, as in JAX)."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 bn_type: str = "sync_bn", groups: int = 1, dtype=None,
                 normalized: bool = False, use_se: bool = False,
                 use_sa: bool = False):
        super().__init__()
        conv = dict(dtype=dtype, normalized=normalized)
        self.features = features
        self.MaskConv_0 = MaskConv(in_features, features, 3, stride, groups,
                                   **conv)
        self.Norm_0 = Norm(features, bn_type)
        self.MaskConv_1 = MaskConv(features, features, 3, 1, **conv)
        self.Norm_1 = Norm(features, bn_type)
        if use_se:
            self.SELayer_0 = SELayer(features)
        if use_sa:
            self.SpatialAttention_0 = SpatialAttention()
        self.downsample = stride != 1 or in_features != features
        if self.downsample:
            self.MaskConv_2 = MaskConv(in_features, features, 1, stride,
                                       groups, **conv)
            self.Norm_2 = Norm(features, bn_type)

    def forward(self, x, mask):
        y, m = self.MaskConv_0(x, mask)
        y = F.relu(self.Norm_0(y))
        y, m = self.MaskConv_1(y, m)
        y = self.Norm_1(y)
        if hasattr(self, "SELayer_0"):
            y = self.SELayer_0(y)
        if hasattr(self, "SpatialAttention_0"):
            y = self.SpatialAttention_0(y, self.features)
        if self.downsample:
            x, mask = self.MaskConv_2(x, mask)
            x = self.Norm_2(x)
        return F.relu(x + y), (mask + m) * 0.5


class FireBlock(nn.Module):
    """Squeeze/expand block: parallel 1x1 and 3x3 branches from the same
    input, BN + relu each, channel concat, no residual.  ``features`` is
    the output width (features // 2 from the 1x1 branch); the mask out
    is the 3x3 branch's."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 bn_type: str = "sync_bn", groups: int = 1, dtype=None,
                 normalized: bool = False):
        super().__init__()
        half = features // 2
        conv = dict(dtype=dtype, normalized=normalized)
        self.sizes = (half, features - half)
        self.MaskConv_0 = MaskConv(in_features, half, 1, stride, groups,
                                   **conv)
        self.Norm_0 = Norm(half, bn_type)
        self.MaskConv_1 = MaskConv(in_features, features - half, 3, stride,
                                   groups, **conv)
        self.Norm_1 = Norm(features - half, bn_type)

    def forward(self, x, mask):
        a, _ = self.MaskConv_0(x, mask)
        a = F.relu(self.Norm_0(a))
        b, m = self.MaskConv_1(x, mask)
        b = F.relu(self.Norm_1(b))
        return _cat_channels([a, b], self.sizes), m


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 residual bottleneck, inner width
    features // 4.  Only the 3x3 conv takes ``groups``: the downsample
    conv does not (unlike the basic block's)."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 bn_type: str = "sync_bn", groups: int = 1, dtype=None,
                 normalized: bool = False):
        super().__init__()
        inner = max(features // 4, 1)
        conv = dict(dtype=dtype, normalized=normalized)
        self.MaskConv_0 = MaskConv(in_features, inner, 1, 1, **conv)
        self.Norm_0 = Norm(inner, bn_type)
        self.MaskConv_1 = MaskConv(inner, inner, 3, stride, groups, **conv)
        self.Norm_1 = Norm(inner, bn_type)
        self.MaskConv_2 = MaskConv(inner, features, 1, 1, **conv)
        self.Norm_2 = Norm(features, bn_type)
        self.downsample = stride != 1 or in_features != features
        if self.downsample:
            self.MaskConv_3 = MaskConv(in_features, features, 1, stride,
                                       **conv)
            self.Norm_3 = Norm(features, bn_type)

    def forward(self, x, mask):
        y, m = self.MaskConv_0(x, mask)
        y = F.relu(self.Norm_0(y))
        y, m = self.MaskConv_1(y, m)
        y = F.relu(self.Norm_1(y))
        y, m = self.MaskConv_2(y, m)
        y = self.Norm_2(y)
        if self.downsample:
            x, mask = self.MaskConv_3(x, mask)
            x = self.Norm_3(x)
        return F.relu(x + y), (mask + m) * 0.5


BLOCK_TYPES = {"basic": BasicBlock, "fire": FireBlock,
               "bottleneck": BottleneckBlock}


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
    """conv stack -> per-cell confidence: the masked spatial softmax
    (``conf_type="softmax"``) or ``(elu + 1 + 1e-12) * (mask + 1e-12)``
    (``"linear"``), in f32; ``tempered`` also returns the confidence of
    the same logits at that temperature, without gradient (it only
    weighs the pyramid loss)."""

    def __init__(self, in_features: int, bn_type: str = "sync_bn",
                 conf_type: str = "softmax", dtype=None):
        super().__init__()
        self.conf_type = conf_type
        self.ConvBNRelu_0 = ConvBNRelu(in_features, 64, 3, bn_type, dtype)
        self.ConvBNRelu_1 = ConvBNRelu(64, 32, 3, bn_type, dtype)
        self.Conv_0 = nn.Conv2d(32, 1, 1)

    def forward(self, x, extra_mask, temperature: float = 1.0,
                tempered=None):
        h = self.ConvBNRelu_1(self.ConvBNRelu_0(x))
        logit = _conv(self.Conv_0, h.float(), replicated=True)
        B, _, H, W = logit.shape

        def finish(lg, T):
            if self.conf_type == "linear":
                return (F.elu(lg) + 1 + 1e-12) * \
                    (extra_mask.float() + 1e-12)
            masked = torch.where(extra_mask > 0, lg, -1000.0)
            if space_split():            # the softmax over the whole map
                full = gather_width(masked, 3)
                conf = torch.softmax(full.reshape(B, -1) / T, dim=-1)
                return local_columns(conf.reshape(full.shape), W, 3)
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


def _gather_w(x: torch.Tensor) -> torch.Tensor:
    """An NCHW output map in NHWC, gathered along W under a space split
    (the unsplit map, on every rank)."""
    return gather_width(_nhwc(x), 2)


class DropoutRngError(RuntimeError):
    """The FC head in train mode at a dropout > 0: JAX's train step
    passes no "dropout" rng, so its apply fails there too."""


class BEVOdomNet(nn.Module):
    """Encoder/decoder over a pair-concatenated BEV feature map."""

    def __init__(self, cfg: OdomCfg, point_cloud_range: tuple):
        super().__init__()
        if cfg.conv_type not in ("mask_conv", "sparse_conv"):
            raise ValueError(f"unknown conv_type {cfg.conv_type!r}; "
                             f"expected 'mask_conv' or 'sparse_conv'")
        if cfg.block_type not in BLOCK_TYPES:
            raise ValueError(f"unknown block_type {cfg.block_type!r}; "
                             f"expected one of {sorted(BLOCK_TYPES)}")
        if cfg.conf_type not in ("softmax", "linear"):
            raise ValueError(f"unknown conf_type {cfg.conf_type!r}")
        self.cfg = cfg
        self.point_cloud_range = tuple(point_cloud_range)
        self.dtype = dt = (torch.bfloat16 if cfg.compute_dtype == "bf16"
                           else torch.float32)
        bn = cfg.bn_type
        Block = BLOCK_TYPES[cfg.block_type]
        norm_conv = cfg.conv_type == "sparse_conv"
        n = dict.fromkeys((Block.__name__, "ConvBNRelu", "Conv", "Dense"), 0)

        def add(kind, module):
            self.add_module(f"{kind}_{n[kind]}", module)
            n[kind] += 1
            return module

        def block(cin, feats, stride, groups=1, **extra):
            return add(Block.__name__,
                       Block(cin, feats, stride, bn, groups, dtype=dt,
                             normalized=norm_conv, **extra))

        cin = 2 * cfg.num_input_features
        self._stages = []
        for i, (n_blocks, stride, feats) in enumerate(zip(
                cfg.layer_nums, cfg.layer_strides, cfg.num_filters)):
            groups = cfg.first_conv_groups if i == 0 else 1
            blocks = [block(cin, feats, stride, groups)]
            for bi in range(n_blocks - 1):
                # attention on the last block of a stage (basic only)
                last = bi == n_blocks - 2
                extra = ({"use_se": cfg.use_se and last,
                          "use_sa": cfg.use_sa and last}
                         if Block is BasicBlock else {})
                blocks.append(block(feats, feats, 1, **extra))
            skip = add("ConvBNRelu", ConvBNRelu(feats, feats, 3, bn, dt))
            self._stages.append((blocks, skip))
            cin = feats
        self._ups = []
        n_up = len(cfg.upsample_strides)
        for i, (stride, feats) in enumerate(zip(cfg.upsample_strides,
                                                cfg.num_upsample_filters)):
            cat = (cin, cfg.num_filters[-(i + 1)])
            cin = sum(cat)
            up = add("ConvBNRelu", ConvBNRelu(cin, feats, 3, bn, dt))
            head = None
            if cfg.use_deep_supervision and i < n_up - 1:
                head = (add("ConvBNRelu",
                            ConvBNRelu(feats, feats // 2, 3, bn, dt)),
                        add("Conv", nn.Conv2d(feats // 2, 7, 1)))
            self._ups.append((stride, cat, up, head))
            cin = feats
        if not cfg.dense_predict:
            # FC head: the encoder bottleneck pooled, two dense layers
            add("Dense", nn.Linear(cfg.num_filters[-1], 1024))
            add("Dense", nn.Linear(1024, 7))
            return
        self._tq_head = (add("ConvBNRelu", ConvBNRelu(cin, 64, 3, bn, dt)),
                         add("ConvBNRelu", ConvBNRelu(64, 32, 3, bn, dt)),
                         add("Conv", nn.Conv2d(32, 7, 1)))
        self.ConfidenceHead_0 = ConfidenceHead(cin, bn, cfg.conf_type, dt)
        self.ConfidenceHead_1 = ConfidenceHead(cin, bn, cfg.conf_type, dt)

    def check_train_mode(self):
        """Raise where JAX's apply fails: the FC head in train mode at a
        dropout > 0 draws from a "dropout" rng stream that JAX's train
        step never passes; the port invents no stream.  ``OdomNet``
        calls it before any statistic moves, as JAX's failed apply
        keeps them."""
        cfg = self.cfg
        if not cfg.dense_predict and self.training and cfg.dropout > 0:
            raise DropoutRngError(
                f"the FC head (dense_predict=False) has no dropout rng in "
                f"train mode: set odom.dropout=0 (is {cfg.dropout}) or "
                f"run in eval mode")

    def forward(self, x_pair: torch.Tensor) -> dict:
        """x_pair: (P, H, W, 2*C) concatenated frame-pair features."""
        cfg = self.cfg
        self.check_train_mode()
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
        for i, (stride, cat, up, head) in enumerate(self._ups):
            x = _cat_channels([x, skips[-(i + 1)]], cat, local=False)
            x = x.repeat_interleave(stride, 2).repeat_interleave(stride, 3)
            x = up(x)
            if head is not None:
                h_mod, conv = head
                py = _conv(conv, h_mod(x).float(), replicated=True)
                pm = py_masks[i].float()
                py_preds.append((py * (pm > 0).float(), pm))

        if not cfg.dense_predict:
            return self._fc_head(skips[-1], x, input_mask)

        cbr0, cbr1, conv = self._tq_head
        tq_map = _conv(conv, cbr1(cbr0(x)).float(), replicated=True)
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
        pyramid = [(_gather_w(a), _gather_w(b)) for a, b in pyramid]

        tq_map, t_conf, q_conf = (_gather_w(tq_map), _gather_w(t_conf),
                                  _gather_w(q_conf))
        mask = _gather_w(input_mask)
        odom = self.aggregate(tq_map, mask, t_conf, q_conf)
        out = {
            "odometry": odom,                      # (P, 7) [t, q]
            "tq_map": tq_map,                      # (P, H, W, 7) local
            "t_conf": t_conf,
            "q_conf": q_conf,
            "pyramid": pyramid,                    # [(map, mask*conf), ...]
            "input_mask": mask,
        }
        if cfg.multi_level_odom:
            # one vote per cascaded pyramid level, coarse -> fine, each
            # weighted by its mask's first channel; then the main vote
            out["odometry_levels"] = [
                self._vote(pmap, pmask[..., 0:1], pmask[..., 0:1])
                for pmap, pmask in pyramid[:-1]] + [odom]
        return out

    def _fc_head(self, bottleneck, x, input_mask) -> dict:
        """The FC head: the spatial mean of the last skip, Dense(1024),
        relu, (dropout, eval mode or rate 0 only), Dense(7) from the
        identity-pose bias; ``odom_format="r(x+t)"`` rotates t.  The
        maps are placeholders: a zero tq map, unit confidences, no
        pyramid."""
        h = bev_mean(bottleneck, self.Dense_0.in_features).to(
            bottleneck.dtype)
        h = F.relu(self.Dense_0(h.float()))
        odom = self.Dense_1(h)
        t, q = odom[:, :3], odom[:, 3:]
        if self.cfg.odom_format == "r(x+t)":
            t = rotate_vec_by_q(t, qnormalize(q))
        P, _, H, W = x.shape
        W = global_width(H, W)
        ones = torch.ones((P, H, W, 1), device=x.device)
        return {
            "odometry": torch.cat([t, qnormalize(q)], dim=-1).float(),
            "tq_map": torch.zeros((P, H, W, 7), device=x.device),
            "t_conf": ones,
            "q_conf": ones.clone(),
            "pyramid": [],
            "input_mask": _gather_w(input_mask),
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

    def aggregate(self, tq_map, mask, t_conf, q_conf):
        """Ego-motion vote over the dense local-pose map (maps (P, H, W,
        C)): the confidence-weighted average of the decoded per-cell
        poses, or with ``use_svd`` the weighted Kabsch of the cell
        centres against the centres minus the flow, weighted by
        t_conf * mask."""
        if not self.cfg.use_svd:
            return self._vote(tq_map, t_conf, q_conf)
        P, H, W = tq_map.shape[:3]
        coords = grid_cell_coords((H, W), self.point_cloud_range,
                                  device=tq_map.device)   # (H, W, 3)
        src = coords[None].expand(P, H, W, 3)
        flow = tq_map[..., :3]
        w = (t_conf * mask)[..., 0].reshape(P, H * W)
        R, t = weighted_kabsch(src.reshape(P, -1, 3),
                               (src - flow).reshape(P, -1, 3), w)
        return torch.cat([t, hemisphere(matrix_to_quat(R))], dim=-1)
