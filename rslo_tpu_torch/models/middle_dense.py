"""Dense masked 3-D conv middle extractor (counterpart of
``rslo_tpu/models/middle_dense.py``).

The sparse middle's channel plan and output contract, computed on the
dense voxel grid with cuDNN ``conv3d`` / ``conv_transpose3d`` (the JAX
module's plain XLA convs; no hand kernel):

  * the active voxels' features are scattered into a (1, F, nz, ny, nx)
    grid once (bfloat16, as the JAX module hard-codes);
  * a submanifold conv is a dense conv times the level's occupancy;
  * a strided conv's occupancy is the strided max-pool of the input
    occupancy (``_occupancy_down``); an inverse conv is a transposed
    conv masked by the finer level's occupancy;
  * per-voxel covariance parameters come from one final gather at the
    input voxel coordinates.

Tensors are NCDHW inside.  Conv weights are ``(Cout, Cin, kd, kh, kw)``
for both conv kinds (``convert.py`` maps flax's DHWIO ``kernel`` to it);
the transposed conv hands torch its (Cin, Cout, ...) view.  JAX's
explicit transposed-conv padding ``(k-1-p, k-1-p + extra)`` is torch's
``padding=p, output_padding=extra``.  Submodules carry the flax
auto-names (``DenseConv_<i>``, ``DenseConvTranspose_<i>``,
``DenseMaskedBN_<i>``, in creation order).

No JAX entry point builds this module (JAX's ``OdomNet`` maps every
middle name but ``PillarMiddleCov`` to the sparse one), so the port's
``OdomNet`` does not either; it is reached by its tests and the smoke
run.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config.schema import MiddleCfg
from ..utils.mesh_axis import psum_if_present
from .middle import update_running_stats

_P1 = (1, 1, 1)
_PZ0 = (0, 1, 1)
_P0 = (0, 0, 0)


def _occupancy_down(occ: torch.Tensor, kernel, stride,
                    padding) -> torch.Tensor:
    """Output-site occupancy of a strided conv: any active input in the
    window (zero padding).  occ: (1, 1, D, H, W)."""
    pd, ph, pw = padding
    return F.max_pool3d(F.pad(occ, (pw, pw, ph, ph, pd, pd)), kernel,
                        stride)


class DenseConv(nn.Module):
    """conv3d (bias added in f32 after the conv's rounding), times the
    OUTPUT level's occupancy, in the input's dtype."""

    def __init__(self, in_features: int, features: int,
                 kernel=(3, 3, 3), stride=(1, 1, 1), padding=_P1):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               *kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, occ_out):
        y = F.conv3d(x, self.weight.to(x.dtype), None, self.stride,
                     self.padding)
        y = (y.float() + self.bias.view(1, -1, 1, 1, 1)) * occ_out
        return y.to(x.dtype)


class DenseConvTranspose(nn.Module):
    """Inverse conv: a transposed conv to ``out_shape`` (D, H, W),
    masked by the finer level's occupancy."""

    def __init__(self, in_features: int, features: int,
                 kernel=(3, 3, 3), stride=(2, 2, 2), padding=_P1):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.padding = tuple(padding)
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               *kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def output_padding(self, in_shape, out_shape) -> Tuple[int, ...]:
        """JAX's extra high-side padding: what ``out_shape`` needs
        beyond the plain transposed size (0 <= extra < stride)."""
        extra = tuple(o - ((i - 1) * s - 2 * p + k) for i, o, s, p, k in
                      zip(in_shape, out_shape, self.stride, self.padding,
                          self.kernel))
        if any(e < 0 or e >= s for e, s in zip(extra, self.stride)):
            raise ValueError(f"transposed conv {tuple(in_shape)} -> "
                             f"{tuple(out_shape)} needs output padding "
                             f"{extra}, outside [0, stride)")
        return extra

    def forward(self, x, occ_fine):
        out_shape = occ_fine.shape[2:]
        y = F.conv_transpose3d(
            x, self.weight.transpose(0, 1).to(x.dtype), None, self.stride,
            self.padding, self.output_padding(x.shape[2:], out_shape))
        y = (y.float() + self.bias.view(1, -1, 1, 1, 1)) * occ_fine
        return y.to(x.dtype)


def _masked_bn_train(x, occ, scale, bias, eps, sync):
    """Train-mode masked BN, y = ((x - mean) * rsqrt(var + eps) * scale
    + bias) * occ over the active cells (n = sum(occ) + 1e-6, var =
    max(s2/n - mean^2, 0)), in f32 (f64 for an f64 input); with
    ``sync``, n, s1 and s2 summed over the "data" axis's ranks.  Returns
    (y, mean, var)."""
    dims = (0, 2, 3, 4)
    v = (1, -1, 1, 1, 1)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    n = torch.sum(occ) * 1.0 + 1e-6
    s1 = torch.sum(xf * occ, dim=dims)
    s2 = torch.sum(xf * xf * occ, dim=dims)
    if sync:
        n, s1, s2 = (psum_if_present(t, "data") for t in (n, s1, s2))
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    y = ((xf - mean.view(v)) * torch.rsqrt(var.view(v) + eps) *
         scale.view(v) + bias.view(v)) * occ
    return y.to(x.dtype), mean, var


class DenseMaskedBN(nn.Module):
    """BN over the active grid cells with running statistics (flax's
    convention: biased variance, 0.99 * old + 0.01 * batch); the output
    is masked by the occupancy and cast to the input dtype.  ``sync``:
    the pooled statistics of every rank's cells inside a data-parallel
    step, as ``middle.MaskedBatchNorm``."""

    def __init__(self, num_features: int, eps: float = 1e-3,
                 momentum: float = 0.99, sync: bool = False):
        super().__init__()
        self.eps, self.momentum, self.sync = eps, momentum, sync
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x, occ):
        if self.training:
            # checkpointed: the backward keeps the input (in its own
            # dtype) and recomputes the f32 grids autograd would keep
            # (and, synced, their sums' all-reduce, on every rank alike)
            y, mean, var = checkpoint(_masked_bn_train, x, occ, self.scale,
                                      self.bias, self.eps, self.sync,
                                      use_reentrant=False)
            update_running_stats(self, mean, var)
            return y
        v = (1, -1, 1, 1, 1)
        y = (x.float() - self.mean.view(v)) * torch.rsqrt(
            self.var.view(v) + self.eps)
        y = (y * self.scale.view(v) + self.bias.view(v)) * occ
        return y.to(x.dtype)


class DenseMiddleCov(nn.Module):
    """Dense middle net + covariance decoder over (features, coords,
    vmask); ``sparse_shape`` is (nz, ny, nx) with the +1 on z applied.
    ``dtype`` is the grid's: bfloat16 as in JAX, float32 for exact
    comparisons."""

    def __init__(self, cfg: MiddleCfg, sparse_shape: Tuple[int, int, int],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.bn_type not in ("none", "bn", "sync_bn"):
            raise ValueError(f"unknown middle bn_type {cfg.bn_type!r}")
        self.cfg = cfg
        self.sparse_shape = tuple(sparse_shape)
        self.dtype = dtype
        c0, c1, c2, c3 = cfg.channels
        n = {"DenseConv": 0, "DenseConvTranspose": 0, "DenseMaskedBN": 0}
        self._layers = []

        def add(kind, module):
            self.add_module(f"{kind}_{n[kind]}", module)
            n[kind] += 1
            self._layers.append(module)

        enc_bn = cfg.bn_type != "none"
        cin = cfg.num_input_features
        # the encoder: (out width, kernel, stride, padding) a conv
        for co, k, s, p in ((c0, 3, 1, _P1), (c0, 3, 1, _P1),
                            (c1, 3, 2, _P1), (c1, 3, 1, _P1),
                            (c1, 3, 1, _P1), (c2, 3, 2, _P1),
                            (c2, 3, 1, _P1), (c2, 3, 1, _P1),
                            (c2, 3, 1, _P1), (c3, 3, 2, _PZ0),
                            (c3, 3, 1, _P1), (c3, 3, 1, _P1),
                            (c3, 3, 1, _P1), (c3, (3, 1, 1), (2, 1, 1), _P0)):
            k = (k,) * 3 if isinstance(k, int) else k
            s = (s,) * 3 if isinstance(s, int) else s
            add("DenseConv", DenseConv(cin, co, k, s, p))
            if enc_bn:
                add("DenseMaskedBN",
                    DenseMaskedBN(co, sync=cfg.bn_type == "sync_bn"))
            cin = co
        # the covariance decoder, always normalized but its last conv
        for kind, ci, co in (("DenseConvTranspose", c2, c1),
                             ("DenseConv", c1, c1),
                             ("DenseConvTranspose", c1, c0),
                             ("DenseConv", c0, c0), ("DenseConv", c0, c0)):
            cls = DenseConv if kind == "DenseConv" else DenseConvTranspose
            add(kind, cls(ci, co))
            add("DenseMaskedBN", DenseMaskedBN(co))
        add("DenseConv", DenseConv(c0, cfg.cov_channels))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initializers: He-normal conv kernels (truncated normal,
        fan_in = kd*kh*kw*Cin, scale 2), zero biases, unit BN scales and
        statistics."""
        from .net import truncated_normal_
        for mod in self.modules():
            if isinstance(mod, (DenseConv, DenseConvTranspose)):
                truncated_normal_(mod.weight, 2.0 / mod.weight[0].numel(),
                                  generator)
                mod.bias.zero_()
            elif isinstance(mod, DenseMaskedBN):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)

    def forward(self, voxel_features: torch.Tensor, coords: torch.Tensor,
                vmask: torch.Tensor):
        """voxel_features: (V, F); coords: (V, 3) zyx (-1 padding);
        vmask: (V,).  Returns (bev (ny', nx', C*D') float32, cov (V, 7)
        float32)."""
        nz, ny, nx = self.sparse_shape
        dev = voxel_features.device
        layers = iter(self._layers)
        enc_bn = self.cfg.bn_type != "none"
        # scatter the features and the occupancy into the grid; invalid
        # voxels park in a spare z slab, which is dropped
        cz = torch.where(vmask, coords[:, 0], nz).long()
        cy, cx = coords[:, 1].long(), coords[:, 2].long()
        grid = torch.zeros((voxel_features.shape[-1], nz + 1, ny, nx),
                           dtype=self.dtype, device=dev)
        grid[:, cz, cy, cx] = voxel_features.to(self.dtype).t()
        occ = torch.zeros((nz + 1, ny, nx), device=dev)
        occ[cz, cy, cx] = 1.0
        x = grid[None, :, :nz]
        occ0 = occ[None, None, :nz]

        def step(x, occ, norm=enc_bn):
            x = next(layers)(x, occ)
            if norm:
                x = next(layers)(x, occ)
            return F.relu(x)

        # encoder
        x = step(step(x, occ0), occ0)
        occ1 = _occupancy_down(occ0, (3, 3, 3), (2, 2, 2), _P1)
        x = step(step(step(x, occ1), occ1), occ1)
        occ2 = _occupancy_down(occ1, (3, 3, 3), (2, 2, 2), _P1)
        x = step(x, occ2)
        x_mid = x
        for _ in range(3):
            x = step(x, occ2)
        occ3 = _occupancy_down(occ2, (3, 3, 3), (2, 2, 2), _PZ0)
        for _ in range(4):
            x = step(x, occ3)
        occ4 = _occupancy_down(occ3, (3, 1, 1), (2, 1, 1), _P0)
        x = step(x, occ4)

        # dense BEV: (1, C, D, H, W) -> (H, W, D*C), z-major channels
        _, C, D, H, W = x.shape
        bev = x[0].permute(2, 3, 1, 0).reshape(H, W, D * C).float()

        # covariance decoder
        y = step(x_mid, occ1, True)
        y = step(y, occ1, True)
        y = step(y, occ0, True)
        y = step(y, occ0, True)
        y = step(y, occ0, True)
        y = next(layers)(y, occ0)
        # gather at the input coords; padded coords (-1) wrap, as in the
        # JAX module, and the mask zeroes their rows
        z = torch.clamp(coords[:, 0], max=nz - 1).long()
        cov = y[0][:, z, cy, cx].t().float()
        cov = torch.cat([F.elu(cov[:, :3]) + 1 + 1e-6, cov[:, 3:]], dim=-1)
        return bev, torch.where(vmask[:, None], cov, 0.0)
