"""Semi-global synchronized BatchNorm (counterpart of
``rslo_tpu/models/semiglobal_bn.py``).

Train mode first moves the running statistics towards the batch
moments, each with a per-channel dynamic momentum adapted from a g^2
stability probe:

    probe <- (1-b) probe + b val
    g2    <- clip((1-b) g2 + b ((probe-probe_old)/probe_old)^2, 0, mom^2)
    mom'  <- 1 - (1-mom)/(1-mom + sqrt(g2) + 1e-9)

and then normalizes with the updated RUNNING statistics (not the batch
ones), in train mode too; eval mode applies them unchanged.  No
gradient flows through the statistics.  Inside a data-parallel step the
batch moments E[x] and E[x^2] are averaged over the ranks of the "data"
axis first (``utils/mesh_axis.py``), as JAX's ``pmean``.

Under a split of the BEV stage (``parallel/``) the statistics are those
of the whole map, as GSPMD computes them: over a space split the sums
of x and x^2 over every rank's columns divided by the global count
(``parallel/spatial.py::batch_moments``); over a model split each rank
holds a slice of the channels, normalizes it with its slice of the
buffers and gathers the moments of every channel, so that every rank
updates all eight buffers whole, as ``Norm`` does.

Eight buffers, the flax ``batch_stats`` leaves: ``mean``, ``var``,
``mean_dyn_mom``, ``var_dyn_mom``, ``mean_g2``, ``var_g2``,
``mean_probe``, ``var_probe``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.spatial import batch_moments
from ..parallel.tensor import channel_range, gather_channels, holds_slice
from ..utils.mesh_axis import pmean_if_present

STATS = ("mean", "var", "mean_dyn_mom", "var_dyn_mom", "mean_g2", "var_g2",
         "mean_probe", "var_probe")


class SemiGlobalSyncBN(nn.Module):
    """Channels on dim 1 (NCHW); computed in f32 and cast back to the
    input dtype."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 beta: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.beta, self.eps = momentum, beta, eps
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        for name in STATS:
            self.register_buffer(name, torch.empty(num_features))
        self.reset_statistics()

    @torch.no_grad()
    def reset_statistics(self):
        """The initial values: running mean 0 and var 1, dynamic momenta
        ``momentum``, g^2 1, probes 0 (mean) and 1 (var)."""
        for name, v in (("mean", 0.0), ("var", 1.0),
                        ("mean_dyn_mom", self.momentum),
                        ("var_dyn_mom", self.momentum),
                        ("mean_g2", 1.0), ("var_g2", 1.0),
                        ("mean_probe", 0.0), ("var_probe", 1.0)):
            getattr(self, name).fill_(v)

    def _probe(self, dyn_mom, g2, probe, val):
        b, mom = self.beta, self.momentum
        probe_old = probe.clone()
        probe.copy_((1 - b) * probe + b * val)
        guard = torch.where(torch.abs(probe_old) > 1e-12, probe_old,
                            torch.full_like(probe_old, 1e-12))
        diff = ((probe - probe_old) / guard) ** 2
        g2.copy_(torch.clamp((1 - b) * g2 + b * diff, 0.0, mom ** 2))
        dyn_mom.copy_(1 - (1 - mom) / (1 - mom + torch.sqrt(g2) + 1e-9))

    def _channels(self, x: torch.Tensor) -> tuple[int, int]:
        """[lo, hi) of the channels ``x`` holds: all of them, or this
        model rank's slice (which may be empty)."""
        c = self.scale.shape[0]
        return channel_range(c) if holds_slice(x, c) else (0, c)

    @torch.no_grad()
    def update_statistics(self, x: torch.Tensor):
        mu, m2 = batch_moments(x.float())
        mu = pmean_if_present(mu, "data")
        m2 = pmean_if_present(m2, "data")
        c = self.scale.shape[0]
        if holds_slice(x, c):
            mu, m2 = gather_channels(mu, c, 0), gather_channels(m2, c, 0)
        var = torch.clamp(m2 - mu * mu, min=0.0)
        self.mean.copy_(self.mean_dyn_mom * mu +
                        (1 - self.mean_dyn_mom) * self.mean)
        self.var.copy_(self.var_dyn_mom * var +
                       (1 - self.var_dyn_mom) * self.var)
        self._probe(self.mean_dyn_mom, self.mean_g2, self.mean_probe, mu)
        self._probe(self.var_dyn_mom, self.var_g2, self.var_probe, var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            self.update_statistics(x)
        lo, hi = self._channels(x)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mean = self.mean[lo:hi].view(shape)
        inv = torch.rsqrt(self.var[lo:hi].view(shape) + self.eps)
        y = (x.float() - mean) * inv
        y = y * self.scale[lo:hi].view(shape) + self.bias[lo:hi].view(shape)
        return y.to(x.dtype)
