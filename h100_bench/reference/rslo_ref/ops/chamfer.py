"""One-direction nearest-neighbour search, the chamfer association, in
plain PyTorch on every device: the contract of the program's
``ops/chamfer.py`` (distance ``((dx*dx + dy*dy) + dz*dz) + penalty``
from the direct f32 differences, penalty ``BIG`` for an invalid tgt, the
lowest index wins a tie, a masked src gives ``(BIG, 0)``, distances
clamped at >= 0)."""
from __future__ import annotations

import torch

BIG = 1e30


@torch.no_grad()
def nn_search_plain(src, src_mask, tgt, tgt_mask, chunk: int = 1024):
    """Plain PyTorch version of ``nn_search`` (same arguments), over tgt
    chunks so that no (N, M) matrix is held at once."""
    src = src.float()
    tgt = tgt.float()
    P, N, _ = src.shape
    M = tgt.shape[1]
    pen = torch.where(tgt_mask, 0.0, BIG).to(torch.float32)
    best_d = torch.full((P, N), BIG, dtype=torch.float32, device=src.device)
    best_i = torch.zeros((P, N), dtype=torch.int32, device=src.device)
    s = src[:, :, None, :]
    for m0 in range(0, M, chunk):
        t = tgt[:, None, m0:m0 + chunk, :]
        dx = s[..., 0] - t[..., 0]
        dy = s[..., 1] - t[..., 1]
        dz = s[..., 2] - t[..., 2]
        d = dx * dx + dy * dy
        d = d + dz * dz
        d = d + pen[:, None, m0:m0 + chunk]
        td = d.min(dim=-1).values
        iota = torch.arange(d.shape[-1], dtype=torch.int32,
                            device=src.device)
        ti = torch.where(d <= td[..., None], iota, d.shape[-1]).min(
            dim=-1).values
        upd = td < best_d
        best_i = torch.where(upd, ti + m0, best_i)
        best_d = torch.where(upd, td, best_d)
    dist = torch.where(src_mask, best_d, BIG)
    idx = torch.where(src_mask, best_i, 0)
    return torch.clamp(dist, min=0.0), idx.to(torch.int32)


def nn_search(src, src_mask, tgt, tgt_mask):
    return nn_search_plain(src, src_mask, tgt, tgt_mask)
