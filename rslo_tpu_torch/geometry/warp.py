"""BEV feature warping by a dense local-transformation map (counterpart
of ``rslo_tpu/geometry/warp.py``): every BEV cell of the target map is
sampled at the position its tq-map motion predicts in the source map
(bilinear, zero padding), giving the warped features and a validity
mask.  NHWC, as in JAX.
"""
from __future__ import annotations

import torch

from .quaternion import rotate_vec_by_q
from .tq_map import grid_cell_coords


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """img: (H, W, C); xy: (..., 2) in pixel coords (x along W, y along
    H).  A tap outside the image reads 0: its index is clamped and the
    value masked."""
    H, W, C = img.shape
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]

    def tap(yy, xx):
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        v = img[torch.clamp(yy, 0, H - 1).to(torch.int64),
                torch.clamp(xx, 0, W - 1).to(torch.int64)]
        return torch.where(inb[..., None], v, 0.0)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    return ((1 - dy) * ((1 - dx) * v00 + dx * v01) +
            dy * ((1 - dx) * v10 + dx * v11))


def inverse_warp(feat_src: torch.Tensor, tq_map: torch.Tensor,
                 pc_range) -> tuple[torch.Tensor, torch.Tensor]:
    """Warp source BEV features into the target frame.

    feat_src: (H, W, C); tq_map: (H, W, 7) local motion map (channels
    last).  Returns (warped (H, W, C), valid (H, W, 1))."""
    H, W, _ = tq_map.shape
    coords = grid_cell_coords((H, W), pc_range, device=tq_map.device)
    pc = torch.tensor(pc_range, dtype=torch.float32)
    cell = torch.stack([(pc[3] - pc[0]) / W, (pc[4] - pc[1]) / H]).to(
        tq_map.device)
    # the world position each cell's point moves to under its local pose
    moved = rotate_vec_by_q(coords, tq_map[..., 3:]) + tq_map[..., :3]
    # world -> pixel: x right (j), y down == -world y (i)
    jx = (moved[..., 0] - coords[0, 0, 0]) / cell[0]
    iy = (coords[0, 0, 1] - moved[..., 1]) / cell[1]
    xy = torch.stack([jx, iy], dim=-1)
    warped = bilinear_sample(feat_src, xy)
    valid = (jx >= 0) & (jx < W) & (iy >= 0) & (iy < H)
    return warped, valid[..., None].to(feat_src.dtype)
