"""Streaming odometry runner with per-frame feature caching
(counterpart of ``rslo_tpu/eval/streaming.py``).

Each incoming scan is voxelized and encoded ONCE, without the
covariance decoder (14 sparse convs); its BEV features pair with the
cached previous frame's features for the motion prediction.  The mean
VFE takes the mean-mode preparation; any other VFE the point stacks,
and the stream feeds the frame the ``SimpleVoxelXYZINormal`` encoding
of them, as the JAX package's stream does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config.schema import PipelineCfg
from ..data.prepare import mean_vfe_ok, prepare_example, voxelizer_config
from ..geometry import np_compose_pose
from ..models.vfe import simple_voxel_xyzi_normal
from ..utils.timing import span


class StreamingOdometry:
    def __init__(self, net, cfg: PipelineCfg, device="cuda"):
        self.mean_mode = mean_vfe_ok(cfg)
        self.device = torch.device(device)
        self.net = net.to(self.device).eval()
        self.cfg = cfg
        self.vcfg = voxelizer_config(cfg)
        self._bev = None
        self.pose = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
        self.trajectory = [self.pose.copy()]

    def _features(self, pts: torch.Tensor, mask: torch.Tensor):
        ex = prepare_example(pts[None], mask[None], self.vcfg,
                             mean_mode=self.mean_mode)
        if self.mean_mode:
            f = ex["voxel_features"][0]
        else:
            f = simple_voxel_xyzi_normal(ex["voxels"][0],
                                         ex["num_points"][0],
                                         self.cfg.vfe.num_input_features)
        return self.net.frame_features(f, ex["coords"][0],
                                       ex["voxel_mask"][0], with_cov=False)

    @torch.no_grad()
    def push(self, points: np.ndarray,
             mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Feed one scan (N, F); returns the current absolute pose
        [t, q]."""
        with span("stream.push"):
            with span("h2d"):
                pts = torch.as_tensor(points, dtype=torch.float32,
                                      device=self.device)
                m = (torch.ones(pts.shape[0], dtype=torch.bool,
                                device=self.device)
                     if mask is None else
                     torch.as_tensor(mask, dtype=torch.bool,
                                     device=self.device))
            bev_new, _ = self._features(pts, m)
            if self._bev is None:
                self._bev = bev_new
                return self.pose
            odom = self.net.pair_predict(self._bev, bev_new)["odometry"][0]
            self._bev = bev_new
            with span("pose"):
                odom = odom.cpu().numpy()
                self.pose = np_compose_pose(self.pose[None], odom[None])[0]
                self.trajectory.append(self.pose.copy())
            return self.pose
