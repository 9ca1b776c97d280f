"""Frame-window datasets over the HDF5 store (counterpart of
``rslo_tpu/data/dataset.py``): splits, temporal windows and cyclic VO
targets.

  * splits: train = seqs 00-06, val = 07-10, eval_train = 00;
  * an index addresses a window of ``seq_length`` consecutive frames
    (stride ``skip``); camera poses are mapped to the LiDAR frame and
    all C(L,2) pairwise relative motions form the target vector
    (``generate_cyc_vo``);
  * the known-corrupt frame (seq 19 frame 4148) is skipped;
  * ``sample(idx, rng)`` is the train-time fetch with a random window
    stride (``DataCfg.random_skip``).

``DATASETS`` maps ``cfg.data.dataset`` to its class.
"""
from __future__ import annotations

import numpy as np

from ..config.schema import DataCfg
from ..geometry.transforms import RT_to_tq, cam_pose_to_lidar, np_calc_vo
from .hdf5_store import SequenceReader

CORRUPT = {(19, 4148)}


def generate_cyc_vo(pose_seq: np.ndarray) -> np.ndarray:
    """(L, 7) absolute poses -> (C(L,2), 7) pairwise motions with
    hemisphere-normalized quaternions."""
    L = len(pose_seq)
    vos = []
    for i in range(L):
        for j in range(i + 1, L):
            vo = np_calc_vo(pose_seq[i:i + 1], pose_seq[j:j + 1])[0]
            vo[3:] *= np.sign(vo[3]) if vo[3] != 0 else 1.0
            vos.append(vo)
    return np.stack(vos).astype(np.float32)


class KittiWindowDataset:
    USE_CROSS_NORMALS = False

    def __init__(self, cfg: DataCfg, split: str = "train",
                 seq_length: int | None = None):
        self.cfg = cfg
        self.split = split
        self.seq_length = seq_length or (cfg.seq_length if split == "train"
                                         else 2)
        self.skip = cfg.skip
        seqs = {"train": cfg.train_sequences, "val": cfg.val_sequences,
                "eval_train": cfg.eval_train_sequences}[split]
        self.readers = {s: SequenceReader(cfg.root, s) for s in seqs}
        self.index = []  # (seq, start_frame)
        span = (self.seq_length - 1) * self.skip
        for s in seqs:
            n = self.readers[s].n_frames
            for i in range(n - span):
                frames = [i + k * self.skip
                          for k in range(self.seq_length)]
                if any((s, fr) in CORRUPT for fr in frames):
                    continue
                self.index.append((s, i))

    supports_random_skip = True

    def __len__(self):
        return len(self.index)

    def window_frames(self, idx: int):
        s, start = self.index[idx]
        return s, [start + k * self.skip for k in range(self.seq_length)]

    def sample(self, idx: int, rng: np.random.Generator) -> dict:
        """Train-time fetch with a per-sample window stride: the window
        keeps its start frame, its stride is drawn uniformly from
        1..skip (or the signed range when skip < 0), and frames past
        the sequence end clamp to its last frame."""
        s, start = self.index[idx]
        if self.skip > 0:
            choices = np.arange(1, self.skip + 1)
        else:
            choices = np.concatenate([np.arange(self.skip, 0),
                                      np.arange(1, -self.skip + 1)])
        skip = int(rng.choice(choices))
        n = self.readers[s].n_frames
        frames = [min(max(start + k * skip, 0), n - 1)
                  for k in range(self.seq_length)]
        if any((s, fr) in CORRUPT for fr in frames):
            return self[idx]
        return self._load_window(s, frames)

    def __getitem__(self, idx: int) -> dict:
        s, frames = self.window_frames(idx)
        return self._load_window(s, frames)

    def _load_window(self, s: int, frames: list) -> dict:
        reader = self.readers[s]
        pts, poses, hier = [], [], []
        want_hier = self.cfg.load_hier_points
        hkey = (f"hier_lidar_points_normals_"
                f"{self.cfg.downsample_voxel_sizes[0]}")
        for fr in frames:
            d = reader.frame(fr, cross_normals=self.USE_CROSS_NORMALS)
            pts.append(d["points"])
            lidar_pose = cam_pose_to_lidar(d["pose"], d["Tr"])
            poses.append(RT_to_tq(lidar_pose)[0])
            if want_hier and hkey in d:
                hier.append(d[hkey])
        poses = np.stack(poses)
        out = {
            "points": pts,                     # list[L] (N_i, 7)
            "pose_seq": poses,                 # (L, 7) absolute lidar poses
            "odometry": generate_cyc_vo(poses),  # (C(L,2), 7)
            "seq": s,
            "frames": frames,
        }
        if want_hier and len(hier) == len(frames):
            out["hier_points"] = hier          # list[L] (Nh_i, 6)
        return out

    def sequence_segments(self):
        """Group the linear eval index by sequence, preserving frame order
        (the eval split iterates windows in order)."""
        seqs = {}
        for n, (s, i) in enumerate(self.index):
            seqs.setdefault(s, []).append(n)
        return seqs


class KittiCrossNormWindowDataset(KittiWindowDataset):
    """Cross-normal variant: network-input normals come from
    ``lidar_cross_normals`` and the fine normals ride along as
    supervision (10-column points)."""
    USE_CROSS_NORMALS = True


DATASETS = {"kitti_hdf5": KittiWindowDataset,
            "kitti_crossnorm_hdf5": KittiCrossNormWindowDataset}
