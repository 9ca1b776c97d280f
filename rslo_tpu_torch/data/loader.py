"""The host batches (counterpart of ``rslo_tpu/data/loader.py``):
fixed-shape padded numpy arrays from dataset samples, points (D, L, N,
F) + masks and odometry targets (D, P, 7) for D samples; voxelization
happens on the device (``data/prepare.py``), the host only pads.

``TrainSampler`` is the shuffled, iteration-budget, resumable index
stream of training, and ``DataLoader`` fetches, augments and collates
batches from it in a thread pool, each fetch with its own seeded rng, so
the batch stream is a function of (dataset, seed, last_iter) alone.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from ..config.schema import DataCfg
from ..utils.timing import span
from .augment import pose_interp_aug, random_flip_y, random_yaw

# int16 transfer-quantization scales: channels 0-2 are metric positions
# (+-128 m at ~3.9 mm resolution), all remaining channels are unit-range
# (intensity, normals)
QUANT_POS_SCALE = 128.0 / 32767.0
QUANT_UNIT_SCALE = 1.0 / 32767.0


def quant_scale(n_features: int) -> np.ndarray:
    s = np.full((n_features,), QUANT_UNIT_SCALE, np.float32)
    s[:3] = QUANT_POS_SCALE
    return s


def quantize_points(pts: np.ndarray) -> np.ndarray:
    """(..., F) f32 -> int16 with the shared per-channel scales."""
    s = quant_scale(pts.shape[-1])
    return np.clip(np.rint(pts / s), -32767, 32767).astype(np.int16)


def pad_points(pts: np.ndarray, n_max: int,
               rng: np.random.Generator | None = None):
    """(N, F) -> ((n_max, F), (n_max,) mask).  Over-capacity clouds are
    subsampled: seeded ``rng`` when given (reproducible train batches),
    fixed-stride otherwise (deterministic eval)."""
    n = len(pts)
    out = np.zeros((n_max, pts.shape[1]), np.float32)
    mask = np.zeros((n_max,), bool)
    if n > n_max:
        if rng is not None:
            sel = rng.choice(n, n_max, replace=False)
        else:
            sel = (np.arange(n_max) * n) // n_max
        out[:] = pts[sel]
        mask[:] = True
    else:
        out[:n] = pts
        mask[:n] = True
    return out, mask


def collate(samples: list, cfg: DataCfg,
            rng: np.random.Generator | None = None) -> dict:
    """list[D] of dataset samples -> fixed-shape batch.  With
    ``cfg.quantize_transfer`` the points are int16, which
    ``prepare_example`` dequantizes on the device."""
    D = len(samples)
    L = len(samples[0]["points"])
    N = cfg.max_points
    pts = np.zeros((D, L, N, samples[0]["points"][0].shape[1]), np.float32)
    msk = np.zeros((D, L, N), bool)
    P = len(samples[0]["odometry"])
    odom = np.zeros((D, P, 7), np.float32)
    meta = []
    want_hier = "hier_points" in samples[0]
    if want_hier:
        Nh = cfg.max_hier_points
        hier = np.zeros((D, L, Nh, samples[0]["hier_points"][0].shape[1]),
                        np.float32)
        hmask = np.zeros((D, L, Nh), bool)
    for d, s in enumerate(samples):
        for t in range(L):
            pts[d, t], msk[d, t] = pad_points(s["points"][t], N, rng)
            if want_hier:
                hier[d, t], hmask[d, t] = pad_points(
                    s["hier_points"][t], Nh, rng)
        odom[d] = s["odometry"]
        meta.append((s.get("seq", -1), tuple(s.get("frames", ()))))
    if cfg.quantize_transfer:
        pts = quantize_points(pts)
    out = {"points": pts, "point_mask": msk, "odometry": odom,
           "meta": meta}
    if want_hier:
        if cfg.quantize_transfer:
            hier = quantize_points(hier)
        out["hier_points"] = hier
        out["hier_mask"] = hmask
    return out


class TrainSampler:
    """Shuffled, iteration-budget, resumable sampler: one permutation
    per epoch, seeded with ``seed + epoch``, read from position
    ``(last_iter + 1) * batch``.

    ``review_cycle`` (> 0, in epochs) repeats every block of
    ``review_cycle * n`` samples once immediately: blocks stream as
    B0 B0 B1 B1 ...  The
    position→index mapping is a pure function, so resume-from-last_iter
    works identically with or without review.
    """

    def __init__(self, n_items: int, total_steps: int, batch: int,
                 seed: int = 0, last_iter: int = -1,
                 review_cycle: float = -1.0):
        self.n = n_items
        self.total = total_steps * batch
        self.seed = seed
        self.pos = (last_iter + 1) * batch
        self.block = (int(review_cycle * n_items)
                      if review_cycle and review_cycle > 0 else 0)

    def _underlying(self, p: int) -> int:
        """Map stream position -> position in the non-repeated shuffled
        stream."""
        if self.block <= 0:
            return p
        b = self.block
        return (p // (2 * b)) * b + (p % (2 * b)) % b

    def _index_at(self, p: int) -> int:
        u = self._underlying(p)
        epoch = u // self.n
        rng = np.random.default_rng(self.seed + epoch)
        return int(rng.permutation(self.n)[u % self.n])

    def __iter__(self):
        # iterate lazily, re-deriving the per-epoch permutation only on
        # epoch boundaries
        perm = None
        perm_epoch = -1
        while True:
            u = self._underlying(self.pos)
            epoch = u // self.n
            if epoch != perm_epoch:
                perm = np.random.default_rng(
                    self.seed + epoch).permutation(self.n)
                perm_epoch = epoch
            yield int(perm[u % self.n])
            self.pos += 1


class DataLoader:
    """Batches of ``device_batch`` samples from a background thread:
    the sampler's indices (training) or the dataset in order, fetched
    in a pool of ``num_workers`` threads; in training each fetch draws
    from its own rng ``(seed + 17, n)`` (n counts fetches from the
    start of this loader) for the random stride, flip, yaw and pose
    interpolation, in that order, and each batch's pad subsampling from
    ``(seed + 17, 9, b)`` (b counts batches), so thread scheduling does
    not change the stream."""

    def __init__(self, dataset, cfg: DataCfg, device_batch: int,
                 total_steps: int, *, train: bool = True, seed: int = 0,
                 last_iter: int = -1, num_workers: int | None = None):
        self.dataset = dataset
        self.cfg = cfg
        self.device_batch = device_batch
        self.train = train
        if train:
            self.sampler = iter(TrainSampler(len(dataset), total_steps,
                                             device_batch, seed, last_iter,
                                             review_cycle=cfg.review_cycle))
        else:
            self.sampler = iter(range(len(dataset)))
        self._seed = seed + 17
        self._seq_no = 0
        self._batch_no = 0
        self.workers = num_workers or cfg.num_workers
        self._q: queue.Queue = queue.Queue(maxsize=4)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _fetch_one(self, idx: int, seq_no: int = 0):
        # per-fetch RNG: thread-safe and reproducible per stream
        # position
        rng = np.random.default_rng((self._seed, seq_no))
        if self.train and getattr(self.dataset, "supports_random_skip",
                                  False) and self.cfg.random_skip:
            s = self.dataset.sample(idx, rng)
        else:
            s = self.dataset[idx]
        if self.train and self.cfg.random_flip_y:
            s = random_flip_y(s, rng)
        if self.train and self.cfg.yaw_aug_rad > 0:
            s = random_yaw(s, rng, self.cfg.yaw_aug_rad)
        if self.train and self.cfg.pose_interp_ratio > 0:
            s = pose_interp_aug(s, rng, self.cfg.pose_interp_ratio)
        return s

    def _run(self):
        from concurrent.futures import ThreadPoolExecutor
        try:
            with ThreadPoolExecutor(max_workers=max(self.workers, 1)) \
                    as pool:
                pending = []
                done = False
                while not self._stop.is_set():
                    # keep a couple of batches in flight
                    while not done and len(pending) < 3:
                        idxs = []
                        for _ in range(self.device_batch):
                            try:
                                idxs.append(next(self.sampler))
                            except StopIteration:
                                done = True
                                break
                        if len(idxs) < self.device_batch:
                            break
                        futs = []
                        for i in idxs:
                            futs.append(pool.submit(
                                self._fetch_one, i, self._seq_no))
                            self._seq_no += 1
                        pending.append(futs)
                    if not pending:
                        self._q.put(None)
                        return
                    batch_futs = pending.pop(0)
                    samples = [f.result() for f in batch_futs]
                    # seeded per-batch rng for pad-subsampling:
                    # reproducible regardless of thread schedule
                    rng = (np.random.default_rng((self._seed, 9,
                                                  self._batch_no))
                           if self.train else None)
                    self._batch_no += 1
                    self._q.put(collate(samples, self.cfg, rng))
        except Exception as e:  # surface worker errors to the consumer
            self._q.put(e)

    def __iter__(self) -> Iterator[dict]:
        while True:
            with span("data.wait"):
                item = self._q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self):
        """Stop the producer: set the flag, then drain the queue so that
        a producer blocked on a full queue gets to see it."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return
