"""The KITTI store: its offline build from a raw KITTI tree
(``create_hdf5``) and its reader (counterpart of
``rslo_tpu/data/hdf5_store.py``), in two formats that hold the same
datasets.

Per sequence ``"XX"``: float32 ragged datasets ``lidar_points`` (N x 4),
``lidar_normals`` (N x 3), optionally ``lidar_cross_normals`` (N x 3)
and ``hier_lidar_points_normals_{size}`` (M x 6), plus ``poses`` and
``calib_Tr`` (n x 12, one row a frame).  Normals are kNN-PCA normals
(``data/normals.py``, the native build); hierarchical clouds are
voxel-grid means of xyz + normals.

* A path ending in ``.h5`` is an HDF5 file, JAX's format: a group a
  sequence, vlen datasets holding each frame flattened.  One reader
  handle per file and process (SWMR).  It needs ``h5py``, imported only
  when such a store is built or opened.
* Any other path is a directory store, which needs only numpy: a
  directory ``XX/`` a sequence, each ragged dataset one ``.npy`` of the
  rows of every frame, ``(rows, width)`` float32, beside an int64
  ``(n + 1,)`` ``.offsets.npy`` of each frame's first row, and
  ``poses.npy`` and ``calib_Tr.npy`` ``(n, 12)``.  A frame's rows hold
  the bytes that HDF5 holds for it.  The build keeps one frame's record
  at a time (rows are appended after a reserved ``.npy`` header, which
  is written once the count is known) and writes a sequence under a
  temporary name, renamed into place when the sequence is complete, so
  a build that dies leaves no sequence that reads as whole.  Sequences
  are independent: builds of different sequences may fill one store
  side by side.  The reader maps a sequence's arrays once per process
  (``np.load(mmap_mode="r")``) and copies a frame's rows out.
"""
from __future__ import annotations

import os
import shutil
import struct
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

_HANDLES: dict = {}
_MAPS: dict = {}
# bytes reserved for a ragged dataset's .npy header (magic, version,
# length and the padded dict; NPY format 1.0)
_NPY_HEADER = 128


def is_hdf5(path) -> bool:
    """Whether ``path`` names an HDF5 store (else a directory store)."""
    return str(path).endswith(".h5")


def get_h5(path: str):
    import h5py
    key = (os.getpid(), str(path))
    if key not in _HANDLES:
        _HANDLES[key] = h5py.File(path, "r", libver="latest", swmr=True,
                                  rdcc_nbytes=1024 ** 3, rdcc_nslots=100003)
    return _HANDLES[key]


def build_frame_record(points: np.ndarray,
                       downsample_sizes: Sequence[float] = (0.1,),
                       normal_radius: float = 0.6, normal_k: int = 30,
                       cross_normal_radius: Optional[float] = None
                       ) -> Dict[str, np.ndarray]:
    """One frame's datasets of the store, keyed by dataset name, each
    shaped as ``SequenceReader.frame`` reads it back: ``lidar_points``
    (N, 4) as given, ``lidar_normals`` (N, 3) at ``normal_radius``,
    ``lidar_cross_normals`` (N, 3) at ``cross_normal_radius`` when it is
    set (the network-input normals of the cross-normal dataset, at a
    coarser spatial scale), and ``hier_lidar_points_normals_{s}``
    (M, 6), the voxel-grid means of xyz + normals at each size."""
    from .normals import estimate_normals, voxel_downsample
    normals = estimate_normals(points[:, :3], normal_radius, normal_k)
    rec = {"lidar_points": points, "lidar_normals": normals}
    if cross_normal_radius:
        rec["lidar_cross_normals"] = estimate_normals(
            points[:, :3], cross_normal_radius, normal_k)
    pn = np.concatenate([points[:, :3], normals], axis=1)
    for s in downsample_sizes:
        rec[f"hier_lidar_points_normals_{s}"] = voxel_downsample(pn, s)
    return rec


def _ragged_names(downsample_sizes, cross_normal_radius):
    names = ["lidar_points", "lidar_normals"]
    if cross_normal_radius:
        names.append("lidar_cross_normals")
    return names + [f"hier_lidar_points_normals_{s}"
                    for s in downsample_sizes]


def _width(name: str) -> int:
    return 4 if name == "lidar_points" else 6 if name.startswith(
        "hier_") else 3


def _sequence_source(kitti_root, seq, max_frames):
    """A sequence's scan files, camera-frame poses (n, 12; identity where
    the tree has no pose file) and ``Tr`` a frame (n, 12)."""
    from .kitti_io import list_frames, read_calib, read_poses, sequence_paths
    velo_dir, seq_dir, pose_file = sequence_paths(kitti_root, seq)
    frames = list_frames(velo_dir)
    if max_frames:
        frames = frames[:max_frames]
    Tr = read_calib(seq_dir)["Tr"].reshape(-1)
    n = len(frames)
    poses = (read_poses(pose_file)[:n] if pose_file is not None
             else np.tile(np.eye(3, 4).reshape(1, 3, 4), (n, 1, 1)))
    return frames, poses.reshape(n, 12), np.tile(Tr, (n, 1))


def create_hdf5(kitti_root: str, out_path: str,
                sequences: Sequence[int] = tuple(range(11)),
                downsample_sizes: Sequence[float] = (0.1,),
                normal_radius: float = 0.6, normal_k: int = 30,
                cross_normal_radius: Optional[float] = None,
                max_frames: Optional[int] = None,
                progress: bool = True) -> None:
    """Build the training store from a raw KITTI odometry tree: per
    sequence, every frame's ``build_frame_record``, the camera-frame
    poses and the calibration's ``Tr``, one row a frame.  ``out_path``
    ending in ``.h5`` writes an HDF5 file (h5py needed: without it this
    raises ``ImportError`` and writes nothing); any other path is a
    directory store, whose sequences in ``sequences`` are (re)written and
    others left as they are."""
    from .kitti_io import read_velodyne
    names = _ragged_names(downsample_sizes, cross_normal_radius)

    def records(frames, seq):
        n = len(frames)
        for i, fr in enumerate(frames):
            yield build_frame_record(read_velodyne(fr), downsample_sizes,
                                     normal_radius, normal_k,
                                     cross_normal_radius)
            if progress and i % 100 == 0:
                print(f"seq {seq:02d}: {i}/{n}", flush=True)

    if not is_hdf5(out_path):
        for seq in sequences:
            frames, poses, Tr = _sequence_source(kitti_root, seq, max_frames)
            _write_sequence(Path(out_path), seq, names, records(frames, seq),
                            poses, Tr)
        return
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"create_hdf5: {out_path} names an HDF5 file (it ends in .h5) "
            f"and h5py is not installed; give a path that does not end in "
            f".h5 to build the directory store, which needs only numpy "
            f"and which train and evaluate read the same way") from e
    with h5py.File(out_path, "w", libver="latest") as f:
        for seq in sequences:
            frames, poses, Tr = _sequence_source(kitti_root, seq, max_frames)
            n = len(frames)
            g = f.create_group(f"{seq:02d}")
            vf = h5py.vlen_dtype(np.float32)
            dsets = {k: g.create_dataset(k, (n,), dtype=vf) for k in names}
            g.create_dataset("poses", data=poses)
            g.create_dataset("calib_Tr", data=Tr)
            for i, rec in enumerate(records(frames, seq)):
                for k, d in dsets.items():
                    d[i] = rec[k].reshape(-1)
                del rec


def _npy_header(shape, descr: str) -> bytes:
    """An NPY 1.0 header of exactly ``_NPY_HEADER`` bytes."""
    d = (f"{{'descr': '{descr}', 'fortran_order': False, 'shape': "
         f"{tuple(int(s) for s in shape)}, }}")
    body = d.ljust(_NPY_HEADER - 11) + "\n"
    if len(body) != _NPY_HEADER - 10:
        raise ValueError(f"shape {shape} does not fit an NPY header of "
                         f"{_NPY_HEADER} bytes")
    return b"\x93NUMPY\x01\x00" + struct.pack("<H", len(body)) + \
        body.encode("latin1")


class _RaggedWriter:
    """One ragged dataset of a sequence being built: each frame's rows
    appended after a reserved header, which is written with the row
    count when the sequence ends."""

    def __init__(self, path: Path, width: int):
        self.path, self.width = path, width
        self.offsets = [0]
        self.f = open(path, "wb")
        self.f.write(bytes(_NPY_HEADER))

    def append(self, rows: np.ndarray):
        rows = np.ascontiguousarray(rows, np.float32).reshape(-1, self.width)
        self.f.write(rows.data)
        self.offsets.append(self.offsets[-1] + len(rows))

    def close(self):
        self.f.seek(0)
        self.f.write(_npy_header((self.offsets[-1], self.width), "<f4"))
        _sync_close(self.f)
        _save(self.path.with_name(self.path.stem + ".offsets.npy"),
              np.asarray(self.offsets, np.int64))


def _sync_close(f):
    """Close ``f`` once its bytes are on the disk."""
    f.flush()
    os.fsync(f.fileno())
    f.close()


def _save(path: Path, arr: np.ndarray):
    f = open(path, "wb")
    np.save(f, arr)
    _sync_close(f)


def _write_sequence(root: Path, seq: int, names, records, poses, Tr):
    """Write one sequence of a directory store from ``records`` (an
    iterable of frame records, consumed one at a time) under a
    temporary directory, renamed to ``root/XX`` once complete."""
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"{seq:02d}"
    tmp = root / f".{seq:02d}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    writers = {}
    try:
        writers = {k: _RaggedWriter(tmp / f"{k}.npy", _width(k))
                   for k in names}
        n = 0
        for rec in records:
            for k, w in writers.items():
                w.append(rec[k])
            del rec     # before the next frame's record is built
            n += 1
        if n != len(poses):
            raise ValueError(f"sequence {seq:02d}: {n} records for "
                             f"{len(poses)} poses")
        for w in writers.values():
            w.close()
        _save(tmp / "poses.npy", poses)
        _save(tmp / "calib_Tr.npy", Tr)
    except BaseException:
        for w in writers.values():
            w.f.close()
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if final.exists():
        old = root / f".{seq:02d}.{os.getpid()}.old"
        os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old)
    else:
        os.replace(tmp, final)
    fd = os.open(root, os.O_RDONLY)     # the rename itself, on the disk
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _map_sequence(seq_dir: str) -> dict:
    """A directory store's sequence, mapped once per process and
    directory: {dataset: array} in name order, a ragged dataset as
    (rows, offsets).  Raises FileNotFoundError where a dataset is
    missing."""
    key = (os.getpid(), seq_dir, os.stat(seq_dir).st_ino)
    if key not in _MAPS:
        names = sorted(p.name[:-len(".npy")] for p in
                       Path(seq_dir).glob("*.npy")
                       if not p.name.endswith(".offsets.npy"))
        maps = {}
        for k in names:
            arr = np.load(os.path.join(seq_dir, k + ".npy"), mmap_mode="r")
            off = os.path.join(seq_dir, k + ".offsets.npy")
            maps[k] = (arr, np.load(off)) if os.path.exists(off) else arr
        for k in ("lidar_points", "lidar_normals", "poses", "calib_Tr"):
            if k not in maps:
                raise FileNotFoundError(f"{seq_dir}: no {k}.npy")
        _MAPS[key] = maps
    return _MAPS[key]


class SequenceReader:
    """Random access to one sequence's frames in a store: an HDF5 file
    (``all.h5``) or a directory store (see the module)."""

    def __init__(self, root: str, seq: int):
        self.path = root
        self.seq = seq
        if os.path.isdir(root):
            self._dir = os.path.join(os.path.abspath(root), f"{seq:02d}")
            if not os.path.isdir(self._dir):
                raise FileNotFoundError(
                    f"{root}: the store holds no complete sequence "
                    f"{seq:02d}")
            self.n_frames = len(_map_sequence(self._dir)["poses"])
        else:
            self._dir = None
            g = get_h5(root)[f"{seq:02d}"]
            self.n_frames = len(g["lidar_points"])

    def frame(self, i: int, cross_normals: bool = False) -> dict:
        if self._dir is None:
            g = get_h5(self.path)[f"{self.seq:02d}"]

            def get(k):
                return g[k][i]
        else:
            g = _map_sequence(self._dir)

            def get(k):
                if isinstance(g[k], tuple):
                    rows, off = g[k]
                    return np.array(rows[off[i]:off[i + 1]])
                return np.array(g[k][i])
        pts = get("lidar_points").reshape(-1, 4)
        nrm = get("lidar_normals").reshape(-1, 3)
        if cross_normals and "lidar_cross_normals" in g:
            # network input = cross normals; the fine normals ride along
            # as supervision (10-column points)
            cross = get("lidar_cross_normals").reshape(-1, 3)
            points = np.concatenate([pts, cross, nrm], axis=1)
        else:
            points = np.concatenate([pts, nrm], axis=1)  # (N, 7)
        out = {
            "points": points,
            "pose": get("poses").reshape(3, 4),
            "Tr": get("calib_Tr").reshape(3, 4),
        }
        for k in g:
            if k.startswith("hier_"):
                out[k] = get(k).reshape(-1, 6)
        return out
