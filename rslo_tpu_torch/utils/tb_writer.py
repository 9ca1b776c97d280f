"""TensorBoard event-file writer in plain Python (counterpart of
``rslo_tpu/utils/tb_writer.py``): scalars and images are written
directly in the on-disk format TensorBoard reads, so neither the
``tensorboard`` package nor a proto runtime is needed.

* TFRecord framing: ``uint64 len | uint32 masked_crc32c(len) | data |
  uint32 masked_crc32c(data)``.
* ``data`` is a serialized ``tensorflow.Event`` proto, hand-encoded
  here (the message uses only varint/fixed64/length-delimited wire
  types):
    Event:   1=double wall_time, 2=int64 step, 3=string file_version,
             5=Summary summary
    Summary: repeated Value=1;  Value: 1=string tag, 2=float
             simple_value, 4=Image image
    Image:   1=int32 height, 2=int32 width, 3=int32 colorspace,
             4=bytes encoded_image_string (PNG)
"""
from __future__ import annotations

import io
import os
import socket
import struct
import time
from pathlib import Path

# ---- crc32c (Castagnoli, as used by TFRecord) -------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tab = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- minimal proto encoding ------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _event(step: int | None = None, wall_time: float | None = None,
           file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    msg = _f_double(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        msg += _f_varint(2, step)
    if file_version is not None:
        msg += _f_bytes(3, file_version.encode())
    if summary is not None:
        msg += _f_bytes(5, summary)
    return msg


def _png_encode(img) -> tuple[bytes, int, int]:
    """uint8 HWC -> (png bytes, h, w); PIL if present, else matplotlib."""
    import numpy as np
    img = np.asarray(img)
    h, w = img.shape[:2]
    try:
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="png")
        return buf.getvalue(), h, w
    except Exception:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        buf = io.BytesIO()
        plt.imsave(buf, img, format="png")
        return buf.getvalue(), h, w


class EventWriter:
    """TensorBoard SummaryWriter stand-in (scalars + HWC images)."""

    def __init__(self, logdir: str):
        self.dir = Path(logdir)
        self.dir.mkdir(parents=True, exist_ok=True)
        host = socket.gethostname()
        self.path = (self.dir /
                     f"events.out.tfevents.{int(time.time())}.{host}."
                     f"{os.getpid()}")
        self._f = open(self.path, "ab")
        self._record(_event(file_version="brain.Event:2"))

    def _record(self, data: bytes):
        hdr = struct.pack("<Q", len(data))
        self._f.write(hdr + struct.pack("<I", _masked_crc(hdr)) + data +
                      struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        val = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
        self._record(_event(step=step, summary=_f_bytes(1, val)))

    def add_image(self, tag: str, img, step: int, dataformats="HWC"):
        """img: float HWC in [0,1] (or uint8)."""
        import numpy as np
        img = np.asarray(img)
        if dataformats == "CHW":
            img = np.moveaxis(img, 0, -1)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        if img.ndim == 3 and img.shape[-1] == 1:
            img = img[..., 0]
        png, h, w = _png_encode(img)
        colorspace = 1 if img.ndim == 2 else img.shape[-1]
        image = (_f_varint(1, h) + _f_varint(2, w) +
                 _f_varint(3, colorspace) + _f_bytes(4, png))
        val = _f_bytes(1, tag.encode()) + _f_bytes(4, image)
        self._record(_event(step=step, summary=_f_bytes(1, val)))

    def close(self):
        self._f.close()
