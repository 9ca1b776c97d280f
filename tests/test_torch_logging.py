"""The port's metric logger and TensorBoard event writer
(rslo_tpu_torch/utils/logging.py, utils/tb_writer.py) against the JAX
package's, the twin of tests/test_logging.py: at a fixed wall time the
two write byte-equal event files, for scalars (nested metrics
flattened) and for RGB and grey images, and equal json lines."""
import time

import numpy as np
import pytest

from rslo_tpu.utils.logging import MetricLogger as JaxLogger
from rslo_tpu_torch.utils.logging import MetricLogger
from rslo_tpu_torch.utils.tb_writer import _masked_crc, crc32c

WALL = 1760000000.25


def _read_records(path):
    """Parse a TFRecord file, verifying both CRCs per record."""
    import struct
    out, data, off = [], path.read_bytes(), 0
    while off < len(data):
        (n,) = struct.unpack_from("<Q", data, off)
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        assert hcrc == _masked_crc(data[off:off + 8])
        rec = data[off + 12:off + 12 + n]
        (dcrc,) = struct.unpack_from("<I", data, off + 12 + n)
        assert dcrc == _masked_crc(rec)
        out.append(rec)
        off += 12 + n + 4
    return out


def test_crc32c_known_vectors():
    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(bytes(32)) == 0x8A9136AA


def _log(cls, root, kind):
    rng = np.random.default_rng(0)
    ml = cls(str(root))
    if kind == "scalars":
        ml.log_metrics({"loss": 1.5, "nested": {"a": 2.0, "n": 3}}, step=10)
        ml.log_metrics({"loss": 0.25, "nested": {"a": -1.0, "n": 4}},
                       step=11)
    elif kind == "rgb":
        ml.log_image("bev", rng.uniform(size=(12, 20, 3)).astype(
            np.float32), step=3)
    else:
        ml.log_image("grey", rng.uniform(-2, 5, size=(16, 24)).astype(
            np.float32), step=4)
    ml.close()
    (evt,) = (root / "tb").glob("events.out.tfevents.*")
    return evt


@pytest.mark.parametrize("kind", ["scalars", "rgb", "grey"])
def test_event_files_byte_equal_to_jax(tmp_path, monkeypatch, kind):
    monkeypatch.setattr(time, "time", lambda: WALL)
    ours = _log(MetricLogger, tmp_path / "port", kind)
    theirs = _log(JaxLogger, tmp_path / "jax", kind)
    assert ours.name == theirs.name
    assert ours.read_bytes() == theirs.read_bytes()
    recs = _read_records(ours)
    assert b"brain.Event:2" in recs[0]
    assert len(recs) == (1 + 2 * 3 if kind == "scalars" else 2)
    if kind != "scalars":
        assert b"\x89PNG" in recs[1]
    assert (tmp_path / "port" / "log.json.lst").read_text() == \
        (tmp_path / "jax" / "log.json.lst").read_text()


def test_disabled_logger_writes_nothing(tmp_path):
    ml = MetricLogger(str(tmp_path / "off"), enabled=False)
    ml.log_metrics({"loss": 1.0}, step=0)
    ml.log_text("x")
    ml.close()
    assert not (tmp_path / "off").exists()
