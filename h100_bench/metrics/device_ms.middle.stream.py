"""device_ms.middle.stream: device ms a scan that the program's span
``middle`` launched: the middle (``OdomNet.frame_features``'s
``self.middle``), in the traced run's stretch of the program's own spans
(``harness/spans.py``)."""
from harness import spans


def read(rec):
    return spans.device_ms(rec, "stream", "middle")
