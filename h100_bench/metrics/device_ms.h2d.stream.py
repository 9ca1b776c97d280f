"""device_ms.h2d.stream: device ms a scan that the program's span ``h2d``
launched: the copies of the scan to the card
(``eval/streaming.py::StreamingOdometry.push``), in the traced run's
stretch of the program's own spans (``harness/spans.py``)."""
from harness import spans


def read(rec):
    return spans.device_ms(rec, "stream", "h2d")
