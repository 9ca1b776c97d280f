"""device_ms.middle.train: device ms a step that the program's span
``middle`` launched: the middle (``OdomNet.frame_features``'s
``self.middle``), in the traced run's stretch of the program's own spans
(``harness/spans.py``)."""
from harness import spans


def read(rec):
    return spans.device_ms(rec, "train", "middle")
