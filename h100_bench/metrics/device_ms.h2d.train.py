"""device_ms.h2d.train: device ms a step that the program's span ``h2d``
launched: the copies of the step's batch to the card
(``train/loop.py::device_prefetch``), in the traced run's stretch of the
program's own spans (``harness/spans.py``)."""
from harness import spans


def read(rec):
    return spans.device_ms(rec, "train", "h2d")
