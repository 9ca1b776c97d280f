"""device_ms.geometry.train: device ms a step that the program's span
``geometry`` launched: the rulebooks
(``models/net.py::OdomNet._middle_geometry``), in the traced run's
stretch of the program's own spans (``harness/spans.py``)."""
from harness import spans


def read(rec):
    return spans.device_ms(rec, "train", "geometry")
