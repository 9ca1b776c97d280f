"""device_ms.prepare.train: device ms a step that the program's span
``prepare`` launched: the voxelizer
(``data/prepare.py::prepare_example``), in the traced run's stretch of
the program's own spans (``harness/spans.py``)."""
from harness import spans


def read(rec):
    return spans.device_ms(rec, "train", "prepare")
