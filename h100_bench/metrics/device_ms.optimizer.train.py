"""device_ms.optimizer.train: device ms a step that the program's span
``optimizer`` launched: the optimizer (``train/optim.py``'s step), in
the traced run's stretch of the program's own spans
(``harness/spans.py``)."""
from harness import spans


def read(rec):
    return spans.device_ms(rec, "train", "optimizer")
