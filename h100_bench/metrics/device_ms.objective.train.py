"""device_ms.objective.train: device ms a step that the program's span
``objective`` launched: the objective
(``losses/objective.py::compute_objective``), in the traced run's
stretch of the program's own spans (``harness/spans.py``)."""
from harness import spans


def read(rec):
    return spans.device_ms(rec, "train", "objective")
