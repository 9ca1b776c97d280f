"""device_ms.backward.train: device ms a step that the program's span
``backward`` launched: the backward (``torch.autograd.grad``, launched
from the autograd engine's thread), in the traced run's stretch of the
program's own spans (``harness/spans.py``)."""
from harness import spans


def read(rec):
    return spans.device_ms(rec, "train", "backward")
