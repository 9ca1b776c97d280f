"""device_ms.bev_net.train: device ms a step that the program's span
``bev_net`` launched: the BEV net and its vote, in the traced run's
stretch of the program's own spans (``harness/spans.py``)."""
from harness import spans


def read(rec):
    return spans.device_ms(rec, "train", "bev_net")
