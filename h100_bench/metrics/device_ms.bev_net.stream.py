"""device_ms.bev_net.stream: device ms a scan that the program's span
``bev_net`` launched: the BEV net on the cached pair
(``OdomNet.pair_predict``), in the traced run's stretch of the program's
own spans (``harness/spans.py``)."""
from harness import spans


def read(rec):
    return spans.device_ms(rec, "stream", "bev_net")
