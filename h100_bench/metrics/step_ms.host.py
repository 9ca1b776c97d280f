"""step_ms.host: the whole window's time over the train steps completed
in it, data path included (host clock, the window closed by a device
synchronize).  Per layer: host clocks differ by half between the
machines a check runs on (PERF.md)."""


def read(rec):
    if rec.kind != "train" or not rec.steps:
        return None
    return rec.window_s / rec.steps * 1e3
