"""idle_pct.stream: the share of a scan's time in which no device
activity runs: the device's busy time a scan in the traced stretch (the
union of its activities' intervals) over the window's time a scan (the
untraced window: the profiler's own host cost slows the traced one)."""


def read(rec):
    t = rec.trace
    if rec.kind != "stream" or t is None or not t.n_device_ops or \
            not rec.steps:
        return None
    return 100.0 * (1.0 - t.busy_s / t.steps / rec.step_s())
