"""device_ms_per_scan: the card's busy time over every scan of the
window (the union of its activities' intervals, from a trace of the
device alone over the whole window) over the scans completed in it: the
card time a streamed scan costs."""


def read(rec):
    if rec.kind != "stream" or not rec.steps or not rec.window_busy_s:
        return None
    return rec.window_busy_s / rec.steps * 1e3
