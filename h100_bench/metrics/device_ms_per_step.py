"""device_ms_per_step: the card's busy time over every train step of the
window (the union of its activities' intervals, from a trace of the
device alone over the whole window) over the steps completed in it: the
card time a training step costs."""


def read(rec):
    if rec.kind != "train" or not rec.steps or not rec.window_busy_s:
        return None
    return rec.window_busy_s / rec.steps * 1e3
