"""scans_per_s.host: every scan completed in the window over the
window's time (host clock; each push returns its pose to the host).
Per layer: host clocks differ by half between the machines a check runs
on (PERF.md)."""


def read(rec):
    if rec.kind != "stream" or not rec.steps:
        return None
    return rec.steps / rec.window_s
