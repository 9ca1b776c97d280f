"""scan_ms_p95.host: the 95th percentile (nearest rank) over every scan
of the window of the time from its push (or, in an open loop, from when
it was due) to its pose returned (host clock).  Per layer: host clocks
differ by half between the machines a check runs on (PERF.md)."""
from harness.record import nearest_rank


def read(rec):
    if rec.kind != "stream" or not rec.latencies_ms:
        return None
    return nearest_rank(rec.latencies_ms, 0.95)
