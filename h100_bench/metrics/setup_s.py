"""setup_s: seconds from the process's start to the first timed step:
imports, the traffic's set-up (the store build in the train cells), the
seeded weights, kernels loaded from the checkout's build cache, and the
warm-up steps or scans (host clock)."""


def read(rec):
    return rec.setup_s if rec.steps else None
