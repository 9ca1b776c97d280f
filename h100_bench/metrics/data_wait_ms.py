"""data_wait_ms: host ms a step that the loop blocks on the next batch
of the train data path (the benchmark's span around the loader's
``next``), averaged over the window's steps."""


def read(rec):
    waits = rec.spans_ms.get("data_wait")
    if rec.kind != "train" or not waits:
        return None
    return sum(waits) / len(waits)
