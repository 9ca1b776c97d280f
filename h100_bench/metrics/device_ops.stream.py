"""device_ops.stream: device activities (kernels, copies, fills) a
scan in the traced stretch (``torch.profiler``): the host's
dispatch count."""


def read(rec):
    if rec.kind != "stream" or rec.trace is None or not rec.trace.n_device_ops:
        return None
    return rec.trace.n_device_ops / rec.trace.steps
