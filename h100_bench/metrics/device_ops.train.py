"""device_ops.train: device activities (kernels, copies, fills) a
step in the traced stretch (``torch.profiler``): the host's
dispatch count."""


def read(rec):
    if rec.kind != "train" or rec.trace is None or not rec.trace.n_device_ops:
        return None
    return rec.trace.n_device_ops / rec.trace.steps
