"""peak_mem_mib.train: the device memory peak of the training process
(``torch.cuda.max_memory_allocated``) through the window, in MiB."""


def read(rec):
    if rec.kind != "train" or not rec.peak_bytes:
        return None
    return rec.peak_bytes / 2 ** 20
