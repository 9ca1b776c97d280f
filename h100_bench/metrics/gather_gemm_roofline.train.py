"""gather_gemm_roofline.train: kernel B1's share of its roofline: the least
time of the gather-GEMM calls of the traced stretch (forward and feature
gradient), from their pairs, shapes and bytes, over their device time."""
from harness import peaks

KERNELS = ("gather_gemm_kernel",)


def read(rec):
    t, c = rec.trace, rec.counts
    if rec.kind != "train" or t is None or c is None:
        return None
    busy = t.kernel_seconds(KERNELS)
    bound = c.gather_gemm_bound_s(peaks) / c.per * t.steps
    if busy <= 0 or bound <= 0:
        return None
    return 100.0 * bound / busy
