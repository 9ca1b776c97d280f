"""gather_gemm_roofline.stream: kernel B1's share of its roofline: the
least time of the gather-GEMM calls of the traced stretch, from their
pairs, shapes and bytes, over their device time."""
from harness import peaks

KERNELS = ("gather_gemm_kernel",)


def read(rec):
    t, c = rec.trace, rec.counts
    if rec.kind != "stream" or t is None or c is None:
        return None
    busy = t.kernel_seconds(KERNELS)
    bound = c.gather_gemm_bound_s(peaks) / c.per * t.steps
    if busy <= 0 or bound <= 0:
        return None
    return 100.0 * bound / busy
