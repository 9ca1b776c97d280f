"""nn_search_roofline: kernel B3's share of its roofline: the least time
of the objective's nearest-neighbour searches of the traced stretch (9
f32 operations a pair of valid points, each input read once), over
their device time."""
from harness import peaks

KERNELS = ("nn_search_kernel",)


def read(rec):
    t, c = rec.trace, rec.counts
    if rec.kind != "train" or t is None or c is None:
        return None
    busy = t.kernel_seconds(KERNELS)
    bound = c.nn_search_bound_s(peaks) / c.per * t.steps
    if busy <= 0 or bound <= 0:
        return None
    return 100.0 * bound / busy
