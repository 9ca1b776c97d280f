"""sites_dropped_pct.stream: the share of the sites found that the
capacities drop, 100 x (found - kept) / found summed over the levels the
configuration has (the voxelizer's voxels against ``max_voxels``; the
sparse middle's L1-L3 against ``level_capacities``), from the program's
counters over the traced run's stretch of scans (``harness/spans.py``)."""
from harness import spans


def read(rec):
    return spans.sites_dropped_pct(rec, "stream")
