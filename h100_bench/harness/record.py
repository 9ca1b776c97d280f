"""What a run hands to the metric readers: its host clock readings, its
spans and counters, the profiler's summary of its traced stretch and the
benchmark's operation counts."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Record:
    kind: str                          # "train" or "stream"
    setup_s: float = 0.0               # process start to the window
    window_s: float = 0.0              # the measured window, host clock
    steps: int = 0                     # steps or scans completed in it
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    spans_ms: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)          # the benchmark's spans, a step each
    window_busy_s: Optional[float] = None   # device busy in the window
    window_ops: int = 0                # device activities in the window
    peak_bytes: int = 0
    trace: Optional[Any] = None        # trace.TraceSummary
    counts: Optional[Any] = None       # counts.Counts

    def step_s(self) -> Optional[float]:
        return self.window_s / self.steps if self.steps else None


def nearest_rank(values, q: float) -> float:
    """The ``q``-quantile (0-1) by nearest rank: the smallest value with
    at least that share of the values at or below it."""
    import math
    s = sorted(values)
    return s[max(0, min(len(s) - 1, math.ceil(q * len(s)) - 1))]
