"""Tracing — only what the LLM engine needs so far.

- `percentile`: nearest-rank percentile over a sorted sample (the
  engine's time-to-first-token and inter-token latency summaries).
- `NULL_TRACER`: the inactive default. Every call site guards its hook
  with ``if tracer.active:``, so the null tracer carries nothing else;
  the recording `Tracer` (spans, Chrome traces, reports) is still to be
  ported.
"""

from __future__ import annotations

import math
from typing import List


def percentile(sorted_vals: List[float], p: float) -> float:
    """Nearest-rank percentile over an already-sorted sample (0.0 when
    empty)."""
    if not sorted_vals:
        return 0.0
    k = max(1, min(len(sorted_vals),
                   math.ceil(p / 100.0 * len(sorted_vals))))
    return sorted_vals[k - 1]


class NullTracer:
    """Do-nothing tracer: `.active` is False, so no hook is ever called."""

    active = False


NULL_TRACER = NullTracer()
