"""Percentiles (counterpart: ``fabric_tpu/utils/stats.py``)."""

from __future__ import annotations

import math


def nearest_rank(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of a pre-sorted list (0 < q <= 100):
    rank = ceil(q/100 * n)."""
    if not sorted_vals:
        return 0.0
    rank = math.ceil(q / 100.0 * len(sorted_vals))
    return sorted_vals[max(0, min(len(sorted_vals) - 1, rank - 1))]
