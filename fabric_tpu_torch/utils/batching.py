"""Batch-shape bucketing (counterpart: ``fabric_tpu/utils/batching.py``)."""

from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(0, (n - 1)).bit_length()
