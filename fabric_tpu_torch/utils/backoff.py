"""Capped exponential backoff with full jitter (counterpart:
``fabric_tpu/utils/backoff.py``).

Delays grow ``factor``x per consecutive failure, never exceed ``cap``,
are drawn uniformly from [delay*(1-jitter), delay], and reset to
``base`` on progress.  The class only computes delays; callers sleep.
"""

from __future__ import annotations

import math
import random


class Backoff:
    """Capped exponential delay sequence with full jitter."""

    def __init__(self, base: float = 0.2, cap: float = 15.0, factor: float = 2.0,
                 jitter: float = 0.5, rng: random.Random | None = None):
        if base <= 0 or cap < base or factor < 1.0:
            raise ValueError(f"Backoff(base={base}, cap={cap}, factor={factor}): "
                             "need base > 0, cap >= base, factor >= 1")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"Backoff jitter {jitter}: must be in [0, 1]")
        self.base, self.cap, self.factor = base, cap, factor
        self.jitter = jitter
        self._rng = rng or random.Random()
        self._attempt = 0
        # the exponent at which base*factor**k reaches cap: peek() clamps
        # to it so a long outage cannot overflow the exponentiation
        self._exp_cap = 0 if factor == 1.0 else math.ceil(math.log(cap / base, factor))

    @property
    def attempt(self) -> int:
        """Consecutive failures since the last reset()."""
        return self._attempt

    def peek(self) -> float:
        """The un-jittered delay the next ``next()`` would scale."""
        return min(self.cap, self.base * self.factor ** min(self._attempt, self._exp_cap))

    def next(self) -> float:
        """Record one failure and return the delay before the next attempt."""
        d = self.peek()
        self._attempt += 1
        if self.jitter:
            lo = d * (1.0 - self.jitter)
            d = lo + self._rng.random() * (d - lo)
        return d

    def reset(self) -> None:
        self._attempt = 0
