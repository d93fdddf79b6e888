"""Metrics registry (counterpart: ``fabric_tpu/ops_metrics.py``).

Counter, Gauge and Histogram with ``With``-style label keywords, one
process-wide registry (``global_registry``) and the Prometheus text
exposition (``Registry.render``), as the reference's: the same sequence
of calls renders the same text.  Histograms keep raw per-bucket counts
(one bisect an observation) and an optional ring of trace exemplars per
label variant (``exemplars_report``).  Host code only, with no
dependency outside the standard library.
"""

from __future__ import annotations

import math
import threading
import time
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass, field
from itertools import accumulate


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Counter:
    def __init__(self, name: str, help_: str, registry: "Registry"):
        self.name, self.help = name, help_
        self._values: dict[tuple, float] = {}
        self._lock = registry._lock

    def add(self, delta: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + delta

    def add_locked(self, delta: float, key: tuple) -> None:
        """``add`` with the registry lock HELD by the caller and the
        label key precomputed — every instrument of one registry
        shares the lock, so a multi-instrument batch (the tx-flow
        cohort publish) pays ONE acquisition."""
        self._values[key] = self._values.get(key, 0.0) + delta

    def value(self, **labels) -> float:
        # under the registry lock: an unlocked read can observe a dict
        # mid-resize from a concurrent add() on another thread
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def snapshot(self) -> dict[tuple, float]:
        """Consistent copy of every label variant (render//trace)."""
        with self._lock:
            return dict(self._values)


class Gauge:
    def __init__(self, name: str, help_: str, registry: "Registry"):
        self.name, self.help = name, help_
        self._values: dict[tuple, float] = {}
        self._lock = registry._lock

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def add(self, delta: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + delta

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def snapshot(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._values)


_DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, math.inf,
)


@dataclass
class _Hist:
    #: RAW per-bucket counts (first bucket the value fits) — one
    #: bisect + one increment per observe instead of walking every
    #: bucket; the read accessors cumulate (Prometheus ``le`` form)
    counts: list = field(default_factory=lambda: [0] * len(_DEFAULT_BUCKETS))
    total: float = 0.0
    n: int = 0


class Histogram:
    def __init__(self, name: str, help_: str, registry: "Registry",
                 buckets=_DEFAULT_BUCKETS, exemplars: int = 0):
        self.name, self.help = name, help_
        self.buckets = tuple(buckets)
        self._values: dict[tuple, _Hist] = {}
        self._lock = registry._lock
        # trace exemplars: a bounded last-K ring of (value, trace ref)
        # per label variant, recorded when the observer passes an
        # ``exemplar=`` ref — so a p99 spike on /vitals links to the
        # exact block's trace tree.  0 (the default) keeps observe()
        # byte-for-byte on today's path.
        self.exemplar_k = int(exemplars)
        self._exemplars: dict[tuple, deque] = {}

    def observe(self, value: float, *, exemplar=None, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            h = self._values.get(k)
            if h is None:
                h = self._values[k] = _Hist(counts=[0] * len(self.buckets))
            h.total += value
            h.n += 1
            # first bucket that fits; a value past every bucket (no
            # +Inf tail) counts toward sum/count but no bucket, same
            # as the Prometheus cumulative form
            i = bisect_left(self.buckets, value)
            if i < len(h.counts):
                h.counts[i] += 1
            if self.exemplar_k and exemplar is not None:
                ring = self._exemplars.get(k)
                if ring is None:
                    ring = self._exemplars[k] = deque(
                        maxlen=self.exemplar_k
                    )
                ring.append((value, str(exemplar)))

    def observe_repeat(self, value: float, n: int, *, exemplar=None,
                       **labels) -> None:
        """``n`` identical observations in O(buckets) under ONE lock
        acquisition — the tx-flow journal's per-block cohort publish
        (every tx of a block shares the included→applied interval, so
        a 1000-tx block costs the same as a 1-tx one).  Bit-equal to
        calling ``observe(value)`` n times; at most one exemplar is
        recorded for the whole batch."""
        n = int(n)
        if n <= 0:
            return
        k = _label_key(labels)
        with self._lock:
            self.observe_repeat_locked(value, n, k, exemplar=exemplar)

    def observe_repeat_locked(self, value: float, n: int, key: tuple,
                              exemplar=None) -> None:
        """Body of :meth:`observe_repeat` with the registry lock HELD
        by the caller and the label key precomputed — every instrument
        of one registry shares the lock, so a multi-instrument batch
        (the tx-flow cohort publish: stages + e2e + lag + counter)
        pays ONE acquisition for the whole block."""
        h = self._values.get(key)
        if h is None:
            h = self._values[key] = _Hist(counts=[0] * len(self.buckets))
        h.total += value * n
        h.n += n
        i = bisect_left(self.buckets, value)
        if i < len(h.counts):
            h.counts[i] += n
        if self.exemplar_k and exemplar is not None:
            ring = self._exemplars.get(key)
            if ring is None:
                ring = self._exemplars[key] = deque(
                    maxlen=self.exemplar_k
                )
            ring.append((value, str(exemplar)))

    def value(self, **labels) -> dict | None:
        """Locked read of ONE label variant: {"counts" (cumulative per
        bucket), "sum", "count"} or None if never observed.  Histograms
        had no read accessor at all before — reaching into ``_values``
        raced ``observe`` mid-update (counts bumped, total not yet)."""
        with self._lock:
            h = self._values.get(_label_key(labels))
            if h is None:
                return None
            return {"counts": list(accumulate(h.counts)),
                    "sum": h.total, "count": h.n}

    def snapshot(self) -> dict[tuple, dict]:
        """Consistent copy of every label variant (render//trace)."""
        with self._lock:
            return {
                k: {"counts": list(accumulate(h.counts)), "sum": h.total,
                    "count": h.n}
                for k, h in self._values.items()
            }

    def exemplar_snapshot(self) -> dict[tuple, list]:
        """Locked copy of every variant's exemplar ring: {label key:
        [(value, trace ref), ...]} — empty when exemplars are unarmed."""
        with self._lock:
            return {k: list(r) for k, r in self._exemplars.items() if r}

    def time(self, **labels):
        """Context manager observing elapsed seconds."""
        hist = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe(time.perf_counter() - self.t0, **labels)
                return False

        return _Timer()


class Registry:
    """Process-local metric registry; render() emits Prometheus text."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(name, help_, Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(name, help_, Gauge)

    def histogram(self, name: str, help_: str = "",
                  buckets=None, exemplars: int | None = None) -> Histogram:
        """``buckets``/``exemplars`` apply on FIRST registration only
        (a metric's bucket layout and exemplar capacity are fixed for
        its lifetime); later callers get the existing instrument
        regardless."""
        kwargs: dict = {} if buckets is None else {"buckets": buckets}
        if exemplars is not None:
            kwargs["exemplars"] = exemplars
        return self._get(name, help_, Histogram, **kwargs)

    def _get(self, name, help_, cls, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help_, self, **kwargs)
        if not isinstance(m, cls):
            raise TypeError(f"metric {name} already registered as {type(m).__name__}")
        return m

    @staticmethod
    def _fmt_labels(key: tuple, extra: str = "") -> str:
        parts = [f'{k}="{v}"' for k, v in key]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def metric(self, name: str):
        """Registered instrument by name, or None (locked lookup — the
        /trace summary reads selected metrics through their locked
        snapshot() accessors rather than reaching into ``_values``)."""
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> list[tuple[str, object]]:
        """Sorted copy of the live metric table (the flight-data
        recorder's sampler walks this, then reads each instrument
        through its own locked ``snapshot()`` — the registry lock is
        held only for the table copy, exactly like ``render``)."""
        with self._lock:
            return sorted(self._metrics.items())

    def render(self) -> str:
        # take the registry lock only to copy the metric table; each
        # instrument's snapshot() then takes the (same, non-reentrant)
        # lock itself — so render sees per-metric-consistent values
        # without racing concurrent observe()/add() mid-update
        with self._lock:
            metrics = sorted(self._metrics.items())
        out = []
        for name, m in metrics:
            if m.help:
                out.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                out.append(f"# TYPE {name} counter")
                for k, v in sorted(m.snapshot().items()):
                    out.append(f"{name}{self._fmt_labels(k)} {v}")
            elif isinstance(m, Gauge):
                out.append(f"# TYPE {name} gauge")
                for k, v in sorted(m.snapshot().items()):
                    out.append(f"{name}{self._fmt_labels(k)} {v}")
            elif isinstance(m, Histogram):
                out.append(f"# TYPE {name} histogram")
                for k, h in sorted(m.snapshot().items()):
                    for b, c in zip(m.buckets, h["counts"]):
                        le = "+Inf" if math.isinf(b) else repr(b)
                        # hoisted: a backslash inside an f-string
                        # expression is a SyntaxError before 3.12
                        le_label = 'le="%s"' % le
                        out.append(
                            f"{name}_bucket"
                            f"{self._fmt_labels(k, le_label)} {c}"
                        )
                    out.append(f"{name}_sum{self._fmt_labels(k)} {h['sum']}")
                    out.append(f"{name}_count{self._fmt_labels(k)} {h['count']}")
        return "\n".join(out) + "\n"


def exemplars_report(registry: "Registry",
                     metric: str | None = None) -> dict:
    """{metric: {label_str: [[value, trace_ref], ...]}} over every
    histogram with a non-empty exemplar ring — the /vitals and
    black-box-bundle surface.  Bounded by construction (each ring is
    last-K)."""
    out: dict = {}
    for name, m in registry.metrics():
        if metric is not None and name != metric:
            continue
        if not isinstance(m, Histogram) or not m.exemplar_k:
            continue
        snap = m.exemplar_snapshot()
        if not snap:
            continue
        out[name] = {
            (",".join(f"{k}={v}" for k, v in key) or "_"): [
                [round(v, 9), ref] for v, ref in ring
            ]
            for key, ring in sorted(snap.items())
        }
    return out


_global = Registry()


def global_registry() -> Registry:
    return _global
