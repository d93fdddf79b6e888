"""Metrics time-series sampler: the flight-data recorder's trails
(counterpart: ``fabric_tpu/observe/timeseries.py``; the reference's
sampler over the port's registry, ``fabric_tpu_torch/ops_metrics.py``).

Every observability surface before this module is point-in-time:
``/metrics`` renders the registry *now*, ``/slo`` and ``/autopilot``
report the current burn and knob vector, and the tracer's flight
recorder holds individual block trees.  A degrade latch, a shed
incident, or a slow run therefore leaves no history to
attribute unless a human was polling at the right moment.
:class:`MetricsSampler` closes that gap: a periodic walker over the
metrics :class:`~fabric_tpu_torch.ops_metrics.Registry` that records, per
metric and label variant, a bounded ring of ``(t, value)`` points —
the trailing series ``/vitals`` serves and the black-box recorder
(observe/blackbox.py) snapshots into incident bundles.

Delta semantics per metric kind (raw monotones are useless trails):

* **counter** — each point is the DELTA since the previous sample
  (``rate()`` at read time divides by the sample spacing), so a
  trail reads as traffic, not as an ever-growing line.  A counter
  reset (process restart behind the same registry object cannot
  happen, but a negative delta is clamped) records the new raw value.
* **gauge** — the raw value (gauges are levels already).
* **histogram** — per-interval ``{n, sum}`` deltas plus an
  approximate interval p99 read off the BUCKET deltas (the smallest
  bucket bound covering 99% of the interval's observations), so a
  latency histogram's trail shows *this interval's* tail, not the
  lifetime-cumulative one.

Locking discipline: one sample pass takes the registry lock only to
copy the metric table (``Registry.metrics()``), then each
instrument's own ``snapshot()`` — never longer than a snapshot copy,
exactly the ``render()`` contract.  The sampler's own series dict is
guarded by its own lock (readers copy under it).

Default OFF everywhere: ``interval_s=0`` means no sampler thread
exists and :func:`configure` leaves the process-global handle None —
tier-1/CPU hosts and the unarmed hot path are unchanged.  Like the
SLO engine and the autopilot, the clock is injectable and tests
drive :meth:`MetricsSampler.sample` directly.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque

_log = logging.getLogger("fabric_tpu_torch.observe.vitals")

#: default points retained per (metric, label-variant) series — at the
#: default 5s interval this is a 20-minute trail
DEFAULT_RETENTION = 240

#: default seconds between sample passes when armed
DEFAULT_INTERVAL_S = 5.0


class _Series:
    """One (metric, label variant) trail."""

    __slots__ = ("kind", "points", "last")

    def __init__(self, kind: str, retention: int):
        self.kind = kind                      # counter|gauge|histogram
        self.points: deque = deque(maxlen=retention)  # (t, value)
        # previous raw reading (counter float / histogram dict) for
        # the delta computation; gauges keep None
        self.last = None


def _hist_point(prev: dict | None, cur: dict, buckets: tuple) -> dict:
    """Interval delta of one histogram variant: {n, sum, p99} where
    p99 is the smallest bucket bound covering 99% of THIS interval's
    observations (None when the interval saw nothing)."""
    if prev is None:
        dn = cur["count"]
        dsum = cur["sum"]
        dcounts = list(cur["counts"])
    else:
        dn = cur["count"] - prev["count"]
        dsum = cur["sum"] - prev["sum"]
        dcounts = [c - p for c, p in zip(cur["counts"], prev["counts"])]
    if dn <= 0:
        return {"n": 0, "sum": 0.0, "p99": None}
    want = math.ceil(0.99 * dn)
    p99 = None
    for b, c in zip(buckets, dcounts):
        if c >= want:  # counts are cumulative per bucket
            p99 = None if math.isinf(b) else b
            break
    return {"n": dn, "sum": round(dsum, 9), "p99": p99}


class MetricsSampler:
    """See module docstring.  ``start()`` runs a daemon sample thread;
    tests drive :meth:`sample` directly with an injected clock."""

    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 retention: int = DEFAULT_RETENTION, registry=None,
                 clock=time.monotonic):
        if interval_s < 0:
            raise ValueError(f"interval_s must be >= 0, got {interval_s}")
        if retention < 1:
            raise ValueError(f"retention must be >= 1, got {retention}")
        self.interval_s = float(interval_s)
        self.retention = int(retention)
        if registry is None:
            from fabric_tpu_torch.ops_metrics import global_registry

            registry = global_registry()
        self.registry = registry
        self.clock = clock
        self._lock = threading.Lock()
        self._series: dict[tuple, _Series] = {}
        self._samples = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def configure(self, interval_s: float | None = None,
                  retention: int | None = None) -> None:
        """Re-knob the sampler; a retention change RESIZES every live
        ring in place (truncated to the newest points)."""
        if interval_s is not None:
            if interval_s < 0:
                raise ValueError(
                    f"interval_s must be >= 0, got {interval_s}"
                )
            self.interval_s = float(interval_s)
        if retention is not None:
            if retention < 1:
                raise ValueError(
                    f"retention must be >= 1, got {retention}"
                )
            with self._lock:
                self.retention = int(retention)
                for s in self._series.values():
                    s.points = deque(
                        list(s.points)[-self.retention:],
                        maxlen=self.retention,
                    )

    def start(self) -> "MetricsSampler":
        if self._thread is not None or self.interval_s <= 0:
            return self
        self._stop.clear()

        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample()
                except Exception as e:  # the trail must never die
                    _log.warning("vitals sample pass failed: %s", e)

        self._thread = threading.Thread(
            target=run, name="fabtpu-vitals", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    # -- sampling ----------------------------------------------------------

    def sample(self) -> float:
        """One pass over the registry: append one point per known
        label variant.  Returns the sample timestamp."""
        from fabric_tpu_torch.ops_metrics import Counter, Gauge, Histogram

        now = self.clock()
        # the registry lock is held only inside metrics()/snapshot();
        # everything below runs on already-copied data
        table = self.registry.metrics()
        with self._lock:
            for name, m in table:
                if isinstance(m, Counter):
                    for key, raw in m.snapshot().items():
                        s = self._get_series(name, key, "counter")
                        prev = s.last
                        s.last = raw
                        delta = raw if prev is None else raw - prev
                        if delta < 0:  # reset: record the new level
                            delta = raw
                        s.points.append((now, round(delta, 9)))
                elif isinstance(m, Gauge):
                    for key, raw in m.snapshot().items():
                        s = self._get_series(name, key, "gauge")
                        s.points.append((now, raw))
                elif isinstance(m, Histogram):
                    for key, raw in m.snapshot().items():
                        s = self._get_series(name, key, "histogram")
                        prev = s.last
                        s.last = raw
                        s.points.append(
                            (now, _hist_point(prev, raw, m.buckets))
                        )
            self._samples += 1
        return now

    def _get_series(self, name: str, key: tuple, kind: str) -> _Series:
        s = self._series.get((name, key))
        if s is None:
            s = self._series[(name, key)] = _Series(kind, self.retention)
        return s

    # -- readers -----------------------------------------------------------

    @staticmethod
    def _label_str(key: tuple) -> str:
        return ",".join(f"{k}={v}" for k, v in key) or "_"

    def series(self, metric: str | None = None,
               points: int | None = None) -> dict:
        """{metric: {label_str: {kind, points: [[t, value], ...]}}} —
        the full trails (``/vitals?metric=N``).  ``points`` truncates each series to its newest N."""
        with self._lock:
            snap = {
                (name, key): (s.kind, list(s.points))
                for (name, key), s in self._series.items()
                if metric is None or name == metric
            }
        out: dict = {}
        for (name, key), (kind, pts) in sorted(snap.items()):
            if points is not None:
                pts = pts[-points:]
            out.setdefault(name, {})[self._label_str(key)] = {
                "kind": kind,
                "points": [
                    [round(t, 3), v] for t, v in pts
                ],
            }
        return out

    def rate(self, metric: str, window: int = 12, **labels) -> float | None:
        """Mean per-second rate of one COUNTER variant over its newest
        ``window`` points, or None (unknown series / too few points /
        not a counter).  The read-time division keeps stored points as
        plain deltas."""
        from fabric_tpu_torch.ops_metrics import _label_key

        with self._lock:
            s = self._series.get((metric, _label_key(labels)))
            if s is None or s.kind != "counter":
                return None
            pts = list(s.points)[-max(2, window):]
        if len(pts) < 2:
            return None
        dt = pts[-1][0] - pts[0][0]
        if dt <= 0:
            return None
        return sum(v for _t, v in pts[1:]) / dt

    def report(self, spark: int = 24) -> dict:
        """JSON-able index (the ``/vitals`` landing payload): per
        metric and label variant, a sparkline-style summary — the
        newest ``spark`` scalar values (histograms contribute their
        interval p99s), plus last/min/max over the retained ring."""
        with self._lock:
            snap = {
                (name, key): (s.kind, list(s.points))
                for (name, key), s in self._series.items()
            }
            samples = self._samples
        metrics: dict = {}
        for (name, key), (kind, pts) in sorted(snap.items()):
            if kind == "histogram":
                scalars = [
                    p["p99"] for _t, p in pts if p["p99"] is not None
                ]
            else:
                scalars = [v for _t, v in pts]
            entry = {
                "kind": kind,
                "n_points": len(pts),
                "spark": [round(v, 6) for v in scalars[-spark:]],
            }
            if scalars:
                entry["last"] = round(scalars[-1], 6)
                entry["min"] = round(min(scalars), 6)
                entry["max"] = round(max(scalars), 6)
            if kind == "histogram" and pts:
                entry["last_interval"] = pts[-1][1]
            metrics.setdefault(name, {})[self._label_str(key)] = entry
        return {
            "interval_s": self.interval_s,
            "retention": self.retention,
            "samples": samples,
            "series_count": len(snap),
            "metrics": metrics,
        }


# -- process-global handle (what /vitals serves by default) ------------------

_global: MetricsSampler | None = None
#: refcount for component lifecycles (acquire/release): the sampler
#: stops only when the LAST colocated holder releases — neither the
#: creator nor a later arriver stopping first may strand the survivor
_refs = 0


def global_sampler() -> MetricsSampler | None:
    return _global


def acquire(interval_s: float,
            retention: int = DEFAULT_RETENTION,
            registry=None, clock=time.monotonic,
            ) -> MetricsSampler | None:
    """Refcounted arming (PeerNode start/stop pairs this with
    :func:`release`): the first acquire builds the sampler, later
    acquires REUSE it untouched — first-arm wins for interval and
    retention, because reconfiguring would truncate the first
    holder's live rings and change its cadence under it — and only
    the last release tears it down.  ``interval_s <= 0`` returns None
    without touching the count."""
    global _refs
    if interval_s <= 0:
        return None
    s = _global
    if s is None:
        s = configure(interval_s, retention, registry=registry,
                      clock=clock)
    _refs += 1
    return s


def release() -> None:
    """Drop one :func:`acquire` hold; the last one out disarms."""
    global _refs
    if _refs > 0:
        _refs -= 1
        if _refs == 0:
            configure(0)


def configure(interval_s: float = 0.0,
              retention: int = DEFAULT_RETENTION,
              registry=None, clock=time.monotonic,
              start: bool = True) -> MetricsSampler | None:
    """Arm (or disarm) the process-global sampler — the nodeconfig
    ``vitals_interval_s`` / ``vitals_retention`` knobs land here.
    ``interval_s <= 0`` stops and clears any armed sampler (and zeroes
    the acquire refcount — the hard OFF) and returns None: the
    recorder's OFF state really is no thread and no state."""
    global _global, _refs
    if interval_s <= 0:
        _refs = 0
        old, _global = _global, None
        if old is not None:
            old.stop()
        return None
    if _global is not None:
        _global.configure(interval_s=interval_s, retention=retention)
        if start:
            _global.start()
        return _global
    _global = MetricsSampler(
        interval_s=interval_s, retention=retention, registry=registry,
        clock=clock,
    )
    if start:
        _global.start()
    return _global
