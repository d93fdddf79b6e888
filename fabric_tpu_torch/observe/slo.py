"""Latency/error SLOs with rolling-window burn rates over the
tracer's finished-block stream (counterpart: ``fabric_tpu/observe/slo.py``;
the reference's engine, unchanged, over the port's tracer and registry).

The span tracer answers "why was block 4217 slow?"; this module
answers the question a multi-tenant operator actually pages on:
"which tenant is burning its latency budget, and how fast?".  An
**objective** declares what a *good* event is (a block committed
under ``ms`` milliseconds; a sidecar request answered without BUSY)
and what fraction of events must be good (``target``, e.g. 0.99 → a
1% error budget).  The engine consumes the tracer's finished-block
stream (``Tracer.add_listener``), buckets events per (objective,
channel), and computes the classic SRE **burn rate** over rolling
windows:

    burn = bad_fraction_in_window / (1 - target)

Burn 1.0 means the budget is being spent exactly as fast as it
accrues; sustained burn > 1 means the SLO will be violated; a burn
over the ``fast`` threshold on the SHORTEST window (default 14 — the
multi-window alerting convention) is the page-now signal, surfaced as
a WARN (rate-limited to one per window per series) and a
``slo_fast_burn_total`` counter.  Gauges ``slo_burn_rate{slo,window,
channel}`` track every series continuously; the ``/slo`` endpoint on
the operations server serves :meth:`SloEngine.report`.

Objectives are declared with a faults-style spec string (the
nodeconfig ``slos`` knob / ``FABTPU_SLOS``):

    name:kind[:k=v ...][; more objectives]

kinds:

* ``latency`` — good = the block root's duration ≤ ``ms=<float>``
  milliseconds.  Applies per channel (the root's ``channel`` attr):
  peer block trees and sidecar request trees alike (a sidecar
  request's channel is ``sidecar:<tenant>``; BUSY replies are not
  latency samples and are skipped).
* ``busy`` — good = a sidecar request was NOT answered BUSY.
  ``pct=<float>`` is the allowed BUSY percentage (target = 1−pct/100).
  Only sidecar request trees (``ns == "sidecar"``) count.

common keys: ``target=`` overrides the good-fraction objective
(latency default 0.99), ``windows=<s1>,<s2>,...`` the rolling windows
in seconds (default 60,300; the shortest is the fast-burn window),
``fast=`` the fast-burn threshold (default 14.0; 0 disables the
WARN), ``channel=`` restricts the objective to one channel/tenant,
``min_events=`` the per-window cold-start floor (default 5): a window
holding fewer events reports burn ``None`` — one bad block on a
freshly started peer is statistically nothing, and it must not fire a
fast-burn WARN (or trip the traffic autopilot) before the window has
a real sample.  Set ``min_events=1`` to restore the raw behavior.

The engine is stdlib-only, locked, and clock-injectable (tests drive
burn-up and recovery without sleeping).  Like the tracer it rides,
it only sees blocks the tracer finalizes — ``trace_ring_blocks=0``
silences SLOs too (documented on the knob).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field

_log = logging.getLogger("fabric_tpu_torch.observe.slo")

DEFAULT_WINDOWS = (60.0, 300.0)
DEFAULT_TARGET = 0.99
DEFAULT_FAST_BURN = 14.0
#: cold-start floor: a window holding fewer events than this reports
#: burn None — one bad block in a near-empty window must not read as
#: burn ≥ 1 (or WARN) on a freshly started peer
DEFAULT_MIN_EVENTS = 5
_KINDS = ("latency", "busy")

#: events retained per (objective, channel) series — bounds memory
#: under a storm; at 1k blocks/s a 4096-event series still spans the
#: default 60s fast window's most recent slice, which is the window
#: fast-burn alerting reads
MAX_EVENTS = 4096


class SloError(ValueError):
    """A malformed SLO spec, phrased so the operator can fix it."""


@dataclass(frozen=True)
class Objective:
    """One declared objective (see module docstring)."""

    name: str
    kind: str                    # "latency" | "busy"
    ms: float = 0.0              # latency threshold (latency kind)
    target: float = DEFAULT_TARGET
    windows: tuple = DEFAULT_WINDOWS
    fast: float = DEFAULT_FAST_BURN
    channel: str = ""            # "" = every channel
    min_events: int = DEFAULT_MIN_EVENTS  # per-window cold-start floor

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - self.target)


def parse_slos(spec: str) -> list[Objective]:
    """``'commit:latency:ms=250;busy:busy:pct=5'`` → objectives."""
    out: list[Objective] = []
    seen: set[str] = set()
    for part in str(spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise SloError(
                f"slo spec {part!r}: expected 'name:kind[:k=v...]'"
            )
        name, kind = fields[0].strip(), fields[1].strip()
        if kind not in _KINDS:
            raise SloError(
                f"slo spec {part!r}: unknown kind {kind!r} "
                f"(expected one of {', '.join(_KINDS)})"
            )
        if name in seen:
            raise SloError(f"slo spec: duplicate objective {name!r}")
        seen.add(name)
        kw: dict = {}
        pct = None
        for f in fields[2:]:
            k, sep, v = f.partition("=")
            k = k.strip()
            if not sep:
                raise SloError(
                    f"slo spec {part!r}: expected k=v, got {f!r}"
                )
            try:
                if k == "ms":
                    kw["ms"] = float(v)
                elif k == "pct":
                    pct = float(v)
                elif k == "target":
                    kw["target"] = float(v)
                elif k == "fast":
                    kw["fast"] = float(v)
                elif k == "windows":
                    kw["windows"] = tuple(
                        sorted(float(w) for w in v.split(",") if w)
                    )
                elif k == "channel":
                    kw["channel"] = v.strip()
                elif k == "min_events":
                    kw["min_events"] = int(v)
                else:
                    raise SloError(
                        f"slo spec {part!r}: unknown key {k!r}"
                    )
            except ValueError as e:
                if isinstance(e, SloError):
                    raise
                raise SloError(
                    f"slo spec {part!r}: cannot parse {f!r}: {e}"
                ) from None
        if kind == "latency":
            if kw.get("ms", 0.0) <= 0:
                raise SloError(
                    f"slo spec {part!r}: latency needs ms=<positive>"
                )
        else:  # busy
            if pct is None or not (0 < pct < 100):
                raise SloError(
                    f"slo spec {part!r}: busy needs pct=<0..100>"
                )
            kw.setdefault("target", 1.0 - pct / 100.0)
        windows = kw.get("windows", DEFAULT_WINDOWS)
        if not windows or any(w <= 0 for w in windows):
            raise SloError(
                f"slo spec {part!r}: windows must be positive seconds"
            )
        if not (0 < kw.get("target", DEFAULT_TARGET) < 1):
            raise SloError(
                f"slo spec {part!r}: target must be in (0, 1)"
            )
        if kw.get("min_events", DEFAULT_MIN_EVENTS) < 1:
            raise SloError(
                f"slo spec {part!r}: min_events must be >= 1"
            )
        out.append(Objective(name=name, kind=kind, **kw))
    return out


@dataclass
class _Series:
    """One (objective, channel) event stream."""

    events: deque = field(
        default_factory=lambda: deque(maxlen=MAX_EVENTS)
    )  # (t, good) pairs, t on the engine clock
    last_warn: float = float("-inf")


class SloEngine:
    """See module docstring.  ``on_block`` is the tracer listener;
    ``record`` is the direct feed for tests and custom signals."""

    def __init__(self, objectives=(), clock=time.monotonic,
                 registry=None):
        self.objectives: tuple = tuple(objectives)
        self.clock = clock
        self._lock = threading.Lock()
        self._series: dict[tuple, _Series] = {}
        if registry is None:
            from fabric_tpu_torch.ops_metrics import global_registry

            registry = global_registry()
        self._burn_gauge = registry.gauge(
            "slo_burn_rate",
            "error-budget burn rate per objective, window and channel "
            "(1.0 = budget spent exactly as fast as it accrues)",
        )
        self._fast_ctr = registry.counter(
            "slo_fast_burn_total",
            "fast-burn threshold trips per objective and channel",
        )

    def set_objectives(self, objectives) -> None:
        with self._lock:
            self.objectives = tuple(objectives)
            self._series.clear()

    # -- the tracer feed ---------------------------------------------------

    def on_block(self, root) -> None:
        """Tracer listener: classify one finished root span against
        every matching objective."""
        if not self.objectives:
            return
        attrs = root.attrs
        channel = str(attrs.get("channel", "") or "")
        ns = attrs.get("ns", "")
        if ns == "autopilot":
            # controller decision events ride the tracer for the
            # actuation trail — they are control plane, not traffic,
            # and must not dilute any latency series
            return
        if ns == "sign":
            # sign-flush roots (peer/signlane.py) exist for the device
            # ledger's /trace?ns=sign waterfall; the sign lane already
            # feeds the endorse SLOs per-request through its observer,
            # so counting flush roots here would double-book them
            return
        busy = bool(attrs.get("busy"))
        dur_ms = root.dur * 1000.0
        for o in self.objectives:
            if o.channel and o.channel != channel:
                continue
            if o.kind == "busy":
                if ns != "sidecar":
                    continue
                self.record(o, channel, good=not busy)
            else:  # latency
                if busy:
                    continue  # a BUSY reply is not a latency sample
                self.record(o, channel, good=dur_ms <= o.ms)

    def record(self, objective: Objective, channel: str,
               good: bool) -> None:
        now = self.clock()
        key = (objective.name, channel)
        fast_burn = None
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _Series()
            s.events.append((now, bool(good)))
            burns = _burns(objective, s.events, now)
            fast_w = objective.windows[0]
            b = burns.get(fast_w)
            if (objective.fast > 0 and b is not None
                    and b >= objective.fast
                    and now - s.last_warn >= fast_w):
                s.last_warn = now
                fast_burn = b
        for w, b in burns.items():
            # None (empty window) exports as 0.0 — no traffic is not a
            # violation, and the gauge must not freeze at a stale value
            self._burn_gauge.set(
                0.0 if b is None else round(b, 4), slo=objective.name,
                window=_wlabel(w), channel=channel,
            )
        if fast_burn is not None:
            self._fast_ctr.add(1, slo=objective.name, channel=channel)
            # incident edge: the fast-burn WARN is rate-limited to one
            # per window already, so the black-box hook inherits that
            # cadence (plus its own per-kind limit)
            from fabric_tpu_torch.observe import blackbox

            blackbox.notify(
                "slo_fast_burn", slo=objective.name, channel=channel,
                burn=round(fast_burn, 4),
                window_s=objective.windows[0],
            )
            _log.warning(
                "SLO %s fast burn on channel %r: burn rate %.1f over "
                "the %s window (threshold %.1f, budget %.2f%%) — the "
                "error budget is being spent %.0fx faster than it "
                "accrues",
                objective.name, channel, fast_burn,
                _wlabel(objective.windows[0]), objective.fast,
                objective.budget * 100.0, fast_burn,
            )

    # -- burn computation --------------------------------------------------

    def burn(self, name: str, channel: str,
             window: float | None = None) -> float | None:
        """Current burn rate of one series (recomputed at call time,
        so recovery decays without new traffic rolling in)."""
        o = next((o for o in self.objectives if o.name == name), None)
        if o is None:
            return None
        window = o.windows[0] if window is None else float(window)
        now = self.clock()
        with self._lock:
            s = self._series.get((name, channel))
            if s is None:
                return None
            return _burns(o, s.events, now).get(window)

    def burns(self, window: float | None = None) -> dict:
        """{(objective_name, channel): burn | None} across every live
        series, recomputed at call time on the fast (or given)
        window — the traffic autopilot's error-signal read.  Cheap:
        one lock to snapshot, per-series reverse walk bounded by the
        window."""
        now = self.clock()
        with self._lock:
            objectives = self.objectives
            series = {
                k: list(s.events) for k, s in self._series.items()
            }
        out: dict = {}
        for o in objectives:
            w = o.windows[0] if window is None else float(window)
            floor = max(1, o.min_events)
            for (name, channel), events in series.items():
                if name != o.name:
                    continue
                lo = now - w
                total = bad = 0
                for t, good in reversed(events):
                    if t < lo:
                        break
                    total += 1
                    if not good:
                        bad += 1
                out[(name, channel)] = (
                    (bad / total / o.budget) if total >= floor else None
                )
        return out

    def report(self) -> dict:
        """JSON-able snapshot (the ``/slo`` endpoint):
        every objective, per-channel window burns recomputed at call
        time, and a status roll-up (ok | burning | fast_burn)."""
        now = self.clock()
        with self._lock:
            objectives = self.objectives
            series = {
                k: list(s.events) for k, s in self._series.items()
            }
        out: dict = {"objectives": [], "clock_s": round(now, 3)}
        for o in objectives:
            entry = {
                "name": o.name, "kind": o.kind,
                "target": o.target, "budget": round(o.budget, 6),
                "windows_s": list(o.windows), "fast_burn": o.fast,
                "channels": {},
            }
            if o.kind == "latency":
                entry["ms"] = o.ms
            if o.channel:
                entry["channel_filter"] = o.channel
            for (name, channel), events in sorted(series.items()):
                if name != o.name:
                    continue
                burns = {}
                total = bad = 0
                lo = now - max(o.windows)
                for t, good in events:
                    if t < lo:
                        continue
                    total += 1
                    if not good:
                        bad += 1
                for w, b in _burns(o, events, now).items():
                    burns[_wlabel(w)] = (
                        None if b is None else round(b, 4)
                    )
                    # refresh the exported gauge too: a channel whose
                    # traffic stopped must decay on the scrape path,
                    # not freeze at its last mid-incident value
                    self._burn_gauge.set(
                        0.0 if b is None else round(b, 4),
                        slo=o.name, window=_wlabel(w), channel=channel,
                    )
                fast = burns.get(_wlabel(o.windows[0]))
                status = "ok"
                if fast is not None and o.fast > 0 and fast >= o.fast:
                    status = "fast_burn"
                elif any(b is not None and b >= 1.0
                         for b in burns.values()):
                    status = "burning"
                entry["channels"][channel] = {
                    "events": total, "bad": bad,
                    "burn": burns, "status": status,
                }
            out["objectives"].append(entry)
        return out


def _burns(o: Objective, events, now: float) -> dict:
    """{window_s: burn | None} over one series — None when the window
    holds fewer than ``o.min_events`` events (no traffic is not a
    violation, and a near-empty window is no sample: one bad block on
    a freshly started peer must not read as burn ≥ 1)."""
    out: dict = {}
    floor = max(1, o.min_events)
    for w in o.windows:
        lo = now - w
        total = bad = 0
        for t, good in reversed(events):
            if t < lo:
                break
            total += 1
            if not good:
                bad += 1
        out[w] = (bad / total / o.budget) if total >= floor else None
    return out


def _wlabel(w: float) -> str:
    return f"{int(w)}s" if float(w).is_integer() else f"{w}s"


# -- endorse-side objectives (the sign lane's SLO feed) ----------------------

#: the default endorse objective pair a peer arms when it runs BOTH an
#: SLO spec and the sign lane (peer/node.py): ``endorse:latency`` —
#: good = a sign request waited ≤ ms in the batcher's coalescing
#: window before its device flush — and ``endorse_busy:busy`` — good =
#: the request was admitted rather than bounced with SignBusy.  Both
#: ride the dedicated ``endorse`` channel so the commit-path latency
#: series stays undiluted, and both surface in ``/slo`` and
#: :meth:`SloEngine.burns` like any other objective (the autopilot's
#: burn map carries them under the ``endorse`` channel).
DEFAULT_ENDORSE_SLOS = (
    "endorse:latency:ms=25:channel=endorse;"
    "endorse_busy:busy:pct=5:channel=endorse"
)

ENDORSE_CHANNEL = "endorse"


def endorse_observer(engine: SloEngine):
    """→ the ``SignBatcher.observer`` callable that classifies the
    sign lane's per-request telemetry — the same wait values feeding
    the ``sign_batch_wait_seconds`` histogram, and the same admission
    edges feeding ``sign_busy_total`` — into the engine's endorse
    objectives.  Objectives are resolved at CALL time, so a
    ``set_objectives`` rotation never strands a stale closure.

    Contract: ``observer(wait_ms: float | None, busy: bool)`` — BUSY
    bounces carry ``wait_ms=None`` (a bounced request has no wait
    sample; it is not a latency event, exactly like the tracer feed's
    BUSY exclusion)."""

    def observer(wait_ms, busy):
        for o in engine.objectives:
            if o.channel != ENDORSE_CHANNEL:
                continue
            if o.kind == "busy":
                engine.record(o, ENDORSE_CHANNEL, good=not busy)
            elif not busy and wait_ms is not None:
                engine.record(o, ENDORSE_CHANNEL,
                              good=wait_ms <= o.ms)

    return observer


# -- commit-path objectives (the tx-flow journal's SLO feed) -----------------

#: the default commit objective pair a peer arms when it runs BOTH an
#: SLO spec and the tx-flow journal (peer/node.py): ``commit_e2e:
#: latency`` — good = a completed flow's end-to-end wall (first
#: milestone → state-apply visibility) came in under ms — and
#: ``commit_valid:busy`` — good = the tx validated VALID (the "bad
#: event" is an invalidated tx, exactly like a bounced sign request).
#: Unlike the per-block tracer feed, these are CLIENT-VISIBLE
#: latencies: one event per transaction, measured to the instant the
#: write became readable, so the autopilot's burn-rate signals track
#: what a user experiences rather than a per-block proxy.  They ride
#: the dedicated ``commit`` channel next to ``endorse``.
DEFAULT_COMMIT_SLOS = (
    "commit_e2e:latency:ms=1000:channel=commit;"
    "commit_valid:busy:pct=5:channel=commit"
)

COMMIT_CHANNEL = "commit"


def commit_feed(engine: SloEngine):
    """→ the ``FlowJournal.slo_feed`` callable that classifies each
    completed tx flow into the engine's commit objectives.  Contract:
    ``feed(e2e_s: float, valid: bool, n: int = 1)`` — called outside
    the journal lock; ``n`` > 1 batches the journal's per-block cohort
    publish (every orderer-side tx of a block shares one e2e/verdict)
    into n identical events.  Objectives are resolved at CALL time, so
    a ``set_objectives`` rotation never strands a stale closure (same
    discipline as :func:`endorse_observer`)."""

    def feed(e2e_s, valid, n=1):
        e2e_ms = float(e2e_s) * 1000.0
        for o in engine.objectives:
            if o.channel != COMMIT_CHANNEL:
                continue
            good = bool(valid) if o.kind == "busy" else e2e_ms <= o.ms
            for _ in range(int(n)):
                engine.record(o, COMMIT_CHANNEL, good)

    return feed


_global = SloEngine()
_attached = False


def global_engine() -> SloEngine:
    return _global


def configure(spec: str | None = None, objectives=None) -> SloEngine:
    """Arm the process-global engine (the nodeconfig ``slos`` knob
    lands here) and attach it to the process-global tracer's
    finished-block stream.  An empty spec detaches nothing — the
    listener is a no-op with no objectives."""
    global _attached
    if objectives is None:
        objectives = parse_slos(spec or "")
    _global.set_objectives(objectives)
    if not _attached:
        from fabric_tpu_torch.observe.tracer import global_tracer

        global_tracer().add_listener(_global.on_block)
        _attached = True
    return _global
