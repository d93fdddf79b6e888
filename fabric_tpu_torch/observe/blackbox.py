"""Black-box incident recorder: one bundle per incident, written at
the moment the incident EDGE fires (counterpart:
``fabric_tpu/observe/blackbox.py``; the reference's recorder over the
port's sampler, tracer, autopilot, SLO engine, ledgers and fault plan).

The time-series sampler (observe/timeseries.py) keeps the trailing
trails; this module decides *when a moment matters* and freezes
everything diagnostic about it into one JSON bundle — so the first
overload on a real accelerator round explains itself instead of
leaving an operator to reconstruct it from whatever was scraped.

Incident edges (each calls :func:`notify`, which is one module
attribute read when no recorder is armed):

* ``degrade_latch`` — DeviceLaneGuard latches its fallback, a
  synchronous ``p256_verify`` on the card (peer/degrade.py);
* ``autopilot_shed`` — the traffic autopilot puts a tenant in shed
  mode (control/autopilot.py);
* ``slo_fast_burn`` — an SLO series trips its fast-burn WARN
  (observe/slo.py);
* ``pipeline_fail_closed`` — a CommitPipeline stage exception fails
  the pipe closed (peer/pipeline.py);
* ``injected_crash`` — a FaultPlan ``crash`` fault is about to
  ``os._exit``: the recorder's last-gasp hook (``faults.on_crash`` —
  the one edge atexit can never see) dumps the bundle synchronously
  before the process dies, and an ``atexit`` handler additionally
  flushes a final ``fault_stats_at_exit`` bundle when an armed chaos
  plan fired during a process that otherwise recorded nothing.

Bundle anatomy (sections resolved lazily from the process globals, so
arming order never matters): the incident ``kind`` + ``detail``, the
trailing metric series from the sampler, recent trace trees from
every flight-recorder namespace, the autopilot decision log, the
sidecar scheduler's ``stats()``, the SLO burn snapshot, and the fault
plan's injection stats.

Bounded on every axis: bundles are rate-limited per kind
(``min_interval_s``), size-bounded (over ``max_bytes`` the heaviest
sections are dropped, named in ``truncated``), and both the in-memory
index and the on-disk files keep only the newest ``max_bundles``.

Default OFF: nothing is constructed until :func:`configure` arms the
recorder (the nodeconfig ``blackbox_dir`` knob, or the flight-data
recorder arming it alongside the sampler), and every edge's
``notify`` call costs one global read + None check when unarmed.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque

_log = logging.getLogger("fabric_tpu_torch.observe.blackbox")

#: bundles retained (memory ring AND on-disk files)
DEFAULT_MAX_BUNDLES = 16

#: seconds between bundles of the SAME kind — an incident storm (a
#: latch that flaps, a shed per tick) must not bury the first bundle
#: under near-identical successors
DEFAULT_MIN_INTERVAL_S = 30.0

#: serialized-bundle size cap; over it, heavy sections drop in
#: _DROP_ORDER until the bundle fits
DEFAULT_MAX_BYTES = 1_500_000

#: trace trees shipped per namespace
TRACE_TREES_PER_NS = 4

#: points of each metric series frozen into a bundle
SERIES_POINTS = 64

_DROP_ORDER = ("traces", "vitals", "launches", "tx_flow", "exemplars", "slo",
               "scheduler", "autopilot")

#: launch-ledger rows frozen into a bundle
LEDGER_ROWS = 8


class BlackBox:
    """See module docstring.  ``record`` is synchronous and contained
    by every caller (incidents are rare; the dump is off every hot
    path by construction)."""

    def __init__(self, out_dir: str = "",
                 max_bundles: int = DEFAULT_MAX_BUNDLES,
                 min_interval_s: float = DEFAULT_MIN_INTERVAL_S,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 sampler=None, tracer=None, scheduler=None,
                 autopilot=None, slo=None, registry=None,
                 commit_source=None, clock=time.monotonic):
        self.out_dir = str(out_dir or "")
        self.max_bundles = max(1, int(max_bundles))
        self.min_interval_s = float(min_interval_s)
        self.max_bytes = int(max_bytes)
        # explicit sources win; None = resolve the process global at
        # record time (a recorder armed before the autopilot still
        # captures its decision log)
        self._sampler = sampler
        self._tracer = tracer
        self.scheduler = scheduler
        self._autopilot = autopilot
        self._slo = slo
        # commit-engine postmortem source: anything with report() →
        # per-channel apply-queue stats + applied-vs-appended heights
        # (PeerNode wires its channels; absent on engine-less hosts)
        self.commit_source = commit_source
        self.clock = clock
        self._lock = threading.Lock()
        self._bundles: deque = deque(maxlen=self.max_bundles)
        self._files: deque = deque()
        self._last: dict[str, float] = {}
        # resume numbering after a restart: the recorder exists for
        # crash-then-restart flows, and a fresh process restarting at
        # seq 1 would overwrite the crashed run's postmortem evidence
        # (and never prune prior-run files against max_bundles)
        self._seq = 0
        if self.out_dir:
            try:
                prior = sorted(
                    (int(name.split("-")[1]),
                     os.path.join(self.out_dir, name))
                    for name in os.listdir(self.out_dir)
                    if name.startswith("blackbox-")
                    and name.endswith(".json")
                    and name.split("-")[1].isdigit()
                )
                if prior:
                    self._seq = prior[-1][0]
                    self._files.extend(p for _s, p in prior)
            except OSError:
                pass  # dir not created yet — _write makes it
        if registry is None:
            from fabric_tpu_torch.ops_metrics import global_registry

            registry = global_registry()
        self._registry = registry
        self._bundle_ctr = registry.counter(
            "blackbox_bundles_total",
            "black-box incident bundles recorded by kind",
        )
        self._limited_ctr = registry.counter(
            "blackbox_rate_limited_total",
            "black-box incidents suppressed by the per-kind rate limit",
        )

    # -- source resolution (lazy: process globals) -------------------------

    def _sources(self):
        sampler = self._sampler
        if sampler is None:
            from fabric_tpu_torch.observe import timeseries

            sampler = timeseries.global_sampler()
        tracer = self._tracer
        if tracer is None:
            from fabric_tpu_torch.observe import global_tracer

            tracer = global_tracer()
        autopilot = self._autopilot
        if autopilot is None:
            from fabric_tpu_torch.control import global_autopilot

            autopilot = global_autopilot()
        slo = self._slo
        if slo is None:
            from fabric_tpu_torch.observe.slo import global_engine

            slo = global_engine()
        from fabric_tpu_torch.observe import ledger as _ledger
        from fabric_tpu_torch.observe import txflow as _txflow

        return (sampler, tracer, autopilot, slo,
                _ledger.global_ledger(), _txflow.global_journal())

    # -- recording ---------------------------------------------------------

    def record(self, kind: str, **detail) -> dict | None:
        """Build + store one incident bundle; None when the per-kind
        rate limit suppressed it.  Every section is independently
        contained — a broken source yields an absent section, never a
        lost bundle."""
        now = self.clock()
        with self._lock:
            last = self._last.get(kind, float("-inf"))
            if now - last < self.min_interval_s:
                limited = True
            else:
                limited = False
                self._last[kind] = now
                self._seq += 1
                seq = self._seq
        if limited:
            self._limited_ctr.add(1, kind=kind)
            return None
        bundle = self._build(kind, detail, now, seq)
        with self._lock:
            self._bundles.append(bundle)
        self._bundle_ctr.add(1, kind=kind)
        path = self._write(bundle)
        _log.warning(
            "black-box bundle #%d recorded for incident %r%s",
            seq, kind, f" -> {path}" if path else "",
        )
        return bundle

    def _build(self, kind: str, detail: dict, now: float,
               seq: int) -> dict:
        sampler, tracer, autopilot, slo, launches, txflow = self._sources()
        bundle: dict = {
            "seq": seq,
            "kind": kind,
            "t_s": round(now, 3),
            "wall_s": round(time.time(), 3),
            "detail": {k: _jsonable(v) for k, v in detail.items()},
        }
        sections: dict = {}

        def grab(name, fn):
            try:
                sections[name] = fn()
            except Exception as e:
                sections[name] = None
                _log.debug("blackbox %s section failed: %s", name, e)

        if sampler is not None:
            grab("vitals", lambda: sampler.series(points=SERIES_POINTS))
        if tracer is not None and tracer.enabled:
            grab("traces", lambda: {
                ns or "_": tracer.blocks(TRACE_TREES_PER_NS, ns=ns)
                for ns in tracer.namespaces()
            })
        if autopilot is not None:
            grab("autopilot", autopilot.report)
        if launches is not None:
            # the device-time ledger: per-kernel decomposition + the
            # last few raw rows — the "was device_wait a compile?"
            # question answered inside the postmortem itself
            grab("launches", lambda: launches.report(rows=LEDGER_ROWS))
        if txflow is not None:
            # the per-tx flow journal: stage decomposition + the last
            # few completed flows — "where did the p99 tx spend its
            # second?" answered inside the postmortem itself
            grab("tx_flow", lambda: txflow.report(rows=LEDGER_ROWS))
        if sampler is not None or launches is not None:
            from fabric_tpu_torch.ops_metrics import exemplars_report

            grab("exemplars",
                 lambda: exemplars_report(self._registry) or None)
        if self.scheduler is not None:
            grab("scheduler", self.scheduler.stats)
        if self.commit_source is not None:
            # the decoupled committer's last word: how far state apply
            # trailed the appended chain when the incident fired
            grab("commit_engine", self.commit_source.report)
        if slo is not None and getattr(slo, "objectives", ()):
            grab("slo", slo.report)
        from fabric_tpu_torch import faults

        plan = faults.plan()
        if plan is not None:
            grab("faults", plan.stats)
        bundle.update(
            {k: v for k, v in sections.items() if v is not None}
        )
        return self._bound(bundle)

    def _bound(self, bundle: dict) -> dict:
        """Enforce ``max_bytes``: drop the heaviest sections in a
        fixed order until the serialized bundle fits, naming what was
        dropped so a truncated bundle is honest about it."""
        dropped = []
        for name in ("",) + _DROP_ORDER:
            if name:
                if name not in bundle:
                    continue
                bundle.pop(name)
                dropped.append(name)
                bundle["truncated"] = list(dropped)
            try:
                size = len(json.dumps(bundle))
            except (TypeError, ValueError):
                # a non-serializable detail slipped in: stringify it
                bundle["detail"] = {
                    k: str(v) for k, v in bundle.get("detail", {}).items()
                }
                size = len(json.dumps(bundle))
            if size <= self.max_bytes:
                break
        return bundle

    def _write(self, bundle: dict) -> str | None:
        if not self.out_dir:
            return None
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(
                self.out_dir,
                f"blackbox-{bundle['seq']:04d}-{bundle['kind']}.json",
            )
            with open(path, "w") as f:
                json.dump(bundle, f, indent=1)
            with self._lock:
                self._files.append(path)
                doomed = []
                while len(self._files) > self.max_bundles:
                    doomed.append(self._files.popleft())
            for old in doomed:
                try:
                    os.remove(old)
                except OSError:
                    pass  # already gone — the bound is best-effort
            return path
        except OSError as e:
            _log.warning("black-box bundle write failed: %s", e)
            return None

    # -- readers (the /vitals incident index) ------------------------------

    def bundles(self) -> list[dict]:
        """Index entries (newest last): seq/kind/time + sizes, never
        the full payloads."""
        with self._lock:
            bundles = list(self._bundles)
        out = []
        for b in bundles:
            out.append({
                "seq": b["seq"],
                "kind": b["kind"],
                "t_s": b["t_s"],
                "wall_s": b.get("wall_s"),
                "detail": b.get("detail", {}),
                "sections": sorted(
                    k for k in b
                    if k in ("vitals", "traces", "autopilot",
                             "scheduler", "slo", "faults", "launches",
                             "tx_flow", "exemplars", "commit_engine")
                ),
                "truncated": b.get("truncated", []),
            })
        return out

    def bundle(self, seq: int) -> dict | None:
        with self._lock:
            for b in self._bundles:
                if b["seq"] == seq:
                    return b
        return None


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


# -- process-global handle + the incident-edge hook --------------------------

_global: BlackBox | None = None
_hooks_installed = False
#: refcount for component lifecycles (acquire/release) — colocated
#: nodes share ONE recorder and only the last release disarms it
_refs = 0


def global_blackbox() -> BlackBox | None:
    return _global


def acquire(**kw) -> BlackBox:
    """Refcounted arming (PeerNode start/stop pairs this with
    :func:`release`): the first acquire builds the recorder with its
    ``configure`` kwargs; later acquires REUSE the live instance
    (first-arm wins for out_dir/source wiring — replacing it would
    discard the first holder's incident index), and only the last
    release disarms."""
    global _refs
    bb = _global if _global is not None else configure(**kw)
    _refs += 1
    return bb


def release() -> None:
    """Drop one :func:`acquire` hold; the last one out disarms."""
    global _refs
    if _refs > 0:
        _refs -= 1
        if _refs == 0:
            configure(enabled=False)


def notify(kind: str, **detail) -> None:
    """The incident-edge hook: one global read + None check when no
    recorder is armed; contained — an edge must never die of its own
    diagnostics."""
    bb = _global
    if bb is None:
        return
    try:
        bb.record(kind, **detail)
    except Exception as e:
        _log.warning("black-box record for %r failed: %s", kind, e)


def _on_injected_crash(point: str) -> None:
    """``faults.on_crash`` hook: last-gasp dump before ``os._exit``."""
    bb = _global
    if bb is not None:
        bb.record("injected_crash", point=point)


def _on_interpreter_exit() -> None:
    """atexit: a chaos-armed process that fired faults but recorded no
    bundle still leaves ONE final stats bundle behind (a crashed child
    never gets here — that is what the pre-crash hook is for)."""
    bb = _global
    if bb is None:
        return
    try:
        from fabric_tpu_torch import faults

        plan = faults.plan()
        if plan is None or plan.fired() == 0:
            return
        with bb._lock:
            recorded = len(bb._bundles)
        if recorded == 0:
            bb.record("fault_stats_at_exit")
    except Exception:
        pass  # interpreter teardown: nothing left to warn with


def configure(out_dir: str = "",
              max_bundles: int = DEFAULT_MAX_BUNDLES,
              min_interval_s: float = DEFAULT_MIN_INTERVAL_S,
              max_bytes: int = DEFAULT_MAX_BYTES,
              sampler=None, tracer=None, scheduler=None,
              autopilot=None, slo=None, registry=None,
              commit_source=None, clock=time.monotonic,
              enabled: bool = True,
              ) -> BlackBox | None:
    """Arm (or, with ``enabled=False``, disarm) the process-global
    recorder — the nodeconfig ``blackbox_dir`` knob lands here.  The
    crash hook and the atexit flush install once per process.
    Disarming zeroes the acquire refcount (the hard OFF)."""
    global _global, _hooks_installed, _refs
    if not enabled:
        _refs = 0
        _global = None
        return None
    _global = BlackBox(
        out_dir=out_dir, max_bundles=max_bundles,
        min_interval_s=min_interval_s, max_bytes=max_bytes,
        sampler=sampler, tracer=tracer, scheduler=scheduler,
        autopilot=autopilot, slo=slo, registry=registry,
        commit_source=commit_source, clock=clock,
    )
    if not _hooks_installed:
        import atexit

        from fabric_tpu_torch import faults

        faults.on_crash(_on_injected_crash)
        atexit.register(_on_interpreter_exit)
        _hooks_installed = True
    return _global
