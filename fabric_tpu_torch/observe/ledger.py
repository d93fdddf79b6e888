"""Per-launch device-time ledger (counterpart: ``fabric_tpu/observe/ledger.py``):
``device_wait`` split into compile, queue, execute and transfer, with
device-memory accounting.

Every kernel dispatch of the commit path (the verify, the fused stage 2,
the sign lane's flush, the resident table's scatter) opens a
:class:`LaunchRecord` before its dispatch call; the record brackets the
call and the blocking device-to-host copy that fetches its output, and
the ledger attributes the wall between them.  The model is the
reference's, host-visible quantities only (no profiler, no CUDA event):

* **compile**: the dispatch call's duration on a program-cache miss.  On
  the card a miss is the first launch of a kernel in the process: the
  launch that loads (or builds) its library, while ``kernels._Entry``
  still holds its ``_load`` stub, and that pays CUDA's lazy module load
  (``kernels.first_launch``).  Stage 2 takes the policy-table cache of
  ``peer/device_block.py`` as its exact verdict (the reference takes its
  program cache).  A caller that owns no cache passes ``compiled=None``
  and the ledger infers a miss on the first sight of its structural key,
  as the reference does for ``verify`` per bucket.  On a hit the same
  interval is dispatch overhead, kept as ``dispatch_ms``.
* **queue**: ``max(0, prior launch's completion - enqueue)`` per device
  lane: a launch cannot start before the previous one on its lane ended.
* **execute**: estimated completion minus estimated start.  Completion
  is the sync's return when it blocked longer than
  ``SYNC_BLOCKED_EPS_S``, else the sync's entry (the card was done
  before the host looked).
* **transfer**: host-to-device bytes (and seconds, where the caller
  timed its staging) noted at staging time, plus the device-to-host
  bytes seen at the fetch.

``compile + queue + execute + h2d ≈ wall`` holds within the dispatch
overhead of cache-hit rows.  The sync is the copy the caller makes
anyway (``.to("cpu")``): the ledger adds no synchronize and no event.

Rows land in per-kernel histograms and counters of the registry (with
trace exemplars, so a slow row links to its block's tree), as
``dev:compile`` / ``dev:queue`` / ``dev:execute`` child spans on a
``device:<lane>`` row under the span that was current at dispatch, and
in :meth:`LaunchLedger.stats` (per-kernel percentiles, cache hit rates,
device-memory watermarks, the newest raw rows).

Device memory: owners (the resident table, the comb table) report their
pinned bytes with :func:`account_hbm`; a launch pins its frames and
outputs with :meth:`LaunchRecord.pin_hbm` until it completes.
:func:`live_device_bytes` is ``torch.cuda.memory_allocated``, sampled on
demand and never per launch.

Disarmed (the default here), every hook is one module-global read and a
None check.  The hooks are contained: a failure of the ledger's own
bookkeeping is logged, while the dispatch and the sync they bracket are
the caller's, outside any ``try`` of the ledger's, so their errors
propagate unchanged.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

_log = logging.getLogger("fabric_tpu_torch.observe.ledger")

#: completed rows retained for the readers and the trailing signals
DEFAULT_RING = 256

#: trace exemplars armed on each ledger histogram (per label variant)
DEFAULT_EXEMPLARS = 8

#: a sync shorter than this is "the device was already done" — the
#: completion estimate then uses the sync's entry time, so host lag
#: between device completion and the fetch call is not booked as
#: execute beyond that bound
SYNC_BLOCKED_EPS_S = 0.0002

#: seconds of trailing rows the device_queue signal aggregates over
SIGNAL_WINDOW_S = 30.0

_HIST_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                 0.1, 0.25, 0.5, 1.0, 2.5, 10.0, float("inf"))


class LaunchRecord:
    """One in-flight device launch.  Created by
    :meth:`LaunchLedger.launch` BEFORE the dispatch call; the caller
    marks :meth:`dispatched` right after the dispatch returns,
    brackets the fetch-side sync with :meth:`sync_begin` /
    :meth:`sync_end`, or calls :meth:`complete` for enqueue-only
    launches whose completion is never awaited (functional scatters).
    Every method is idempotent-safe: a double fetch completes once."""

    __slots__ = ("ledger", "kernel", "lane", "key", "lanes", "compiled",
                 "sharded", "t0", "t1", "t_sync0", "h2d_bytes", "h2d_s",
                 "d2h_bytes", "_parent", "_ref", "_done",
                 "_dispatch_marked", "_pins")

    def __init__(self, ledger: "LaunchLedger", kernel: str, lane: str,
                 compiled: bool, lanes: int, parent, ref,
                 sharded: bool | None = None):
        self.ledger = ledger
        self.kernel = kernel
        self.lane = lane
        self.lanes = int(lanes)
        self.compiled = bool(compiled)
        #: None = no mesh configured (untagged row, every launch of
        #: the port today); True/False = a mesh was configured and the
        #: dispatch did / did not shard
        self.sharded = sharded
        self.t0 = ledger.clock()
        self.t1: float | None = None
        self.t_sync0: float | None = None
        self.h2d_bytes = 0
        self.h2d_s = 0.0
        self.d2h_bytes = 0
        self._parent = parent
        self._ref = ref
        self._done = False
        self._dispatch_marked = False
        self._pins: list = []

    def note_h2d(self, nbytes: int, seconds: float = 0.0) -> None:
        """Count host→device upload bytes (and, when the caller timed
        the staging, seconds) toward this launch's transfer lane."""
        self.h2d_bytes += int(nbytes)
        self.h2d_s += float(seconds)

    def begin_dispatch(self) -> None:
        """Re-anchor the record's start at the ACTUAL dispatch call
        (first call wins).  Callers that stage on the host between
        opening the record and dispatching (the verify wire-frame
        pack) mark this boundary so host staging is never booked as
        compile on a miss or dispatch overhead on a hit; callers that
        never call it keep the open-time anchor (over-approximate,
        the safe direction)."""
        if not self._dispatch_marked:
            self._dispatch_marked = True
            self.t0 = self.ledger.clock()

    def pin_hbm(self, owner: str, nbytes: int) -> None:
        """Account transient device bytes (launch frames, outputs)
        pinned by THIS launch: the level is ADDITIVE across concurrent
        depth-N launches — so the watermark records the true
        concurrent peak, not the largest single block — and released
        when the record completes."""
        nbytes = int(nbytes)
        self._pins.append((owner, nbytes))
        self.ledger.adjust_hbm(owner, nbytes)

    def dispatched(self) -> None:
        """The dispatch call returned — the launch is enqueued.  On a
        program-cache miss the interval since :meth:`launch` is the
        compile."""
        if self.t1 is None:
            self.t1 = self.ledger.clock()

    def sync_begin(self) -> None:
        if self.t_sync0 is None:
            self.t_sync0 = self.ledger.clock()

    def sync_end(self, d2h_bytes: int = 0) -> None:
        """The fetch returned — the launch (and its d2h readback) is
        complete; the ledger attributes and records the row."""
        if self._done:
            return
        self._done = True
        self.d2h_bytes += int(d2h_bytes)
        if self.t1 is None:
            self.t1 = self.ledger.clock()
        t2 = self.t_sync0 if self.t_sync0 is not None else self.t1
        t3 = self.ledger.clock()
        self.ledger._complete(self, t2, t3)

    def complete(self) -> None:
        """Enqueue-only completion: the caller never syncs (functional
        scatter updates).  The row records compile/dispatch/transfer;
        queue and execute stay None and the device lane's completion
        estimate is untouched."""
        if self._done:
            return
        self._done = True
        if self.t1 is None:
            self.t1 = self.ledger.clock()
        self.ledger._complete(self, None, None)


class LaunchLedger:
    """See module docstring.  One process-global instance in
    production (:func:`global_ledger`); tests construct their own with
    an injected clock and a private registry."""

    def __init__(self, registry=None, tracer=None,
                 clock=time.perf_counter, ring: int = DEFAULT_RING,
                 exemplars: int = DEFAULT_EXEMPLARS):
        self.clock = clock
        if registry is None:
            from fabric_tpu_torch.ops_metrics import global_registry

            registry = global_registry()
        self.registry = registry
        if tracer is None:
            from fabric_tpu_torch.observe.tracer import global_tracer

            tracer = global_tracer()
        self.tracer = tracer
        self._lock = threading.Lock()
        self._rows: deque = deque(maxlen=max(1, int(ring)))
        #: lane → estimated completion time of the newest finished
        #: launch — the queue-attribution bracket
        self._lane_done: dict[str, float] = {}
        #: (kernel, key) structural keys already dispatched — the
        #: first-seen cache-miss inference for callers that do not own
        #: their program cache
        self._seen: set = set()
        #: owner → [current_bytes, watermark_bytes]
        self._hbm: dict[str, list] = {}
        self._launch_ctr = registry.counter(
            "device_launches_total",
            "device launches recorded by the launch ledger, by kernel "
            "and program-cache outcome",
        )
        kw = dict(buckets=_HIST_BUCKETS, exemplars=int(exemplars))
        self._compile_h = registry.histogram(
            "device_launch_compile_seconds",
            "per-launch program compile time (s; cache misses only)",
            **kw,
        )
        self._queue_h = registry.histogram(
            "device_launch_queue_seconds",
            "per-launch device-lane queue wait (s): enqueue until the "
            "prior launch on the same lane completed",
            **kw,
        )
        self._execute_h = registry.histogram(
            "device_launch_execute_seconds",
            "per-launch device execute time (s; estimated completion "
            "minus estimated start)",
            **kw,
        )
        self._h2d_ctr = registry.counter(
            "device_launch_h2d_bytes_total",
            "host→device bytes uploaded per kernel (launch frames, "
            "state miss fills, scatter rows)",
        )
        self._d2h_ctr = registry.counter(
            "device_launch_d2h_bytes_total",
            "device→host bytes fetched per kernel",
        )
        self._hbm_gauge = registry.gauge(
            "device_ledger_hbm_bytes",
            "device-memory bytes currently pinned, by owner tag",
        )
        self._hbm_peak_gauge = registry.gauge(
            "device_ledger_hbm_watermark_bytes",
            "device-memory high-watermark bytes, by owner tag",
        )

    # -- recording ---------------------------------------------------------

    def launch(self, kernel: str, *, key=None, lane: str = "dev",
               lanes: int = 0, compiled: bool | None = None,
               h2d_bytes: int = 0,
               sharded: bool | None = None) -> LaunchRecord:
        """Open a record for one device dispatch.  ``compiled`` is the
        caller's exact program-cache verdict where it owns the cache;
        None infers miss-on-first-sight of ``(kernel, key)``.
        ``sharded`` tags the row when a device mesh is configured
        (the reference's multi-device dispatch; the port has none yet,
        so its rows stay untagged).  The tracer's
        thread-current span is captured as the parent the device
        child spans land under (None off traced paths)."""
        if compiled is None:
            k = (kernel, key)
            with self._lock:
                compiled = k not in self._seen
                self._seen.add(k)
        parent = self.tracer.current()
        ref = None
        if parent is not None and parent.root is not None:
            a = parent.root.attrs
            blk = a.get("block")
            if blk is not None:
                ns = a.get("ns", "")
                ref = f"{ns}:{blk}" if ns else str(blk)
        rec = LaunchRecord(self, kernel, lane, compiled, lanes,
                           parent, ref, sharded=sharded)
        if h2d_bytes:
            rec.note_h2d(h2d_bytes)
        return rec

    def _complete(self, rec: LaunchRecord, t2, t3) -> None:
        t0, t1 = rec.t0, rec.t1
        dispatch_s = max(0.0, t1 - t0)
        compile_s = dispatch_s if rec.compiled else 0.0
        queue_s = execute_s = None
        f = None
        if t3 is not None:
            # completion estimate: the sync's return when it genuinely
            # blocked, its entry otherwise (see module docstring)
            f = t3 if (t3 - t2) > SYNC_BLOCKED_EPS_S else t2
            f = max(f, t1)
        with self._lock:
            if f is not None:
                prev = self._lane_done.get(rec.lane, float("-inf"))
                start = min(f, max(t1, prev))
                queue_s = max(0.0, start - t1)
                execute_s = max(0.0, f - start)
                if f > prev:
                    self._lane_done[rec.lane] = f
            row = {
                "t_s": round(self.clock(), 6),
                "kernel": rec.kernel,
                "lane": rec.lane,
                "lanes": rec.lanes,
                "cache": "miss" if rec.compiled else "hit",
                "dispatch_ms": round(dispatch_s * 1000.0, 4),
                "compile_ms": round(compile_s * 1000.0, 4),
                "queue_ms": (None if queue_s is None
                             else round(queue_s * 1000.0, 4)),
                "execute_ms": (None if execute_s is None
                               else round(execute_s * 1000.0, 4)),
                "h2d_bytes": rec.h2d_bytes,
                "h2d_ms": round(rec.h2d_s * 1000.0, 4),
                "d2h_bytes": rec.d2h_bytes,
                "wall_ms": (None if f is None else
                            round((rec.h2d_s + f - t0) * 1000.0, 4)),
            }
            if rec.sharded is not None:
                row["sharded"] = rec.sharded
            if rec._ref is not None:
                row["block"] = rec._ref
            self._rows.append(row)
        k = rec.kernel
        self._launch_ctr.add(1, kernel=k, cache=row["cache"])
        if rec.compiled:
            self._compile_h.observe(compile_s, exemplar=rec._ref,
                                    kernel=k)
        if queue_s is not None:
            self._queue_h.observe(queue_s, exemplar=rec._ref, kernel=k)
            self._execute_h.observe(execute_s, exemplar=rec._ref,
                                    kernel=k)
        if rec.h2d_bytes:
            self._h2d_ctr.add(rec.h2d_bytes, kernel=k)
        if rec.d2h_bytes:
            self._d2h_ctr.add(rec.d2h_bytes, kernel=k)
        for owner, nbytes in rec._pins:
            # transient pins (launch frames, outputs) release when the
            # launch completes — the level tracks what is pinned NOW
            self.adjust_hbm(owner, -nbytes)
        self._spans(rec, t1, queue_s, execute_s, f)

    def _spans(self, rec: LaunchRecord, t1, queue_s, execute_s, f):
        """Device-lane child spans under the span that was current at
        dispatch time — /trace and the Perfetto export grow a
        ``device:<lane>`` row per kernel."""
        parent = rec._parent
        if parent is None or not self.tracer.enabled:
            return
        th = f"device:{rec.lane}"
        if rec.compiled:
            self.tracer.add("dev:compile", rec.t0, t1, parent=parent,
                            thread=th, kernel=rec.kernel)
        if queue_s is not None and queue_s > 0:
            self.tracer.add("dev:queue", t1, t1 + queue_s,
                            parent=parent, thread=th, kernel=rec.kernel)
        if execute_s is not None:
            self.tracer.add("dev:execute", f - execute_s, f,
                            parent=parent, thread=th, kernel=rec.kernel,
                            lanes=rec.lanes)

    # -- HBM accounting ----------------------------------------------------

    def account_hbm(self, owner: str, nbytes: int) -> None:
        """A PERSISTENT owner tag (resident_table / comb_table)
        reports its currently-pinned device bytes as a level; the
        ledger keeps the level and the high watermark.  Transient
        per-launch pins (launch frames, outputs) go through
        :meth:`LaunchRecord.pin_hbm` instead — additive across
        concurrent launches, released at completion."""
        nbytes = int(nbytes)
        with self._lock:
            ent = self._hbm.get(owner)
            if ent is None:
                ent = self._hbm[owner] = [0, 0]
            ent[0] = nbytes
            ent[1] = max(ent[1], nbytes)
            peak = ent[1]
        self._hbm_gauge.set(nbytes, owner=owner)
        self._hbm_peak_gauge.set(peak, owner=owner)

    def adjust_hbm(self, owner: str, delta: int) -> None:
        """Additive form for transient pins: concurrent depth-N
        launches SUM their frames, so the watermark records the true
        concurrent peak rather than the largest single block."""
        with self._lock:
            ent = self._hbm.get(owner)
            if ent is None:
                ent = self._hbm[owner] = [0, 0]
            ent[0] = max(0, ent[0] + int(delta))
            ent[1] = max(ent[1], ent[0])
            level, peak = ent
        self._hbm_gauge.set(level, owner=owner)
        self._hbm_peak_gauge.set(peak, owner=owner)

    # -- readers -----------------------------------------------------------

    @staticmethod
    def _pcts(vals: list) -> dict | None:
        if not vals:
            return None
        from fabric_tpu_torch.utils.stats import nearest_rank

        vals = sorted(vals)
        return {
            "n": len(vals),
            "p50": round(nearest_rank(vals, 50), 4),
            "p99": round(nearest_rank(vals, 99), 4),
            "max": round(vals[-1], 4),
        }

    def stats(self) -> dict:
        """Per-kernel decomposition over the retained rows + HBM
        watermarks — the ledger's summary and a bench's
        ``extras.device_ledger`` payload."""
        with self._lock:
            rows = list(self._rows)
            hbm = {o: {"current_bytes": c, "watermark_bytes": w}
                   for o, (c, w) in sorted(self._hbm.items())}
        kernels: dict[str, dict] = {}
        for r in rows:
            k = kernels.setdefault(r["kernel"], {
                "launches": 0, "cache_misses": 0, "unsharded": 0,
                "compile_ms": [], "queue_ms": [], "execute_ms": [],
                "h2d_bytes": 0, "d2h_bytes": 0,
            })
            k["launches"] += 1
            if r.get("sharded") is False:
                k["unsharded"] += 1
            if r["cache"] == "miss":
                k["cache_misses"] += 1
                k["compile_ms"].append(r["compile_ms"])
            if r["queue_ms"] is not None:
                k["queue_ms"].append(r["queue_ms"])
            if r["execute_ms"] is not None:
                k["execute_ms"].append(r["execute_ms"])
            k["h2d_bytes"] += r["h2d_bytes"]
            k["d2h_bytes"] += r["d2h_bytes"]
        out: dict[str, dict] = {}
        for name, k in sorted(kernels.items()):
            n = k["launches"]
            out[name] = {
                "launches": n,
                "cache_misses": k["cache_misses"],
                "cache_hit_rate": round((n - k["cache_misses"]) / n, 4),
                # mesh-configured dispatches that ran unsharded (0
                # without a mesh)
                "unsharded_launches": k["unsharded"],
                "compile_ms": self._pcts(k["compile_ms"]),
                "queue_ms": self._pcts(k["queue_ms"]),
                "execute_ms": self._pcts(k["execute_ms"]),
                "h2d_bytes": k["h2d_bytes"],
                "d2h_bytes": k["d2h_bytes"],
            }
        return {"kernels": out, "hbm": hbm, "rows_retained": len(rows)}

    def rows(self, n: int | None = None,
             kernel: str | None = None) -> list[dict]:
        """The newest ``n`` raw rows (oldest first); ``n <= 0`` means
        none — NOT everything (``rows[-0:]`` would invert the bound)."""
        with self._lock:
            rows = list(self._rows)
        if kernel is not None:
            rows = [r for r in rows if r["kernel"] == kernel]
        if n is not None:
            rows = rows[-n:] if n > 0 else []
        return rows

    def report(self, rows: int = 16, kernel: str | None = None) -> dict:
        out = self.stats()
        out["recent"] = self.rows(rows, kernel=kernel)
        return out

    def queue_p99_ms(self, window_s: float = SIGNAL_WINDOW_S):
        """Trailing queue-wait p99 (ms) across kernels — the
        autopilot's ``device_queue_ms`` signal, the honest replacement
        for inferring device pressure from launch-span p99.  None when
        the window holds no synced rows."""
        horizon = self.clock() - window_s
        with self._lock:
            vals = sorted(
                r["queue_ms"] for r in self._rows
                if r["queue_ms"] is not None and r["t_s"] >= horizon
            )
        if not vals:
            return None
        from fabric_tpu_torch.utils.stats import nearest_rank

        return float(nearest_rank(vals, 99))


def live_device_bytes(device=None) -> int | None:
    """Bytes of live tensors on the card (``torch.cuda.memory_allocated``
    of ``device``, the current one by default): sampled on demand, NEVER
    per launch.  None without CUDA."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        return int(torch.cuda.memory_allocated(device))
    except Exception as e:
        _log.debug("memory_allocated sample unavailable: %s", e)
        return None


# -- process-global handle + the dispatch hooks ------------------------------

_global: LaunchLedger | None = None
#: refcount for component lifecycles (acquire/release) — colocated
#: nodes share ONE ledger and only the last release disarms it
_refs = 0


def global_ledger() -> LaunchLedger | None:
    return _global


def launch(kernel: str, **kw) -> LaunchRecord | None:
    """The dispatch-site hook: one module-global read + None check
    when no ledger is armed; contained — a dispatch must never die of
    its own attribution."""
    led = _global
    if led is None:
        return None
    try:
        return led.launch(kernel, **kw)
    except Exception as e:
        _log.debug("launch record for %r failed: %s", kernel, e)
        return None


def note_h2d(kernel: str, nbytes: int) -> None:
    """Record standalone h2d bytes against ``kernel`` (the resident
    state path's per-block miss-fill/frame accounting folds in here)."""
    led = _global
    if led is None:
        return
    try:
        led._h2d_ctr.add(int(nbytes), kernel=kernel)
    except Exception as e:
        _log.debug("h2d note for %r failed: %s", kernel, e)


def account_hbm(owner: str, nbytes: int) -> None:
    """Owner-tag HBM hook: one global read + None check unarmed."""
    led = _global
    if led is None:
        return
    try:
        led.account_hbm(owner, nbytes)
    except Exception as e:
        _log.debug("hbm account for %r failed: %s", owner, e)


def acquire(**kw) -> LaunchLedger:
    """Refcounted arming (a component's start/stop pairs this with
    :func:`release`): the first acquire builds the ledger with its
    :func:`configure` kwargs; later acquires REUSE the live instance
    (first-arm wins — replacing it would discard the first holder's
    rows and lane state), and only the last release disarms."""
    global _refs
    led = _global if _global is not None else configure(**kw)
    _refs += 1
    return led


def release() -> None:
    """Drop one :func:`acquire` hold; the last one out disarms."""
    global _refs
    if _refs > 0:
        _refs -= 1
        if _refs == 0:
            configure(enabled=False)


def configure(enabled: bool = True, registry=None, tracer=None,
              clock=time.perf_counter, ring: int = DEFAULT_RING,
              exemplars: int = DEFAULT_EXEMPLARS,
              ) -> LaunchLedger | None:
    """Arm (or, with ``enabled=False``, disarm) the process-global
    ledger.
    Disarming zeroes the acquire refcount (the hard OFF)."""
    global _global, _refs
    if not enabled:
        _refs = 0
        _global = None
        return None
    _global = LaunchLedger(registry=registry, tracer=tracer,
                           clock=clock, ring=ring, exemplars=exemplars)
    return _global
