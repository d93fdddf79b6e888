"""Block-commit span tracer (counterpart: ``fabric_tpu/observe/tracer.py``):
flight recorder, Chrome trace export, slow-block watchdog.

The metrics registry (``fabric_tpu_torch.ops_metrics``) answers
distribution questions; this module records a per-block timeline: a tree
of spans rooted at one span per committed block, across every thread
the commit path touches (the prefetch thread, the caller's thread, the
committer thread, the host staging pool's workers).

* Always on and cheap: a span is a ``perf_counter`` pair and one list
  append; the one lock is taken once a block, at finalize (the ring
  append and the watchdog's median).  ``ring_blocks=0`` turns every
  call into a no-op.
* Explicit handles across threads: contextvars do not follow
  ``ThreadPoolExecutor`` tasks, so spans are passed (``parent=``) or
  adopted (``attach``/``detach``).  Each thread keeps a current span;
  ``span()``/``add()`` default their parent to it, so leaf code (the
  validator's stage timers, pool workers) needs no plumbing.
* Rings per namespace: peer block trees live in ``""``, a sidecar's
  request trees in ``"sidecar"``; watchdog medians are per namespace.
* :func:`device_annotation` is ``torch.profiler.record_function``
  around a kernel dispatch while a ``torch.profiler`` capture records,
  so the host's dispatch spans line up with the card's kernels in the
  profiler's trace; with no capture it is a shared null context.

Exports: :meth:`Tracer.export_chrome` (Chrome trace-event JSON, one row
a thread, one process row a stitched remote subtree), :meth:`Tracer.blocks`
(JSON trees) and :func:`format_block` (the watchdog's text breakdown).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque

_log = logging.getLogger("fabric_tpu_torch.observe")

#: the reference's defaults for the flight recorder's size and the
#: watchdog's factor (its node config's trace_ring_blocks /
#: trace_slow_factor)
DEFAULT_RING_BLOCKS = 32
DEFAULT_SLOW_FACTOR = 5.0

#: watchdog arms only after this many committed blocks — the first
#: blocks of a stream eat compiles and cache warms, and a median of two
#: samples is noise
_WATCHDOG_MIN_SAMPLES = 8

_USE_CURRENT = object()  # sentinel: "parent argument not given"

#: Chrome trace-event color names for the launch ledger's device-lane
#: spans (observe/ledger.py): compile stalls render visually distinct
#: from queue waits and execute
_DEV_SPAN_COLORS = {
    "dev:compile": "terrible",
    "dev:queue": "bad",
    "dev:execute": "good",
}


class Span:
    """One timed region.  ``t0``/``t1`` are ``perf_counter`` seconds;
    ``thread`` is the name of the thread that STARTED the span (the
    Chrome row it renders on).  ``children`` appends are GIL-atomic, so
    concurrent pool workers may add children to a shared parent without
    a lock.  ``root`` points at the block root the span hangs under
    (set by the tracer at creation — how a leaf instrumentation site,
    e.g. the sidecar client, finds the block it is part of without a
    parent chain), and ``proc`` names the PROCESS a stitched remote
    span ran in (None = this process; the Chrome export renders one
    pid row per proc)."""

    __slots__ = ("name", "t0", "t1", "thread", "attrs", "children",
                 "events", "root", "proc")

    def __init__(self, name: str, t0: float, thread: str, attrs: dict):
        self.name = name
        self.t0 = t0
        self.t1: float | None = None
        self.thread = thread
        self.attrs = attrs
        self.children: list[Span] = []
        self.events: list[tuple] = []  # (name, t, attrs)
        self.root: Span | None = None
        self.proc: str | None = None

    @property
    def dur(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    def to_dict(self, base: float) -> dict:
        """JSON-able tree, times in ms relative to ``base``."""
        d = {
            "name": self.name,
            "start_ms": round((self.t0 - base) * 1000.0, 3),
            "dur_ms": round(self.dur * 1000.0, 3),
            "thread": self.thread,
        }
        if self.proc:
            d["proc"] = self.proc
        if self.attrs:
            d["attrs"] = self.attrs
        if self.events:
            d["events"] = [
                {"name": n, "at_ms": round((t - base) * 1000.0, 3),
                 **({"attrs": a} if a else {})}
                for n, t, a in self.events
            ]
        if self.children:
            d["children"] = [c.to_dict(base) for c in self.children]
        return d


class _SpanCtx:
    """Context manager for one live span: starts on __enter__, attaches
    as the thread's current, restores + ends on __exit__.  A None span
    (disabled tracer / no parent) makes every step a no-op."""

    __slots__ = ("_tracer", "_name", "_parent", "_attrs", "_span", "_tok")

    def __init__(self, tracer, name, parent, attrs):
        self._tracer = tracer
        self._name = name
        self._parent = parent
        self._attrs = attrs

    def __enter__(self):
        sp = self._tracer.start(self._name, self._parent, **self._attrs)
        self._span = sp
        self._tok = self._tracer.attach(sp) if sp is not None else None
        return sp

    def __exit__(self, exc_type, exc, tb):
        if self._span is not None:
            self._tracer.detach(self._tok)
            self._tracer.end(self._span)
        return False


class Tracer:
    """Span recorder + bounded flight recorder + slow-block watchdog.

    One process-global instance (:func:`global_tracer`) backs the
    production commit path; tests construct their own.  ``clock`` is
    injectable so watchdog behavior is testable without sleeping.
    """

    def __init__(self, ring_blocks: int = DEFAULT_RING_BLOCKS,
                 slow_factor: float = DEFAULT_SLOW_FACTOR,
                 clock=time.perf_counter):
        self.clock = clock
        self._local = threading.local()
        self._lock = threading.Lock()
        self._listeners: list = []
        self.configure(ring_blocks=ring_blocks, slow_factor=slow_factor)

    def configure(self, ring_blocks: int | None = None,
                  slow_factor: float | None = None) -> None:
        """Re-size the flight recorder / re-arm the watchdog; recent
        trees survive a resize (truncated to the new capacity)."""
        with self._lock:
            if ring_blocks is not None:
                self.ring_blocks = int(ring_blocks)
                cap = max(1, self.ring_blocks)
                # one ring PER NAMESPACE: peer block trees live in the
                # default "" ring, a colocated sidecar's request trees
                # in "sidecar" — a request storm can no longer evict
                # real block trees, and /trace?block=N cannot collide
                old = getattr(self, "_rings", None) or {"": deque()}
                self._rings: dict[str, deque] = {
                    ns: deque(list(ring)[-cap:], maxlen=cap)
                    for ns, ring in old.items()
                }
                self._rings.setdefault("", deque(maxlen=cap))
                self._slow: deque = deque(
                    list(getattr(self, "_slow", ())), maxlen=16
                )
                # watchdog medians are per-namespace too: sidecar
                # requests (~ms) and block commits (~100ms) are
                # different populations, and mixing them would poison
                # the trailing median both ways
                if not hasattr(self, "_durs"):
                    self._durs: dict[str, deque] = {}
            if slow_factor is not None:
                self.slow_factor = float(slow_factor)

    @property
    def _ring(self) -> deque:
        """The default-namespace ring (peer block trees)."""
        return self._rings[""]

    # -- finished-block listeners (the SLO engine subscribes) --------------

    def add_listener(self, fn) -> None:
        """``fn(root_span)`` runs after every :meth:`finish_block`
        (outside the tracer lock, on the finishing thread).  Exceptions
        are contained — a broken listener cannot take down the commit
        path."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass  # already removed — detach is idempotent

    @property
    def enabled(self) -> bool:
        return self.ring_blocks > 0

    # -- recording (hot path: no locks) ------------------------------------

    def begin_block(self, number: int, ns: str = "", **attrs):
        """Root span for one block's trip through the commit pipeline
        (submit → commit complete).  ``ns`` names the flight-recorder
        ring the tree finalizes into ("" = peer blocks; the sidecar
        server uses "sidecar" so request trees never evict or collide
        with block trees).  Returns None when disabled — every other
        method tolerates a None span/parent as a no-op."""
        if not self.enabled:
            return None
        attrs["block"] = int(number)
        if ns:
            attrs["ns"] = str(ns)
        sp = Span("block", self.clock(),
                  threading.current_thread().name, attrs)
        sp.root = sp
        return sp

    def start(self, name: str, parent, **attrs):
        """Explicit span start under ``parent`` (a handle passed across
        a thread boundary).  None parent → no-op (returns None)."""
        if parent is None:
            return None
        sp = Span(name, self.clock(), threading.current_thread().name,
                  attrs)
        sp.root = parent.root if parent.root is not None else parent
        parent.children.append(sp)
        return sp

    def end(self, span) -> None:
        if span is not None:
            span.t1 = self.clock()

    def span(self, name: str, parent=_USE_CURRENT, **attrs) -> _SpanCtx:
        """``with tracer.span("launch", parent=root):`` — the span
        becomes the thread's *current* for its extent, so nested
        ``add()``/``span()`` calls with no explicit parent land under
        it.  Default parent is the thread's current span."""
        if parent is _USE_CURRENT:
            parent = self.current()
        return _SpanCtx(self, name, parent, attrs)

    def add(self, name: str, t0: float, t1: float, parent=_USE_CURRENT,
            thread: str | None = None, **attrs) -> None:
        """Record an already-measured span [t0, t1] (retro form for
        code that times stages anyway, e.g. BlockValidator._t).
        ``thread`` overrides the row name — the launch ledger files
        its ``dev:*`` spans on a synthetic ``device:<lane>`` row so
        /trace and the Perfetto export grow a device lane instead of
        mixing device time into the recording thread's row."""
        if parent is _USE_CURRENT:
            parent = self.current()
        if parent is None:
            return
        sp = Span(name, t0,
                  thread or threading.current_thread().name, attrs)
        sp.t1 = t1
        sp.root = parent.root if parent.root is not None else parent
        parent.children.append(sp)

    def event(self, name: str, parent=_USE_CURRENT, **attrs) -> None:
        """Zero-duration annotation (barrier redo, stale-prefetch
        re-parse, coalesced-group membership)."""
        if parent is _USE_CURRENT:
            parent = self.current()
        if parent is None:
            return
        parent.events.append((name, self.clock(), attrs))

    @staticmethod
    def set_attrs(span, **attrs) -> None:
        if span is not None:
            span.attrs.update(attrs)

    # -- thread-local current span -----------------------------------------

    def attach(self, span):
        """Adopt ``span`` as this thread's current; returns a token for
        :meth:`detach`.  This is how a pool/executor task inherits the
        submitting thread's span across the thread boundary."""
        prev = getattr(self._local, "cur", None)
        self._local.cur = span
        return prev

    def detach(self, token) -> None:
        self._local.cur = token

    def current(self):
        return getattr(self._local, "cur", None)

    # -- finalize: ring + watchdog (the one lock per block) ----------------

    def finish_block(self, root) -> None:
        if root is None:
            return
        if root.t1 is None:
            root.t1 = self.clock()
        dur = root.dur
        ns = root.attrs.get("ns", "")
        slow = False
        with self._lock:
            ring = self._rings.get(ns)
            if ring is None:
                ring = self._rings[ns] = deque(
                    maxlen=max(1, self.ring_blocks)
                )
            ring.append(root)
            durs = self._durs.get(ns)
            if durs is None:
                durs = self._durs[ns] = deque(maxlen=128)
            if (len(durs) >= _WATCHDOG_MIN_SAMPLES
                    and self.slow_factor > 0):
                med = sorted(durs)[len(durs) // 2]
                if med > 0 and dur > self.slow_factor * med:
                    slow = True
                    self._slow.append(root)
            durs.append(dur)
        if slow:
            root.attrs["slow"] = True
            from fabric_tpu_torch.ops_metrics import global_registry

            global_registry().counter(
                "trace_slow_blocks_total",
                "blocks flagged by the slow-block watchdog",
            ).add(1, channel=str(root.attrs.get("channel", "")))
            _log.warning(
                "slow block %s: %.1f ms (> %.1fx trailing median "
                "%.1f ms)\n%s",
                root.attrs.get("block"), dur * 1000.0, self.slow_factor,
                med * 1000.0, format_block(root),
            )
        for fn in list(self._listeners):
            try:
                fn(root)
            except Exception as e:  # a listener must never kill commit
                _log.debug("tracer listener %r failed: %s", fn, e)

    # -- readers (flight recorder) -----------------------------------------

    def blocks(self, n: int | None = None, ns: str = "") -> list[dict]:
        """Most recent block trees (oldest first), as JSON-able dicts."""
        with self._lock:
            roots = list(self._rings.get(ns, ()))
        if n is not None:
            roots = roots[-n:]
        return [self._root_dict(r) for r in roots]

    def block(self, number: int, ns: str = "") -> dict | None:
        with self._lock:
            roots = list(self._rings.get(ns, ()))
        for r in reversed(roots):
            if r.attrs.get("block") == number:
                return self._root_dict(r)
        return None

    def namespaces(self) -> dict[str, int]:
        """{ns: trees currently held} for every non-empty ring."""
        with self._lock:
            return {ns: len(r) for ns, r in self._rings.items() if r}

    def slow_blocks(self) -> list[dict]:
        with self._lock:
            roots = list(self._slow)
        return [self._root_dict(r) for r in roots]

    def recent_roots(self, ns: str = "") -> list:
        """The flight recorder's live Span roots (oldest first) — the
        overlap-coverage analyzer (observe/overlap.py) walks these
        directly; the trees are finished, so reading them lock-free
        after the snapshot copy is safe."""
        with self._lock:
            return list(self._rings.get(ns, ()))

    @staticmethod
    def _root_dict(root) -> dict:
        d = root.to_dict(root.t0)
        d["block"] = root.attrs.get("block")
        # absolute perf_counter base: start_ms values are per-block
        # relative, and cross-BLOCK consumers (overlap coverage) need
        # a common timeline to compare neighbors on
        d["t0_s"] = root.t0
        return d

    # -- Chrome trace-event export -----------------------------------------

    def chrome_events(self) -> list[dict]:
        """Flight recorder → Chrome trace-event list ("X" complete
        events + "i" instants + thread_name/process_name metadata),
        one tid per thread/worker name so Perfetto renders one row
        each.  Stitched remote spans (``Span.proc`` set — the sidecar
        subtree the client merged in) get their own pid, so the
        cross-process waterfall renders on distinct process rows.
        Every namespace's ring is exported (peer blocks + sidecar
        request trees in a colocated process)."""
        with self._lock:
            roots = [r for ring in self._rings.values() for r in ring]
        roots.sort(key=lambda r: r.t0)
        pids: dict[str, int] = {"local": 0}
        tids: dict[tuple, int] = {}
        events: list[dict] = []

        def pid(proc: str) -> int:
            p = pids.get(proc)
            if p is None:
                p = pids[proc] = len(pids)
            return p

        def tid(p: int, name: str) -> int:
            t = tids.get((p, name))
            if t is None:
                t = tids[(p, name)] = sum(
                    1 for k in tids if k[0] == p
                ) + 1
            return t

        def walk(sp: Span, block: int) -> None:
            p = pid(sp.proc or "local")
            row = tid(p, sp.thread)
            # the root's block number is the grouping key and always
            # wins — a stitched remote subtree's own ids must not
            # shadow it (its request id rides as args["req"])
            ev = {
                "name": sp.name, "cat": "fabtpu", "ph": "X",
                "ts": sp.t0 * 1e6,
                "dur": max(0.0, sp.dur) * 1e6,
                "pid": p, "tid": row,
                "args": {**sp.attrs, "block": block},
            }
            # ledger device-lane spans: color-code so a compile stall
            # reads differently from execute at a glance in Perfetto
            cname = _DEV_SPAN_COLORS.get(sp.name)
            if cname is not None:
                ev["cname"] = cname
            events.append(ev)
            for n, t, a in sp.events:
                events.append({
                    "name": n, "cat": "fabtpu", "ph": "i", "s": "t",
                    "ts": t * 1e6, "pid": p, "tid": row,
                    "args": {"block": block, **a},
                })
            for c in sp.children:
                walk(c, block)

        for root in roots:
            walk(root, int(root.attrs.get("block", -1)))
        meta = [
            {"name": "process_name", "ph": "M", "pid": p, "tid": 0,
             "args": {"name": proc}}
            for proc, p in pids.items()
        ]
        meta += [
            {"name": "thread_name", "ph": "M", "pid": p, "tid": t,
             "args": {"name": n}}
            for (p, n), t in tids.items()
        ]
        return meta + events

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(),
                       "displayTimeUnit": "ms"}, f)


def format_block(root) -> str:
    """Compact indented breakdown of one block tree — the watchdog's
    WARN payload."""
    base = root.t0
    lines: list[str] = []

    def walk(sp: Span, depth: int) -> None:
        row = f"{sp.proc}:{sp.thread}" if sp.proc else sp.thread
        lines.append(
            "%s%-24s %8.2f ms @ %7.2f ms  [%s]" % (
                "  " * depth, sp.name, sp.dur * 1000.0,
                (sp.t0 - base) * 1000.0, row,
            )
        )
        for n, t, _a in sp.events:
            lines.append("%s! %s @ %.2f ms" % (
                "  " * (depth + 1), n, (t - base) * 1000.0,
            ))
        for c in sp.children:
            walk(c, depth + 1)

    walk(root, 0)
    return "\n".join(lines)


def span_from_dict(d: dict, offset_s: float = 0.0,
                   proc: str | None = None) -> Span:
    """Reconstruct a :class:`Span` tree from ``Span.to_dict(0.0)``
    output — the wire form a sidecar ships its finished request
    subtree back in.  Times in the dict are absolute ms on the REMOTE
    process's clock; ``offset_s`` (remote − local, the NTP-style
    estimate from the request/response timestamp midpoints) is
    subtracted so the tree lands on the local timeline.  ``proc``
    labels every reconstructed span's process row."""
    sp = Span(
        str(d.get("name", "?")),
        float(d.get("start_ms", 0.0)) / 1000.0 - offset_s,
        str(d.get("thread", "?")),
        dict(d.get("attrs") or {}),
    )
    sp.t1 = sp.t0 + max(0.0, float(d.get("dur_ms", 0.0))) / 1000.0
    sp.proc = proc
    for ev in d.get("events", ()):
        sp.events.append((
            str(ev.get("name", "?")),
            float(ev.get("at_ms", 0.0)) / 1000.0 - offset_s,
            dict(ev.get("attrs") or {}),
        ))
    for c in d.get("children", ()):
        child = span_from_dict(c, offset_s, proc)
        child.root = sp
        sp.children.append(child)
    return sp


_global = Tracer()


def global_tracer() -> Tracer:
    return _global


def configure(ring_blocks: int | None = None,
              slow_factor: float | None = None) -> Tracer:
    """Configure the process-global tracer (``ring_blocks`` /
    ``slow_factor``)."""
    _global.configure(ring_blocks=ring_blocks, slow_factor=slow_factor)
    return _global


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()
_record_function = None
_autograd_profiler = None


def device_annotation(name: str):
    """``torch.profiler.record_function(name)`` around a kernel dispatch
    while a ``torch.profiler`` capture is recording, so the dispatch
    shows as a CPU event beside the card's kernels; otherwise a shared
    null context (one module attribute read).  A fresh
    ``record_function`` per recorded call: it holds its own handle, and
    two threads may annotate at once."""
    global _record_function, _autograd_profiler
    if _record_function is None:
        import torch.autograd.profiler as autograd_profiler
        from torch.profiler import record_function

        _autograd_profiler = autograd_profiler
        _record_function = record_function
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL_CTX
    return _record_function(name)
