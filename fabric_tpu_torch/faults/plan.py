"""Deterministic fault injection (counterpart: ``fabric_tpu/faults/plan.py``).

A seedable :class:`FaultPlan` maps named injection points to fault
kinds; the code that must survive calls ``fire(point, **ctx)`` there
(``afire`` on an event loop).  The port places these points:

==============================  ==============================================
injection point                 fires
==============================  ==============================================
``p256v3.verify_launch``        the v3 verify dispatch (``ops/p256v3.py``)
``validator.verify_launch``     each device-lane attempt of a
                                ``DeviceLaneGuard`` (``peer/degrade.py``)
``validator.stage2``            the fused stage-2 dispatch
``hostpool.task``               inside every ``HostStagePool`` task
``pipeline.prefetch``           ``CommitPipeline``'s prefetch stage
``pipeline.launch``             its caller-thread launch stage
``pipeline.commit``             its commit stage
``ledger.fsync.before``         ``BlockStore``, right before ``os.fsync``
``ledger.fsync.after``          ``BlockStore``, right after ``os.fsync``
``ledger.apply.before``         ``AsyncApplyEngine``, before a block's apply
``ledger.apply.after``          ``AsyncApplyEngine``, after it (and history)
``rpc.frame``                   every framed-RPC frame sent (``afire``)
``sidecar.request``             the sidecar server's admission (``afire``)
``sidecar.dispatch``            the sidecar's coalesced dispatch
==============================  ==============================================

Kinds: ``raise`` (:class:`InjectedFault`), ``latency`` (sleep ``ms``;
``asyncio.sleep`` under ``afire``, so one stream slows and the loop
runs on), ``disconnect`` and ``truncate`` (``ConnectionResetError``, a
torn stream), ``crash`` (the crash hooks, then ``os._exit(86)``: the
kill-mid-fsync tests run it in a child process).  The spec string::

    point:kind[:p=0.5][:n=3][:after=2][:ms=50] [; more specs]

``p`` is the trigger probability per arrival, drawn from the rule's own
``random.Random`` seeded by (seed, point, kind, position), so a seeded
run replays whatever the interleaving of other points; ``n`` the
trigger budget; ``after`` the arrivals skipped first (``after=8``: the
ninth arrival fires); ``ms`` the sleep of ``latency``.

A plan is armed by ``configure(spec)`` (its seed defaults to
``FABTPU_FAULTS_SEED``) or ``install(plan)``, disarmed by ``reset()``,
and at import from ``FABTPU_FAULTS`` / ``FABTPU_FAULTS_SEED``, so a
child process needs no plumbing.  With no plan armed ``fire`` is one
global read.  ``shield()`` marks the current thread as a recovery path
(the degraded lane's fallback): its arrivals never trigger, so a
persistent fault cannot chase the fallback through shared entry points.
Each triggered fault counts in the registry's
``faults_injected_total{point,kind}`` (the reference's :292-298);
``stats()`` and ``fired()`` report the plan's own counts.
"""

from __future__ import annotations

import asyncio
import os
import random
import threading
import time

_KINDS = ("raise", "latency", "disconnect", "truncate", "crash")

ENV_SPEC = "FABTPU_FAULTS"
ENV_SEED = "FABTPU_FAULTS_SEED"

#: the exit code of a ``crash`` fault
CRASH_EXIT = 86


class FaultSpecError(ValueError):
    """A malformed fault spec string."""


class InjectedFault(RuntimeError):
    """Raised by a ``raise``-kind injection point."""

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point}")
        self.point = point


class _Rule:
    __slots__ = ("point", "kind", "p", "n", "after", "ms", "arrivals", "fired", "rng")

    def __init__(self, point: str, kind: str, p: float = 1.0, n: int | None = None,
                 after: int = 0, ms: float = 0.0):
        self.point, self.kind = point, kind
        self.p, self.n, self.after, self.ms = p, n, after, ms
        self.arrivals = 0
        self.fired = 0
        self.rng: random.Random | None = None


def _parse(spec: str) -> list:
    rules = []
    for part in (p.strip() for p in spec.split(";")):
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise FaultSpecError(f"fault spec {part!r}: expected 'point:kind[:k=v...]'")
        point, kind = fields[0].strip(), fields[1].strip()
        if kind not in _KINDS:
            raise FaultSpecError(f"fault spec {part!r}: unknown kind {kind!r} "
                                 f"(expected one of {', '.join(_KINDS)})")
        kw: dict = {}
        for f in fields[2:]:
            k, _, v = f.partition("=")
            k = k.strip()
            conv = {"p": float, "n": int, "after": int, "ms": float}.get(k)
            if conv is None:
                raise FaultSpecError(f"fault spec {part!r}: unknown param {k!r} "
                                     "(expected p/n/after/ms)")
            try:
                kw[k] = conv(v)
            except ValueError:
                raise FaultSpecError(f"fault spec {part!r}: cannot parse '{k}={v}'") from None
        if not 0 <= kw.get("p", 1.0) <= 1:
            raise FaultSpecError(f"fault spec {part!r}: p must be in [0, 1]")
        if kind == "latency" and kw.get("ms", 0.0) <= 0:
            raise FaultSpecError(f"fault spec {part!r}: latency needs ms=<positive>")
        rules.append(_Rule(point, kind, **kw))
    return rules


class FaultPlan:
    """A parsed, armed set of rules.  Budgets and draws are guarded by
    one lock, taken only at points that have rules."""

    def __init__(self, spec: str = "", seed: int | None = None):
        self.spec = spec
        self.seed = seed
        self._lock = threading.Lock()
        self._rules: dict = {}
        for i, rule in enumerate(_parse(spec)):
            rule.rng = (random.Random(f"{seed}:{rule.point}:{rule.kind}:{i}")
                        if seed is not None else random.Random())
            self._rules.setdefault(rule.point, []).append(rule)

    @property
    def points(self) -> tuple:
        return tuple(sorted(self._rules))

    def _admit(self, rule: _Rule) -> bool:
        with self._lock:
            rule.arrivals += 1
            if rule.arrivals <= rule.after:
                return False
            if rule.n is not None and rule.fired >= rule.n:
                return False
            if rule.p < 1.0 and rule.rng.random() >= rule.p:
                return False
            rule.fired += 1
        _injected_counter().add(1, point=rule.point, kind=rule.kind)
        return True

    def fire(self, point: str, **ctx) -> None:
        """An arrival at ``point``: trigger each rule its budget and
        draw allow.  May raise, sleep or end the process.  A shielded
        thread's arrivals are not counted."""
        rules = self._rules.get(point)
        if not rules or _shielded():
            return
        for rule in rules:
            if self._admit(rule):
                _trigger(rule, point)

    async def afire(self, point: str, **ctx) -> None:
        """``fire`` on an event loop: a latency fault awaits
        ``asyncio.sleep``, so it slows one stream, not the loop."""
        rules = self._rules.get(point)
        if not rules or _shielded():
            return
        for rule in rules:
            if self._admit(rule):
                if rule.kind == "latency":
                    await asyncio.sleep(rule.ms / 1000.0)
                else:
                    _trigger(rule, point)

    def stats(self) -> dict:
        """{point: [{kind, arrivals, fired}]}."""
        with self._lock:
            return {point: [{"kind": r.kind, "arrivals": r.arrivals, "fired": r.fired}
                            for r in rules]
                    for point, rules in sorted(self._rules.items())}

    def fired(self, point: str | None = None) -> int:
        with self._lock:
            rules = (self._rules.get(point, ()) if point is not None
                     else [r for rs in self._rules.values() for r in rs])
            return sum(r.fired for r in rules)


def _injected_counter():
    from fabric_tpu_torch.ops_metrics import global_registry

    return global_registry().counter(
        "faults_injected_total", "chaos faults triggered by point and kind"
    )


def _trigger(rule: _Rule, point: str) -> None:
    kind = rule.kind
    if kind == "latency":
        time.sleep(rule.ms / 1000.0)
    elif kind == "raise":
        raise InjectedFault(point)
    elif kind == "disconnect":
        raise ConnectionResetError(f"injected disconnect at {point}")
    elif kind == "truncate":
        raise ConnectionResetError(f"injected truncated stream at {point}")
    else:
        # crash: nothing flushed, no atexit; each hook contained, since
        # a broken hook must not save the process from its death
        for hook in list(_crash_hooks):
            try:
                hook(point)
            except Exception:
                pass
        os._exit(CRASH_EXIT)


# -- the process-global plan ----------------------------------------------------

_plan: FaultPlan | None = None
_tl = threading.local()
_crash_hooks: list = []


def on_crash(fn) -> None:
    """Run ``fn(point)`` right before a ``crash`` fault ends the
    process.  Idempotent."""
    if fn not in _crash_hooks:
        _crash_hooks.append(fn)


def remove_crash_hook(fn) -> None:
    if fn in _crash_hooks:
        _crash_hooks.remove(fn)


def _shielded() -> bool:
    return getattr(_tl, "shield", 0) > 0


class shield:
    """Context manager: the current thread runs a recovery path, and
    the injection points it passes never trigger.  Nests."""

    def __enter__(self):
        _tl.shield = getattr(_tl, "shield", 0) + 1
        return self

    def __exit__(self, *exc):
        _tl.shield -= 1
        return False


def configure(spec: str = "", seed: int | None = None) -> FaultPlan | None:
    """Arm the global plan from a spec (empty: disarm); ``seed``
    defaults to ``FABTPU_FAULTS_SEED``.  Returns the plan."""
    global _plan
    if seed is None:
        seed_s = os.environ.get(ENV_SEED, "")
        seed = int(seed_s) if seed_s else None
    _plan = FaultPlan(spec, seed=seed) if spec else None
    return _plan


def install(plan: FaultPlan | None) -> None:
    """Arm an already-built plan (a caller holds it to read stats)."""
    global _plan
    _plan = plan


def reset() -> None:
    global _plan
    _plan = None


def plan() -> FaultPlan | None:
    return _plan


def fire(point: str, **ctx) -> None:
    """The hook: one global read when no plan is armed."""
    p = _plan
    if p is not None:
        p.fire(point, **ctx)


async def afire(point: str, **ctx) -> None:
    """The event-loop hook; call sites check ``plan() is not None``
    first, so the unarmed path makes no coroutine."""
    p = _plan
    if p is not None:
        await p.afire(point, **ctx)


def _init_from_env() -> None:
    spec = os.environ.get(ENV_SPEC, "")
    if spec:
        configure(spec)


_init_from_env()
