"""Deterministic fault injection (counterpart: ``fabric_tpu/faults/plan.py``).

A seedable :class:`FaultPlan` maps named injection points to fault
kinds; the code that must survive calls ``fire(point, **ctx)`` there.
The port places the ledger's four points:

==========================  ==============================================
injection point             fires
==========================  ==============================================
``ledger.fsync.before``     ``BlockStore``, right before ``os.fsync``
``ledger.fsync.after``      ``BlockStore``, right after ``os.fsync``
``ledger.apply.before``     ``AsyncApplyEngine``, before a block's apply
``ledger.apply.after``      ``AsyncApplyEngine``, after it (and history)
==========================  ==============================================

Kinds: ``raise`` (:class:`InjectedFault`) and ``latency`` (sleep
``ms``).  A plan is armed by ``configure(spec)``, which returns it, and
disarmed by ``reset()``; the spec string::

    point:kind[:p=0.5][:n=3][:after=2][:ms=50] [; more specs]

``p`` is the trigger probability per arrival, drawn from the rule's own
``random.Random`` seeded by (seed, point, kind, position), so a seeded
run replays whatever the interleaving of other points; ``n`` the
trigger budget; ``after`` the arrivals skipped first (``after=8``: the
ninth arrival fires); ``ms`` the sleep of ``latency``.  With no plan
armed ``fire`` is one global read.  The reference's triggered-fault
counter lives in its metrics registry; here ``stats()`` and ``fired()``
report it.  The reference's ``disconnect``, ``truncate`` and ``crash``
kinds, its environment variables, ``afire``, ``shield`` and crash
hooks serve points the port has not placed.
"""

from __future__ import annotations

import random
import threading
import time

_KINDS = ("raise", "latency")


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
        return True

    def fire(self, point: str, **ctx) -> None:
        """An arrival at ``point``: trigger each rule its budget and
        draw allow.  May raise or sleep."""
        for rule in self._rules.get(point, ()):
            if self._admit(rule):
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


def _trigger(rule: _Rule, point: str) -> None:
    if rule.kind == "latency":
        time.sleep(rule.ms / 1000.0)
    else:
        raise InjectedFault(point)


# -- the process-global plan ----------------------------------------------------

_plan: FaultPlan | None = None


def configure(spec: str = "", seed: int | None = None) -> FaultPlan | None:
    """Arm the global plan from a spec (empty: disarm).  Returns the
    plan."""
    global _plan
    _plan = FaultPlan(spec, seed=seed) if spec else None
    return _plan


def reset() -> None:
    global _plan
    _plan = None


def fire(point: str, **ctx) -> None:
    """The hook: one global read when no plan is armed."""
    p = _plan
    if p is not None:
        p.fire(point, **ctx)
