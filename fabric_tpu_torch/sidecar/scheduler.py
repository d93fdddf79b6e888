"""Weighted deficit round-robin admission for the validation sidecar
(counterpart: ``fabric_tpu/sidecar/scheduler.py``).  ``stats()`` holds
the tenants' numbers; the registry (``registry=``, else the global one)
gets the reference's ``sidecar_queue_depth``, ``sidecar_tenant_share``,
``sidecar_tenant_deficit`` gauges, ``sidecar_queue_age_seconds`` and the
``sidecar_busy_total`` and ``sidecar_shed_total`` counters, each bumped
outside the scheduler's lock.

Every tenant registers with a ``weight``; each visit of the rotation to
a backlogged tenant credits its deficit ``weight * quantum`` signatures
and drains whole requests while the deficit covers their cost, so
served signature shares converge to the weight ratio under backlog.
Every tenant's queue is bounded (``queue_limit`` requests): ``submit``
returns False when it is full, or when the tenant is in shed mode, and
the server answers a typed BUSY frame.  Plain locked data, no asyncio:
the server's event loop drives it and tests drive it directly.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

from fabric_tpu_torch.utils.stats import nearest_rank

#: deficit credit per unit weight per round: about one 1000-tx block's
#: 2-of-3 signature batch
DEFAULT_QUANTUM = 4096


@dataclass
class Request:
    """One queued signature batch; the scheduler reads only ``cost``
    (``root``: the server's trace root; ``trace``: the peer's trace
    context the request carried)."""

    tenant: str
    seq: int
    items: list
    stream: object = None
    root: object = None
    trace: dict | None = None
    t_enqueue: float = 0.0
    cost: int = field(default=0)

    def __post_init__(self):
        if not self.cost:
            self.cost = max(1, len(self.items))


class _Tenant:
    __slots__ = ("name", "weight", "queue", "deficit", "served_cost", "enqueued", "rejected",
                 "shed_count", "refs", "ages")

    def __init__(self, name: str, weight: float):
        self.name = name
        self.weight = float(weight)
        self.queue: deque = deque()
        self.deficit = 0.0
        self.served_cost = 0
        self.enqueued = 0
        self.rejected = 0
        self.shed_count = 0
        self.refs = 1  # connections sharing this tenant entry
        self.ages: deque = deque(maxlen=256)  # trailing seconds in queue


class WeightedScheduler:
    """Thread-safe; every public method takes the one lock briefly."""

    def __init__(self, queue_limit: int = 8, quantum: int = DEFAULT_QUANTUM,
                 registry=None, clock=time.perf_counter):
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.queue_limit = int(queue_limit)
        self.quantum = int(quantum)
        self.clock = clock
        self._lock = threading.Lock()
        self._tenants: dict[str, _Tenant] = {}
        self._order: list[str] = []  # registration order = DRR rotation
        self._rr = 0
        self._carry: str | None = None  # tenant parked mid-credit
        self._shed: set[str] = set()
        # totals of fully disconnected tenants, restored on re-register
        self._retired: dict[str, dict] = {}
        if registry is None:
            from fabric_tpu_torch.ops_metrics import global_registry

            registry = global_registry()
        self._depth_gauge = registry.gauge(
            "sidecar_queue_depth",
            "requests waiting in a tenant's sidecar admission queue",
        )
        self._share_gauge = registry.gauge(
            "sidecar_tenant_share",
            "tenant's fraction of signatures served by the sidecar",
        )
        self._age_hist = registry.histogram(
            "sidecar_queue_age_seconds",
            "time a request waited in its tenant's admission queue "
            "before the DRR drain picked it",
        )
        self._deficit_gauge = registry.gauge(
            "sidecar_tenant_deficit",
            "tenant's current deficit credit (signatures) in the "
            "weighted-deficit-round-robin rotation",
        )
        self._busy_ctr = registry.counter(
            "sidecar_busy_total",
            "requests rejected at a full tenant admission queue "
            "(answered with a typed BUSY frame)",
        )
        self._shed_ctr = registry.counter(
            "sidecar_shed_total",
            "requests turned away by autopilot shed mode (answered "
            "with a typed BUSY frame + retry-after)",
        )

    # -- tenant lifecycle --------------------------------------------------

    def register(self, name: str, weight: float = 1.0) -> None:
        if weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0")
        with self._lock:
            t = self._tenants.get(name)
            if t is not None:
                t.refs += 1
                t.weight = float(weight)
                return
            t = _Tenant(name, weight)
            old = self._retired.pop(name, None)
            if old is not None:
                t.served_cost = old["served_cost"]
                t.enqueued = old["enqueued"]
                t.rejected = old["rejected"]
                t.shed_count = old.get("shed_count", 0)
                t.ages.extend(old.get("_ages", ()))
            self._tenants[name] = t
            self._order.append(name)

    def set_weight(self, name: str, weight: float) -> bool:
        """Update a live registration's weight in place (deficit and
        stats kept); False when the tenant is not registered (a retired
        entry's weight is updated for its next registration)."""
        if weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0")
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                old = self._retired.get(name)
                if old is not None:
                    old["weight"] = float(weight)
                return False
            t.weight = float(weight)
            return True

    def weight(self, name: str) -> float | None:
        """A live registration's weight (None when not registered)."""
        with self._lock:
            t = self._tenants.get(name)
            return t.weight if t is not None else None

    def set_shed(self, name: str, shed: bool) -> None:
        """While shed, every arrival of the tenant is turned away; what
        was admitted still completes."""
        with self._lock:
            if shed:
                self._shed.add(name)
            else:
                self._shed.discard(name)

    def is_shed(self, name: str) -> bool:
        with self._lock:
            return name in self._shed

    def unregister(self, name: str) -> list:
        """Drop one connection's claim; when the last goes, the tenant
        leaves the rotation and its queued requests come back."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                return []
            t.refs -= 1
            if t.refs > 0:
                return []
            del self._tenants[name]
            self._order.remove(name)
            self._rr %= max(1, len(self._order))
            if self._carry == name:
                self._carry = None
            self._retired[name] = {"weight": t.weight, "served_cost": t.served_cost,
                                   "enqueued": t.enqueued, "rejected": t.rejected,
                                   "shed_count": t.shed_count, "_ages": list(t.ages)}
            orphans = list(t.queue)
            t.queue.clear()
        self._depth_gauge.set(0, tenant=name)
        return orphans

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Admit one request; False = queue full or tenant shed."""
        shed = False
        with self._lock:
            t = self._tenants.get(req.tenant)
            if t is None:
                raise KeyError(f"tenant {req.tenant!r} is not registered")
            if req.tenant in self._shed:
                t.rejected += 1
                t.shed_count += 1
                shed = True
                depth = None
            elif len(t.queue) >= self.queue_limit:
                t.rejected += 1
                depth = None
            else:
                if not req.t_enqueue:
                    req.t_enqueue = self.clock()
                t.queue.append(req)
                t.enqueued += 1
                depth = len(t.queue)
        if depth is None:
            self._busy_ctr.add(1, tenant=req.tenant)
            if shed:
                self._shed_ctr.add(1, tenant=req.tenant)
            return False
        self._depth_gauge.set(depth, tenant=req.tenant)
        return True

    # -- the DRR drain -----------------------------------------------------

    def next_batch(self, max_requests: int) -> list:
        """Pop up to ``max_requests`` requests across tenants by weighted
        deficit round-robin; empty only when nothing is queued.  A batch
        that fills while a tenant still holds credit parks the rotation
        there, so the next call resumes without re-crediting."""
        out: list = []
        touched: set = set()
        now = self.clock()
        with self._lock:
            while len(out) < max_requests:
                order = self._order
                n = len(order)
                if n == 0:
                    break
                t = None
                for k in range(n):
                    idx = (self._rr + k) % n
                    cand = self._tenants[order[idx]]
                    if cand.queue:
                        t = cand
                        self._rr = idx
                        break
                if t is None:
                    break
                if self._carry == t.name:
                    self._carry = None  # resume: credit already given
                else:
                    t.deficit += t.weight * self.quantum
                while t.queue and len(out) < max_requests and t.deficit >= t.queue[0].cost:
                    req = t.queue.popleft()
                    t.deficit -= req.cost
                    t.served_cost += req.cost
                    if req.t_enqueue:
                        t.ages.append(max(0.0, now - req.t_enqueue))
                    out.append(req)
                    touched.add(t.name)
                if not t.queue:
                    t.deficit = 0.0  # an emptied tenant banks no credit
                    self._rr = (self._rr + 1) % n
                elif t.deficit < t.queue[0].cost:
                    self._rr = (self._rr + 1) % n
                else:
                    self._carry = t.name
            total = sum(t.served_cost for t in self._tenants.values())
            gauges = {name: (len(self._tenants[name].queue),
                             self._tenants[name].served_cost / total if total else 0.0,
                             self._tenants[name].deficit)
                      for name in touched}
        for name, (depth, share, deficit) in gauges.items():
            self._depth_gauge.set(depth, tenant=name)
            self._share_gauge.set(round(share, 4), tenant=name)
            self._deficit_gauge.set(round(deficit, 1), tenant=name)
        for req in out:
            if req.t_enqueue:
                self._age_hist.observe(max(0.0, now - req.t_enqueue), tenant=req.tenant)
        return out

    # -- introspection -----------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return sum(len(t.queue) for t in self._tenants.values())

    def stats(self) -> dict:
        """{tenant: {weight, depth, served_cost, share, enqueued,
        rejected, shed_count, shed, busy_rate, deficit, queue_age_ms}};
        retired tenants keep their totals at depth 0."""
        with self._lock:
            rows, ages = {}, {}
            for name, t in self._tenants.items():
                rows[name] = {"weight": t.weight, "depth": len(t.queue),
                              "served_cost": t.served_cost, "enqueued": t.enqueued,
                              "rejected": t.rejected, "shed_count": t.shed_count,
                              "shed": name in self._shed, "deficit": round(t.deficit, 1)}
                ages[name] = list(t.ages)
            for name, old in self._retired.items():
                if name not in rows:
                    row = {k: v for k, v in old.items() if not k.startswith("_")}
                    rows[name] = {"depth": 0, "deficit": 0.0, "shed_count": 0,
                                  "shed": name in self._shed, **row}
                    ages[name] = list(old.get("_ages", ()))
            total = sum(r["served_cost"] for r in rows.values())
        for name, r in rows.items():
            r["share"] = round(r["served_cost"] / total, 4) if total else 0.0
            arrivals = r["enqueued"] + r["rejected"]
            r["busy_rate"] = round(r["rejected"] / arrivals, 4) if arrivals else 0.0
            a = sorted(ages.get(name, ()))
            r["queue_age_ms"] = {"p50": round(nearest_rank(a, 50) * 1000.0, 3),
                                 "p99": round(nearest_rank(a, 99) * 1000.0, 3), "n": len(a)}
        return dict(sorted(rows.items()))
