"""Traffic autopilot: closed-loop overload control over the SLO engine
(counterpart: ``fabric_tpu/control/autopilot.py``; the reference's
controller, rules and governance unchanged, reading the port's tracer,
launch ledger, SLO engine, scheduler and sign lane).

The reference peer survives overload by queueing and stalling; a
device fabric serving many tenants must instead *adapt*.  Every error
signal the loop needs already exists — ``observe/slo.py`` turns the
tracer's finished-block stream into rolling burn rates, the sidecar
scheduler exports per-tenant queue-age/deficit/BUSY telemetry, and
``observe/overlap.py`` scores how much of the pipeline window is
actually hidden — but until this module nothing *acted* on any of it.

:class:`Autopilot` is a periodic controller (injectable clock, like
the SLO engine) that reads those trailing signals each tick and
actuates the existing commit-path knobs through their new runtime
setters:

* **raise** ``coalesce_blocks`` when tenant queues back up (trailing
  queue-age p99 above the high band) — more blocks per device
  dispatch amortizes launch overhead exactly when there is backlog to
  amortize over;
* **shrink** ``verify_chunk`` when the p99 launch latency grows
  (smaller chunks start the device sooner and bound per-dispatch
  stall), and grow it back toward monolithic when launches are fast;
* **step** ``pipeline_depth`` down when overlap coverage says the
  deep window is wasted (host stages are not hiding device_wait, so
  the extra in-flight state buys nothing but durability lag), back up
  when coverage is high;
* **resize** ``host_stage_workers`` up when the trailing prefetch
  (host parse + staging) p99 grows — the feeder is slower than its
  device, exactly the case the staging pool exists for — and back
  toward serial staging when the feeder runs comfortably ahead
  (HostStagePool.set_workers: drain-and-rebuild at a task boundary);
* **grow** ``sign_batch_max`` when the endorsement sign lane bounces
  requests with BUSY (trailing busy rate above its band) — bigger
  batches per device flush absorb the arrival rate — and back down
  when the lane is quiet and draining fast (small batches keep the
  first-proposal latency tight);
* **tune** ``sign_batch_wait_ms`` alongside it: shrink the lane's
  coalescing window when the wait p99 says the linger has become the
  endorsement latency, and stretch it when a flowing lane keeps
  flushing nearly-empty batches (occupancy fill under its band) —
  the max-wait half of the max-batch/max-wait contract, closed-loop;
* **re-weight or BUSY-shed** tenants on fast burn: a tenant whose
  latency budget burns past the shed band is put in *shed mode* —
  the scheduler answers its arrivals with typed BUSY + retry-after
  (bounded, exactly accounted) until the backlog drains and its burn
  recovers; moderate burn halves the tenant's scheduler weight
  instead, restored once the burn clears.

Every decision is governed so the controller can never flap or drive
a knob out of its validated range:

* **hysteresis bands** — each rule actuates only above its high or
  below its low threshold; the dead band between them holds, so a
  steady signal converges to ZERO actuations;
* **per-knob cooldowns** — a knob that just moved cannot move again
  for ``cool`` seconds (spec key; default
  :data:`DEFAULT_COOLDOWN_S`), so one slow signal cannot ratchet a
  knob across its whole range inside one incident;
* **max one step per tick** — rules are evaluated in priority order
  (shed > re-weight > coalesce > chunk > depth > host workers >
  restore) and the first eligible actuation wins the tick;
* **hard clamps** — knob values move along a per-knob ladder derived
  from the operator's min/max spec; the ladder ends ARE the clamp,
  there is no code path that steps past them.

Knob bounds ride a faults-style spec string (the nodeconfig
``autopilot_knobs`` knob)::

    name[:min=..][:max=..][:cool=..] [; more knobs]

known names: ``coalesce_blocks``, ``verify_chunk``,
``pipeline_depth``, ``host_stage_workers``, ``sign_batch_max``,
``sign_batch_wait_ms``, ``weight``, ``shed`` (shed takes only
``cool=``).
Omitting a knob from the spec keeps its default bounds
(:data:`DEFAULT_KNOB_SPECS`); an empty spec means all defaults.  The
port differs from the reference in one default: ``verify_chunk``
(:data:`OPT_IN_KNOBS`) is actuated only when the spec names it.  On the
H100 a ``p256_verify`` launch of 512 or 1,024 lanes costs about one
lane's ladder (~1.35 ms), so the rule's step to smaller chunks under
device pressure adds card time instead of relieving it.

Observability: every actuation bumps
``autopilot_actuations_total{knob,direction}``, lands as a finished
root in the tracer's ``autopilot`` flight-recorder namespace
(``/trace?ns=autopilot``), and appends to the bounded decision log
the ``/autopilot`` operations endpoint serves next to the current
knob vector and the ``autopilot_enabled`` gauge.

Default OFF (nodeconfig ``autopilot=false``): tier-1 and CPU hosts
keep the exact static path — the controller object is never built.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field

_log = logging.getLogger("fabric_tpu_torch.control.autopilot")

#: knob names the spec parser accepts — an operator typo must be a
#: config error, not a silently-ignored bound
KNOWN_KNOBS = ("coalesce_blocks", "verify_chunk", "pipeline_depth",
               "host_stage_workers", "sign_batch_max",
               "sign_batch_wait_ms", "weight", "shed")

#: default per-knob bounds (overridable per knob via the spec string)
DEFAULT_KNOB_SPECS = (
    "coalesce_blocks:min=0:max=8;"
    "verify_chunk:min=512:max=4096;"
    "pipeline_depth:min=2:max=4;"
    "host_stage_workers:min=0:max=4;"
    "sign_batch_max:min=64:max=4096;"
    "sign_batch_wait_ms:min=0.5:max=16;"
    "weight:min=0.125:max=8;"
    "shed"
)

#: knobs in the defaults that the controller drives only when the
#: operator's spec names them (see the module docstring)
OPT_IN_KNOBS = ("verify_chunk",)

#: seconds a knob rests after an actuation (spec key ``cool=``)
DEFAULT_COOLDOWN_S = 10.0

#: decisions retained for /autopilot
DECISION_LOG = 64

#: default hysteresis bands — the dead band between each (lo, hi)
#: pair is the no-flap guarantee
DEFAULT_BANDS = {
    "queue_hi_ms": 50.0,   # queue-age p99 above → coalesce up
    "queue_lo_ms": 5.0,    # below → coalesce down
    "launch_hi_ms": 250.0,  # launch p99 above → shrink verify_chunk
    "launch_lo_ms": 50.0,   # below → grow it back
    "devq_hi_ms": 25.0,    # ledger device-queue p99 above → shrink
                           # verify_chunk (launches queue behind each
                           # other on the device lane)
    "devq_lo_ms": 2.0,     # below → grow it back toward monolithic
    "coverage_lo": 0.25,   # overlap coverage below → depth down
    "coverage_hi": 0.85,   # above → depth up
    "prefetch_hi_ms": 150.0,  # prefetch (host parse) p99 above →
                              # host_stage_workers up
    "prefetch_lo_ms": 20.0,   # below → back toward serial staging
    "sign_busy_hi": 0.05,   # sign-lane BUSY rate above → batch up
    "sign_busy_lo": 0.005,  # below (and waits short) → batch down
    "sign_wait_lo_ms": 5.0,  # waits must also sit below this for a
                             # step down (a draining lane, not a
                             # momentarily idle one)
    "sign_wait_hi_ms": 10.0,  # wait p99 above → shrink the
                              # coalescing window (wait_ms down)
    "sign_fill_lo": 0.25,   # occupancy p50 / batch_max below (lane
                            # flowing) → linger longer (wait_ms up)
    "apply_hi_ms": 100.0,  # state-apply queue age above → the
                           # applier is the bottleneck: coalesce
                           # DOWN (bigger groups only grow the lag)
    "apply_lo_ms": 10.0,   # below → the apply lane is keeping up;
                           # the coalesce rule is free to act on
                           # admission-queue age again
    "burn_hi": 1.5,        # tenant burn above → halve its weight
    "burn_lo": 0.5,        # below → restore toward its hello weight
    "shed_hi": 4.0,        # tenant fast burn above → shed mode ON
    "shed_lo": 1.0,        # burn below (or aged out) → shed mode OFF
}


class KnobSpecError(ValueError):
    """A malformed autopilot knob spec, phrased for the operator."""


@dataclass(frozen=True)
class KnobSpec:
    """One knob's validated actuation range (see module docstring)."""

    name: str
    lo: float = 0.0
    hi: float = 0.0
    cooldown_s: float = DEFAULT_COOLDOWN_S

    def ladder(self) -> tuple:
        """The ordered value ladder a step moves ±1 along — index 0 is
        the least-adapted end, the last index the most.  The ladder
        ends ARE the hard clamps."""
        if self.name == "coalesce_blocks":
            # 1 is meaningless (a group of one never coalesces)
            return (int(self.lo),) + tuple(
                n for n in range(max(2, int(self.lo) + 1), int(self.hi) + 1)
            )
        if self.name == "verify_chunk":
            # 0 = monolithic; "up" (adapt) moves to ever-smaller
            # chunks: 0 → hi → hi/2 → ... → lo
            out = [0]
            c = int(self.hi)
            while c >= max(1, int(self.lo)):
                out.append(c)
                c //= 2
            return tuple(out)
        if self.name == "pipeline_depth":
            return tuple(range(int(self.lo), int(self.hi) + 1))
        if self.name == "host_stage_workers":
            # 0 = serial staging (pool off); 1 is meaningless (a
            # 1-worker pool is queue overhead — resolve_host_pool
            # returns None below 2), so the ladder jumps 0 → 2
            return (int(self.lo),) + tuple(
                n for n in range(max(2, int(self.lo) + 1),
                                 int(self.hi) + 1)
            )
        if self.name == "sign_batch_max":
            # doubling rungs min → max ("up" = bigger sign batches per
            # device flush); the max is always a rung so the operator
            # cap is reachable exactly
            out = []
            c = int(self.lo)
            while c < int(self.hi):
                out.append(c)
                c *= 2
            out.append(int(self.hi))
            return tuple(out)
        if self.name == "sign_batch_wait_ms":
            # doubling float rungs min → max ("up" = linger longer in
            # the coalescing window so batches actually fill); the
            # operator's max is always a rung
            out = []
            c = float(self.lo)
            while c < float(self.hi):
                out.append(c)
                c *= 2
            out.append(float(self.hi))
            return tuple(out)
        return ()  # weight/shed are not ladder knobs


def parse_knob_specs(spec: str | None) -> dict[str, KnobSpec]:
    """``'coalesce_blocks:min=0:max=8;weight:min=0.5:max=4'`` →
    {name: KnobSpec}, defaults filled for every unnamed knob."""
    out: dict[str, KnobSpec] = {}
    named: set[str] = set()
    for operator, source in enumerate((DEFAULT_KNOB_SPECS, spec or "")):
        for part in str(source).split(";"):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            name = fields[0].strip()
            if name not in KNOWN_KNOBS:
                raise KnobSpecError(
                    f"autopilot knob spec {part!r}: unknown knob "
                    f"{name!r} (expected one of {', '.join(KNOWN_KNOBS)})"
                )
            if operator:
                named.add(name)
            kw: dict = {}
            for f in fields[1:]:
                k, sep, v = f.partition("=")
                k = k.strip()
                if not sep:
                    raise KnobSpecError(
                        f"autopilot knob spec {part!r}: expected k=v, "
                        f"got {f!r}"
                    )
                try:
                    if k == "min":
                        kw["lo"] = float(v)
                    elif k == "max":
                        kw["hi"] = float(v)
                    elif k == "cool":
                        kw["cooldown_s"] = float(v)
                    else:
                        raise KnobSpecError(
                            f"autopilot knob spec {part!r}: unknown key "
                            f"{k!r} (expected min/max/cool)"
                        )
                except ValueError as e:
                    if isinstance(e, KnobSpecError):
                        raise
                    raise KnobSpecError(
                        f"autopilot knob spec {part!r}: cannot parse "
                        f"{f!r}"
                    ) from None
            base = out.get(name)
            if base is not None:  # operator spec overrides defaults
                kw.setdefault("lo", base.lo)
                kw.setdefault("hi", base.hi)
                kw.setdefault("cooldown_s", base.cooldown_s)
            ks = KnobSpec(name=name, **kw)
            if name == "shed":
                ks = KnobSpec(name=name, cooldown_s=ks.cooldown_s)
            elif ks.hi < ks.lo:
                raise KnobSpecError(
                    f"autopilot knob spec {part!r}: max < min"
                )
            elif name == "pipeline_depth" and ks.lo < 2:
                # depth 1 is the serial oracle; the controller must
                # never cross the pipelined/serial boundary at runtime
                raise KnobSpecError(
                    f"autopilot knob spec {part!r}: pipeline_depth "
                    "min must be >= 2 (depth 1 is the serial oracle, "
                    "not a runtime target)"
                )
            elif name == "host_stage_workers" and ks.lo == 1:
                # a 1-worker pool is queue overhead with no
                # parallelism (resolve_host_pool returns None below
                # 2), and a ladder rung at 1 would actuate the
                # serial-close path while reporting a pool of one
                raise KnobSpecError(
                    f"autopilot knob spec {part!r}: "
                    "host_stage_workers min must be 0 (serial "
                    "staging) or >= 2 — a 1-worker pool does not "
                    "exist"
                )
            elif name == "sign_batch_max" and ks.lo < 1:
                raise KnobSpecError(
                    f"autopilot knob spec {part!r}: sign_batch_max "
                    "min must be >= 1 (a 0-lane sign batch does not "
                    "exist)"
                )
            elif name == "sign_batch_wait_ms" and ks.lo <= 0:
                raise KnobSpecError(
                    f"autopilot knob spec {part!r}: sign_batch_wait_ms "
                    "min must be > 0 ms (a doubling ladder cannot "
                    "leave a 0 floor; wait_ms=0 is the static "
                    "flush-immediately config, not a runtime rung)"
                )
            elif name == "weight" and ks.lo <= 0:
                raise KnobSpecError(
                    f"autopilot knob spec {part!r}: weight min must "
                    "be > 0 (the scheduler rejects non-positive "
                    "weights)"
                )
            if ks.cooldown_s < 0:
                raise KnobSpecError(
                    f"autopilot knob spec {part!r}: cool must be >= 0"
                )
            out[name] = ks
    for name in OPT_IN_KNOBS:
        if name not in named:
            out.pop(name, None)
    return out


def host_clamped_specs(knob_specs: dict, cores: int | None = None,
                       ) -> dict:
    """Clamp the ``host_stage_workers`` ladder to the machine: the
    pool itself clamps resizes to the core count, so ladder rungs
    above it would charge cooldowns and log decisions for actuations
    that can never change anything.  Returns the dict with that one
    spec replaced (a ≤1-rung result leaves the knob structurally
    inert — correct on a 1-core host)."""
    if cores is None:
        import os

        cores = os.cpu_count() or 1
    spec = knob_specs.get("host_stage_workers")
    if spec is None or spec.hi <= cores:
        return knob_specs
    out = dict(knob_specs)
    out["host_stage_workers"] = KnobSpec(
        name="host_stage_workers", lo=min(spec.lo, float(cores)),
        hi=float(cores), cooldown_s=spec.cooldown_s,
    )
    return out


def resolve_host_workers_initial(configured: int,
                                 cores: int | None = None) -> int:
    """The configured ``host_stage_workers`` knob → the worker count
    the validator actually resolved (mirrors ``resolve_host_pool``:
    −1 = one per core, clamped to cores, < 2 = serial/0) — the value
    the controller's ladder snap must start from.  Passing the raw
    −1 would snap to 0 and INVERT the knob: the first slow-feeder
    'up' step would shrink a per-core pool to 2 workers."""
    if cores is None:
        import os

        cores = os.cpu_count() or 1
    n = cores if configured < 0 else min(int(configured), cores)
    return n if n >= 2 else 0


@dataclass
class Signals:
    """One tick's trailing-signal snapshot (every field optional: an
    absent source — no scheduler attached, empty flight recorder —
    reads as None/{} and its rules simply skip)."""

    #: {(objective_name, channel): fast-window burn | None}
    burn: dict = field(default_factory=dict)
    #: {tenant: trailing queue-age p99 ms} (scheduler stats)
    queue_age_p99_ms: dict = field(default_factory=dict)
    #: {tenant: CURRENT admission-queue depth} (scheduler stats) —
    #: the live-pressure signal: trailing ages say how bad it WAS,
    #: depth says whether it still is
    queue_depth: dict = field(default_factory=dict)
    #: {tenant: served-signature share} (scheduler stats) — the
    #: consumption signal: a serial-submitting offender never builds
    #: queue depth (it waits on each verdict), but it does dominate
    #: the served share
    share: dict = field(default_factory=dict)
    #: {tenant: BUSY pushback fraction} (scheduler stats)
    busy_rate: dict = field(default_factory=dict)
    launch_p99_ms: float | None = None
    #: trailing device-lane queue-wait p99 ms off the launch ledger
    #: (observe/ledger.py) — the honest device-pressure signal: a
    #: launch that waited behind its predecessor on the device lane,
    #: measured, not inferred from launch-span p99.  None = no ledger
    #: armed (or no synced rows in the window): the chunk rule falls
    #: back to launch_p99_ms.
    device_queue_p99_ms: float | None = None
    overlap_coverage: float | None = None
    #: trailing prefetch-span (host parse + staging) p99 ms — the
    #: host_stage_workers signal: a feeder slower than its device
    #: shows up here, not in launch_p99
    prefetch_p99_ms: float | None = None
    #: sign-lane signals (SignBatcher.stats()): trailing BUSY bounce
    #: rate and submit→flush wait p99 — the sign_batch_max knob's
    #: pressure/drain pair.  None = no sign lane armed: the rule
    #: skips, so a sign-less peer charges no cooldowns and logs no
    #: phantom decisions.
    sign_busy_rate: float | None = None
    sign_wait_p99_ms: float | None = None
    #: age of the OLDEST batch waiting in the async commit engine's
    #: state-apply queue (AsyncApplyEngine.stats()) — the trailing-
    #: apply pressure signal: blocks are durable and acked, but the
    #: state DB lags by this much.  None = serial commit engine (or
    #: no channel yet): the apply rule skips entirely.
    apply_queue_age_ms: float | None = None
    #: trailing batch-occupancy p50 as a fraction of batch_max — the
    #: sign_batch_wait_ms knob's efficiency signal: a flowing lane
    #: flushing nearly-empty batches wastes device dispatches
    sign_fill: float | None = None
    clock_s: float = 0.0

    def tenant_burn(self, tenant: str) -> float | None:
        """Worst fast-window burn across objectives for one tenant's
        sidecar channel — the shed/re-weight signal."""
        chan = f"sidecar:{tenant}"
        vals = [b for (_n, c), b in self.burn.items()
                if c == chan and b is not None]
        return max(vals) if vals else None

    def worst_burn(self) -> float | None:
        vals = [b for b in self.burn.values() if b is not None]
        return max(vals) if vals else None


@dataclass
class Decision:
    """One actuation, with the signal that triggered it — the
    /autopilot decision log entry and the tracer event payload."""

    t: float
    knob: str
    direction: str        # "up" | "down" | "on" | "off"
    old: object
    new: object
    signal: str           # which trailing signal triggered it
    value: float | None   # the signal's reading
    threshold: float      # the band edge it crossed
    tenant: str = ""

    def to_dict(self) -> dict:
        d = {
            "t_s": round(self.t, 3), "knob": self.knob,
            "direction": self.direction, "from": self.old,
            "to": self.new, "signal": self.signal,
            "value": (round(self.value, 4)
                      if isinstance(self.value, float) else self.value),
            "threshold": self.threshold,
        }
        if self.tenant:
            d["tenant"] = self.tenant
        return d


def _p99(sorted_vals: list) -> float | None:
    if not sorted_vals:
        return None
    rank = math.ceil(0.99 * len(sorted_vals))
    return sorted_vals[max(0, min(len(sorted_vals) - 1, rank - 1))]


class Autopilot:
    """See module docstring.

    ``apply_knob(name, value)`` actuates the ladder knobs
    (coalesce_blocks / verify_chunk / pipeline_depth) on the live
    commit path; ``set_weight(tenant, w)`` / ``set_shed(tenant, on)``
    actuate the scheduler (None = that rule is disabled).  ``slo`` is
    the burn-rate engine, ``scheduler`` anything with the
    WeightedScheduler ``stats()`` shape, ``tracer`` the span tracer
    whose flight recorder supplies launch-latency and
    overlap-coverage trails.  Tests drive :meth:`tick` directly with
    a prebuilt :class:`Signals`; production calls :meth:`start` for
    the background thread."""

    def __init__(self, knob_specs=None, apply_knob=None, *,
                 set_weight=None, set_shed=None, slo=None,
                 scheduler=None, tracer=None, sign_source=None,
                 commit_source=None, initial=None,
                 tick_s: float = 1.0, clock=time.monotonic,
                 registry=None, enabled: bool = True, bands=None):
        if knob_specs is None or isinstance(knob_specs, str):
            knob_specs = parse_knob_specs(knob_specs)
        self.specs: dict[str, KnobSpec] = dict(knob_specs)
        self.apply_knob = apply_knob or (lambda name, value: None)
        self.set_weight = set_weight
        self.set_shed = set_shed
        self.slo = slo
        self.scheduler = scheduler
        # anything with the SignBatcher stats() shape (busy_rate +
        # wait_ms percentiles) — None on peers without a sign lane
        self.sign_source = sign_source
        # anything with the AsyncApplyEngine stats() shape
        # (oldest_age_ms) — None on serial-commit peers
        self.commit_source = commit_source
        if tracer is None:
            from fabric_tpu_torch.observe import global_tracer

            tracer = global_tracer()
        self.tracer = tracer
        self.tick_s = float(tick_s)
        self.clock = clock
        self.bands = {**DEFAULT_BANDS, **(bands or {})}
        self._lock = threading.Lock()
        # current ladder-knob values, snapped onto each ladder (the
        # configured starting point may sit between rungs)
        self.values: dict[str, object] = {}
        initial = dict(initial or {})
        for name, spec in self.specs.items():
            ladder = spec.ladder()
            if not ladder:
                continue
            want = initial.get(name, ladder[0])
            self.values[name] = min(
                ladder, key=lambda v: (abs(v - want), v)
            )
        # tenant state: live weights (first sight records the hello
        # weight as the restore target) and the shed set
        self._hello_weight: dict[str, float] = {}
        self._weights: dict[str, float] = {}
        self._shed: set[str] = set()
        self._last_act: dict[tuple, float] = {}
        # throughput-mode holds (peer/replay.py): while any are live
        # the overload knives (shed/BUSY, weight halving) stay
        # sheathed — a closed-loop replay feed keeps every queue full
        # by DESIGN, and those rules would misread full occupancy as
        # an open-loop overload incident.  Refcounted: concurrent
        # replays on different channels each take one hold.
        self._throughput_hold = 0
        self.decisions: deque = deque(maxlen=DECISION_LOG)
        self._last_signals: Signals | None = None
        self._seq = 0
        self._enabled = bool(enabled)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if registry is None:
            from fabric_tpu_torch.ops_metrics import global_registry

            registry = global_registry()
        self._act_ctr = registry.counter(
            "autopilot_actuations_total",
            "autopilot knob actuations by knob and direction",
        )
        self._enabled_gauge = registry.gauge(
            "autopilot_enabled",
            "1 while the traffic autopilot is actuating, 0 otherwise",
        )
        self._enabled_gauge.set(1 if self._enabled else 0)

    # -- enable/disable ----------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)
        self._enabled_gauge.set(1 if self._enabled else 0)

    # -- throughput mode (closed-loop replay) ------------------------------

    def hold_throughput(self) -> None:
        """Enter throughput mode: suppress the shed/BUSY and
        weight-halving overload rules while a closed-loop feed
        (chain replay) intentionally saturates the commit path.  The
        efficiency ladder rules (coalesce, verify_chunk, depth, host
        workers) keep actuating — they are exactly what tunes the
        replay toward the ceiling."""
        with self._lock:
            self._throughput_hold += 1

    def release_throughput(self) -> None:
        with self._lock:
            if self._throughput_hold > 0:
                self._throughput_hold -= 1

    @property
    def throughput_mode(self) -> bool:
        with self._lock:
            return self._throughput_hold > 0

    # -- signal acquisition ------------------------------------------------

    def read_signals(self) -> Signals:
        """Build one tick's snapshot from the live sources; each source
        is independently contained — a broken reader yields an absent
        signal, never a dead controller."""
        now = self.clock()
        s = Signals(clock_s=now)
        if self.slo is not None:
            try:
                s.burn = self.slo.burns()
            except Exception as e:
                _log.debug("autopilot: slo signal read failed: %s", e)
        if self.scheduler is not None:
            try:
                for tenant, row in self.scheduler.stats().items():
                    age = (row.get("queue_age_ms") or {})
                    if age.get("n"):
                        s.queue_age_p99_ms[tenant] = float(
                            age.get("p99", 0.0)
                        )
                    s.queue_depth[tenant] = int(row.get("depth", 0))
                    s.share[tenant] = float(row.get("share", 0.0))
                    s.busy_rate[tenant] = float(row.get("busy_rate", 0.0))
            except Exception as e:
                _log.debug("autopilot: scheduler signal read failed: %s",
                           e)
        if self.sign_source is not None:
            try:
                st = self.sign_source.stats()
                s.sign_busy_rate = float(st.get("busy_rate", 0.0))
                wait = st.get("wait_ms") or {}
                if wait.get("n"):
                    s.sign_wait_p99_ms = float(wait.get("p99") or 0.0)
                occ = st.get("occupancy") or {}
                bm = int(st.get("batch_max") or 0)
                if occ.get("n") and bm > 0:
                    s.sign_fill = float(occ.get("p50") or 0.0) / bm
            except Exception as e:
                _log.debug("autopilot: sign signal read failed: %s", e)
        if self.commit_source is not None:
            try:
                st = self.commit_source.stats()
                age = st.get("oldest_age_ms")
                if age is not None:
                    s.apply_queue_age_ms = float(age)
            except Exception as e:
                _log.debug("autopilot: commit signal read failed: %s", e)
        try:
            from fabric_tpu_torch.observe import ledger as _ledger

            led = _ledger.global_ledger()
            if led is not None:
                s.device_queue_p99_ms = led.queue_p99_ms()
        except Exception as e:
            _log.debug("autopilot: ledger signal read failed: %s", e)
        try:
            roots = self.tracer.recent_roots()
        except Exception as e:
            _log.debug("autopilot: tracer signal read failed: %s", e)
            roots = []
        if roots:
            launches = sorted(
                c.dur * 1000.0 for r in roots for c in r.children
                if c.name == "launch" and c.t1 is not None
            )
            s.launch_p99_ms = _p99(launches)
            prefetches = sorted(
                c.dur * 1000.0 for r in roots for c in r.children
                if c.name == "prefetch" and c.t1 is not None
            )
            s.prefetch_p99_ms = _p99(prefetches)
            depth = int(self.values.get("pipeline_depth", 2) or 2)
            try:
                from fabric_tpu_torch.observe import coverage_from_roots

                cov = coverage_from_roots(
                    roots, window=max(1, depth - 1)
                )
                s.overlap_coverage = cov.get("mean")
            except Exception as e:
                _log.debug("autopilot: coverage read failed: %s", e)
        return s

    # -- the control loop --------------------------------------------------

    def tick(self, signals: Signals | None = None) -> Decision | None:
        """One controller step: read (or accept) the trailing signals,
        pick at most ONE actuation per the rule priority order, apply
        it through the runtime setters.  Disabled ⇒ zero actuations,
        always."""
        if not self._enabled:
            return None
        s = signals if signals is not None else self.read_signals()
        now = s.clock_s if signals is not None else self.clock()
        with self._lock:
            self._last_signals = s
            d = self._decide(s, now)
            if d is not None:
                self._actuate(d, now)
        if d is not None and d.knob == "shed" and d.direction == "on":
            # incident edge: a shed decision IS an incident — freeze
            # the trailing series, decision log and scheduler stats so
            # the overload attributes itself.  OUTSIDE the controller
            # lock: the bundle reads this controller's own report()
            # (rare branch; the import costs nothing on ordinary
            # ticks).
            from fabric_tpu_torch.observe import blackbox

            blackbox.notify(
                "autopilot_shed", tenant=d.tenant,
                burn=d.value, threshold=d.threshold,
            )
        return d

    def _cool(self, knob: str, tenant: str, now: float) -> bool:
        spec = self.specs.get(knob)
        cool = spec.cooldown_s if spec is not None else DEFAULT_COOLDOWN_S
        last = self._last_act.get((knob, tenant), float("-inf"))
        return now - last >= cool

    def _step(self, knob: str, direction: int):
        """(old, new) one ladder step in ``direction``; None at the
        clamp — the ladder ends are unsteppable by construction."""
        ladder = self.specs[knob].ladder()
        cur = self.values[knob]
        i = ladder.index(cur)
        j = i + direction
        if j < 0 or j >= len(ladder):
            return None
        return cur, ladder[j]

    def _decide(self, s: Signals, now: float) -> Decision | None:
        b = self.bands
        # throughput mode (replay hold; caller holds self._lock so
        # read the counter raw): the overload knives below (rules 1
        # and 2) are suppressed — a closed-loop replay keeps queues
        # full on purpose, and shedding/penalizing its tenant would
        # throttle exactly the catch-up it is trying to finish.  The
        # efficiency rules (3+) still run.
        tput = self._throughput_hold > 0
        # 1) emergency shed: a tenant burning past the shed band gets
        #    BUSY + retry-after instead of queue space — but ONLY the
        #    tenant actually applying the pressure.  Under one shared
        #    device lane an overload victim burns too (its requests
        #    wait behind the offender's), so the rule requires the
        #    candidate to hold the deepest admission queue: shedding
        #    the victim would bound nothing.
        if (not tput and self.set_shed is not None
                and "shed" in self.specs and not self._shed):
            # ONE knife at a time: while a shed is active the incident
            # is already being bounded, and every other tenant's burn
            # is contaminated by it (a victim's lingering bad window +
            # its rising share would make it shed-eligible exactly as
            # the offender's bound starts working).  A second offender
            # is re-evaluated the moment the current shed lifts.
            for tenant in sorted(set(s.queue_age_p99_ms)
                                 | set(s.busy_rate)
                                 | set(s.queue_depth)
                                 | {c.split(":", 1)[1]
                                    for (_n, c) in s.burn if
                                    c.startswith("sidecar:")}):
                burn = s.tenant_burn(tenant)
                my_depth = s.queue_depth.get(tenant, 0)
                deeper_elsewhere = any(
                    d > my_depth for t2, d in s.queue_depth.items()
                    if t2 != tenant
                )
                # depth 0 does not acquit: a SERIAL offender waits on
                # each verdict and never builds a queue, yet it still
                # dominates the served share.  A burning tenant with
                # an empty queue AND someone else out-consuming it is
                # a victim remembering an incident — shedding it
                # bounds nothing.  (Depth/share-less signals skip the
                # pressure test: no scheduler means burn is all we
                # have.)
                no_pressure = (
                    tenant in s.queue_depth and my_depth == 0
                    and tenant in s.share
                    and any(v > s.share[tenant] + 1e-9
                            for t2, v in s.share.items()
                            if t2 != tenant)
                )
                if (burn is not None and burn >= b["shed_hi"]
                        and not deeper_elsewhere and not no_pressure
                        and self._cool("shed", tenant, now)):
                    return Decision(
                        t=now, knob="shed", direction="on",
                        old=False, new=True, signal="burn",
                        value=burn, threshold=b["shed_hi"],
                        tenant=tenant,
                    )
        # 2) moderate burn: halve the tenant's scheduler weight
        if (not tput and self.set_weight is not None
                and "weight" in self.specs):
            spec = self.specs["weight"]
            for tenant in sorted(set(self._weights)
                                 | {c.split(":", 1)[1]
                                    for (_n, c) in s.burn
                                    if c.startswith("sidecar:")}):
                if tenant in self._shed:
                    continue
                burn = s.tenant_burn(tenant)
                cur = self._weights.get(
                    tenant, self._hello_weight.get(tenant, 1.0)
                )
                if (burn is not None and burn >= b["burn_hi"]
                        and cur / 2.0 >= spec.lo
                        and self._cool("weight", tenant, now)):
                    return Decision(
                        t=now, knob="weight", direction="down",
                        old=cur, new=cur / 2.0, signal="burn",
                        value=burn, threshold=b["burn_hi"],
                        tenant=tenant,
                    )
        # 3) queue backlog: coalesce more blocks per dispatch — UNLESS
        #    the async commit engine's state-apply queue is itself
        #    aging past its band: then the applier (not dispatch
        #    overhead) is the bottleneck, and bigger groups only grow
        #    the trailing lag.  High apply age instead steps coalesce
        #    DOWN, shrinking the batches the applier must absorb.
        ages = [v for v in s.queue_age_p99_ms.values()]
        age_p99 = max(ages) if ages else None
        apply_age = s.apply_queue_age_ms
        apply_hot = (apply_age is not None
                     and apply_age > b["apply_hi_ms"])
        if "coalesce_blocks" in self.values and apply_hot:
            if self._cool("coalesce_blocks", "", now):
                step = self._step("coalesce_blocks", -1)
                if step is not None:
                    return Decision(
                        t=now, knob="coalesce_blocks", direction="down",
                        old=step[0], new=step[1],
                        signal="apply_queue_age_ms", value=apply_age,
                        threshold=b["apply_hi_ms"],
                    )
        elif "coalesce_blocks" in self.values and age_p99 is not None:
            if (age_p99 > b["queue_hi_ms"]
                    and self._cool("coalesce_blocks", "", now)):
                step = self._step("coalesce_blocks", +1)
                if step is not None:
                    return Decision(
                        t=now, knob="coalesce_blocks", direction="up",
                        old=step[0], new=step[1],
                        signal="queue_age_p99_ms", value=age_p99,
                        threshold=b["queue_hi_ms"],
                    )
            elif (age_p99 < b["queue_lo_ms"]
                    and self._cool("coalesce_blocks", "", now)):
                step = self._step("coalesce_blocks", -1)
                if step is not None:
                    return Decision(
                        t=now, knob="coalesce_blocks", direction="down",
                        old=step[0], new=step[1],
                        signal="queue_age_p99_ms", value=age_p99,
                        threshold=b["queue_lo_ms"],
                    )
        # 4) device pressure: smaller verify chunks.  The launch
        #    ledger's trailing queue-wait p99 is the HONEST signal
        #    (launch-span p99 mixes host staging and compile time into
        #    what it calls device pressure) — when the ledger is armed
        #    its reading drives this rule; the launch-span p99 stays
        #    as the ledger-less fallback.
        if "verify_chunk" in self.values:
            if s.device_queue_p99_ms is not None:
                sig, val = "device_queue_p99_ms", s.device_queue_p99_ms
                hi, lo = b["devq_hi_ms"], b["devq_lo_ms"]
            else:
                sig, val = "launch_p99_ms", s.launch_p99_ms
                hi, lo = b["launch_hi_ms"], b["launch_lo_ms"]
        else:
            val = None
        if "verify_chunk" in self.values and val is not None:
            if val > hi and self._cool("verify_chunk", "", now):
                step = self._step("verify_chunk", +1)
                if step is not None:
                    return Decision(
                        t=now, knob="verify_chunk", direction="up",
                        old=step[0], new=step[1],
                        signal=sig, value=val, threshold=hi,
                    )
            elif val < lo and self._cool("verify_chunk", "", now):
                step = self._step("verify_chunk", -1)
                if step is not None:
                    return Decision(
                        t=now, knob="verify_chunk", direction="down",
                        old=step[0], new=step[1],
                        signal=sig, value=val, threshold=lo,
                    )
        # 5) wasted window: step pipeline depth down (up on recovery)
        if ("pipeline_depth" in self.values
                and s.overlap_coverage is not None):
            if (s.overlap_coverage < b["coverage_lo"]
                    and self._cool("pipeline_depth", "", now)):
                step = self._step("pipeline_depth", -1)
                if step is not None:
                    return Decision(
                        t=now, knob="pipeline_depth", direction="down",
                        old=step[0], new=step[1],
                        signal="overlap_coverage",
                        value=s.overlap_coverage,
                        threshold=b["coverage_lo"],
                    )
            elif (s.overlap_coverage > b["coverage_hi"]
                    and self._cool("pipeline_depth", "", now)):
                step = self._step("pipeline_depth", +1)
                if step is not None:
                    return Decision(
                        t=now, knob="pipeline_depth", direction="up",
                        old=step[0], new=step[1],
                        signal="overlap_coverage",
                        value=s.overlap_coverage,
                        threshold=b["coverage_hi"],
                    )
        # 6) slow feeder: more host staging workers when the prefetch
        #    (host parse + staging) p99 grows — the pool resizes at a
        #    task boundary; back toward serial staging when the feeder
        #    is comfortably ahead of the device
        if ("host_stage_workers" in self.values
                and s.prefetch_p99_ms is not None):
            if (s.prefetch_p99_ms > b["prefetch_hi_ms"]
                    and self._cool("host_stage_workers", "", now)):
                step = self._step("host_stage_workers", +1)
                if step is not None:
                    return Decision(
                        t=now, knob="host_stage_workers",
                        direction="up", old=step[0], new=step[1],
                        signal="prefetch_p99_ms",
                        value=s.prefetch_p99_ms,
                        threshold=b["prefetch_hi_ms"],
                    )
            elif (s.prefetch_p99_ms < b["prefetch_lo_ms"]
                    and self._cool("host_stage_workers", "", now)):
                step = self._step("host_stage_workers", -1)
                if step is not None:
                    return Decision(
                        t=now, knob="host_stage_workers",
                        direction="down", old=step[0], new=step[1],
                        signal="prefetch_p99_ms",
                        value=s.prefetch_p99_ms,
                        threshold=b["prefetch_lo_ms"],
                    )
        # 6b) sign-lane pressure: BUSY bounces mean the admission
        #     window (2 × batch_max) is too small for the endorsement
        #     arrival rate — bigger batches per flush absorb it; step
        #     back down only when the lane is both quiet (busy ≈ 0)
        #     AND draining fast (wait p99 under its band), so a
        #     momentarily idle lane doesn't shrink into the next burst
        if ("sign_batch_max" in self.values
                and s.sign_busy_rate is not None):
            if (s.sign_busy_rate > b["sign_busy_hi"]
                    and self._cool("sign_batch_max", "", now)):
                step = self._step("sign_batch_max", +1)
                if step is not None:
                    return Decision(
                        t=now, knob="sign_batch_max", direction="up",
                        old=step[0], new=step[1],
                        signal="sign_busy_rate",
                        value=s.sign_busy_rate,
                        threshold=b["sign_busy_hi"],
                    )
            elif (s.sign_busy_rate < b["sign_busy_lo"]
                    and s.sign_wait_p99_ms is not None
                    and s.sign_wait_p99_ms < b["sign_wait_lo_ms"]
                    and self._cool("sign_batch_max", "", now)):
                step = self._step("sign_batch_max", -1)
                if step is not None:
                    return Decision(
                        t=now, knob="sign_batch_max",
                        direction="down", old=step[0], new=step[1],
                        signal="sign_busy_rate",
                        value=s.sign_busy_rate,
                        threshold=b["sign_busy_lo"],
                    )
        # 6c) sign-lane coalescing window (the wait_ms twin of 6b):
        #     waits stretching past their band mean the linger IS the
        #     endorsement latency — shrink the window; a flowing lane
        #     flushing nearly-empty batches (occupancy fill under its
        #     band) wastes device dispatches — linger longer so
        #     batches actually fill.  Wait p99 wins when both fire
        #     (latency rules efficiency), and both ride the usual
        #     cooldown / dead-band / clamp-ladder governance.
        if ("sign_batch_wait_ms" in self.values
                and s.sign_wait_p99_ms is not None):
            if (s.sign_wait_p99_ms > b["sign_wait_hi_ms"]
                    and self._cool("sign_batch_wait_ms", "", now)):
                step = self._step("sign_batch_wait_ms", -1)
                if step is not None:
                    return Decision(
                        t=now, knob="sign_batch_wait_ms",
                        direction="down", old=step[0], new=step[1],
                        signal="sign_wait_p99_ms",
                        value=s.sign_wait_p99_ms,
                        threshold=b["sign_wait_hi_ms"],
                    )
            elif (s.sign_fill is not None
                    and s.sign_fill < b["sign_fill_lo"]
                    and self._cool("sign_batch_wait_ms", "", now)):
                step = self._step("sign_batch_wait_ms", +1)
                if step is not None:
                    return Decision(
                        t=now, knob="sign_batch_wait_ms",
                        direction="up", old=step[0], new=step[1],
                        signal="sign_fill", value=s.sign_fill,
                        threshold=b["sign_fill_lo"],
                    )
        # 7) recovery: restore a halved weight toward its hello value
        if self.set_weight is not None and "weight" in self.specs:
            spec = self.specs["weight"]
            for tenant, cur in sorted(self._weights.items()):
                target = self._hello_weight.get(tenant, 1.0)
                if cur >= target or tenant in self._shed:
                    continue
                burn = s.tenant_burn(tenant)
                if ((burn is None or burn < b["burn_lo"])
                        and self._cool("weight", tenant, now)):
                    new = min(target, min(cur * 2.0, spec.hi))
                    return Decision(
                        t=now, knob="weight", direction="up",
                        old=cur, new=new, signal="burn",
                        value=burn, threshold=b["burn_lo"],
                        tenant=tenant,
                    )
        # 8) recovery: lift shed once the burn cleared and the queue
        #    drained (a shed tenant produces few latency samples, so
        #    an aged-out window — burn None — also counts as clear;
        #    CURRENT depth is the drain signal — trailing ages keep
        #    remembering the incident long after it ends)
        if self.set_shed is not None and "shed" in self.specs:
            for tenant in sorted(self._shed):
                burn = s.tenant_burn(tenant)
                depth = s.queue_depth.get(tenant, 0)
                if ((burn is None or burn < b["shed_lo"])
                        and depth == 0
                        and self._cool("shed", tenant, now)):
                    return Decision(
                        t=now, knob="shed", direction="off",
                        old=True, new=False, signal="burn",
                        value=burn, threshold=b["shed_lo"],
                        tenant=tenant,
                    )
        return None

    def _actuate(self, d: Decision, now: float) -> None:
        if d.knob == "shed":
            if d.new:
                self._shed.add(d.tenant)
            else:
                self._shed.discard(d.tenant)
            self.set_shed(d.tenant, bool(d.new))
        elif d.knob == "weight":
            self._weights[d.tenant] = float(d.new)
            self._hello_weight.setdefault(d.tenant, float(d.old))
            self.set_weight(d.tenant, float(d.new))
        else:
            spec = self.specs[d.knob]
            ladder = spec.ladder()
            assert d.new in ladder, (d.knob, d.new, ladder)
            self.values[d.knob] = d.new
            self.apply_knob(d.knob, d.new)
        self._last_act[(d.knob, d.tenant)] = now
        self.decisions.append(d)
        self._act_ctr.add(1, knob=d.knob, direction=d.direction)
        # the actuation trail rides its own flight-recorder namespace
        # (/trace?ns=autopilot) so decisions line up with the block
        # timeline without colliding with block numbers
        self._seq += 1
        root = self.tracer.begin_block(
            self._seq, ns="autopilot", **d.to_dict()
        )
        self.tracer.finish_block(root)
        _log.info(
            "autopilot: %s %s %s -> %s (%s=%s, threshold %s%s)",
            d.knob, d.direction, d.old, d.new, d.signal,
            d.value if d.value is not None else "n/a", d.threshold,
            f", tenant {d.tenant}" if d.tenant else "",
        )

    def observe_hello(self, tenant: str, weight: float) -> None:
        """Record a tenant's declared weight as its restore target
        (the sidecar server calls this at hello)."""
        with self._lock:
            self._hello_weight[tenant] = float(weight)
            self._weights.setdefault(tenant, float(weight))

    # -- background driver -------------------------------------------------

    def start(self) -> "Autopilot":
        if self._thread is not None:
            return self
        self._stop.clear()

        def run():
            while not self._stop.wait(self.tick_s):
                try:
                    self.tick()
                except Exception as e:  # the loop must never die
                    _log.warning("autopilot tick failed: %s", e)

        self._thread = threading.Thread(
            target=run, name="fabtpu-autopilot", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    # -- /autopilot --------------------------------------------------------

    def report(self) -> dict:
        """JSON-able snapshot for the operations endpoint: current
        knob vector, clamp ranges, tenant shed/weight state, and the
        last N decisions with their triggering signals."""
        with self._lock:
            sigs = self._last_signals
            out = {
                "enabled": self._enabled,
                "throughput_mode": self._throughput_hold > 0,
                "tick_s": self.tick_s,
                "knobs": {
                    name: {
                        "value": self.values.get(name),
                        "min": spec.lo, "max": spec.hi,
                        "ladder": list(spec.ladder()),
                        "cooldown_s": spec.cooldown_s,
                    }
                    for name, spec in sorted(self.specs.items())
                    if spec.ladder()
                },
                "tenants": {
                    "shed": sorted(self._shed),
                    "weights": dict(sorted(self._weights.items())),
                    "hello_weights": dict(
                        sorted(self._hello_weight.items())
                    ),
                },
                "decisions": [d.to_dict() for d in self.decisions],
            }
        if sigs is not None:
            out["signals"] = {
                "burn": {
                    f"{n}/{c or '-'}": (round(v, 4)
                                        if v is not None else None)
                    for (n, c), v in sorted(sigs.burn.items())
                },
                "queue_age_p99_ms": dict(
                    sorted(sigs.queue_age_p99_ms.items())
                ),
                "busy_rate": dict(sorted(sigs.busy_rate.items())),
                "launch_p99_ms": sigs.launch_p99_ms,
                "device_queue_p99_ms": sigs.device_queue_p99_ms,
                "apply_queue_age_ms": sigs.apply_queue_age_ms,
                "overlap_coverage": sigs.overlap_coverage,
                "prefetch_p99_ms": sigs.prefetch_p99_ms,
                "clock_s": round(sigs.clock_s, 3),
            }
        return out


# -- process-global handle (what /autopilot serves by default) --------------

_global: Autopilot | None = None


def global_autopilot() -> Autopilot | None:
    return _global


def set_global(ap: Autopilot | None) -> None:
    global _global
    _global = ap
