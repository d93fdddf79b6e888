"""Per-transaction flow journal (counterpart: ``fabric_tpu/observe/txflow.py``):
end-to-end latency from endorse to state apply, on one monotonic clock.

Each layer stamps named milestones against the journal's clock, keyed by
tx id; the first stamp of a milestone wins:

=================  ============================================
``endorse_begin``  the gateway's Endorse entered
``endorse_end``    the endorsement collected or failed
``submit``         the gateway's Submit entered
``broadcast``      the orderer acknowledged the broadcast
``included``       the block carrying the tx reached
                   ``CommitPipeline``'s commit, with its verdict
``durable``        the block's append crossed the fsync fence
                   (``BlockStore.sync`` or the applier's
                   ``ensure_synced``)
``applied``        the block's state apply (and history) completed:
                   the tx's writes are readable
=================  ============================================

Stages telescope over the milestones that landed, so ``sum(stages) ==
e2e`` exactly: ``endorse`` = endorse_begin→endorse_end, ``submit`` =
endorse_end→broadcast, ``order`` = broadcast→included, ``durable`` =
included→durable, ``apply`` = durable→applied; a missing milestone
merges its interval into the next stage present.  ``visibility_lag`` =
applied − durable, recorded when both fences were seen.

Transactions first seen at inclusion (every transaction of the port's
commit path: the port has no gateway yet) ride one per-block cohort: a
single ring record expanded to per-tx rows at read time, with O(1)
batched instrument updates a block.  Replayed blocks (``peer/replay.py``)
record inclusion to apply only, tagged ``origin="replay"``.  The sign
lane's coalescing wait feeds the ``sign_wait`` stage histogram through
:func:`sign_observer` (``SignBatcher(observer=...)``), without a tx id.

Instruments: ``tx_flow_stage_seconds{stage}``,
``tx_flow_e2e_seconds{outcome}``, ``tx_flow_visibility_lag_seconds``,
``tx_flow_flows_total{origin}`` and ``tx_flow_evicted_total``; outcome
labels are the names of ``peer/txcodes.py``.  Disarmed (the default),
every hook is one module-global read and a None check.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import Counter, OrderedDict, deque
from operator import itemgetter

_log = logging.getLogger("fabric_tpu_torch.observe.txflow")

#: completed flows retained for the readers
DEFAULT_RING = 256

#: bounded LRU of in-flight (not yet applied) flows — an abandoned
#: flow (endorse that never ordered, an orphaned submit) is evicted
#: oldest-first rather than leaking
DEFAULT_INFLIGHT = 4096

#: blocks whose included-but-not-yet-applied txid sets are held for
#: the durable/apply fence stamps (the apply queue is ~4 deep)
DEFAULT_BLOCKS = 128

#: trace exemplars armed per histogram label variant
DEFAULT_EXEMPLARS = 8

_HIST_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                 0.1, 0.25, 0.5, 1.0, 2.5, 10.0, 30.0, float("inf"))

#: milestone order; stage names are keyed by the milestone that ENDS
#: them (telescoping adjacent differences — see module docstring)
MILESTONES = ("endorse_begin", "endorse_end", "submit", "broadcast",
              "included", "durable", "applied")
_STAGE_END = {
    "endorse_end": "endorse",
    "broadcast": "submit",
    "included": "order",
    "durable": "durable",
    "applied": "apply",
}
STAGES = ("endorse", "submit", "order", "durable", "apply")


_code_names: dict[int, str] = {0: "VALID"}
#: precomputed instrument label keys (ops_metrics ``_label_key``
#: form) — the cohort publish batches its updates through the locked
#: fast path, which takes the key rather than kwargs
_STAGE_KEYS = {s: (("stage", s),) for s in
               ("endorse", "submit", "order", "durable", "apply")}
_outcome_keys: dict[int, tuple] = {}


def _code_name(code: int) -> str:
    """Verdict label for the e2e histogram / rows: the name in
    ``peer/txcodes.py`` (the proto enum's), else ``code<N>``
    (memoized — cohort expansion resolves per tx)."""
    code = int(code)
    name = _code_names.get(code)
    if name is None:
        from fabric_tpu_torch.peer.txcodes import TxValidationCode

        try:
            name = TxValidationCode(code).name
        except ValueError:
            name = f"code{code}"
        _code_names[code] = name
    return name


def _outcome_key(code: int) -> tuple:
    k = _outcome_keys.get(code)
    if k is None:
        k = _outcome_keys[code] = (("outcome", _code_name(code)),)
    return k


class FlowJournal:
    """See module docstring.  One process-global instance in
    production (:func:`global_journal`); tests construct their own
    with an injected clock and a private registry."""

    def __init__(self, registry=None, tracer=None,
                 clock=time.perf_counter, ring: int = DEFAULT_RING,
                 inflight: int = DEFAULT_INFLIGHT,
                 blocks: int = DEFAULT_BLOCKS,
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
        self._inflight_max = max(1, int(inflight))
        self._blocks_max = max(1, int(blocks))
        #: tx_id → flow entry {"t": {milestone: ts}, ...} (LRU order).
        #: GATEWAY-origin flows only — commit-side txs never open
        #: per-tx entries (they ride block cohorts, below), so a
        #: commit-heavy peer's armed cost stays O(1) per block
        self._inflight: OrderedDict[str, dict] = OrderedDict()
        #: block num → cohort awaiting the durable/apply fences:
        #: {"num", "channel", "origin", "t_inc", "t_dur", "known":
        #: [tx_id with a live gateway entry], "partial": [(tx_id,
        #: code) first seen at inclusion — they share the block's
        #: included/durable/applied timestamps by construction]}
        self._blocks: OrderedDict[int, dict] = OrderedDict()
        self._done: deque = deque(maxlen=max(1, int(ring)))
        #: recent sign-lane waits (ms) — histogram-only feed (no
        #: tx_id on the flusher thread), summarized in stats()
        self._sign_waits: deque = deque(maxlen=max(1, int(ring)))
        self._evicted = 0
        #: per-completed-flow SLO feed — ``feed(e2e_s, valid)``; set
        #: by the arming layer (the reference's node wires its commit
        #: SLO engine here), called outside the journal lock
        self.slo_feed = None
        kw = dict(buckets=_HIST_BUCKETS, exemplars=int(exemplars))
        self._stage_h = registry.histogram(
            "tx_flow_stage_seconds",
            "per-tx flow stage durations (s) by stage, telescoped "
            "over the journal's monotonic milestones",
            **kw,
        )
        self._e2e_h = registry.histogram(
            "tx_flow_e2e_seconds",
            "per-tx end-to-end wall (s; first milestone → applied) "
            "by validation outcome",
            **kw,
        )
        self._lag_h = registry.histogram(
            "tx_flow_visibility_lag_seconds",
            "apply-visible minus durable-append per tx (s) — the "
            "async committer's read-your-writes window",
            **kw,
        )
        self._flows_ctr = registry.counter(
            "tx_flow_flows_total",
            "completed tx flows by origin (gateway/commit/replay)",
        )
        self._evicted_ctr = registry.counter(
            "tx_flow_evicted_total",
            "abandoned in-flight flows evicted by the LRU bound",
        )
        #: every instrument of one registry shares its lock — the
        #: cohort publish batches all its updates under ONE
        #: acquisition of it (observe_repeat_locked / add_locked)
        self._metrics_lock = self._stage_h._lock

    # -- entry management (callers hold self._lock) -------------------------

    def _entry(self, tx_id: str, origin: str) -> dict:
        ent = self._inflight.get(tx_id)
        if ent is None:
            ent = {"tx_id": tx_id, "t": {}, "origin": origin}
            self._inflight[tx_id] = ent
            while len(self._inflight) > self._inflight_max:
                self._inflight.popitem(last=False)
                self._evicted += 1
                self._evicted_ctr.add(1)
        else:
            self._inflight.move_to_end(tx_id)
        return ent

    @staticmethod
    def _stamp(ent: dict, milestone: str, t: float) -> None:
        ent["t"].setdefault(milestone, t)

    # -- milestone hooks ----------------------------------------------------

    def endorse_begin(self, tx_id: str) -> None:
        t = self.clock()
        with self._lock:
            self._stamp(self._entry(tx_id, "gateway"), "endorse_begin", t)

    def endorse_end(self, tx_id: str, ok: bool = True) -> None:
        t = self.clock()
        done = None
        with self._lock:
            ent = self._entry(tx_id, "gateway")
            self._stamp(ent, "endorse_end", t)
            if not ok:
                # a failed endorsement is the flow's terminal event —
                # complete now (outcome endorse_error) instead of
                # waiting for an inclusion that can never come
                self._inflight.pop(tx_id, None)
                done = self._complete_locked(ent, t,
                                             outcome="ENDORSE_ERROR")
        if done is not None:
            self._publish(*done, valid=False)

    def submit_begin(self, tx_id: str) -> None:
        t = self.clock()
        with self._lock:
            self._stamp(self._entry(tx_id, "gateway"), "submit", t)

    def broadcast_done(self, tx_id: str) -> None:
        t = self.clock()
        with self._lock:
            self._stamp(self._entry(tx_id, "gateway"), "broadcast", t)

    def sign_event(self, wait_ms, busy: bool) -> None:
        """One sign-lane request event (``SignBatcher.observer``
        contract): flushed requests carry their coalescing-window
        wait; BUSY bounces carry None and are not a latency sample.
        No tx attribution — the wait is inside the endorse stage."""
        if busy or wait_ms is None:
            return
        self._sign_waits.append(round(float(wait_ms), 4))
        self._stage_h.observe(float(wait_ms) / 1000.0, stage="sign_wait")

    def block_included(self, num: int, txs, channel: str = "",
                       replay: bool = False) -> None:
        """One block reached commit: stamp inclusion + verdict for
        every ``(tx_id, code)`` in ``txs``.  The journal takes
        OWNERSHIP of ``txs`` (callers build it fresh per block, as
        the pipeline hook does) and empty tx_ids must already be
        filtered out.  Unknown tx_ids open PARTIAL records; under
        ``replay`` every record is opened fresh — replayed blocks
        must never inherit (or fake) endorse stamps from a colliding
        live flow."""
        t = self.clock()
        num_i = int(num)
        with self._lock:
            known: list = []
            if replay or not self._inflight:
                # the commit-heavy fast path: no gateway flow can
                # match (replay must not match even if one could), so
                # every tx shares the block's timestamps — no per-tx
                # walk, no per-tx entries, no LRU traffic
                partial = txs
            else:
                partial = []
                inflight = self._inflight
                for tp in txs:
                    tx_id = tp[0]
                    if not tx_id:
                        continue
                    ent = inflight.get(tx_id)
                    if ent is None:
                        partial.append(tp)
                        continue
                    tt = ent["t"]
                    if "included" not in tt:
                        tt["included"] = t
                    ent["block"] = num_i
                    ent["code"] = int(tp[1])
                    if channel:
                        ent["channel"] = channel
                    known.append(tx_id)
            if known or partial:
                self._blocks[num_i] = {
                    "num": num_i, "channel": channel,
                    "origin": "replay" if replay else "commit",
                    "t_inc": t, "t_dur": None,
                    "known": known, "partial": partial,
                }
                while len(self._blocks) > self._blocks_max:
                    self._blocks.popitem(last=False)

    def block_durable(self, num: int) -> None:
        """The block's append crossed the fsync fence (serial
        ``blocks.sync`` or the applier's ``ensure_synced``) —
        idempotent, first fence wins."""
        t = self.clock()
        with self._lock:
            c = self._blocks.get(int(num))
            if c is None:
                return
            if c["t_dur"] is None:
                c["t_dur"] = t
            for tx_id in c["known"]:
                ent = self._inflight.get(tx_id)
                if ent is not None:
                    self._stamp(ent, "durable", t)

    def block_applied(self, num: int) -> None:
        """State apply (+ history) for the block completed: every
        included tx of the block becomes READABLE — complete its
        flows, record histograms, feed the commit SLOs.  Gateway
        flows complete per tx (their endorse/submit stamps differ);
        the partial cohort completes as ONE ring record + O(1)
        batched instrument updates — every member shares the block's
        included/durable/applied interval by construction."""
        t = self.clock()
        completed = []
        crow_pub = None
        with self._lock:
            c = self._blocks.pop(int(num), None)
            if c is None:
                return
            for tx_id in c["known"]:
                ent = self._inflight.pop(tx_id, None)
                if ent is None:
                    continue
                self._stamp(ent, "applied", t)
                completed.append(self._complete_locked(ent, t))
            if c["partial"]:
                crow_pub = self._complete_cohort_locked(c, t)
        for row, pub in completed:
            self._publish(row, pub, valid=row["code"] == 0)
        if crow_pub is not None:
            self._publish_cohort(*crow_pub)

    # -- completion ---------------------------------------------------------

    def _complete_locked(self, ent: dict, t_end: float,
                         outcome: str | None = None):
        """Telescope the present milestones into stages (identity:
        stages sum EXACTLY to e2e — one clock, adjacent differences)
        and append the completed row.  Caller holds the lock.
        Returns ``(row, pub)`` — ``pub`` carries the raw-seconds
        values for :meth:`_publish`, kept OFF the ring row so a
        publish never mutates a dict a reader may be copying."""
        ts = ent["t"]
        present = [(m, ts[m]) for m in MILESTONES if m in ts]
        t0 = present[0][1]
        stages = {}
        prev = t0
        for m, t in present[1:]:
            stage = _STAGE_END.get(m)
            if stage is not None:
                stages[stage] = max(0.0, t - prev)
                prev = t
        e2e = max(0.0, t_end - t0)
        code = int(ent.get("code", -1))
        lag = None
        if "durable" in ts and "applied" in ts:
            lag = max(0.0, ts["applied"] - ts["durable"])
        row = {
            "t_s": round(self.clock(), 6),
            "tx_id": ent["tx_id"],
            "origin": ent.get("origin", "commit"),
            "outcome": outcome if outcome is not None else _code_name(code),
            "code": code,
            "block": ent.get("block"),
            "channel": ent.get("channel", ""),
            "e2e_ms": round(e2e * 1000.0, 4),
            "stages_ms": {k: round(v * 1000.0, 4)
                          for k, v in stages.items()},
            "visibility_lag_ms": (None if lag is None
                                  else round(lag * 1000.0, 4)),
            "milestones": {m: round(t - t0, 6) for m, t in present},
            "partial": "endorse_begin" not in ts,
        }
        self._done.append(row)
        return row, (stages, e2e, lag)

    def _complete_cohort_locked(self, c: dict, t_app: float):
        """One completed-COHORT ring record for a block's partial
        flows: they were all first seen at inclusion, so every member
        shares included/durable/applied — per-tx rows are expanded
        lazily by the readers (:meth:`_expand_cohort`).  Caller holds
        the lock.  Returns ``(crow, pub)`` for
        :meth:`_publish_cohort`."""
        t_inc = c["t_inc"]
        t_dur = c["t_dur"]
        stages = {}
        lag = None
        if t_dur is not None:
            stages["durable"] = max(0.0, t_dur - t_inc)
            stages["apply"] = max(0.0, t_app - t_dur)
            lag = max(0.0, t_app - t_dur)
        else:
            stages["apply"] = max(0.0, t_app - t_inc)
        e2e = max(0.0, t_app - t_inc)
        milestones = {"included": 0.0}
        if t_dur is not None:
            milestones["durable"] = round(t_dur - t_inc, 6)
        milestones["applied"] = round(t_app - t_inc, 6)
        crow = {
            "_cohort": True,
            # verdict counts, computed ONCE here (before the record
            # is reachable from the ring) — publish and stats() both
            # read them instead of re-walking the tx list
            "codes": dict(Counter(map(itemgetter(1), c["partial"]))),
            "t_s": round(t_app, 6),
            "origin": c["origin"],
            "block": c["num"],
            "channel": c["channel"],
            "e2e_ms": round(e2e * 1000.0, 4),
            "stages_ms": {k: round(v * 1000.0, 4)
                          for k, v in stages.items()},
            "visibility_lag_ms": (None if lag is None
                                  else round(lag * 1000.0, 4)),
            "milestones": milestones,
            "partial": True,
            "txs": c["partial"],
            "n": len(c["partial"]),
        }
        self._done.append(crow)
        return crow, (stages, e2e, lag)

    @staticmethod
    def _expand_cohort(crow: dict) -> list:
        """Per-tx rows from one cohort record (read-time only — the
        hot path never pays for this)."""
        shared = {k: v for k, v in crow.items()
                  if k not in ("_cohort", "txs", "n", "codes")}
        out = []
        for tx_id, code in crow["txs"]:
            r = dict(shared)
            r["tx_id"] = tx_id
            r["code"] = int(code)
            r["outcome"] = _code_name(int(code))
            out.append(r)
        return out

    def _publish(self, row: dict, pub, valid: bool) -> None:
        """Registry + SLO side effects of one completed flow, OUTSIDE
        the journal lock (histograms and the SLO engine take their
        own locks)."""
        stages, e2e, lag = pub
        blk = row.get("block")
        chan = row.get("channel", "")
        ref = None if blk is None else (f"{chan}:{blk}" if chan else str(blk))
        for stage, dur in stages.items():
            self._stage_h.observe(dur, exemplar=ref, stage=stage)
        self._e2e_h.observe(e2e, exemplar=ref, outcome=row["outcome"])
        if lag is not None:
            self._lag_h.observe(lag, exemplar=ref)
        self._flows_ctr.add(1, origin=row["origin"])
        feed = self.slo_feed
        if feed is not None:
            try:
                feed(e2e, valid)
            except Exception as e:
                _log.debug("commit SLO feed failed: %s", e)

    def _publish_cohort(self, crow: dict, pub) -> None:
        """Batched registry + SLO side effects for a whole partial
        cohort, OUTSIDE the journal lock: O(1) instrument updates per
        block regardless of its tx count (observe_repeat), one
        exemplar per block — this is what keeps the default-ON armed
        cost flat on the commit path."""
        stages, e2e, lag = pub
        n = crow["n"]
        codes = crow["codes"]
        blk = crow["block"]
        chan = crow["channel"]
        ref = f"{chan}:{blk}" if chan else str(blk)
        with self._metrics_lock:
            for stage, dur in stages.items():
                self._stage_h.observe_repeat_locked(
                    dur, n, _STAGE_KEYS[stage], exemplar=ref
                )
            for code, cnt in codes.items():
                self._e2e_h.observe_repeat_locked(
                    e2e, cnt, _outcome_key(code), exemplar=ref
                )
            if lag is not None:
                self._lag_h.observe_repeat_locked(lag, n, (), exemplar=ref)
            self._flows_ctr.add_locked(n, (("origin", crow["origin"]),))
        feed = self.slo_feed
        if feed is not None:
            try:
                for code, cnt in codes.items():
                    feed(e2e, code == 0, cnt)
            except Exception as e:
                _log.debug("commit SLO feed failed: %s", e)

    # -- readers ------------------------------------------------------------

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
        """Stage / e2e / visibility-lag percentiles over the retained
        completed flows — the journal's summary and a bench's
        ``extras.tx_flow`` payload."""
        with self._lock:
            rows = list(self._done)
            inflight = len(self._inflight)
            evicted = self._evicted
            sign_waits = list(self._sign_waits)
        stages: dict[str, list] = {}
        e2e: dict[str, list] = {}
        lags: list = []
        partial = replayed = total = 0
        for r in rows:
            if r.get("_cohort"):
                n = r["n"]
                total += n
                partial += n
                if r["origin"] == "replay":
                    replayed += n
                for k, v in r["stages_ms"].items():
                    stages.setdefault(k, []).extend([v] * n)
                for code, cnt in r["codes"].items():
                    e2e.setdefault(_code_name(code), []).extend(
                        [r["e2e_ms"]] * cnt
                    )
                if r["visibility_lag_ms"] is not None:
                    lags.extend([r["visibility_lag_ms"]] * n)
                continue
            total += 1
            for k, v in r["stages_ms"].items():
                stages.setdefault(k, []).append(v)
            e2e.setdefault(r["outcome"], []).append(r["e2e_ms"])
            if r["visibility_lag_ms"] is not None:
                lags.append(r["visibility_lag_ms"])
            if r["partial"]:
                partial += 1
            if r["origin"] == "replay":
                replayed += 1
        return {
            "flows_completed": total,
            "flows_inflight": inflight,
            "flows_evicted": evicted,
            "flows_partial": partial,
            "flows_replayed": replayed,
            "stages_ms": {s: self._pcts(stages[s])
                          for s in sorted(stages)},
            "e2e_ms": {o: self._pcts(e2e[o]) for o in sorted(e2e)},
            "visibility_lag_ms": self._pcts(lags),
            "sign_wait_ms": self._pcts(sign_waits),
        }

    def rows(self, n: int | None = None) -> list[dict]:
        """The newest ``n`` completed flows (oldest first), cohort
        records expanded to per-tx rows at read time; ``n <= 0``
        means none — NOT everything (``rows[-0:]`` would invert the
        bound)."""
        with self._lock:
            raw = list(self._done)
        rows: list[dict] = []
        for r in raw:
            if r.get("_cohort"):
                rows.extend(self._expand_cohort(r))
            else:
                rows.append(r)
        if n is not None:
            rows = rows[-n:] if n > 0 else []
        return rows

    def lookup(self, tx_id: str) -> dict | None:
        """One flow's full milestone record: a completed row when the
        flow finished (cohort members expanded on the fly), else a
        live in-flight snapshot — a gateway entry, or a cohort member
        between inclusion and apply."""
        with self._lock:
            for r in reversed(self._done):
                if r.get("_cohort"):
                    for tx, code in r["txs"]:
                        if tx == tx_id:
                            row = {k: v for k, v in r.items()
                                   if k not in ("_cohort", "txs", "n",
                                                "codes")}
                            row["tx_id"] = tx_id
                            row["code"] = int(code)
                            row["outcome"] = _code_name(int(code))
                            return row
                elif r["tx_id"] == tx_id:
                    return dict(r)
            ent = self._inflight.get(tx_id)
            if ent is not None:
                ts = ent["t"]
                present = [(m, ts[m]) for m in MILESTONES if m in ts]
                t0 = present[0][1] if present else 0.0
                return {
                    "tx_id": tx_id,
                    "origin": ent.get("origin", "commit"),
                    "block": ent.get("block"),
                    "channel": ent.get("channel", ""),
                    "code": ent.get("code"),
                    "inflight": True,
                    "milestones": {m: round(t - t0, 6)
                                   for m, t in present},
                }
            for num in reversed(self._blocks):
                c = self._blocks[num]
                for tx, code in c["partial"]:
                    if tx == tx_id:
                        ms = {"included": 0.0}
                        if c["t_dur"] is not None:
                            ms["durable"] = round(
                                c["t_dur"] - c["t_inc"], 6
                            )
                        return {
                            "tx_id": tx_id,
                            "origin": c["origin"],
                            "block": c["num"],
                            "channel": c["channel"],
                            "code": int(code),
                            "inflight": True,
                            "milestones": ms,
                        }
        return None

    def report(self, rows: int = 16) -> dict:
        out = self.stats()
        out["recent"] = self.rows(rows)
        return out


# -- process-global handle + the layer hooks ---------------------------------

_global: FlowJournal | None = None
#: refcount for component lifecycles (acquire/release) — colocated
#: nodes share ONE journal and only the last release disarms
_refs = 0


def global_journal() -> FlowJournal | None:
    return _global


def enabled() -> bool:
    """One module-global read: callers that must build per-tx payloads
    for a hook (the pipeline's verdict list) gate on this so the
    disarmed path stays structurally zero."""
    return _global is not None


# Each hook is written out longhand (one global read, one None check,
# a direct method call inside a containment try) rather than through a
# generic getattr dispatcher — these sit on the endorse and commit hot
# paths, and a commit/endorse must never die of its own attribution.


def endorse_begin(tx_id: str) -> None:
    j = _global
    if j is None:
        return
    try:
        j.endorse_begin(tx_id)
    except Exception as e:
        _log.debug("txflow endorse_begin hook failed: %s", e)


def endorse_end(tx_id: str, ok: bool = True) -> None:
    j = _global
    if j is None:
        return
    try:
        j.endorse_end(tx_id, ok)
    except Exception as e:
        _log.debug("txflow endorse_end hook failed: %s", e)


def submit_begin(tx_id: str) -> None:
    j = _global
    if j is None:
        return
    try:
        j.submit_begin(tx_id)
    except Exception as e:
        _log.debug("txflow submit_begin hook failed: %s", e)


def broadcast_done(tx_id: str) -> None:
    j = _global
    if j is None:
        return
    try:
        j.broadcast_done(tx_id)
    except Exception as e:
        _log.debug("txflow broadcast_done hook failed: %s", e)


def block_included(num: int, txs, channel: str = "",
                   replay: bool = False) -> None:
    j = _global
    if j is None:
        return
    try:
        j.block_included(num, txs, channel=channel, replay=replay)
    except Exception as e:
        _log.debug("txflow block_included hook failed: %s", e)


def block_durable(num: int) -> None:
    j = _global
    if j is None:
        return
    try:
        j.block_durable(num)
    except Exception as e:
        _log.debug("txflow block_durable hook failed: %s", e)


def block_applied(num: int) -> None:
    j = _global
    if j is None:
        return
    try:
        j.block_applied(num)
    except Exception as e:
        _log.debug("txflow block_applied hook failed: %s", e)


def sign_observer():
    """→ a ``SignBatcher.observer`` callable feeding the journal's
    ``sign_wait`` stage.  Resolves the global per CALL, so the same
    attached observer goes quiet when the journal disarms (one global
    read + None check per event, like every other hook)."""

    def observer(wait_ms, busy):
        j = _global
        if j is None:
            return
        try:
            j.sign_event(wait_ms, busy)
        except Exception as e:
            _log.debug("txflow sign observer failed: %s", e)

    return observer


def acquire(**kw) -> FlowJournal:
    """Refcounted arming (a component's start/stop pairs this with
    :func:`release`): the first acquire builds the journal with its
    :func:`configure` kwargs; later acquires REUSE the live instance
    (first-arm wins), and only the last release disarms."""
    global _refs
    j = _global if _global is not None else configure(**kw)
    _refs += 1
    return j


def release() -> None:
    """Drop one :func:`acquire` hold; the last one out disarms."""
    global _refs
    if _refs > 0:
        _refs -= 1
        if _refs == 0:
            configure(enabled=False)


def configure(enabled: bool = True, registry=None, tracer=None,
              clock=time.perf_counter, ring: int = DEFAULT_RING,
              inflight: int = DEFAULT_INFLIGHT,
              blocks: int = DEFAULT_BLOCKS,
              exemplars: int = DEFAULT_EXEMPLARS,
              ) -> FlowJournal | None:
    """Arm (or, with ``enabled=False``, disarm) the process-global
    journal.  Disarming
    zeroes the acquire refcount (the hard OFF)."""
    global _global, _refs
    if not enabled:
        _refs = 0
        _global = None
        return None
    _global = FlowJournal(registry=registry, tracer=tracer, clock=clock,
                          ring=ring, inflight=inflight, blocks=blocks,
                          exemplars=exemplars)
    return _global
