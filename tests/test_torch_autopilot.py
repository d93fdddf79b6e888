"""The traffic autopilot (``fabric_tpu_torch/control/autopilot.py``)
against the reference's (``fabric_tpu/control/autopilot.py``), on fake
clocks, crypto-free: knob specs (ladders, clamps, the same errors for
the same malformed specs, ``tests/test_autopilot.py``'s cases), seeded
random signal sequences through both controllers (the same decisions,
actuations and ``report()``s), the reference's bursty open-loop
overload differential (``_run_overload``) through each package's
scheduler, SLO engine, tracer and fault plan (the same shed set,
accounting and admitted work), and the run-time setters the port's
autopilot actuates, each latched at its boundary: ``CommitPipeline``'s
depth and coalescing, ``BlockValidator``'s verify chunk and staging
pool (a real pool), the sign lane's batch cap and wait and the
sidecar server's coalescing and chunk.  Decisions compare exactly."""

import json
import os
import threading
import types

import numpy as np
import pytest

import fabric_tpu.control as jcontrol
import fabric_tpu_torch.control as pcontrol
from fabric_tpu.faults import FaultPlan as JFaultPlan
from fabric_tpu.faults import InjectedFault as JInjectedFault
from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.observe import Tracer as JTracer
from fabric_tpu.observe import slo as jslo
from fabric_tpu.ops_metrics import Registry as JRegistry
from fabric_tpu.peer.validator import BlockValidator as JBlockValidator
from fabric_tpu.peer.validator import PolicyProvider as JPolicyProvider
from fabric_tpu.sidecar import scheduler as jsched
from fabric_tpu_torch.faults import FaultPlan as PFaultPlan
from fabric_tpu_torch.faults import InjectedFault as PInjectedFault
from fabric_tpu_torch.ledger.statedb import MemVersionedDB, UpdateBatch
from fabric_tpu_torch.observe import Tracer as PTracer
from fabric_tpu_torch.observe import slo as pslo
from fabric_tpu_torch.ops_metrics import Registry as PRegistry
from fabric_tpu_torch.peer.pipeline import CommitPipeline
from fabric_tpu_torch.peer.signlane import SignBatcher
from fabric_tpu_torch.peer.validator import BlockValidator, PolicyProvider
from fabric_tpu_torch.sidecar import scheduler as psched

PKGS = {
    "ref": types.SimpleNamespace(ctl=jcontrol, slo=jslo, sched=jsched, Tracer=JTracer,
                                 Registry=JRegistry, FaultPlan=JFaultPlan,
                                 InjectedFault=JInjectedFault),
    "port": types.SimpleNamespace(ctl=pcontrol, slo=pslo, sched=psched, Tracer=PTracer,
                                  Registry=PRegistry, FaultPlan=PFaultPlan,
                                  InjectedFault=PInjectedFault),
}
INITIAL = {"coalesce_blocks": 0, "verify_chunk": 0, "pipeline_depth": 2,
           "host_stage_workers": 0, "sign_batch_max": 256, "sign_batch_wait_ms": 2.0}


class Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def set(self, t: float) -> None:
        self.t = max(self.t, t)


def _specs(pkg, spec):
    ks = PKGS[pkg].ctl.parse_knob_specs(spec)
    return {n: (k.lo, k.hi, k.cooldown_s, k.ladder()) for n, k in sorted(ks.items())}


# ---------------------------------------------------------------------------
# knob specs


@pytest.mark.parametrize("spec", [
    "", "verify_chunk:min=256:max=1024;pipeline_depth:max=3:cool=2",
    "coalesce_blocks:min=2:max=4;weight:min=0.5:max=4;shed:cool=3",
    "host_stage_workers:min=2:max=6", "sign_batch_max:min=32:max=100",
    "sign_batch_wait_ms:min=1:max=6", " verify_chunk : max=8192 ; ",
])
def test_knob_specs_give_the_references_ladders(spec):
    # the port drives verify_chunk only where the spec names it (OPT_IN_KNOBS)
    want = _specs("ref", spec)
    if "verify_chunk" not in spec:
        del want["verify_chunk"]
    assert _specs("port", spec) == want
    ks = {p: PKGS[p].ctl.parse_knob_specs(spec) for p in PKGS}
    for cores in (1, 3, 16):
        got, want = (PKGS[p].ctl.host_clamped_specs(ks[p], cores=cores) for p in ("port", "ref"))
        assert got["host_stage_workers"].ladder() == want["host_stage_workers"].ladder()
    for configured in (-1, 0, 1, 3, 16):
        for cores in (1, 2, 8):
            assert (pcontrol.resolve_host_workers_initial(configured, cores=cores)
                    == jcontrol.resolve_host_workers_initial(configured, cores=cores))


@pytest.mark.parametrize("spec", [None, "", "pipeline_depth:max=3", "verify_chunk"])
def test_verify_chunk_is_driven_only_where_the_spec_names_it(spec):
    """The port's one default that differs: under device pressure the
    reference steps verify_chunk down; the port does so only when the
    operator's spec names the knob."""
    ap = pcontrol.Autopilot(spec, lambda k, v: None, tracer=PTracer(), registry=PRegistry(),
                            initial=dict(INITIAL))
    d = ap.tick(pcontrol.Signals(device_queue_p99_ms=80.0, clock_s=100.0))
    named = spec is not None and "verify_chunk" in spec
    assert ("verify_chunk" in ap.report()["knobs"]) == named
    assert (d is not None and d.knob == "verify_chunk") == named


@pytest.mark.parametrize("bad", [
    "frobnicate:min=1", "verify_chunk:min=9:max=2", "pipeline_depth:min=1", "weight:min=0",
    "verify_chunk:bogus=1", "verify_chunk:min", "verify_chunk:min=abc", "shed:cool=-1",
    "host_stage_workers:min=1", "sign_batch_max:min=0", "sign_batch_wait_ms:min=0:max=8",
])
def test_malformed_knob_specs_raise_the_references_error(bad):
    with pytest.raises(jcontrol.KnobSpecError) as want:
        jcontrol.parse_knob_specs(bad)
    with pytest.raises(pcontrol.KnobSpecError) as got:
        pcontrol.parse_knob_specs(bad)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the controller: seeded signal sequences through both packages


def _random_signals(pkg, rng, t):
    """One tick's Signals from the seeded draw (the same draw for both
    packages: the caller hands each a generator from the same seed)."""
    S = PKGS[pkg].ctl.Signals
    pick = lambda p, lo, hi: float(rng.uniform(lo, hi)) if rng.random() < p else None
    tenants = ("a", "b", "c")
    burn = {}
    for tn in tenants:
        if rng.random() < 0.6:
            burn[("lat", f"sidecar:{tn}")] = (None if rng.random() < 0.2
                                              else float(rng.uniform(0, 8)))
    if rng.random() < 0.3:
        burn[("commit", "ch")] = float(rng.uniform(0, 3))
    live = [tn for tn in tenants if rng.random() < 0.7]
    return S(burn=burn,
             queue_age_p99_ms={tn: float(rng.uniform(0, 120)) for tn in live},
             queue_depth={tn: int(rng.integers(0, 4)) for tn in live},
             share={tn: float(rng.uniform(0, 1)) for tn in live},
             busy_rate={tn: float(rng.uniform(0, 0.2)) for tn in live},
             launch_p99_ms=pick(0.5, 0, 400), device_queue_p99_ms=pick(0.3, 0, 40),
             overlap_coverage=pick(0.5, 0, 1), prefetch_p99_ms=pick(0.5, 0, 250),
             sign_busy_rate=pick(0.5, 0, 0.1), sign_wait_p99_ms=pick(0.5, 0, 20),
             apply_queue_age_ms=pick(0.3, 0, 150), sign_fill=pick(0.4, 0, 1),
             clock_s=t)


def _drive(pkg, seed, ticks=160):
    p = PKGS[pkg]
    clk = Clock(0.0)
    acts, sheds, weights = [], [], []
    ap = p.ctl.Autopilot(
        "verify_chunk:cool=3;coalesce_blocks:cool=2;pipeline_depth:cool=4;"
        "host_stage_workers:cool=5;sign_batch_max:cool=2;sign_batch_wait_ms:cool=3;"
        "weight:cool=6;shed:cool=7",
        lambda k, v: acts.append((k, v)), set_shed=lambda tn, on: sheds.append((tn, on)),
        set_weight=lambda tn, w: weights.append((tn, w)),
        tracer=p.Tracer(ring_blocks=8, slow_factor=0, clock=clk), clock=clk,
        registry=p.Registry(), initial=INITIAL)
    ap.observe_hello("a", 2.0)
    ap.observe_hello("b", 1.0)
    rng = np.random.default_rng(seed)
    decisions = []
    for i in range(ticks):
        clk.t += float(rng.uniform(0, 4))
        if i == ticks // 3:
            ap.hold_throughput()
        if i == 2 * ticks // 3:
            ap.release_throughput()
        d = ap.tick(_random_signals(pkg, rng, clk.t))
        decisions.append(None if d is None else d.to_dict())
    return decisions, acts, sheds, weights, ap.report()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_signal_sequences_decide_as_the_reference(seed):
    got, want = _drive("port", seed), _drive("ref", seed)
    assert got == want
    decisions = [d for d in got[0] if d is not None]
    assert len(decisions) > 20
    assert {d["knob"] for d in decisions} >= {"verify_chunk", "coalesce_blocks",
                                             "pipeline_depth", "sign_batch_max"}


# ---------------------------------------------------------------------------
# the reference's bursty overload differential on both packages


def _run_overload(pkg, enabled, seed=11):
    """``tests/test_autopilot.py::_run_overload`` over one package's
    WeightedScheduler, SloEngine, Tracer, Autopilot and FaultPlan."""
    p = PKGS[pkg]
    clk = Clock(0.0)
    reg = p.Registry()
    tracer = p.Tracer(ring_blocks=512, slow_factor=0, clock=clk)
    engine = p.slo.SloEngine(
        p.slo.parse_slos("lat:latency:ms=100:target=0.9:windows=30:min_events=3:fast=3"),
        clock=clk, registry=reg)
    tracer.add_listener(engine.on_block)
    sched = p.sched.WeightedScheduler(queue_limit=64, clock=clk, registry=reg)
    sched.register("noisy")
    sched.register("quiet")
    # "verify_chunk": the reference's default knob set (the port opts it in)
    pilot = p.ctl.Autopilot("verify_chunk", lambda k, v: None, set_shed=sched.set_shed,
                            slo=engine, scheduler=sched, tracer=tracer, clock=clk,
                            registry=reg, enabled=enabled,
                            bands={"shed_hi": 3.0, "shed_lo": 1.0})
    storm_plan = p.FaultPlan("sim.storm:raise:p=0.85", seed=seed)
    arrivals = []
    t = 5.0
    while t < 25.0:
        arrivals.append((round(t, 3), "noisy"))
        t += 0.05
    t = 25.0
    while t < 60.0:
        arrivals.append((round(t, 3), "noisy"))
        t += 0.5
    t = 0.0
    while t < 60.0:
        arrivals.append((round(t, 3), "quiet"))
        t += 0.5
    arrivals.sort()
    state = {"server_free": 0.0, "last_tick": 0.0, "seq": 0, "admitted": [], "shed": [],
             "busy": []}
    inflight = {}

    def maybe_tick():
        while clk() - state["last_tick"] >= 1.0:
            state["last_tick"] += 1.0
            pilot.tick()

    def make_lanes(tenant, seq):
        storm = False
        if tenant == "noisy" and clk() < 25.0:
            try:
                storm_plan.fire("sim.storm")
            except p.InjectedFault:
                storm = True
        n = 4 if tenant == "noisy" else 2
        return [{"id": f"{tenant}-{seq}-{i}", "bad": storm and i % 2 == 0} for i in range(n)]

    def serve_until(limit):
        while sched.pending():
            start = max(state["server_free"], clk())
            if start >= limit:
                return
            clk.set(start)
            maybe_tick()
            batch = sched.next_batch(1)
            if not batch:
                return
            (req,) = batch
            root, lanes = inflight.pop(req.seq)
            done = start + (0.4 if any(ln["bad"] for ln in lanes) else 0.02)
            state["server_free"] = done
            clk.set(done)
            maybe_tick()
            tracer.finish_block(root)
            state["admitted"].append(lanes)

    for t_arr, tenant in arrivals:
        serve_until(t_arr)
        clk.set(t_arr)
        maybe_tick()
        state["seq"] += 1
        seq = state["seq"]
        lanes = make_lanes(tenant, seq)
        root = tracer.begin_block(seq, ns="sidecar", channel=f"sidecar:{tenant}")
        req = p.sched.Request(tenant=tenant, seq=seq, items=lanes, t_enqueue=clk())
        if sched.submit(req):
            inflight[seq] = (root, lanes)
        else:
            tracer.set_attrs(root, busy=True)
            tracer.finish_block(root)
            (state["shed"] if sched.is_shed(tenant) else state["busy"]).append((tenant, seq))
    serve_until(float("inf"))
    clk.set(max(clk(), 61.0))
    maybe_tick()
    stats = sched.stats()
    return {"admitted": state["admitted"], "shed": state["shed"], "busy": state["busy"],
            "arrivals": state["seq"],
            "decisions": [d.to_dict() for d in pilot.decisions],
            "shed_count": {tn: stats[tn]["shed_count"] for tn in stats},
            "burn": {ch: engine.burn("lat", ch) for ch in ("sidecar:noisy", "sidecar:quiet")},
            "shed_now": sched.is_shed("noisy"), "report": pilot.report()}


@pytest.mark.parametrize("enabled", [True, False])
def test_bursty_overload_differential_matches_the_reference(enabled):
    got, want = _run_overload("port", enabled), _run_overload("ref", enabled)
    assert got == want
    if enabled:  # the reference's own acceptance, on the port
        assert got["shed"] and all(tn == "noisy" for tn, _ in got["shed"])
        assert got["shed_count"]["noisy"] == len(got["shed"])
        assert len(got["admitted"]) + len(got["shed"]) + len(got["busy"]) == got["arrivals"]
        assert ("shed", "on") in [(d["knob"], d["direction"]) for d in got["decisions"]]
        assert not got["shed_now"]
        assert all(b is None or b < 1.0 for b in got["burn"].values())
    else:
        assert got["shed"] == [] and got["decisions"] == []
        assert got["burn"]["sidecar:noisy"] >= 1.0


# ---------------------------------------------------------------------------
# the run-time setters, each latched at its boundary


class _Ptx:
    def __init__(self, txid, idx):
        self.txid, self.idx, self.is_config = txid, idx, False


class _Pending:
    def __init__(self, block, txs, raw):
        self.block, self.txs, self.raw = block, txs, raw

    @property
    def txids(self):
        return {p.txid for p in self.txs}


class _Block:
    def __init__(self, number, txs):
        self.number, self.txs = number, txs


class _MiniValidator:
    """A tx is VALID unless its reads mismatch committed state; a valid
    tx writes its own id.  ``preprocess_many`` groups are recorded."""

    def __init__(self, state):
        self.state = state
        self.groups = []

    def preprocess(self, block):
        return json.loads(json.dumps(block.txs))

    def preprocess_many(self, blocks):
        self.groups.append([b.number for b in blocks])
        return [self.preprocess(b) for b in blocks]

    def validate_launch(self, block, pre=None, overlay=None, extra_txids=None):
        raw = pre if pre is not None else self.preprocess(block)
        return _Pending(block, [_Ptx(t["id"], i) for i, t in enumerate(raw)], raw)

    def validate_finish(self, pend):
        codes, batch = [], UpdateBatch()
        for ptx, t in zip(pend.txs, pend.raw):
            ok = all((None if (vv := self.state.get_state("ns", k)) is None
                      else list(vv.version)) == want for k, want in t.get("reads", {}).items())
            codes.append(0 if ok else 11)
            if ok:
                batch.put("ns", ptx.txid, b"v", (pend.block.number, ptx.idx))
        return bytes(codes), batch, []


def _stream(n_blocks, n_tx=4):
    """Blocks whose last tx reads a key no block writes, at a version:
    an MVCC failure whatever the depth."""
    return [_Block(n, [{"id": f"tx{n}_{i}", **({"reads": {"never": [9, 9]}} if i == 3 else {})}
                       for i in range(n_tx)]) for n in range(n_blocks)]


def test_pipeline_set_depth_applies_at_the_submit_boundary():
    blocks = _stream(8)

    def run(reknob):
        state = MemVersionedDB()
        filters = []
        with CommitPipeline(_MiniValidator(state), lambda res: state.apply_updates(res.batch),
                            depth=2) as pipe:
            for b in blocks:
                if reknob and b.number in (3, 6):
                    pipe.set_depth(4 if b.number == 3 else 2)
                    assert pipe.depth == (2 if b.number == 3 else 4)  # latched only
                r = pipe.submit(b)
                if r is not None:
                    filters.append((r.block.number, r.tx_filter))
                if reknob and b.number == 3:
                    assert pipe.depth == 4  # applied at this submit boundary
            r = pipe.flush()
            filters.append((r.block.number, r.tx_filter))
        return filters, sorted((k, v.version) for k, v in state.iter_all()), pipe.depth

    got, want = run(True), run(False)
    assert got[:2] == want[:2] and got[2] == 2
    assert all(f == bytes([0, 0, 0, 11]) for _, f in got[0]) and len(got[0]) == 8


def test_pipeline_set_depth_never_crosses_the_serial_boundary():
    v = _MiniValidator(MemVersionedDB())
    pipe = CommitPipeline(v, lambda res: None, depth=1)
    pipe.set_depth(4)
    pipe.submit(_stream(1)[0])
    assert pipe.depth == 1
    pipe.close()
    pipe2 = CommitPipeline(v, lambda res: None, depth=2)
    pipe2.set_depth(1)
    pipe2.submit(_stream(1)[0])
    assert pipe2.depth == 2
    pipe2.close()


def test_pipeline_set_coalesce_blocks_latches_at_submit_many():
    v = _MiniValidator(MemVersionedDB())
    pipe = CommitPipeline(v, lambda res: v.state.apply_updates(res.batch), depth=2,
                          coalesce_blocks=4)
    blocks = _stream(9)
    pipe.set_coalesce_blocks(1)  # below 2: off
    pipe.submit(blocks[0])
    assert pipe.coalesce_blocks == 0
    pipe.set_coalesce_blocks(3)
    assert pipe.coalesce_blocks == 0
    out = pipe.submit_many(blocks[1:])
    assert pipe.coalesce_blocks == 3
    out.append(pipe.flush())
    pipe.close()
    assert v.groups == [[1, 2, 3], [4, 5, 6], [7, 8]]
    assert [r.block.number for r in out] == list(range(9))
    assert all(r.tx_filter == bytes([0, 0, 0, 11]) for r in out)


def test_validator_set_verify_chunk_latches_at_preprocess():
    got = []
    for v in (BlockValidator(PolicyProvider({}), MemVersionedDB(), device="cpu"),
              JBlockValidator(None, JPolicyProvider({}), JMemDB())):
        seen = [v.verify_chunk]
        for n in (1024, -5, 64):
            v.set_verify_chunk(n)
            seen.append(v.verify_chunk)  # not yet: the block boundary only
            v._apply_pending_knobs()     # what preprocess() runs first
            seen.append(v.verify_chunk)
        v.close()
        got.append(seen)
    assert got[0] == got[1] == [0, 0, 1024, 1024, 0, 0, 64]


@pytest.mark.skipif((os.cpu_count() or 1) < 3, reason="resizes a pool to 3 workers")
def test_set_host_stage_workers_resizes_a_real_pool_as_the_reference():
    """decision → apply_knob → ``set_host_stage_workers`` → the pool
    built, resized at its next idle task boundary, and closed, in step
    with the JAX validator."""
    trail = {}
    for pkg, v in (("port", BlockValidator(PolicyProvider({}), MemVersionedDB(),
                                           device="cpu")),
                   ("ref", JBlockValidator(None, JPolicyProvider({}), JMemDB()))):
        clk = Clock(0.0)
        ap = PKGS[pkg].ctl.Autopilot(
            "host_stage_workers:min=0:max=3", lambda k, val: v.set_host_stage_workers(int(val)),
            tracer=PKGS[pkg].Tracer(clock=clk), clock=clk, registry=PKGS[pkg].Registry(),
            initial={"host_stage_workers": 0})
        S = PKGS[pkg].ctl.Signals
        seen = []
        try:
            for t, prefetch in ((20.0, 500.0), (80.0, 500.0), (140.0, 1.0), (200.0, 1.0)):
                d = ap.tick(S(prefetch_p99_ms=prefetch, clock_s=t))
                before = v.host_pool.workers if v.host_pool is not None else 0
                v._apply_pending_knobs()
                pool = v.host_pool
                if pool is not None:  # an idle submit is the resize's boundary
                    pool.submit(lambda: None).result()
                seen.append((d.new, before, v.host_stage_workers,
                             pool.workers if pool is not None else 0))
        finally:
            v.close()
        trail[pkg] = seen
    assert trail["port"] == trail["ref"] == [(2, 0, 2, 2), (3, 2, 3, 3), (2, 3, 2, 2),
                                             (0, 2, 0, 0)]


def test_sign_lane_setters_apply_from_the_next_flush():
    flushes, gate = [], threading.Event()

    def sign_many(digests):
        gate.wait(10.0)
        flushes.append(len(digests))
        return [(1, 1)] * len(digests)

    lane = SignBatcher(sign_many, batch_max=2, wait_ms=0.0).start()
    try:
        lane.set_batch_max(8)
        lane.set_wait_ms(200.0)
        assert (lane.batch_max, lane.wait_ms) == (8, 200.0)
        assert lane.stats()["batch_max"] == 8
        threads = [threading.Thread(target=lane.sign_digest, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        gate.set()
        for th in threads:
            th.join(10.0)
    finally:
        gate.set()
        lane.stop()
    assert sum(flushes) == 8 and max(flushes) > 2


def test_sidecar_server_knobs_latch_at_the_drain_boundary():
    from fabric_tpu_torch.sidecar.server import SidecarServer

    srv = SidecarServer(device="cpu", coalesce=4, verify_chunk=0,
                        verify_fn=lambda sets: [[True] * len(s) for s in sets])
    srv.set_coalesce(0)
    srv.set_verify_chunk(512)
    assert (srv.coalesce, srv.verify_chunk) == (4, 0)
    srv._apply_pending_knobs()  # what the dispatcher runs before each batch
    assert (srv.coalesce, srv.verify_chunk) == (1, 512)
    srv.set_verify_chunk(-3)
    srv._apply_pending_knobs()
    assert srv.verify_chunk == 0
