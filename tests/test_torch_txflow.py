"""The port's tx-flow journal against the reference's
(``fabric_tpu/observe/txflow.py``): the scripts of
``tests/test_txflow.py:62-293`` — full and partial flows, a missing
durable fence, verdict labels, a failed endorsement, first-stamp-wins,
the in-flight LRU, the bounded block map, sign-lane waits, replay tags
— through both journals with injected clocks and private registries
give the same rows, ``stats()``, ``lookup()`` answers, rendered
registry and exemplars.  Then the commit path: toy JSON blocks through
each package's ``CommitPipeline`` and serial sqlite ``KVLedger`` on a
clock that ticks per call give the same journal; the port's async
applier marks every transaction durable and then applied; the sign
lane feeds ``sign_wait`` through ``sign_observer``; disarmed hooks do
nothing."""

import json
from types import SimpleNamespace

import pytest
from test_commit_pipeline import ToyValidator as JToyValidator
from test_commit_pipeline import _stream

import fabric_tpu.observe.txflow as jtxflow
import fabric_tpu.ops_metrics as jmetrics
from fabric_tpu.ledger.kvledger import KVLedger as JKVLedger
from fabric_tpu.peer.pipeline import CommitPipeline as JCommitPipeline
from fabric_tpu_torch import ops_metrics as pmetrics
from fabric_tpu_torch.ledger.kvledger import KVLedger
from fabric_tpu_torch.ledger.statedb import UpdateBatch
from fabric_tpu_torch.observe import txflow as ptxflow
from fabric_tpu_torch.peer import signlane
from fabric_tpu_torch.peer.pipeline import CommitPipeline
from fabric_tpu_torch.protos import messages as M

REF = SimpleNamespace(txflow=jtxflow, metrics=jmetrics)
PORT = SimpleNamespace(txflow=ptxflow, metrics=pmetrics)


class Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> None:
        self.t += dt


class TickClock:
    """Advances 1 ms at every read: two packages making the same hook
    calls in the same order read the same times."""

    def __init__(self, t: float = 10.0):
        self.t = t

    def __call__(self) -> float:
        self.t += 0.001
        return self.t


def _journal(m, **kw):
    kw.setdefault("registry", m.metrics.Registry())
    kw.setdefault("tracer", SimpleNamespace())
    return m.txflow.FlowJournal(**kw)


def _observed(j, txs=(), extra=None):
    return {"rows": j.rows(), "rows3": j.rows(3), "rows0": j.rows(0), "stats": j.stats(),
            "report": j.report(rows=2), "lookup": {tx: j.lookup(tx) for tx in txs},
            "render": j.registry.render(),
            "exemplars": (jmetrics.exemplars_report(j.registry)
                          if isinstance(j.registry, jmetrics.Registry)
                          else pmetrics.exemplars_report(j.registry)), **(extra or {})}


def _full_flow(j, clk, tx="tx-1", num=7, code=0, channel="ch"):
    j.endorse_begin(tx); clk.tick(0.010)
    j.endorse_end(tx); clk.tick(0.004)
    j.submit_begin(tx); clk.tick(0.002)
    j.broadcast_done(tx); clk.tick(0.030)
    j.block_included(num, [(tx, code)], channel=channel); clk.tick(0.005)
    j.block_durable(num); clk.tick(0.003)
    j.block_applied(num)


# ---------------------------------------------------------------------------
# scripts


def _s_full(m):
    clk = Clock()
    j = _journal(m, clock=clk)
    _full_flow(j, clk)
    return _observed(j, ["tx-1", "nope"])


def _s_partial_and_missing_durable(m):
    clk = Clock()
    j = _journal(m, clock=clk)
    j.block_included(3, [("txP", 0), ("txQ", 10)]); clk.tick(0.008)
    inflight = j.lookup("txQ")
    j.block_durable(3); clk.tick(0.002)
    j.block_applied(3)
    j.block_included(1, [("txM", 0)]); clk.tick(0.009)
    j.block_applied(1)
    return _observed(j, ["txP", "txQ", "txM"], {"inflight": inflight})


def _s_verdict_labels(m):
    clk = Clock()
    j = _journal(m, clock=clk)
    j.block_included(2, [("txV", 0), ("txI", 11), ("txX", 77), ("txD", 9)],
                     channel="c"); clk.tick(0.001)
    j.block_applied(2)
    return _observed(j, ["txI", "txX"])


def _s_failed_endorse_and_first_wins(m):
    clk = Clock()
    j = _journal(m, clock=clk)
    j.endorse_begin("txE"); clk.tick(0.006)
    j.endorse_end("txE", ok=False)
    j.endorse_begin("tx"); clk.tick(0.005)
    j.endorse_begin("tx"); clk.tick(0.005)
    j.endorse_end("tx")
    j.block_included(0, [("tx", 0)])
    j.block_durable(0)
    j.block_durable(0)
    j.block_applied(0)
    j.block_applied(0)
    return _observed(j, ["txE", "tx"])


def _s_lru(m):
    clk = Clock()
    j = _journal(m, clock=clk, inflight=4)
    for i in range(10):
        j.endorse_begin(f"tx{i}")
        clk.tick(0.001)
    j2 = _journal(m, clock=clk, inflight=2)
    j2.endorse_begin("a")
    j2.endorse_begin("b")
    j2.endorse_end("a")
    j2.endorse_begin("c")
    return _observed(j, ["tx9", "tx0"], {"second": _observed(j2, ["a", "b", "c"])})


def _s_block_map_bounded(m):
    clk = Clock()
    j = _journal(m, clock=clk, blocks=3)
    for n in range(6):
        j.block_included(n, [(f"t{n}", 0)])
        clk.tick(0.001)
    j.block_applied(0)
    j.block_applied(5)
    return _observed(j, ["t0", "t4", "t5"])


def _s_gateway_meets_cohort(m):
    """Gateway flows and first-seen txs in one block: the known ones
    complete per tx, the rest as the block's cohort."""
    clk = Clock()
    j = _journal(m, clock=clk, ring=16)
    for tx in ("g1", "g2"):
        j.endorse_begin(tx); clk.tick(0.002)
        j.endorse_end(tx); clk.tick(0.001)
        j.submit_begin(tx); clk.tick(0.001)
        j.broadcast_done(tx); clk.tick(0.003)
    j.block_included(9, [("g1", 0), ("c1", 0), ("g2", 11), ("c2", 12)], channel="ch")
    clk.tick(0.004)
    mid = {tx: j.lookup(tx) for tx in ("g1", "c1")}
    j.block_durable(9); clk.tick(0.002)
    j.block_applied(9)
    return _observed(j, ["g1", "g2", "c1", "c2"], {"mid": mid})


def _s_sign_waits(m):
    clk = Clock()
    j = _journal(m, clock=clk)
    j.sign_event(2.5, False)
    j.sign_event(None, True)
    j.sign_event(0.7, False)
    j.sign_event(1.0, True)
    return _observed(j)


def _s_replay(m):
    clk = Clock()
    j = _journal(m, clock=clk)
    j.endorse_begin("txR"); clk.tick(0.050)
    j.block_included(4, [("txR", 0), ("txS", 11)], replay=True); clk.tick(0.002)
    j.block_applied(4)
    return _observed(j, ["txR", "txS"])


def _s_slo_feed(m):
    clk = Clock()
    j = _journal(m, clock=clk)
    fed = []
    j.slo_feed = lambda e2e, valid, n=1: fed.append((round(e2e, 6), valid, n))
    _full_flow(j, clk, tx="ok")
    j.block_included(8, [("bad", 11), ("good", 0), ("bad2", 11)]); clk.tick(0.01)
    j.block_applied(8)
    return _observed(j, extra={"fed": fed})


SCRIPTS = [_s_full, _s_partial_and_missing_durable, _s_verdict_labels,
           _s_failed_endorse_and_first_wins, _s_lru, _s_block_map_bounded,
           _s_gateway_meets_cohort, _s_sign_waits, _s_replay, _s_slo_feed]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__[3:])
def test_journal_matches_reference(script):
    assert script(PORT) == script(REF)


def test_stage_identity_holds():
    for script in SCRIPTS:
        for r in script(PORT)["rows"]:
            assert abs(sum(r["stages_ms"].values()) - r["e2e_ms"]) < 1e-3, r


# ---------------------------------------------------------------------------
# arming


def test_disarmed_hooks_are_none_checks():
    assert ptxflow.global_journal() is None and ptxflow.enabled() is False
    ptxflow.endorse_begin("x")
    ptxflow.endorse_end("x")
    ptxflow.submit_begin("x")
    ptxflow.broadcast_done("x")
    ptxflow.block_included(0, [("x", 0)])
    ptxflow.block_durable(0)
    ptxflow.block_applied(0)
    ptxflow.sign_observer()(1.5, False)
    assert ptxflow.global_journal() is None


def test_acquire_release_refcount():
    reg = pmetrics.Registry()
    try:
        j1 = ptxflow.acquire(registry=reg)
        j2 = ptxflow.acquire()
        assert j1 is j2 and ptxflow.enabled()
        ptxflow.release()
        assert ptxflow.enabled()
        ptxflow.release()
        assert not ptxflow.enabled()
    finally:
        ptxflow.configure(enabled=False)


def test_registry_untouched_until_armed():
    reg = pmetrics.Registry()
    assert "tx_flow_stage_seconds" not in reg.render()
    try:
        ptxflow.configure(registry=reg)
        assert "tx_flow_stage_seconds" in reg.render()
    finally:
        ptxflow.configure(enabled=False)


def test_hook_failure_is_contained():
    class Broken(ptxflow.FlowJournal):
        def block_included(self, *a, **k):
            raise KeyError("bookkeeping")

    ptxflow._global = Broken(registry=pmetrics.Registry(), tracer=SimpleNamespace())
    try:
        ptxflow.block_included(1, [("t", 0)])  # logged, not raised
    finally:
        ptxflow.configure(enabled=False)


def test_sign_lane_feeds_sign_wait():
    """``SignBatcher(observer=sign_observer())``: each flushed request's
    coalescing wait lands in the journal's ``sign_wait`` stage, and the
    lane's own instruments count the requests and the flush."""
    jreg, lreg = pmetrics.Registry(), pmetrics.Registry()
    try:
        j = ptxflow.configure(registry=jreg)
        batcher = signlane.SignBatcher(signlane.cpu_sign_backend(0x1234567), batch_max=8,
                                       wait_ms=0.0, registry=lreg,
                                       observer=ptxflow.sign_observer())
        with batcher:
            sig = batcher.sign_digest(99)
        assert sig == signlane.cpu_sign_backend(0x1234567)([99])[0]
        assert j.stats()["sign_wait_ms"]["n"] == 1
        assert jreg.histogram("tx_flow_stage_seconds").value(stage="sign_wait")["count"] == 1
        assert lreg.counter("sign_requests_total").value() == 1
        assert lreg.histogram("sign_batch_lanes").value()["count"] == 1
    finally:
        ptxflow.configure(enabled=False)


# ---------------------------------------------------------------------------
# the commit path


class PortToyValidator(JToyValidator):
    """The reference's toy JSON validator over the port's blocks and
    update batches (``tests/test_commit_pipeline.py``)."""

    def validate_finish(self, pend):
        flt, jbatch, hist = super().validate_finish(pend)
        batch = UpdateBatch()
        for (ns, key), vv in jbatch.updates.items():
            if vv.value is None:
                batch.delete(ns, key, vv.version)
            else:
                batch.put(ns, key, vv.value, vv.version)
        return flt, batch, hist


def _run_commit_path(pkg, tmp_path, blocks, gateway, depth=1, async_commit=False):
    """Blocks through ``pkg``'s pipeline into its sqlite KVLedger with
    the journal armed on a tick clock; ``gateway``: tx ids stamped
    endorse-side first → (journal, registry)."""
    m = PORT if pkg == "port" else REF
    reg = m.metrics.Registry()
    j = m.txflow.configure(registry=reg, clock=TickClock())
    try:
        for tx in gateway:
            m.txflow.endorse_begin(tx)
            m.txflow.endorse_end(tx)
            m.txflow.submit_begin(tx)
            m.txflow.broadcast_done(tx)
        if pkg == "port":
            lg = KVLedger(str(tmp_path / "port"), async_commit=async_commit)
            v = PortToyValidator(lg.state)
            blocks = [M.Block.parse(b.SerializeToString()) for b in blocks]
            pipe_cls = CommitPipeline
        else:
            lg = JKVLedger(str(tmp_path / "ref"), async_commit=async_commit)
            v = JToyValidator(lg.state)
            pipe_cls = JCommitPipeline

        def commit_fn(res):
            lg.commit_block(res.block, res.tx_filter, res.batch, res.history, None, res.txids)

        with pipe_cls(v, commit_fn, depth=depth, channel="toy",
                      registry=m.metrics.Registry()) as pipe:
            for b in blocks:
                pipe.submit(b)
            pipe.flush()
        if async_commit:
            lg.drain_state()
        lg.close()
    finally:
        m.txflow.configure(enabled=False)
    return j, reg


def _txids(blocks):
    return [json.loads(bytes(d))["id"] for b in blocks for d in b.data.data]


def test_commit_path_journal_matches_reference(tmp_path):
    """Depth 1, the serial ledger: the same hook calls in the same order,
    so on a ticking clock the same rows, stats and registry text."""
    blocks = _stream(3, 4)
    txids = _txids(blocks)
    gateway = txids[::3]
    want, wreg = _run_commit_path("ref", tmp_path, blocks, gateway)
    got, greg = _run_commit_path("port", tmp_path, blocks, gateway)
    assert got.rows() == want.rows()
    assert got.stats() == want.stats()
    assert [got.lookup(t) for t in txids] == [want.lookup(t) for t in txids]
    assert greg.render() == wreg.render()
    rows = {r["tx_id"]: r for r in got.rows()}
    assert set(rows) == set(txids)
    assert all(list(r["milestones"])[-3:] == ["included", "durable", "applied"]
               for r in rows.values())
    assert {r["outcome"] for r in rows.values()} == {"VALID", "MVCC_READ_CONFLICT"}


def test_async_applier_marks_durable_then_applied(tmp_path):
    """Depth 2 over the async applier: every transaction completes
    included → durable → applied, its lag recorded."""
    blocks = _stream(4, 3)
    j, reg = _run_commit_path("port", tmp_path, blocks, (), depth=2, async_commit=True)
    rows = j.rows()
    assert sorted(r["tx_id"] for r in rows) == sorted(_txids(blocks))
    for r in rows:
        ms = r["milestones"]
        assert list(ms) == ["included", "durable", "applied"]
        assert ms["included"] <= ms["durable"] <= ms["applied"]
        assert r["visibility_lag_ms"] is not None and r["channel"] == "toy"
    assert j.stats()["flows_partial"] == len(rows)
