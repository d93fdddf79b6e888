"""The port's launch ledger against the reference's
(``fabric_tpu/observe/ledger.py``): the same scripted launches — cache
misses and hits, queueing under depth-N overlap, a sync that did not
block, first-seen keys, enqueue-only rows, the ring, re-anchored
dispatch, transient and owner device-memory pins, exemplars and the
device-lane spans (``tests/test_ledger.py:68-340``) — through both, with
injected clocks, private registries and tracers, give the same rows,
``stats()``, rendered registry, exemplars and span trees.  Then the
port's own hooks on the CPU: the verify, stage-2, scatter and sign
records the commit path opens, the disarmed and refcounted arming, and
a launch error that propagates through an armed ledger."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import fabric_tpu.observe.ledger as jledger
import fabric_tpu.observe.tracer as jtracer
import fabric_tpu.ops_metrics as jmetrics
from fabric_tpu_torch import kernels
from fabric_tpu_torch import ops_metrics as pmetrics
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.observe import ledger as pledger
from fabric_tpu_torch.observe import tracer as ptracer
from fabric_tpu_torch.ops import p256sign, p256v3
from fabric_tpu_torch.peer import device_block
from fabric_tpu_torch.state import residency

REF = SimpleNamespace(ledger=jledger, tracer=jtracer, metrics=jmetrics)
PORT = SimpleNamespace(ledger=pledger, tracer=ptracer, metrics=pmetrics)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_verify(monkeypatch):
    """The verify kernel's wrapper replaced by a cheap stand-in (lane i
    accepted when i is odd): these tests check the records around the
    launch, not the verify."""
    monkeypatch.setattr(p256v3, "verify_batch_packed",
                        lambda frame: torch.arange(frame.shape[0]) % 2 == 1)


class Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _ledger(m, **kw):
    clk = Clock()
    reg = m.metrics.Registry()
    tr = m.tracer.Tracer(ring_blocks=8, slow_factor=0, clock=clk)
    return m.ledger.LaunchLedger(registry=reg, tracer=tr, clock=clk, **kw), reg, tr, clk


def _observed(led, reg, tr, extra=None):
    return {"rows": led.rows(), "stats": led.stats(), "render": reg.render(),
            "exemplars": jmetrics.exemplars_report(reg) if isinstance(reg, jmetrics.Registry)
            else pmetrics.exemplars_report(reg),
            "trees": tr.blocks(), "chrome": tr.chrome_events(), "q99": led.queue_p99_ms(),
            "report": led.report(rows=3), **(extra or {})}


# ---------------------------------------------------------------------------
# scripts (tests/test_ledger.py's cases, written once for both packages)


def _miss_exact(m):
    led, reg, tr, clk = _ledger(m)
    rec = led.launch("stage2", compiled=True, lanes=64, h2d_bytes=4096)
    rec.note_h2d(0, seconds=0.010)
    clk.advance(0.5)
    rec.dispatched()
    clk.advance(0.1)
    rec.sync_begin()
    clk.advance(0.9)
    rec.sync_end(d2h_bytes=64)
    return _observed(led, reg, tr)


def _hit_tolerance(m):
    led, reg, tr, clk = _ledger(m)
    r0 = led.launch("k", compiled=True)
    clk.advance(0.01)
    r0.dispatched()
    r0.sync_begin()
    clk.advance(0.05)
    r0.sync_end()
    rec = led.launch("k", compiled=False, lanes=8)
    clk.advance(0.002)
    rec.dispatched()
    rec.sync_begin()
    clk.advance(0.2)
    rec.sync_end()
    return _observed(led, reg, tr)


def _queue_overlap(m):
    led, reg, tr, clk = _ledger(m)
    a = led.launch("stage2", compiled=False)
    clk.advance(0.001)
    a.dispatched()
    b = led.launch("stage2", compiled=False)
    clk.advance(0.001)
    b.dispatched()
    a.sync_begin()
    clk.advance(0.5)
    a.sync_end()
    b.sync_begin()
    clk.advance(0.3)
    b.sync_end()
    return _observed(led, reg, tr)


def _nonblocking_sync(m):
    led, reg, tr, clk = _ledger(m)
    rec = led.launch("k", compiled=False)
    clk.advance(0.001)
    rec.dispatched()
    clk.advance(5.05)
    rec.sync_begin()
    rec.sync_end()
    rec.sync_end()  # a second fetch completes nothing
    return _observed(led, reg, tr)


def _first_seen(m):
    led, reg, tr, clk = _ledger(m)
    verdicts = [led.launch("verify", key=key).compiled
                for key in ((1024, False, 0), (1024, False, 0), (2048, False, 0))]
    return _observed(led, reg, tr, {"verdicts": verdicts})


def _enqueue_only(m):
    led, reg, tr, clk = _ledger(m)
    rec = led.launch("resident_scatter", compiled=True, h2d_bytes=192)
    clk.advance(0.02)
    rec.dispatched()
    rec.complete()
    rec.complete()
    nxt = led.launch("k", compiled=False)
    nxt.dispatched()
    nxt.sync_begin()
    clk.advance(0.1)
    nxt.sync_end()
    return _observed(led, reg, tr)


def _ring_and_filters(m):
    led, reg, tr, clk = _ledger(m, ring=8)
    for i in range(20):
        rec = led.launch("a" if i % 2 else "b", compiled=False)
        rec.dispatched()
        rec.sync_begin()
        clk.advance(0.001)
        rec.sync_end()
    return _observed(led, reg, tr, {"three": led.rows(3), "a": led.rows(kernel="a"),
                                     "zero": led.rows(0), "neg": led.rows(-3)})


def _begin_dispatch(m):
    led, reg, tr, clk = _ledger(m)
    rec = led.launch("verify", compiled=True)
    clk.advance(2.0)
    rec.begin_dispatch()
    clk.advance(0.3)
    rec.begin_dispatch()
    rec.dispatched()
    rec.sync_begin()
    clk.advance(0.1)
    rec.sync_end()
    return _observed(led, reg, tr)


def _hbm(m):
    led, reg, tr, clk = _ledger(m)
    a = led.launch("stage2", compiled=False)
    a.pin_hbm("launch_frames", 10 << 20)
    a.dispatched()
    b = led.launch("stage2", compiled=False)
    b.pin_hbm("launch_frames", 10 << 20)
    b.dispatched()
    mid = led.stats()["hbm"]
    a.sync_begin()
    clk.advance(0.1)
    a.sync_end()
    b.sync_begin()
    clk.advance(0.1)
    b.sync_end()
    led.account_hbm("resident_table", 1 << 20)
    led.account_hbm("comb_table", 376832)
    led.account_hbm("resident_table", 512)
    return _observed(led, reg, tr, {"mid": mid})


def _exemplars_and_spans(m):
    """Rows under a traced block: trace exemplars on the histograms and
    dev:* spans on the device lane under the dispatch-time span."""
    led, reg, tr, clk = _ledger(m)
    root = tr.begin_block(42, channel="c")
    tok = tr.attach(root)
    try:
        with tr.span("launch"):
            rec = led.launch("stage2", compiled=True, lanes=16)
            clk.advance(0.3)
            rec.dispatched()
        a = led.launch("stage2", compiled=False, lanes=16)
        clk.advance(0.001)
        a.dispatched()
    finally:
        tr.detach(tok)
    rec.sync_begin()
    clk.advance(0.2)
    rec.sync_end()
    a.sync_begin()
    clk.advance(0.1)
    a.sync_end()
    side = tr.begin_block(7, ns="sidecar")
    tok = tr.attach(side)
    try:
        s = led.launch("verify", key=(16, True, 0), lanes=3)
        s.dispatched()
        s.sync_begin()
        clk.advance(0.001)
        s.sync_end()
    finally:
        tr.detach(tok)
    tr.finish_block(side)
    clk.advance(0.01)
    tr.finish_block(root)
    return _observed(led, reg, tr, {"sidecar": tr.blocks(ns="sidecar")})


def _sharded_tags(m):
    led, reg, tr, clk = _ledger(m)
    for sharded in (None, True, False, False):
        rec = led.launch("stage2", compiled=False, sharded=sharded)
        rec.dispatched()
        rec.sync_begin()
        clk.advance(0.01)
        rec.sync_end()
    return _observed(led, reg, tr)


def _queue_signal_window(m):
    led, reg, tr, clk = _ledger(m)
    for dt in (0.1, 0.2):
        a = led.launch("k", compiled=False)
        a.dispatched()
        b = led.launch("k", compiled=False)
        b.dispatched()
        a.sync_begin()
        clk.advance(dt)
        a.sync_end()
        b.sync_begin()
        clk.advance(0.05)
        b.sync_end()
    early = led.queue_p99_ms()
    clk.advance(60.0)
    return _observed(led, reg, tr, {"early": early, "late": led.queue_p99_ms(window_s=1.0)})


SCRIPTS = [_miss_exact, _hit_tolerance, _queue_overlap, _nonblocking_sync, _first_seen,
           _enqueue_only, _ring_and_filters, _begin_dispatch, _hbm, _exemplars_and_spans,
           _sharded_tags, _queue_signal_window]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__.strip("_"))
def test_ledger_matches_reference(script):
    assert script(PORT) == script(REF)


def test_identity_of_scripted_rows():
    """The reference's identity on every synced row of the scripts:
    |wall - (compile + queue + execute + h2d)| <= 0.05 wall + dispatch
    + 0.01 ms (``tests/test_ledger.py:626-632``)."""
    n = 0
    for script in SCRIPTS:
        for r in script(PORT)["rows"]:
            if r["wall_ms"] is None:
                continue
            parts = r["compile_ms"] + r["queue_ms"] + r["execute_ms"] + r["h2d_ms"]
            assert abs(r["wall_ms"] - parts) <= 0.05 * r["wall_ms"] + r["dispatch_ms"] + 0.01
            n += 1
    assert n >= 25


# ---------------------------------------------------------------------------
# arming


def test_disarmed_hooks_register_nothing():
    assert pledger.global_ledger() is None
    before = pmetrics.Registry()
    assert pledger.launch("stage2", compiled=True) is None
    pledger.note_h2d("state", 4096)
    pledger.account_hbm("resident_table", 1024)
    assert before.metrics() == []
    led, reg, _, _ = _ledger(PORT)
    names = {n for n, _ in reg.metrics()}
    assert {"device_launch_compile_seconds", "device_launches_total",
            "device_ledger_hbm_bytes"} <= names


def test_acquire_release_refcount():
    reg = pmetrics.Registry()
    try:
        l1 = pledger.acquire(registry=reg)
        l2 = pledger.acquire()
        assert l1 is l2 and pledger.global_ledger() is l1
        pledger.release()
        assert pledger.global_ledger() is l1
        pledger.release()
        assert pledger.global_ledger() is None
        pledger.release()  # one too many: stays off
        assert pledger.global_ledger() is None
        pledger.acquire(registry=reg)
        pledger.configure(enabled=False)  # the hard off zeroes the count
        pledger.acquire(registry=reg)
        pledger.release()
        assert pledger.global_ledger() is None
    finally:
        pledger.configure(enabled=False)


def test_hook_bookkeeping_failure_is_contained(fake_verify):
    """A failure inside the ledger's own ``launch`` is logged and the
    dispatch goes on without a record."""
    class Broken(pledger.LaunchLedger):
        def launch(self, *a, **k):
            raise KeyError("bookkeeping")

    pledger._global = Broken(registry=pmetrics.Registry(),
                             tracer=ptracer.Tracer(ring_blocks=0))
    try:
        assert pledger.launch("stage2", compiled=True) is None
        h = p256v3.verify_launch([(1, 1, 1, 1, 1)], device="cpu")
        assert h.rec is None and h.fetch() == [False]
    finally:
        pledger.configure(enabled=False)


def test_live_device_bytes_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    assert pledger.live_device_bytes() is None


# ---------------------------------------------------------------------------
# the port's hook sites on the CPU


@pytest.fixture
def armed():
    reg = pmetrics.Registry()
    tr = ptracer.Tracer(ring_blocks=8, slow_factor=0)
    led = pledger.configure(registry=reg, tracer=tr)
    yield led, reg, tr
    pledger.configure(enabled=False)


def _sig_items(n, seed=7):
    rng = np.random.default_rng(seed)
    key = ec_ref.SigningKey(int(rng.integers(1, 1 << 62)))
    qx, qy = key.public
    out = []
    for i in range(n):
        e = int(rng.integers(1, 1 << 62))
        r, s = key.sign_digest(e)
        out.append((e, r, s if i % 3 else s + 1, qx, qy))
    return out


def test_verify_records_and_fetch_brackets(armed, fake_verify):
    """One record a launch (first sight of a bucket a miss, on the CPU),
    the frame's bytes as h2d, the fetch's copy as the sync; a coalesced
    launch is one record, on the first live block's handle."""
    led, reg, tr = armed
    items = _sig_items(3)
    for _ in range(2):
        h = p256v3.verify_launch(items, device="cpu")
        assert h.fetch() == [False, True, False]
    hs = p256v3.verify_launch_many([items[:2], [], items[2:]], device="cpu")
    assert [h.rec is not None for h in hs] == [True, False, False]
    assert [h.fetch() for h in hs] == [[False, True], [], [False]]
    rows = led.rows(kernel="verify")
    assert [r["cache"] for r in rows] == ["miss", "hit", "miss"]
    assert [r["lanes"] for r in rows] == [3, 3, 32]
    assert rows[0]["h2d_bytes"] == 16 * p256v3.FRAME_COLS * 2
    assert all(r["d2h_bytes"] > 0 and r["wall_ms"] is not None for r in rows)
    assert reg.histogram("device_launch_compile_seconds").value(kernel="verify")["count"] == 2


def test_sign_record_and_comb_owner(armed):
    led, reg, tr = armed
    key = 0x1234567
    sigs = p256sign.sign_launch([11, 12], key, device="cpu").fetch()
    assert sigs == p256sign.sign_host([11, 12], key)
    (row,) = led.rows(kernel="sign")
    assert row["lanes"] == 2 and row["h2d_bytes"] == 16 * 16 * 2 and row["wall_ms"] is not None


def test_scatter_records_match_launches(armed):
    """A ``resident_scatter`` record per table scatter that writes rows,
    enqueue-only, and the table's bytes on the ``resident_table`` owner."""
    led, reg, tr = armed
    res = residency.ResidencyManager(slots=64, device="cpu")
    pairs = [("ns", f"k{i}") for i in range(5)]
    res.admit(pairs, np.ones(5, bool), np.array([[1, i] for i in range(5)]))
    res.admit(pairs[:2], np.ones(2, bool), np.array([[1, 0], [1, 1]]))  # resident: no scatter
    residency.table_scatter(res._ensure_table(), np.zeros(0, np.int32), np.zeros((0, 3)))
    rows = led.rows(kernel="resident_scatter")
    assert len(rows) == 1 and rows[0]["queue_ms"] is None and rows[0]["lanes"] == 5
    assert led.stats()["hbm"]["resident_table"]["current_bytes"] == 64 * residency.SLOT_BYTES


def test_stage2_cache_verdict_is_the_policy_table_cache(armed):
    """``DeviceBlockPipeline.run``: a miss on a new set of plans and
    shapes, a hit on the same one; the verify record completes
    enqueue-only, the stage-2 record at its fetch."""
    from test_torch_stage2 import _stage2_operands

    led, reg, tr = armed
    sig_valid, lv, groups, sp, dims = _stage2_operands(3)
    t = torch.from_numpy
    pgroups = [(pol.compile_plan(pol.from_dsl(d)), t(gp), eb, S) for d, gp, eb, S in groups]
    vrec = led.launch("verify", compiled=False)
    vrec.dispatched()
    handle = p256v3.VerifyHandle(t(sig_valid), len(sig_valid), vrec)
    pipe = device_block.DeviceBlockPipeline()
    outs = [pipe.run(handle, t(lv), pgroups, t(sp), dims, lv.shape[0])() for _ in range(2)]
    assert np.array_equal(outs[0]["valid"], outs[1]["valid"])
    (v,) = led.rows(kernel="verify")
    assert v["queue_ms"] is None and v["wall_ms"] is None  # completed enqueue-only
    rows = led.rows(kernel="stage2")
    assert [r["cache"] for r in rows] == ["miss", "hit"]
    for r in rows:
        parts = r["compile_ms"] + r["queue_ms"] + r["execute_ms"] + r["h2d_ms"]
        assert abs(r["wall_ms"] - parts) <= 0.05 * r["wall_ms"] + r["dispatch_ms"] + 0.01
    assert led.stats()["hbm"]["launch_frames"]["current_bytes"] == 0


def test_launch_error_propagates_through_an_armed_ledger(armed, monkeypatch):
    """The hook wraps the attribution only: a dispatch that raises and a
    fetch whose copy raises reach the caller unchanged."""
    led, reg, tr = armed

    def boom(frame):
        raise RuntimeError("fab_p256_verify: CUDA error 700")

    monkeypatch.setattr(p256v3, "verify_batch_packed", boom)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        p256v3.verify_launch(_sig_items(2), device="cpu")
    monkeypatch.undo()

    class BadCopy:
        shape = (16,)

        def __getitem__(self, _):
            return self

        def to(self, _):
            raise RuntimeError("copy failed")

    h = p256v3.VerifyHandle(BadCopy(), 2, led.launch("verify", compiled=False))
    with pytest.raises(RuntimeError, match="copy failed"):
        h.fetch()
    assert led.rows() == []


def test_first_launch_tracks_the_process():
    """``kernels.first_launch``: True until a wrapper counted the kernel
    once; ``reset_counts`` leaves it."""
    name = "sha256_blocks"
    before = kernels.first_launch(name)
    kernels._count(name)
    try:
        assert kernels.first_launch(name) is False
        kernels.reset_counts()
        assert kernels.first_launch(name) is False
    finally:
        kernels.launches[name] = 0
        if before:
            kernels._launched.discard(name)
