"""The port's validation sidecar (``fabric_tpu_torch/comm/rpc.py``,
``sidecar/``) against the JAX package's, on the CPU.

The wire codec against ``fabric_tpu.sidecar.wire`` (each encodes, the
other decodes; unpackable items; a torn payload; the reference's
optional trace fields); the port's client against the reference's
server and the reference's client against the port's server (hello,
welcome, request and response frames on a real socket); the
``WeightedScheduler`` against the reference's on one seeded script;
then the port's server and client on localhost: a crypto-free
``verify_fn`` and the facade on ``device="cpu"``, an ERROR answer that
raises ``SidecarUnavailable`` while the stream survives, BUSY retried,
re-attach after a server restart, ``MAX_FRAME`` on send,
``set_coalesce`` at the drain boundary, ``set_weight`` by in-stream
re-hello (each client against each server), and the ``sidecar.request``,
``sidecar.dispatch`` and ``rpc.frame`` fault points.  Last,
``SidecarValidator`` under ``CommitPipeline`` on
``tests/test_torch_slice.py``'s blocks against the JAX
``BlockValidator``, and its latch: a server stopped and restarted, the
blocks between verified on the peer, a probe that re-attaches."""

import asyncio
import random
import threading
import time

import numpy as np
import pytest
import torch

from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.ops_metrics import Registry
from fabric_tpu.peer.validator import BlockValidator as JBlockValidator
from fabric_tpu.sidecar import wire as jwire
from fabric_tpu.sidecar.client import SidecarLink as JSidecarLink
from fabric_tpu.sidecar.scheduler import Request as JRequest
from fabric_tpu.sidecar.scheduler import WeightedScheduler as JScheduler
from fabric_tpu.sidecar.server import SidecarServer as JSidecarServer
from fabric_tpu_torch import carry, faults
from fabric_tpu_torch.comm import rpc
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.peer.pipeline import CommitPipeline
from fabric_tpu_torch.sidecar import wire
from fabric_tpu_torch.sidecar.client import SidecarLink, SidecarUnavailable, parse_endpoint
from fabric_tpu_torch.sidecar.scheduler import Request, WeightedScheduler
from fabric_tpu_torch.sidecar.server import SidecarServer
from fabric_tpu_torch.sidecar.validator import SidecarValidator
from fabric_tpu_torch.utils.backoff import Backoff
from fabric_tpu_torch.utils.stats import nearest_rank
from test_torch_slice import POLICIES, _blocks, _decode, _reference, _rows, _seed_batch
from test_torch_slice import _Store, net  # noqa: F401  (module fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy_verify(itemsets):
    """item = (seq, valid_flag, 0, 0, 0)."""
    return [[bool(it[1]) for it in items] for items in itemsets]


def _server(**kw):
    kw.setdefault("verify_fn", toy_verify)
    kw.setdefault("device", "cpu")
    return SidecarServer(**kw).start_background()


# ---------------------------------------------------------------------------
# Wire codec


def test_wire_codec_matches_reference():
    big = 1 << 256
    tuples = [(1, 2, 3, 4, 5), (big - 1, 0, 1, big - 1, 7), (1, big, 2, 3, 4), (5, -1, 0, 0, 0),
              (1, 2, 3)]
    assert wire.pack_items(tuples) == jwire.pack_items(tuples)
    for seq in (0, 7, 1 << 40):
        for mine, ref in ((wire.encode_request(seq, tuples), jwire.encode_request(seq, tuples)),
                          (wire.encode_response(seq, [True, False, True]),
                           jwire.encode_response(seq, [True, False, True])),
                          (wire.encode_busy(seq, 20.0), jwire.encode_busy(seq, 20.0)),
                          (wire.encode_error(seq, "x" * 900), jwire.encode_error(seq, "x" * 900))):
            assert mine == ref
    hdr, items = jwire.decode_request(wire.encode_request(3, tuples))
    assert items == wire.decode_request(jwire.encode_request(3, tuples))[1]
    assert items[2] == items[3] == items[4] == wire.INVALID_ITEM == jwire.INVALID_ITEM
    # the reference's optional trace and remote fields are accepted
    hdr, got = wire.decode_request(jwire.encode_request(4, tuples[:2], trace={"block": 9}))
    assert hdr["seq"] == 4 and got == tuples[:2]
    hdr, v = wire.decode_response(jwire.encode_response(5, [True], remote={"spans": {}}))
    assert hdr["seq"] == 5 and v == [True]
    assert wire.decode_response(jwire.encode_busy(6, 250.0)) == \
        jwire.decode_response(wire.encode_busy(6, 250.0))
    torn = wire.encode_request(1, [(1, 1, 0, 0, 0)])[:-3]
    for dec in (wire.decode_request, jwire.decode_request):
        with pytest.raises(ValueError):
            dec(torn)
    assert parse_endpoint("h:12") == ("h", 12) and parse_endpoint(":7") == ("127.0.0.1", 7)
    with pytest.raises(ValueError):
        parse_endpoint("nohost")


class _LoopThread:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=15.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def stop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=5.0)


def test_frames_interoperate_with_reference():
    """The port's client against the reference's server, and the
    reference's client against the port's server."""
    lt = _LoopThread()
    try:
        ref = JSidecarServer(verify_fn=toy_verify, registry=Registry())
        lt.run(ref.start())
        link = SidecarLink("127.0.0.1", ref.port, tenant="a", weight=2.0)
        try:
            assert link.submit([(1, 1, 0, 0, 0), (2, 0, 0, 0, 0)]).fetch() == [True, False]
            assert ref.scheduler.weight("a") == 2.0
        finally:
            link.close()
            lt.run(ref.stop())
    finally:
        lt.stop()
    srv = _server()
    try:
        jlink = JSidecarLink("127.0.0.1", srv.port, tenant="b", weight=1.5, registry=Registry())
        try:
            assert jlink.submit([(1, 0, 0, 0, 0), (2, 1, 0, 0, 0)]).fetch() == [False, True]
        finally:
            jlink.close()
        assert srv.stats()["requests"] == {"b": {"ok": 1}}
    finally:
        srv.stop_background()


def test_rpc_unary_and_errors_name_the_method():
    async def main():
        srv = rpc.RpcServer()

        async def echo(req):
            if req == b"boom":
                raise ValueError("bad input")
            return req[::-1]

        srv.register_unary("Echo", echo)
        await srv.start()
        cli = rpc.RpcClient("127.0.0.1", srv.port)
        try:
            assert await cli.unary("Echo", b"abc") == b"cba"
            with pytest.raises(rpc.RpcError, match="^Echo: ValueError: bad input"):
                await cli.unary("Echo", b"boom")
            with pytest.raises(rpc.RpcError, match="^Nope: unknown method Nope"):
                await cli.unary("Nope", b"x")
        finally:
            await cli.close()
            await srv.stop()

    asyncio.run(main())


# ---------------------------------------------------------------------------
# Scheduler


def test_scheduler_matches_reference_on_a_seeded_script():
    rng = random.Random(20261017)
    mine = WeightedScheduler(queue_limit=3, quantum=5, clock=lambda: 1.0)
    ref = JScheduler(queue_limit=3, quantum=5, clock=lambda: 1.0, registry=Registry())
    names = ["a", "b", "c", "d"]
    ops = {}
    for step in range(600):
        op = rng.random()
        name = rng.choice(names)
        if op < 0.12:
            w = rng.choice([0.5, 1.0, 2.0, 3.0])
            mine.register(name, w), ref.register(name, w)
            key = "register"
        elif op < 0.55:
            items = [0] * rng.randrange(0, 9)
            try:
                got = mine.submit(Request(name, step, items))
            except KeyError:
                got = "unregistered"
            try:
                want = ref.submit(JRequest(name, step, items))
            except KeyError:
                want = "unregistered"
            assert got == want, step
            key = f"submit_{got}"
        elif op < 0.8:
            k = rng.randrange(1, 5)
            got = [(r.tenant, r.seq) for r in mine.next_batch(k)]
            assert got == [(r.tenant, r.seq) for r in ref.next_batch(k)], step
            key = "next_batch"
        elif op < 0.87:
            w = rng.choice([0.5, 1.0, 4.0])
            assert mine.set_weight(name, w) == ref.set_weight(name, w)
            key = "set_weight"
        elif op < 0.92:
            shed = rng.random() < 0.5
            mine.set_shed(name, shed), ref.set_shed(name, shed)
            key = "set_shed"
        else:
            got = [(r.tenant, r.seq) for r in mine.unregister(name)]
            assert got == [(r.tenant, r.seq) for r in ref.unregister(name)], step
            key = "unregister"
        ops[key] = ops.get(key, 0) + 1
        assert mine.pending() == ref.pending()
    assert mine.stats() == ref.stats()
    assert ops.get("submit_False", 0) > 10 and ops.get("submit_True", 0) > 50, ops
    with pytest.raises(ValueError):
        WeightedScheduler(quantum=0)


def test_backoff_and_percentile_match_reference():
    from fabric_tpu.utils.backoff import Backoff as JBackoff
    from fabric_tpu.utils.stats import nearest_rank as jnearest_rank

    a, b = Backoff(0.02, 0.5, rng=random.Random(3)), JBackoff(0.02, 0.5, rng=random.Random(3))
    assert [a.next() for _ in range(12)] == [b.next() for _ in range(12)]
    vals = sorted(random.Random(4).random() for _ in range(37))
    for q in (1, 50, 90, 99, 100):
        assert nearest_rank(vals, q) == jnearest_rank(vals, q)


# ---------------------------------------------------------------------------
# Server and client on localhost


def test_server_client_toy_and_facade_on_cpu():
    srv = _server(coalesce=4)
    link = SidecarLink("127.0.0.1", srv.port, tenant="t1")
    try:
        hs = [link.submit([(i, i % 2, 0, 0, 0) for i in range(n)]) for n in (1, 5, 0, 9)]
        assert [h.fetch() for h in hs] == [[i % 2 == 1 for i in range(n)] for n in (1, 5, 0, 9)]
        st = srv.stats()
        assert st["requests"]["t1"]["ok"] == 4 and st["dispatches"] >= 1
        assert sum(st["coalesce"]["requests"]) == 4
        assert len(st["latency_s"]["t1"]["total"]) == 4 and srv.health_check() is None
    finally:
        link.close()
        srv.stop_background()
    # the facade's default kernel (v3) on the CPU
    rng = np.random.default_rng(5)
    k = ec_ref.SigningKey(d=int(rng.integers(1, 1 << 62)))
    items = []
    for j in range(6):
        e = int.from_bytes(rng.bytes(32), "big")
        r, s = k.sign_digest(e)
        items.append((e ^ (j % 2), r, s, *k.public))
    srv = SidecarServer(device="cpu").start_background()
    link = SidecarLink("127.0.0.1", srv.port, tenant="t2")
    try:
        assert link.submit(items).fetch() == [j % 2 == 0 for j in range(6)]
    finally:
        link.close()
        srv.stop_background()


def test_dispatch_error_raises_and_the_stream_survives():
    calls = []

    def flaky(itemsets):
        calls.append(len(itemsets))
        if len(calls) == 1:
            raise RuntimeError("card fault")
        return toy_verify(itemsets)

    srv = _server(verify_fn=flaky)
    link = SidecarLink("127.0.0.1", srv.port, tenant="t")
    try:
        with pytest.raises(SidecarUnavailable, match="card fault"):
            link.submit([(1, 1, 0, 0, 0)]).fetch()
        assert link.submit([(1, 1, 0, 0, 0)]).fetch() == [True]
        assert link.attach_total == 1  # the same stream answered
        assert srv.stats()["requests"]["t"] == {"error": 1, "ok": 1}
    finally:
        link.close()
        srv.stop_background()


def test_short_verdict_vector_is_refused():
    srv = _server(verify_fn=lambda sets: [v[:-1] for v in toy_verify(sets)])
    link = SidecarLink("127.0.0.1", srv.port, tenant="t")
    try:
        with pytest.raises(SidecarUnavailable, match="1 verdicts for a 2-signature"):
            link.submit([(1, 1, 0, 0, 0), (2, 1, 0, 0, 0)]).fetch()
    finally:
        link.close()
        srv.stop_background()


def test_busy_is_retried():
    gate = threading.Event()

    def slow(itemsets):
        gate.wait(10.0)
        return toy_verify(itemsets)

    srv = _server(verify_fn=slow, queue_blocks=1, coalesce=1)
    link = SidecarLink("127.0.0.1", srv.port, tenant="t", busy_retries=40,
                       backoff=Backoff(base=0.01, cap=0.05, jitter=0.0))
    try:
        hs = [link.submit([(i, 1, 0, 0, 0)]) for i in range(4)]
        deadline = time.time() + 10
        while link.busy_total == 0 and time.time() < deadline:
            time.sleep(0.01)
        gate.set()
        assert [h.fetch() for h in hs] == [[True]] * 4
        assert link.busy_total > 0
        assert srv.stats()["requests"]["t"]["busy"] == link.busy_total
    finally:
        gate.set()
        link.close()
        srv.stop_background()


def test_restart_reattaches_on_next_submit():
    srv = _server()
    port = srv.port
    link = SidecarLink("127.0.0.1", port, tenant="t", timeout_s=5.0)
    try:
        assert link.submit([(1, 1, 0, 0, 0)]).fetch() == [True]
        srv.stop_background()
        with pytest.raises(SidecarUnavailable):
            link.submit([(1, 1, 0, 0, 0)]).fetch()
        srv = _server(port=port)
        assert link.submit([(2, 0, 0, 0, 0)]).fetch() == [False]
        assert link.attach_total == 2
    finally:
        link.close()
        srv.stop_background()


def test_max_frame_enforced_on_send(monkeypatch):
    monkeypatch.setattr(rpc, "MAX_FRAME", 2000)
    srv = _server()
    link = SidecarLink("127.0.0.1", srv.port, tenant="t")
    try:
        with pytest.raises(SidecarUnavailable, match="MAX_FRAME"):
            link.submit([(1, 1, 0, 0, 0)] * 20).fetch()  # 3,200 item bytes
        assert link.submit([(1, 1, 0, 0, 0)] * 2).fetch() == [True, True]
    finally:
        link.close()
        srv.stop_background()

    async def send():
        class W:
            def write(self, b):
                raise AssertionError("an oversized frame reached the socket")

        await rpc._write_frame(W(), 1, rpc.KIND_MSG, b"x" * 2001)

    with pytest.raises(rpc.FrameTooLargeError):
        asyncio.run(send())


def test_set_coalesce_applies_at_the_drain_boundary():
    groups, entered, gate = [], threading.Event(), threading.Event()

    def verify(itemsets):
        groups.append(len(itemsets))
        entered.set()
        gate.wait(10.0)
        return toy_verify(itemsets)

    srv = _server(verify_fn=verify, coalesce=1, queue_blocks=16)
    links = [SidecarLink("127.0.0.1", srv.port, tenant=t) for t in ("a", "b")]
    try:
        first = links[0].submit([(0, 1, 0, 0, 0)])
        assert entered.wait(10.0)
        hs = [links[i % 2].submit([(i, 1, 0, 0, 0)]) for i in range(6)]
        deadline = time.time() + 10
        while srv.scheduler.pending() < 6 and time.time() < deadline:
            time.sleep(0.01)
        srv.set_coalesce(4)
        assert srv.coalesce == 1  # latched until the next drain
        gate.set()
        assert first.fetch() == [True] and all(h.fetch() == [True] for h in hs)
        assert groups[0] == 1 and groups[1] == 4 and sum(groups) == 7
        assert srv.coalesce == 4
        assert srv.stats()["coalesce"]["requests"] == groups
    finally:
        gate.set()
        for link in links:
            link.close()
        srv.stop_background()


@pytest.mark.parametrize("server", ["port", "ref"])
@pytest.mark.parametrize("client", ["port", "ref"])
def test_set_weight_by_in_stream_rehello(server, client):
    """Each client against each server: a live re-hello changes the
    tenant's weight in place (the same stream keeps serving), a refused
    weight answers False and drops the stream, and a detached link
    keeps the weight for its next hello."""
    lt = _LoopThread()
    if server == "port":
        srv = _server()
        sched, stop = srv.scheduler, srv.stop_background
    else:
        srv = JSidecarServer(verify_fn=toy_verify, registry=Registry())
        lt.run(srv.start())
        sched, stop = srv.scheduler, lambda: lt.run(srv.stop())
    link = (SidecarLink("127.0.0.1", srv.port, tenant="w", weight=1.0) if client == "port"
            else JSidecarLink("127.0.0.1", srv.port, tenant="w", weight=1.0,
                              registry=Registry()))
    try:
        assert link.set_weight(2.0) is False  # not attached yet: rides the hello
        assert link.submit([(1, 1, 0, 0, 0)]).fetch() == [True]
        assert sched.weight("w") == 2.0 and link.attached
        assert link.set_weight(3.5) is True
        assert sched.weight("w") == 3.5
        assert link.submit([(2, 0, 0, 0, 0)]).fetch() == [False]
        assert link.set_weight(-1.0) is False  # refused: the server ends the stream
        deadline = time.time() + 5
        while link.attached and time.time() < deadline:
            time.sleep(0.01)
        assert not link.attached
        link.weight = 1.5
        assert link.submit([(3, 1, 0, 0, 0)]).fetch() == [True]  # re-attaches
        assert sched.weight("w") == 1.5
    finally:
        link.close()
        stop()
        lt.stop()


def test_rehello_must_name_the_streams_tenant():
    srv = _server()
    try:
        assert srv._re_hello("a", b'{"tenant": "a", "weight": 2}') is None
        assert "registered as 'a'" in srv._re_hello("a", b'{"tenant": "b", "weight": 2}')
        assert srv._re_hello("a", b"{not json").startswith("bad re-hello")
    finally:
        srv.stop_background()


def test_dispatch_and_request_fault_points():
    """``sidecar.dispatch`` fails one coalesced dispatch (an ERROR
    answer, the stream survives); ``sidecar.request`` by ``afire``: a
    latency slows the stream only, a raise ends it and the next submit
    re-attaches; ``rpc.frame`` cuts a frame's send."""
    srv = _server()
    link = SidecarLink("127.0.0.1", srv.port, tenant="f", timeout_s=5.0)
    try:
        plan = faults.configure("sidecar.dispatch:raise:n=1")
        with pytest.raises(SidecarUnavailable, match="injected fault at sidecar.dispatch"):
            link.submit([(1, 1, 0, 0, 0)]).fetch()
        assert link.submit([(1, 1, 0, 0, 0)]).fetch() == [True]
        assert plan.fired("sidecar.dispatch") == 1 and link.attach_total == 1
        plan = faults.configure("sidecar.request:latency:ms=50:n=1")
        t0 = time.perf_counter()
        assert link.submit([(2, 0, 0, 0, 0)]).fetch() == [False]
        assert time.perf_counter() - t0 >= 0.045 and plan.fired() == 1
        plan = faults.configure("sidecar.request:raise:n=1")
        with pytest.raises(SidecarUnavailable):
            link.submit([(3, 1, 0, 0, 0)]).fetch()
        assert link.submit([(3, 1, 0, 0, 0)]).fetch() == [True]
        assert link.attach_total == 2
        plan = faults.configure("rpc.frame:disconnect:n=1")
        with pytest.raises(SidecarUnavailable):
            link.submit([(4, 1, 0, 0, 0)]).fetch()
        assert plan.fired("rpc.frame") == 1
        assert link.submit([(4, 1, 0, 0, 0)]).fetch() == [True]
        st = srv.stats()["requests"]["f"]
        assert st["error"] == 1
    finally:
        faults.reset()
        link.close()
        srv.stop_background()


# ---------------------------------------------------------------------------
# SidecarValidator under CommitPipeline


@pytest.fixture(scope="module")
def stream(net):  # noqa: F811
    blocks = _blocks(net, seed=20261019, n_blocks=6)
    want = _reference(net, blocks)
    seed = JMemDB()
    seed.apply_updates(_seed_batch(), (1, 0))
    rows = [(ns, key, vv.value, vv.version) for (ns, key), vv in seed.iter_all()]
    people = [net["client"], *net["peers"]]
    idents = [(p.msp_id, p.identity.role, *p.identity.public_numbers) for p in people]
    _, _, carried = carry.from_reference(rows, POLICIES, idents)
    known = {(i.msp_id, i.role, i.qx, i.qy): i for i in carried}
    parser = JBlockValidator(net["mgr"], net["prov"], JMemDB())
    return [_decode(b, parser, net["mgr"], known) for b in blocks], want, rows


@pytest.mark.parametrize("depth", [1, 2])
def test_sidecar_validator_matches_reference(stream, depth):
    decoded, want, rows = stream
    srv = SidecarServer(device="cpu").start_background()
    state, prov, _ = carry.from_reference(rows, POLICIES, [])
    store = _Store()
    v = SidecarValidator(prov, state, block_store=store, device="cpu",
                         sidecar_endpoint=f"127.0.0.1:{srv.port}", tenant="slice")

    def commit(res):
        state.apply_updates(res.batch)
        store.txids.update(t for t, _ in res.txids)

    got = []
    try:
        with CommitPipeline(v, commit, depth=depth) as pipe:
            for blk in decoded:
                res = pipe.submit(blk)
                if res is not None:
                    got.append(res)
            res = pipe.flush()
            if res is not None:
                got.append(res)
    finally:
        v.close()
        srv.stop_background()
    assert [(r.tx_filter, _rows(r.batch), r.history) for r in got] == want
    assert all(r.pend.dpre is None and r.pend.fetch2 is None for r in got)  # the host path
    assert srv.stats()["requests"]["slice"]["ok"] == len(decoded)


def test_sidecar_validator_raises_when_the_sidecar_is_gone(stream):
    """The link raises ``SidecarUnavailable`` when the sidecar is gone;
    the validator's latch turns each failure into a fallback verify on
    the peer's own device with the reference's verdicts, and latches
    after two (``sidecar_fail_threshold``), so the third block goes
    straight to the fallback."""
    decoded, want, rows = stream
    srv = _server()
    port = srv.port
    srv.stop_background()
    state, prov, _ = carry.from_reference(rows, POLICIES, [])
    store = _Store()
    v = SidecarValidator(prov, state, block_store=store, device="cpu",
                         sidecar_endpoint=f"127.0.0.1:{port}", sidecar_recovery_s=60.0)
    got = []
    try:
        with pytest.raises(SidecarUnavailable):
            v.link.submit([(1, 1, 0, 0, 0)]).fetch()
        for blk in decoded[:3]:
            flt, batch, hist = v.validate(blk)
            state.apply_updates(batch)
            store.txids.update(p.txid for p in v.last_parsed if p.txid)
            got.append((flt, _rows(batch), hist))
    finally:
        v.close()
    assert got == want[:3]
    st = v.sidecar_guard.stats()
    assert v.device_guard is v.sidecar_guard
    assert st["degraded"] and st["failures_total"] == 2 and st["fallback_blocks_total"] == 3
    assert st["probes_total"] == 0 and not v.link.attached


def test_sidecar_restart_latches_and_reattaches(stream):
    """The server stops after block 1 and comes back on its port before
    block 4: blocks 2 and 3 fail over the link and verify on the peer
    (the latch engages at the second), a probe re-attaches the link,
    and every verdict is the reference's; every failure falls between
    the stop and the restart."""
    decoded, want, rows = stream
    srv = SidecarServer(device="cpu").start_background()
    port = srv.port
    state, prov, _ = carry.from_reference(rows, POLICIES, [])
    store = _Store()
    v = SidecarValidator(prov, state, block_store=store, device="cpu", tenant="r",
                         sidecar_endpoint=f"127.0.0.1:{port}", sidecar_recovery_s=0.05)
    got, seen = [], {}

    def commit(res):
        state.apply_updates(res.batch)
        store.txids.update(t for t, _ in res.txids)
        got.append((res.tx_filter, _rows(res.batch), res.history))

    try:
        with CommitPipeline(v, commit, depth=2) as pipe:
            def feed(lo, hi):
                for blk in decoded[lo:hi]:
                    pipe.submit(blk)
                pipe.flush()

            feed(0, 2)
            seen["before"] = v.sidecar_guard.stats()
            srv.stop_background()
            feed(2, 4)
            seen["stopped"] = v.sidecar_guard.stats()
            srv = SidecarServer(port=port, device="cpu").start_background()
            time.sleep(0.06)
            feed(4, 5)  # the probe
            feed(5, 6)
            seen["after"] = v.sidecar_guard.stats()
        assert v.link.attached
    finally:
        v.close()
        srv.stop_background()
    assert got == want
    assert seen["before"]["failures_total"] == 0 and not seen["before"]["degraded"]
    assert seen["stopped"]["degraded"] and seen["stopped"]["failures_total"] == 2
    assert seen["stopped"]["fallback_blocks_total"] == 2
    after = seen["after"]
    assert not after["degraded"] and after["failures_total"] == 2
    assert after["fallback_blocks_total"] == 2 and after["probes_total"] == 1
    assert after["degraded_s"] > 0
    assert srv.stats()["requests"]["r"]["ok"] == 2  # the probe's block and the last
