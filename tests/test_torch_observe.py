"""The port's span tracer, metrics registry and overlap analyser against
the reference's (``fabric_tpu/observe/{tracer,overlap}.py``,
``fabric_tpu/ops_metrics.py``), on scripted inputs with injected clocks:
the same ``blocks()`` JSON, Chrome events, ``format_block`` text and
watchdog verdicts; the same ``Registry.render()`` text and exemplars;
the same coverage over all three input forms.  Then the hooks: pool
workers' spans, the dispatch annotation under ``torch.profiler``, the
sidecar's stitched subtree across the two packages, and the port's
``CommitPipeline`` beside the reference's over the same signed blocks
(the same span-name trees on the same threads, the same metric names,
labels and counts, a stage-2 ledger row that meets the attribution
identity).  No sleeps: every clock that a comparison reads is injected."""

import logging
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest
import torch
from test_torch_frontend import _port_msp
from test_torch_sidecar import _LoopThread
from test_torch_slice import _blocks, _seed_batch, _Store, net  # noqa: F401  (module fixture)
from test_torch_slice import POLICIES
from test_torch_wire import _CachedVerify

import fabric_tpu.observe.overlap as joverlap
import fabric_tpu.observe.tracer as jtracer
import fabric_tpu.ops_metrics as jmetrics
from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.parallel.hostpool import HostStagePool as JHostStagePool
from fabric_tpu.peer import validator as jvalidator
from fabric_tpu.peer.pipeline import CommitPipeline as JCommitPipeline
from fabric_tpu.peer.validator import BlockValidator as JBlockValidator
from fabric_tpu.sidecar.client import SidecarLink as JSidecarLink
from fabric_tpu.sidecar.server import SidecarServer as JSidecarServer
from fabric_tpu_torch import carry, observe
from fabric_tpu_torch import ops_metrics as pmetrics
from fabric_tpu_torch.observe import ledger as pledger
from fabric_tpu_torch.observe import overlap as poverlap
from fabric_tpu_torch.observe import tracer as ptracer
from fabric_tpu_torch.ops import p256v3
from fabric_tpu_torch.parallel.hostpool import HostStagePool
from fabric_tpu_torch.peer import validator as pv
from fabric_tpu_torch.peer.pipeline import CommitPipeline
from fabric_tpu_torch.protos import messages as M
from fabric_tpu_torch.sidecar.client import SidecarLink
from fabric_tpu_torch.sidecar.server import SidecarServer

REF = SimpleNamespace(tracer=jtracer, metrics=jmetrics, overlap=joverlap)
PORT = SimpleNamespace(tracer=ptracer, metrics=pmetrics, overlap=poverlap)
SEED = 20261018
E2E_BLOCKS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Clock:
    def __init__(self, t: float = 50.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------------------
# tracer scripts: each returns what the readers give


def _readers(tr, mod, roots=()):
    out = {"blocks": tr.blocks(), "chrome": tr.chrome_events(), "slow": tr.slow_blocks(),
           "namespaces": tr.namespaces(),
           "text": [mod.format_block(r) for r in roots]}
    for ns in out["namespaces"]:
        out[f"blocks:{ns}"] = tr.blocks(ns=ns)
    return out


def _script_nesting(m):
    clk = Clock()
    tr = m.tracer.Tracer(ring_blocks=4, slow_factor=0, clock=clk)
    root = tr.begin_block(1, channel="c")
    with tr.span("launch", parent=root, k=3) as sp:
        clk.tick(0.001)
        tr.add("state_fill", clk() - 0.0005, clk())
        tr.event("note", detail="x")
        with tr.span("inner"):
            clk.tick(0.002)
        tr.set_attrs(sp, device=True)
    assert tr.current() is None
    clk.tick(0.003)
    tr.add("commit_wait", clk() - 0.001, clk(), parent=root)
    tr.add("dev:execute", clk() - 0.002, clk(), parent=root, thread="device:dev", lanes=4)
    tr.add("dev:compile", clk() - 0.003, clk() - 0.002, parent=root, thread="device:dev")
    tr.finish_block(root)
    return _readers(tr, m.tracer, [root])


def _script_cross_thread(m):
    clk = Clock()
    tr = m.tracer.Tracer(ring_blocks=4, slow_factor=0, clock=clk)
    root = tr.begin_block(2, channel="x")

    def task(i):
        tok = tr.attach(root)
        try:
            with tr.span("worker-stage", worker=str(i)):
                clk.tick(0.001)
        finally:
            tr.detach(tok)
        return tr.current()

    with ThreadPoolExecutor(1, thread_name_prefix="tw") as ex:
        for i in range(3):
            assert ex.submit(task, i).result() is None
    tr.finish_block(root)
    return _readers(tr, m.tracer, [root])


def _script_ring_and_resize(m):
    clk = Clock()
    tr = m.tracer.Tracer(ring_blocks=3, slow_factor=0, clock=clk)
    for n in range(5):
        r = tr.begin_block(n)
        clk.tick(0.01)
        tr.finish_block(r)
    first = _readers(tr, m.tracer)
    tr.configure(ring_blocks=2)
    second = _readers(tr, m.tracer)
    tr.configure(ring_blocks=0)
    return {"first": first, "second": second, "disabled": tr.begin_block(9) is None,
            "one": tr.block(4), "gone": tr.block(0)}


def _script_watchdog(m):
    clk = Clock()
    tr = m.tracer.Tracer(ring_blocks=32, slow_factor=3.0, clock=clk)
    roots = []
    for n in range(9):
        r = tr.begin_block(n)
        clk.tick(0.010)
        tr.finish_block(r)
    for n, dt in ((9, 0.5), (10, 0.011), (11, 0.029), (12, 0.031)):
        r = tr.begin_block(n)
        with tr.span("finish", parent=r):
            clk.tick(dt)
        tr.finish_block(r)
        roots.append(r)
    out = _readers(tr, m.tracer, roots)
    out["flags"] = [r.attrs.get("slow", False) for r in roots]
    return out


def _script_namespaces(m):
    clk = Clock()
    tr = m.tracer.Tracer(ring_blocks=4, slow_factor=2.0, clock=clk)
    for n in range(10):
        b = tr.begin_block(n)
        clk.tick(0.1)
        tr.finish_block(b)
        s = tr.begin_block(n, ns="sidecar", channel="sidecar:t")
        tr.add("queue_wait", clk(), clk() + 0.001, parent=s)
        clk.tick(0.001 if n < 9 else 0.05)
        tr.finish_block(s)
    return _readers(tr, m.tracer)


def _script_span_from_dict(m):
    clk = Clock()
    tr = m.tracer.Tracer(ring_blocks=4, slow_factor=0, clock=clk)
    remote = m.tracer.Tracer(ring_blocks=4, slow_factor=0, clock=Clock(900.0))
    r = remote.begin_block(77, ns="sidecar", seq=3)
    remote.add("queue_wait", 900.0, 900.002, parent=r)
    remote.add("dispatch", 900.002, 900.010, parent=r, coalesced=2)
    remote.event("busy", parent=r)
    remote.end(r)
    wire = r.to_dict(0.0)
    root = tr.begin_block(5)
    sp = m.tracer.span_from_dict(wire, offset_s=850.0, proc="sidecar")
    sp.root = root
    root.children.append(sp)
    clk.tick(0.02)
    tr.finish_block(root)
    return _readers(tr, m.tracer, [root])


def _script_disabled(m):
    tr = m.tracer.Tracer(ring_blocks=0, clock=Clock())
    root = tr.begin_block(5)
    with tr.span("x", parent=root) as sp:
        tr.add("y", 0.0, 1.0)
        tr.event("z")
    tr.finish_block(root)
    return {"root": root, "sp": sp, "blocks": tr.blocks(), "enabled": tr.enabled}


TRACER_SCRIPTS = [_script_nesting, _script_cross_thread, _script_ring_and_resize,
                  _script_watchdog, _script_namespaces, _script_span_from_dict,
                  _script_disabled]


@pytest.mark.parametrize("script", TRACER_SCRIPTS, ids=lambda f: f.__name__[8:])
def test_tracer_matches_reference(script, caplog):
    with caplog.at_level(logging.WARNING):
        want = script(REF)
        got = script(PORT)
    assert got == want


def test_watchdog_warns_and_counts_like_the_reference(caplog, monkeypatch):
    """The slow-block warning's text and the global counter it bumps."""
    regs = {}
    for name, m in (("ref", REF), ("port", PORT)):
        reg = m.metrics.Registry()
        monkeypatch.setattr(m.metrics, "_global", reg)
        regs[name] = reg
    texts = {}
    for name, m in (("ref", REF), ("port", PORT)):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            _script_watchdog(m)
        texts[name] = [r.getMessage() for r in caplog.records if "slow block" in r.getMessage()]
    assert texts["port"] == texts["ref"] and texts["port"]
    assert regs["port"].render() == regs["ref"].render()
    assert "trace_slow_blocks_total" in regs["port"].render()


# ---------------------------------------------------------------------------
# the registry


def _registry_script(m):
    reg = m.metrics.Registry()
    c = reg.counter("a_total", "things")
    c.add()
    c.add(2.5, kernel="k", cache="miss")
    c.add(1, cache="hit", kernel="k")
    g = reg.gauge("level", "")
    g.set(3, owner="x")
    g.add(-1, owner="x")
    g.add(4)
    h = reg.histogram("lat_seconds", "lat", exemplars=3)
    for i, v in enumerate((0.0004, 0.003, 0.2, 7.0, 50.0, 0.003)):
        h.observe(v, exemplar=f"blk{i}", stage="s")
    h.observe(0.01, stage="t")
    h.observe_repeat(0.02, 5, exemplar="c:9", stage="t")
    h.observe_repeat(0.02, 0, stage="t")
    hb = reg.histogram("sized", "bounded", buckets=(1, 4, 16))
    for v in (0.5, 3, 16, 40):
        hb.observe(v)
    with reg._lock:
        hb.observe_repeat_locked(2, 3, (("unit", "u"),), exemplar="ignored")
        c.add_locked(4, (("kernel", "q"),))
    reg.histogram("lat_seconds", buckets=(1, 2))  # first registration wins
    with pytest.raises(TypeError):
        reg.counter("level")
    return {"render": reg.render(), "exemplars": m.metrics.exemplars_report(reg),
            "one": m.metrics.exemplars_report(reg, "lat_seconds"),
            "value": h.value(stage="t"), "snap": h.snapshot(), "none": h.value(stage="zz"),
            "cval": c.value(kernel="k", cache="miss"), "gval": g.snapshot(),
            "names": [n for n, _ in reg.metrics()]}


def test_registry_matches_reference():
    assert _registry_script(PORT) == _registry_script(REF)


def test_histogram_timer_and_global_registry():
    reg = pmetrics.Registry()
    with reg.histogram("t_seconds").time(stage="x"):
        pass
    assert reg.histogram("t_seconds").value(stage="x")["count"] == 1
    assert pmetrics.global_registry() is pmetrics.global_registry()


# ---------------------------------------------------------------------------
# overlap coverage on all three input forms


def _overlap_script(m):
    """Blocks 0..5: each a prefetch (host), a device_wait inside finish,
    a commit on the committer row; neighbours' host work covers part of
    each device_wait."""
    clk = Clock(10.0)
    tr = m.tracer.Tracer(ring_blocks=16, slow_factor=0, clock=clk)
    roots = []
    for k in range(6):
        base = 10.0 + 0.1 * k
        r = tr.begin_block(k)
        r.t0 = base
        tr.add("prefetch", base, base + 0.04, parent=r)
        tr.add("host_parse", base + 0.01, base + 0.03, parent=r)
        tr.add("prefetch_wait", base + 0.04, base + 0.05, parent=r)
        tr.add("finish", base + 0.06, base + 0.16, parent=r)
        tr.add("device_wait", base + 0.06 + 0.005 * k, base + 0.14, parent=r)
        tr.add("commit_wait", base + 0.16, base + 0.17, parent=r)
        tr.add("commit", base + 0.17, base + 0.19 + 0.01 * (k % 2), parent=r)
        clk.t = base + 0.2
        tr.finish_block(r)
        roots.append(r)
    out = {}
    for w in (1, 2):
        out[f"roots{w}"] = m.overlap.coverage_from_roots(tr.recent_roots(), window=w)
        out[f"dump{w}"] = m.overlap.coverage_from_trace_dump(tr.blocks(), window=w)
        out[f"idx{w}"] = m.overlap.coverage_from_trace_dump(
            {"recent_blocks": tr.blocks(4), "slow_blocks": tr.blocks()[:2]}, window=w)
        out[f"chrome{w}"] = m.overlap.coverage_from_spans(
            m.overlap.spans_from_chrome(tr.chrome_events()), window=w)
    out["unanchored"] = m.overlap.coverage_from_trace_dump(
        [{k: v for k, v in b.items() if k != "t0_s"} for b in tr.blocks()])
    out["none"] = m.overlap.coverage_from_spans([])
    out["non_host"] = sorted(m.overlap.NON_HOST)
    return out


def test_overlap_coverage_matches_reference():
    got, want = _overlap_script(PORT), _overlap_script(REF)
    assert got == want
    assert got["roots2"]["blocks_measured"] == 6
    # the three forms agree within the rounding of the JSON trees
    for k in ("p50", "mean", "min"):
        assert got["roots2"][k] == pytest.approx(got["chrome2"][k], abs=2e-3)
        assert got["roots2"][k] == pytest.approx(got["dump2"][k], abs=2e-3)


# ---------------------------------------------------------------------------
# hooks


def test_pool_worker_spans_match_reference():
    """Tasks submitted under an attached root run as spans named for
    their stage, on the pool's threads, with the worker label."""
    shapes = {}
    for name, tmod, pool_cls in (("ref", jtracer, JHostStagePool),
                                 ("port", ptracer, HostStagePool)):
        tr = tmod.global_tracer()
        root = tr.begin_block(991)
        tok = tr.attach(root)
        try:
            with pool_cls(2) as pool:
                assert [f.result() for f in [pool.submit(lambda x: 2 * x, i, stage="unit")
                                             for i in (1, 2, 3)]] == [2, 4, 6]
        finally:
            tr.detach(tok)
        tasks = [c for c in root.children if c.name == "unit"]
        shapes[name] = sorted((c.name, c.thread.rsplit("_", 1)[0], sorted(c.attrs))
                              for c in tasks)
    assert shapes["port"] == shapes["ref"]
    assert len(shapes["port"]) == 3 and shapes["port"][0][1] == "fabtpu-hoststage"


def _fake_verify(frame):
    """A cheap stand-in for the verify kernel's wrapper (these tests
    check what surrounds the launch)."""
    return torch.zeros(frame.shape[0], dtype=torch.bool)


def test_dispatch_annotation_shows_under_the_profiler(monkeypatch):
    """``device_annotation``: a shared null context with no capture; a
    ``record_function`` event inside one (the verify's dispatch)."""
    monkeypatch.setattr(p256v3, "verify_batch_packed", _fake_verify)
    assert observe.device_annotation("fabtpu.x") is observe.device_annotation("fabtpu.y")
    with observe.device_annotation("fabtpu.x") as a:
        assert a is None
    items = [(1, 1, 1, 1, 1)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        p256v3.verify_launch(items, device="cpu").fetch()
    names = {e.name for e in prof.events()}
    assert "fabtpu.verify_dispatch" in names


def _toy_verify(itemsets):
    return [[bool(it[0] % 2) for it in items] for items in itemsets]


def _stitched(tmod, link_cls, server, registry_kw):
    """One submit under a traced block → the block's stitched child."""
    tr = tmod.global_tracer()
    link = link_cls("127.0.0.1", server.port, tenant="obs", **registry_kw)
    try:
        root = tr.begin_block(4242, channel="obs")
        tok = tr.attach(root)
        try:
            assert link.submit([(3, 1, 1, 1, 1), (4, 1, 1, 1, 1)]).fetch() == [True, False]
        finally:
            tr.detach(tok)
        tr.finish_block(root)
    finally:
        link.close()
    (sub,) = [c for c in root.children if c.name == "sidecar_request"]
    return {"proc": sub.proc, "attrs": sorted(sub.attrs),
            "children": sorted((c.name, sorted(c.attrs)) for c in sub.children),
            "nested": all(sub.t0 <= c.t0 <= c.t1 <= sub.t1 + 1e-6 for c in sub.children)}


def test_sidecar_subtree_stitches_across_packages():
    """The peer's block context rides the request; each package's
    client stitches the other package's server subtree the same way."""
    out = {}
    lt = _LoopThread()
    jsrv = JSidecarServer(verify_fn=_toy_verify, registry=jmetrics.Registry())
    lt.run(jsrv.start())
    psrv = SidecarServer(verify_fn=_toy_verify, device="cpu",
                         registry=pmetrics.Registry()).start_background()
    try:
        out["port_client_ref_server"] = _stitched(ptracer, SidecarLink, jsrv,
                                                  {"registry": pmetrics.Registry()})
        out["ref_client_port_server"] = _stitched(jtracer, JSidecarLink, psrv,
                                                  {"registry": jmetrics.Registry()})
        out["port_client_port_server"] = _stitched(ptracer, SidecarLink, psrv,
                                                   {"registry": pmetrics.Registry()})
    finally:
        lt.run(jsrv.stop())
        lt.stop()
        psrv.stop_background()
    want = out["ref_client_port_server"]
    assert want["proc"] == "sidecar" and want["nested"]
    assert [c[0] for c in want["children"]] == ["dispatch", "queue_wait"]
    assert {"req", "clock_offset_ms", "rtt_ms", "peer_block"} <= set(want["attrs"])
    assert out["port_client_ref_server"] == want == out["port_client_port_server"]
    # the server's own request trees sit in the "sidecar" ring
    assert ptracer.global_tracer().namespaces().get("sidecar", 0) >= 2


# ---------------------------------------------------------------------------
# the commit pipeline, port beside reference


def _shape(sp, drop):
    """(name, thread without its worker suffix, attrs, sorted children)."""
    kids = tuple(sorted(_shape(c, drop) for c in sp.children if not drop(c.name)))
    return (sp.name, re.sub(r"_\d+$", "", sp.thread), tuple(sorted(sp.attrs.items())), kids)


def _counts(reg, name):
    m = reg.metric(name)
    if m is None:
        return None
    snap = m.snapshot()
    return {k: (v["count"] if isinstance(v, dict) else v) for k, v in snap.items()}


@pytest.fixture(scope="module")
def e2e(net):
    """Blocks through the reference's CommitPipeline (JAX validator,
    verdicts of its verify from the port's plain verify) and the port's
    (wire blocks, the port's MSP), each under a private global tracer
    and registry; the port's launch ledger armed on a registry of its
    own."""
    blocks = _blocks(net, seed=SEED, n_blocks=E2E_BLOCKS)
    parser = JBlockValidator(net["mgr"], net["prov"], JMemDB())
    todo = list(dict.fromkeys(it for b in blocks for it in parser._parse(b)[1].tuples()))
    jcache = _CachedVerify(jax=True)
    jcache.bits.update(zip(todo, p256v3.verify_launch(todo, device="cpu").fetch()))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jtr = jtracer.Tracer(ring_blocks=16, slow_factor=0)
        jreg = jmetrics.Registry()
        mp.setattr(jtracer, "_global", jtr)
        mp.setattr(jmetrics, "_global", jreg)
        mp.setattr(jvalidator.p256, "verify_launch", jcache)
        state = JMemDB()
        state.apply_updates(_seed_batch(), (1, 0))
        store = _Store()
        v = JBlockValidator(net["mgr"], net["prov"], state, block_store=store)

        def jcommit(res):
            state.apply_updates(res.batch, (res.block.header.number, 0))
            store.txids.update(t for t, _ in res.txids)

        with JCommitPipeline(v, jcommit, depth=2, tracer=jtr, registry=jreg) as pipe:
            got = [pipe.submit(b) for b in blocks]
            got.append(pipe.flush())
        out["ref"] = {"filters": [bytes(r.tx_filter) for r in got if r is not None],
                      "roots": jtr.recent_roots(), "reg": jreg}
    seed = JMemDB()
    seed.apply_updates(_seed_batch(), (1, 0))
    rows = [(ns, key, vv.value, vv.version) for (ns, key), vv in seed.iter_all()]
    wire = [M.Block.parse(b.SerializeToString()) for b in blocks]
    with pytest.MonkeyPatch.context() as mp:
        ptr = ptracer.Tracer(ring_blocks=16, slow_factor=0)
        preg = pmetrics.Registry()
        lreg = pmetrics.Registry()
        mp.setattr(ptracer, "_global", ptr)
        mp.setattr(pmetrics, "_global", preg)
        led = pledger.configure(registry=lreg, tracer=ptr)
        try:
            pstate, prov, _ = carry.from_reference(rows, POLICIES, [])
            v = pv.BlockValidator(prov, pstate, block_store=_Store(), device="cpu",
                                  msp=_port_msp(net["mgr"]))

            def pcommit(res):
                pstate.apply_updates(res.batch)
                v.blocks.txids.update(t for t, _ in res.txids)

            with CommitPipeline(v, pcommit, depth=2, tracer=ptr, registry=preg) as pipe:
                got = [pipe.submit(b) for b in wire]
                got.append(pipe.flush())
        finally:
            pledger.configure(enabled=False)
        out["port"] = {"filters": [bytes(r.tx_filter) for r in got if r is not None],
                       "roots": ptr.recent_roots(), "reg": preg, "ledger": led, "lreg": lreg}
    return out


def test_pipeline_span_trees_match_reference(e2e):
    """One root a block; the same span names on the same threads, the
    validator's stages under prefetch, launch and finish.  Left out:
    ``hd_frame``, which the port frames only for a ledger's block store,
    and the port's launch-ledger spans (``dev:*``), checked below."""
    ref, port = e2e["ref"], e2e["port"]
    assert port["filters"] == ref["filters"] and len(port["filters"]) == E2E_BLOCKS
    want = [_shape(r, lambda n: n == "hd_frame") for r in ref["roots"]]
    got = [_shape(r, lambda n: n.startswith("dev:")) for r in port["roots"]]
    assert got == want
    for r in port["roots"]:
        names = [c.name for c in r.children]
        for stage in ("prefetch", "prefetch_wait", "launch", "finish", "commit_wait", "commit"):
            assert names.count(stage) == 1, (r.attrs, names)
    assert port["roots"][-1].attrs.get("tail") is True


def test_pipeline_metrics_match_reference(e2e):
    """The same metric names with the same label sets; equal block and
    stage counts.  The reference's ``device_mesh_shards`` waits for the
    port's multi-GPU slice; the reference's verify records
    ``h2d_bytes_per_block`` in the dispatch this test's double replaces."""
    jreg, preg = e2e["ref"]["reg"], e2e["port"]["reg"]
    jnames = {n for n, _ in jreg.metrics()} - {"device_mesh_shards"}
    pnames = {n for n, _ in preg.metrics()}
    assert pnames - jnames == {"h2d_bytes_per_block"}
    assert jnames <= pnames
    for name in sorted(jnames):
        jkeys = {tuple(k for k, _ in key) for key in jreg.metric(name).snapshot()}
        pkeys = {tuple(k for k, _ in key) for key in preg.metric(name).snapshot()}
        assert pkeys == jkeys, name
    assert _counts(preg, "commit_pipeline_blocks_total") == _counts(
        jreg, "commit_pipeline_blocks_total")
    assert sum(_counts(preg, "commit_pipeline_blocks_total").values()) == E2E_BLOCKS
    jst = {k: v for k, v in _counts(jreg, "validator_stage_seconds").items()
           if k != (("stage", "hd_frame"),)}
    assert _counts(preg, "validator_stage_seconds") == jst


def test_pipeline_ledger_rows_meet_the_identity(e2e):
    """The CPU stage-2 rows (one a fused block) and the verify rows they
    completed enqueue-only: compile + queue + execute + h2d within the
    reference's tolerance of the wall, device spans under the launch."""
    port = e2e["port"]
    led, lreg = port["ledger"], port["lreg"]
    rows = led.rows()
    s2 = [r for r in rows if r["kernel"] == "stage2"]
    fused = sum(1 for r in port["roots"]
                for c in r.children if c.name == "launch" and c.attrs.get("device"))
    assert len(s2) == fused >= 1
    assert s2[0]["cache"] == "miss"
    for r in s2:
        parts = r["compile_ms"] + r["queue_ms"] + r["execute_ms"] + r["h2d_ms"]
        assert abs(r["wall_ms"] - parts) <= 0.05 * r["wall_ms"] + r["dispatch_ms"] + 0.01, r
        assert r["h2d_bytes"] > 0 and r["d2h_bytes"] > 0 and r["block"] is not None
    assert len([r for r in rows if r["kernel"] == "verify"]) == E2E_BLOCKS
    ctr = lreg.counter("device_launches_total")
    assert sum(ctr.snapshot().values()) == len(rows)
    dev = [c for r in port["roots"] for sp in r.children for c in sp.children
           if c.name.startswith("dev:")]
    assert dev and all(c.thread == "device:dev" for c in dev)
    st = led.stats()
    assert st["hbm"]["launch_frames"]["current_bytes"] == 0
    assert st["hbm"]["launch_frames"]["watermark_bytes"] > 0


def test_disarmed_hooks_register_nothing(monkeypatch):
    """With no ledger or journal armed the hooks are one global read:
    no instruments appear, and a whole CPU verify records nothing."""
    from fabric_tpu_torch.observe import txflow

    assert pledger.global_ledger() is None and not txflow.enabled()
    reg = pmetrics.Registry()
    assert pledger.launch("stage2", compiled=True) is None
    pledger.note_h2d("state", 10)
    pledger.account_hbm("resident_table", 10)
    txflow.block_included(1, [("t", 0)])
    txflow.block_applied(1)
    assert reg.metrics() == [] and pledger.global_ledger() is None
    monkeypatch.setattr(p256v3, "verify_batch_packed", _fake_verify)
    h = p256v3.verify_launch([(1, 1, 1, 1, 1)], device="cpu")
    assert h.rec is None and h.fetch() == [False]


def test_tracer_is_thread_local():
    """Each thread keeps its own current span (the handle crosses by
    ``attach`` only)."""
    tr = ptracer.Tracer(ring_blocks=2, slow_factor=0)
    root = tr.begin_block(1)
    tok = tr.attach(root)
    seen = []
    t = threading.Thread(target=lambda: seen.append(tr.current()))
    t.start()
    t.join()
    tr.detach(tok)
    assert seen == [None] and tr.current() is None
