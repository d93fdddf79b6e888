"""The operations server (``fabric_tpu_torch/opsserver.py``) against the
reference's (``fabric_tpu/opsserver.py``), both serving over HTTP: the
same metric operations give the same /metrics text; /healthz (OK and
503), /version, /logspec GET and PUT, /slo, /autopilot, /vitals, the
debug routes and 404 give the reference's status and JSON; /trace,
/launches and /txflow answer with the reference's shape (the port's
/launches adds ``kernel_launches``, its kernel wrappers' counts)."""

import asyncio
import json
import logging
import threading
import urllib.error
import urllib.request

import pytest

from fabric_tpu import opsserver as jops
from fabric_tpu import ops_metrics as jmetrics
from fabric_tpu.observe import ledger as jledger
from fabric_tpu.observe import slo as jslo
from fabric_tpu.observe import tracer as jtracer
from fabric_tpu.observe import txflow as jtxflow
from fabric_tpu_torch import kernels
from fabric_tpu_torch import opsserver as pops
from fabric_tpu_torch import ops_metrics as pmetrics
from fabric_tpu_torch.observe import ledger as pledger
from fabric_tpu_torch.observe import slo as pslo
from fabric_tpu_torch.observe import tracer as ptracer
from fabric_tpu_torch.observe import txflow as ptxflow


def _feed(reg):
    """The same metric operations on either package's registry."""
    c = reg.counter("ledger_transaction_count", "committed txs by validity")
    c.add(7, channel="ch", status="valid")
    c.add(2, channel="ch", status="invalid")
    c.add(1, channel="other", status="valid")
    g = reg.gauge("ledger_blockchain_height", "committed block height")
    g.set(12, channel="ch")
    g.set(3.5, channel="other")
    h = reg.histogram("validation_duration", "validate phase per block (s)")
    for v in (0.001, 0.02, 0.3, 2.5, 40.0):
        h.observe(v, channel="ch")
    reg.counter("deliver_reconnects_total", "reconnects").add(1)
    return reg


class _Servers:
    """Both packages' servers on one background loop."""

    def __init__(self, health_checks, launches=None, txflow=None, armed=None):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.ports = {}
        self.servers = []
        for pkg, ops, metrics, tr in (("ref", jops, jmetrics, jtracer),
                                      ("port", pops, pmetrics, ptracer)):
            health = ops.HealthRegistry()
            for name, fn in health_checks:
                health.register(name, fn)
            kw = {"registry": _feed(metrics.Registry()), "health": health,
                  "tracer": tr.Tracer(), "launches": (launches or {}).get(pkg),
                  "txflow": (txflow or {}).get(pkg)}
            kw["slo"] = (jslo if pkg == "ref" else pslo).SloEngine()
            kw.update((armed or {}).get(pkg, {}))
            srv = asyncio.run_coroutine_threadsafe(
                ops.OperationsServer(port=0, **kw).start(), self.loop).result(10)
            self.servers.append(srv)
            self.ports[pkg] = srv.port

    def get(self, pkg, path, method="GET", body=None):
        req = urllib.request.Request(f"http://127.0.0.1:{self.ports[pkg]}{path}",
                                     method=method, data=body)
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.headers.get("Content-Type"), r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Content-Type"), e.read()

    def both(self, path, **kw):
        return self.get("ref", path, **kw), self.get("port", path, **kw)

    def close(self):
        for srv in self.servers:
            asyncio.run_coroutine_threadsafe(srv.stop(), self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


@pytest.fixture
def servers(monkeypatch):
    """Servers whose process-global controllers are unconfigured (the
    reference resolves its autopilot, recorder and ledgers lazily)."""
    import fabric_tpu.control as jcontrol
    import fabric_tpu_torch.control as pcontrol
    from fabric_tpu.observe import blackbox as jbb
    from fabric_tpu.observe import timeseries as jts
    from fabric_tpu_torch.observe import blackbox as pbb
    from fabric_tpu_torch.observe import timeseries as pts

    for mod in (jcontrol, pcontrol):
        monkeypatch.setattr(mod, "global_autopilot", lambda: None)
    for mod in (jts, pts):
        monkeypatch.setattr(mod, "global_sampler", lambda: None)
    for mod in (jbb, pbb):
        monkeypatch.setattr(mod, "global_blackbox", lambda: None)
    monkeypatch.setattr(jledger, "global_ledger", lambda: None)
    monkeypatch.setattr(pledger, "global_ledger", lambda: None)
    monkeypatch.setattr(jtxflow, "global_journal", lambda: None)
    monkeypatch.setattr(ptxflow, "global_journal", lambda: None)
    s = _Servers([("ok", lambda: None), ("also", lambda: True)])
    yield s
    s.close()


def test_the_same_operations_render_the_same_metrics(servers):
    (js, jt, jb), (ps, pt, pb) = servers.both("/metrics")
    assert (ps, pt) == (js, jt) == (200, "text/plain; version=0.0.4")
    assert pb == jb and b"ledger_blockchain_height" in pb
    assert _feed(pmetrics.Registry()).render() == _feed(jmetrics.Registry()).render()


@pytest.mark.parametrize("path,method,body", [
    ("/healthz", "GET", None), ("/version", "GET", None), ("/logspec", "GET", None),
    ("/nosuch", "GET", None), ("/autopilot", "GET", None), ("/vitals", "GET", None),
    ("/vitals?metric=ledger_blockchain_height", "GET", None),
    ("/vitals?incident=3", "GET", None), ("/vitals?incident=x", "GET", None),
    ("/trace?block=5", "GET", None), ("/trace?block=x", "GET", None),
    ("/trace?ns=sidecar&block=2", "GET", None), ("/launches", "GET", None),
    ("/txflow", "GET", None), ("/debug/profile?seconds=x", "GET", None),
    ("/debug/nosuch", "GET", None), ("/logspec", "PUT", b"{not json"),
    ("/logspec", "PUT", b'{"nospec": 1}'),
])
def test_a_route_answers_as_the_reference(servers, path, method, body):
    (js, jt, jb), (ps, pt, pb) = servers.both(path, method=method, body=body)
    assert (ps, pt) == (js, jt)
    if jt == "application/json" and jb:
        got, want = json.loads(pb), json.loads(jb)
        if path.startswith("/logspec") and method == "PUT":
            assert set(got) == set(want) == {"error"}
        else:
            assert got == want
    else:
        assert pb == jb


def test_healthz_fails_as_the_reference():
    def bad():
        return "ledger ch unhealthy"

    def boom():
        raise RuntimeError("gone")

    s = _Servers([("ok", lambda: None), ("ledgers", bad), ("rpc_server", boom)])
    try:
        (js, _, jb), (ps, _, pb) = s.both("/healthz")
        assert ps == js == 503
        assert json.loads(pb) == json.loads(jb) == {
            "status": "Service Unavailable", "failed_checks": [
                {"component": "ledgers", "reason": "ledger ch unhealthy"},
                {"component": "rpc_server", "reason": "RuntimeError: gone"}]}
    finally:
        s.close()


def test_logspec_put_sets_the_levels(servers):
    names = ("fabric_tpu_torch", "fabric_tpu_torch.peer", "fabric_tpu", "fabric_tpu.peer")
    old = {n: logging.getLogger(n).level for n in names}
    root = logging.getLogger("fabric_tpu_torch")
    try:
        (js, _, _), (ps, _, _) = servers.both(
            "/logspec", method="PUT",
            body=b'{"spec": "error:fabric_tpu_torch.peer=debug:fabric_tpu.peer=debug"}')
        assert ps == js == 204
        assert root.level == logging.ERROR
        assert logging.getLogger("fabric_tpu_torch.peer").level == logging.DEBUG
        _, (_, _, pb) = servers.both("/logspec")
        assert json.loads(pb) == {"spec": "ERROR"}
    finally:
        for n, level in old.items():
            logging.getLogger(n).setLevel(level)


def test_slo_answers_an_unconfigured_engine(servers):
    (js, _, jb), (ps, _, pb) = servers.both("/slo")
    got, want = json.loads(pb), json.loads(jb)
    assert ps == js == 200
    assert set(got) == set(want) == {"objectives", "clock_s"}
    assert got["objectives"] == want["objectives"] == []


def test_trace_has_the_references_shape(servers):
    (js, _, jb), (ps, _, pb) = servers.both("/trace?overlap_window=1")
    got, want = json.loads(pb), json.loads(jb)
    assert ps == js == 200
    assert got == want


def test_debug_routes(servers):
    (js, jt, jb), (ps, pt, pb) = servers.both("/debug/stacks")
    assert (ps, pt) == (js, jt) == (200, "text/plain")
    assert b"--- thread " in pb
    (js, jt, jb), (ps, pt, pb) = servers.both("/debug/profile?seconds=0.1")
    assert (ps, pt) == (js, jt) == (200, "text/plain")
    assert pb.split(b"\n")[1] == jb.split(b"\n")[1]  # the table's header


def test_launches_and_txflow_armed_have_the_references_shape():
    ledgers = {"ref": jledger.LaunchLedger(registry=jmetrics.Registry(),
                                           tracer=jtracer.Tracer()),
               "port": pledger.LaunchLedger(registry=pmetrics.Registry(),
                                            tracer=ptracer.Tracer())}
    journals = {"ref": jtxflow.FlowJournal(registry=jmetrics.Registry(),
                                           tracer=jtracer.Tracer()),
                "port": ptxflow.FlowJournal(registry=pmetrics.Registry(),
                                            tracer=ptracer.Tracer())}
    s = _Servers([], launches=ledgers, txflow=journals)
    try:
        for path in ("/launches", "/launches?n=0", "/launches?n=x", "/txflow",
                     "/txflow?tx=nosuch", "/txflow?n=x"):
            (js, _, jb), (ps, _, pb) = s.both(path)
            assert ps == js, path
            got, want = json.loads(pb), json.loads(jb)
            if path.startswith("/launches") and ps == 200:
                assert got.pop("kernel_launches") == kernels.launches
                got.pop("live_device_bytes", None)
                want.pop("live_device_bytes", None)
            assert set(got) == set(want), path
            if ps != 200:
                assert got == want
    finally:
        s.close()


class _Clock:
    def __init__(self, t: float):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _armed(pkg):
    """One package's SLO engine, autopilot, sampler and black box on a
    fake clock, put through the same operations: burns, two decisions,
    three sample passes and one incident bundle."""
    if pkg == "ref":
        from fabric_tpu.control import Autopilot, Signals
        from fabric_tpu.observe import Tracer, blackbox, slo, timeseries
        metrics = jmetrics
    else:
        from fabric_tpu_torch.control import Autopilot, Signals
        from fabric_tpu_torch.observe import Tracer, blackbox, slo, timeseries
        metrics = pmetrics
    clk = _Clock(100.0)
    reg = metrics.Registry()
    engine = slo.SloEngine(slo.parse_slos("lat:latency:ms=100:windows=30,300:min_events=2:"
                                          "fast=0;busy:busy:pct=5"), clock=clk, registry=reg)
    for i in range(12):
        clk.t += 0.5
        engine.record(engine.objectives[0], "ch", good=i % 3 != 0)
        engine.record(engine.objectives[1], "sidecar:t1", good=i % 5 != 0)
    tracer = Tracer(ring_blocks=8, slow_factor=0, clock=clk)
    # "verify_chunk": the reference's default knob set (the port opts it in)
    ap = Autopilot("verify_chunk", lambda k, v: None, slo=engine, tracer=tracer, clock=clk, registry=reg,
                   initial={"coalesce_blocks": 0, "verify_chunk": 0, "pipeline_depth": 2})
    ap.tick(Signals(launch_p99_ms=300.0, clock_s=clk.t))
    clk.t += 20.0
    ap.tick(Signals(queue_age_p99_ms={"t1": 80.0}, clock_s=clk.t))
    sampled = _feed(metrics.Registry())
    sampler = timeseries.MetricsSampler(interval_s=1.0, retention=8, registry=sampled,
                                        clock=clk)
    for _ in range(3):
        clk.t += 1.0
        sampler.sample()
        sampled.counter("deliver_reconnects_total").add(2)
    bb = blackbox.BlackBox(out_dir="", sampler=sampler, tracer=tracer, autopilot=ap, slo=engine,
                           registry=reg, clock=clk)
    bb.record("slo_fast_burn", slo="lat", channel="ch", burn=20.0)
    return {"slo": engine, "autopilot": ap, "vitals": sampler, "blackbox": bb}


def _no_wall(x):
    if isinstance(x, dict):
        return {k: _no_wall(v) for k, v in x.items() if k != "wall_s"}
    if isinstance(x, list):
        return [_no_wall(v) for v in x]
    return x


@pytest.mark.parametrize("path", [
    "/slo", "/autopilot", "/vitals", "/vitals?metric=deliver_reconnects_total",
    "/vitals?metric=ledger_blockchain_height&label=channel=ch", "/vitals?incident=1"])
def test_armed_routes_answer_as_the_reference(monkeypatch, path):
    """The SLO engine, the autopilot, the sampler and the black box of
    each package, put through the same operations, serve the same
    /slo, /autopilot and /vitals JSON (the bundles' wall-clock times
    aside)."""
    from fabric_tpu import faults as jfaults
    from fabric_tpu_torch import faults as pfaults

    for mod in (jledger, pledger):
        monkeypatch.setattr(mod, "global_ledger", lambda: None)
    for mod in (jtxflow, ptxflow):
        monkeypatch.setattr(mod, "global_journal", lambda: None)
    for mod in (jfaults, pfaults):
        monkeypatch.setattr(mod, "plan", lambda: None)
    s = _Servers([], armed={pkg: _armed(pkg) for pkg in ("ref", "port")})
    try:
        (js, jt, jb), (ps, pt, pb) = s.both(path)
        assert (ps, pt) == (js, jt) == (200, "application/json")
        got, want = json.loads(pb), json.loads(jb)
        assert _no_wall(got) == _no_wall(want)
        if path == "/autopilot":
            assert [d["knob"] for d in got["decisions"]] == ["verify_chunk", "coalesce_blocks"]
        if path == "/vitals?incident=1":
            assert {"vitals", "traces", "autopilot", "slo"} <= set(got)
    finally:
        s.close()


@pytest.mark.parametrize("lane", ["healthy", "device", "sidecar"])
def test_the_peers_device_lane_check_names_what_the_port_does(tmp_path, lane):
    """``device_verify_lane``: a degraded guard is a failed check whose
    reason says the channel commits through the card's own
    ``p256_verify`` (the port has no CPU fallback)."""
    from types import SimpleNamespace

    from fabric_tpu_torch.crypto.msp import MSPManager
    from fabric_tpu_torch.peer.node import PeerNode

    node = PeerNode("p", str(tmp_path / "p"), MSPManager(), None, device="cpu")
    validator = SimpleNamespace(device_guard=SimpleNamespace(degraded=lane != "healthy"))
    if lane == "sidecar":
        validator.link = object()
    node.channels["ch"] = SimpleNamespace(validator=validator)
    reason = node._device_lanes()
    if lane == "healthy":
        assert reason is None
    else:
        assert reason.startswith("channel ch: ")
        assert "p256_verify on the card" in reason and "CPU" not in reason
        assert ("sidecar link" in reason) == (lane == "sidecar")
