"""The flight recorder (``fabric_tpu_torch/observe/{timeseries,
blackbox}.py``) against the reference's (``fabric_tpu/observe/``), on
fake clocks: the same registry operations give the same sampler series,
rates and report; the same incidents give the same bundles (sections,
detail, truncation, rate limits, ``max_bundles`` in memory and on disk,
the sequence resumed after a restart), wall-clock times aside; the
port's incident edges (the guard's latch, a failed pipe stage, a shed
decision, a fast burn) each write one bundle; an ``injected_crash``
bundle is written from a child process, as ``tests/test_vitals.py``
does.  Everything compares exactly."""

import json
import os
import subprocess
import sys
import types

import pytest

from fabric_tpu import faults as jfaults
from fabric_tpu import ops_metrics as jmetrics
from fabric_tpu.control import Autopilot as JAutopilot
from fabric_tpu.control import Signals as JSignals
from fabric_tpu.observe import Tracer as JTracer
from fabric_tpu.observe import blackbox as jbb
from fabric_tpu.observe import ledger as jledger
from fabric_tpu.observe import timeseries as jts
from fabric_tpu.observe import txflow as jtxflow
from fabric_tpu.peer.degrade import DeviceLaneGuard as JGuard
from fabric_tpu_torch import faults as pfaults
from fabric_tpu_torch import ops_metrics as pmetrics
from fabric_tpu_torch.control import Autopilot as PAutopilot
from fabric_tpu_torch.control import Signals as PSignals
from fabric_tpu_torch.observe import Tracer as PTracer
from fabric_tpu_torch.observe import blackbox as pbb
from fabric_tpu_torch.observe import ledger as pledger
from fabric_tpu_torch.observe import timeseries as pts
from fabric_tpu_torch.observe import txflow as ptxflow
from fabric_tpu_torch.peer.degrade import DeviceLaneGuard as PGuard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "ref": types.SimpleNamespace(m=jmetrics, ts=jts, bb=jbb, faults=jfaults, Tracer=JTracer,
                                 Autopilot=JAutopilot, Signals=JSignals, Guard=JGuard),
    "port": types.SimpleNamespace(m=pmetrics, ts=pts, bb=pbb, faults=pfaults, Tracer=PTracer,
                                  Autopilot=PAutopilot, Signals=PSignals, Guard=PGuard),
}


class Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def _quiet_globals(monkeypatch):
    """No process-global ledger or journal feeds a bundle, and every
    test leaves both packages' recorders off."""
    for mod in (jledger, pledger):
        monkeypatch.setattr(mod, "global_ledger", lambda: None)
    for mod in (jtxflow, ptxflow):
        monkeypatch.setattr(mod, "global_journal", lambda: None)
    yield
    for p in PKGS.values():
        p.ts.configure(0)
        p.bb.configure(enabled=False)
        p.faults.reset()


def _no_wall(x):
    if isinstance(x, dict):
        return {k: _no_wall(v) for k, v in x.items() if k != "wall_s"}
    if isinstance(x, list):
        return [_no_wall(v) for v in x]
    return x


def _both(fn):
    """``fn(pkg namespace)`` for each package → (port's, reference's)."""
    return fn(PKGS["port"]), fn(PKGS["ref"])


# ---------------------------------------------------------------------------
# the sampler


def _sampled(p, retention=8):
    clk = Clock()
    reg = p.m.Registry()
    s = p.ts.MetricsSampler(interval_s=1.0, retention=retention, registry=reg, clock=clk)
    c, g = reg.counter("reqs_total", "t"), reg.gauge("depth", "t")
    h = reg.histogram("lat_s", "t")
    for i in range(11):
        c.add(i % 4, tenant="a")
        c.add(1, tenant="b")
        g.set(i * 1.5, tenant="a")
        if i % 3:
            h.observe(0.002 * i)
            h.observe(0.3)
        if i == 6:  # a reset: the new level is recorded, never a negative delta
            with c._lock:
                c._values[(("tenant", "a"),)] = 1.0
        s.sample()
        clk.t += 1.0
    out = {"series": s.series(), "report": s.report(spark=5),
           "rate": s.rate("reqs_total", tenant="b"), "points": s.series(points=3)}
    s.configure(retention=3)
    out["resized"] = s.series(metric="depth")
    return out


def test_the_same_registry_operations_give_the_same_series():
    got, want = _both(_sampled)
    assert got == want
    assert got["series"]["reqs_total"]["tenant=b"]["points"][-1][1] == 1.0
    assert [p["n"] for _, p in got["series"]["lat_s"]["_"]["points"]][:3] == [0, 2, 2]


@pytest.mark.parametrize("bad", [{"interval_s": -1}, {"retention": 0}])
def test_sampler_validation_as_the_reference(bad):
    for p in PKGS.values():
        with pytest.raises(ValueError):
            p.ts.MetricsSampler(registry=p.m.Registry(), **bad)


def test_acquire_release_refcount_as_the_reference(tmp_path):
    def trail(p):
        out = []
        s1 = p.ts.acquire(5.0, retention=4, registry=p.m.Registry())
        s2 = p.ts.acquire(5.0, retention=9)
        b1 = p.bb.acquire(out_dir=str(tmp_path / "a"), registry=p.m.Registry())
        b2 = p.bb.acquire(out_dir=str(tmp_path / "b"))
        out.append((s1 is s2, b1 is b2, s1.retention, b1.out_dir == str(tmp_path / "a")))
        p.ts.release()
        p.bb.release()
        out.append((p.ts.global_sampler() is s1, p.bb.global_blackbox() is b1))
        p.ts.release()
        p.bb.release()
        out.append((p.ts.global_sampler(), p.bb.global_blackbox(), p.ts.acquire(0)))
        return out

    got, want = _both(trail)
    assert got == want == [(True, True, 4, True), (True, True), (None, None, None)]


# ---------------------------------------------------------------------------
# bundles


def _incident(p, out_dir, **bb_kw):
    """A sampler with trails, a tracer with a block tree, an autopilot
    with one decision, a seeded fault plan, then a guard that latches →
    the recorder's index and bundle."""
    clk = Clock()
    reg = p.m.Registry()
    s = p.ts.MetricsSampler(interval_s=1.0, retention=8, registry=reg, clock=clk)
    reg.counter("fallback_seen_total", "t").add(3, channel="ch1")
    s.sample()
    tr = p.Tracer(ring_blocks=4, slow_factor=0, clock=clk)
    root = tr.begin_block(7, channel="ch1")
    clk.t += 0.25
    tr.finish_block(root)
    # "verify_chunk": the reference's default knob set (the port opts it in)
    ap = p.Autopilot("verify_chunk", lambda k, v: None,
                     tracer=p.Tracer(ring_blocks=4, slow_factor=0, clock=clk),
                     clock=clk, registry=reg)
    ap.tick(p.Signals(queue_age_p99_ms={"t1": 500.0}, clock_s=clk()))
    bb = p.bb.configure(out_dir=out_dir, sampler=s, tracer=tr, autopilot=ap, clock=clk,
                        registry=reg, **bb_kw)
    guard = p.Guard(fail_threshold=2, retries=1, channel="ch1", clock=clk,
                    sleep=lambda _s: None)
    p.faults.install(p.faults.FaultPlan("validator.verify_launch:raise:n=4", seed=7))
    try:
        guard.run_launch(lambda: "device", lambda: "fallback")
        guard.record_success()
        guard.record_failure(RuntimeError("again"))
        guard.record_failure(RuntimeError("again"))  # inside the rate limit: no bundle
    finally:
        p.faults.reset()
    idx = bb.bundles()
    return idx, [bb.bundle(b["seq"]) for b in idx], sorted(os.listdir(out_dir))


def test_a_latch_bundle_has_the_references_anatomy(tmp_path):
    (gidx, gb, gfiles), (widx, wb, wfiles) = (
        _incident(PKGS["port"], str(tmp_path / "port")),
        _incident(PKGS["ref"], str(tmp_path / "ref")))
    assert gfiles == wfiles == ["blackbox-0001-degrade_latch.json"]
    assert len(gb) == len(wb) == 1
    # the port names its fallback route; everything else is the reference's
    # (the index entry shares the bundle's detail)
    assert gb[0]["detail"].pop("fallback") == "synchronous p256_verify on the card"
    assert _no_wall(gb) == _no_wall(wb) and _no_wall(gidx) == _no_wall(widx)
    b = gb[0]
    assert set(b) >= {"vitals", "traces", "autopilot", "faults"}
    assert b["autopilot"]["decisions"][0]["knob"] == "coalesce_blocks"
    assert b["traces"]["_"][0]["block"] == 7
    assert b["faults"]["validator.verify_launch"][0]["fired"] == 2
    on_disk = json.loads((tmp_path / "port" / gfiles[0]).read_text())
    assert on_disk["detail"].pop("fallback") == "synchronous p256_verify on the card"
    assert _no_wall(on_disk) == _no_wall(b)


def test_truncation_rate_limits_and_the_ring_as_the_reference(tmp_path):
    def run(p):
        clk = Clock()
        reg = p.m.Registry()
        s = p.ts.MetricsSampler(interval_s=1.0, retention=256, registry=reg, clock=clk)
        g = reg.gauge("wide", "t")
        for i in range(400):
            g.set(i, series=f"s{i % 40}")
        for _ in range(64):
            s.sample()
            clk.t += 1.0
        d = tmp_path / p.m.__name__
        bb = p.bb.BlackBox(out_dir=str(d), sampler=s, clock=clk, registry=reg,
                           tracer=p.Tracer(ring_blocks=0), max_bytes=20_000, max_bundles=3,
                           min_interval_s=30.0)
        seen = [bb.record("degrade_latch", channel="ch1"), bb.record("degrade_latch"),
                bb.record("autopilot_shed")]
        for i in range(4):
            clk.t += 31.0
            seen.append(bb.record(f"kind{i}"))
        limited = reg.counter("blackbox_rate_limited_total", "").value(kind="degrade_latch")
        files = sorted(os.listdir(d))
        # a restart over the same directory resumes the sequence
        bb2 = p.bb.BlackBox(out_dir=str(d), sampler=s, clock=clk, registry=reg,
                            max_bundles=3, min_interval_s=0.0)
        bb2.record("degrade_latch")
        return (_no_wall(seen), _no_wall(bb.bundles()), limited, files,
                sorted(os.listdir(d)))

    got, want = _both(run)
    assert got == want
    first = got[0][0]
    assert len(json.dumps(first)) <= 20_000 and "vitals" in first["truncated"]
    assert got[0][1] is None and got[2] == 1
    assert got[4] == ["blackbox-0005-kind2.json", "blackbox-0006-kind3.json",
                      "blackbox-0007-degrade_latch.json"]


def test_the_ports_incident_edges_each_write_one_bundle(tmp_path):
    """A shed decision, a fast burn and a failed pipe stage, on the
    port's own objects (the guard's latch: the test above)."""
    from fabric_tpu_torch.ledger.statedb import MemVersionedDB
    from fabric_tpu_torch.observe.slo import Objective, SloEngine
    from fabric_tpu_torch.peer.pipeline import CommitPipeline
    from test_torch_autopilot import _MiniValidator, _stream

    clk = Clock()
    reg = pmetrics.Registry()
    ap = PAutopilot(None, lambda k, v: None, set_shed=lambda t, on: None,
                    tracer=PTracer(ring_blocks=4, slow_factor=0, clock=clk), clock=clk,
                    registry=reg)
    bb = pbb.configure(out_dir=str(tmp_path), clock=clk, registry=reg, autopilot=ap,
                       tracer=PTracer(ring_blocks=4, slow_factor=0, clock=clk))
    d = ap.tick(PSignals(burn={("lat", "sidecar:noisy"): 9.0}, clock_s=clk()))
    assert (d.knob, d.direction) == ("shed", "on")
    eng = SloEngine([Objective(name="lat", kind="latency", ms=10.0, windows=(60.0,),
                               min_events=1)], clock=clk, registry=reg)
    for _ in range(3):
        eng.record(eng.objectives[0], "ch1", good=False)

    def wedged(res):
        raise RuntimeError("committer wedged")

    pipe = CommitPipeline(_MiniValidator(MemVersionedDB()), wedged, depth=2, channel="ch1",
                          tracer=PTracer(ring_blocks=4, slow_factor=0))
    with pytest.raises(RuntimeError, match="wedged"):
        for b in _stream(3):
            pipe.submit(b)
        pipe.flush()
    with pytest.raises(RuntimeError, match="closed"):
        pipe.submit(_stream(1)[0])
    idx = bb.bundles()
    assert [(b["kind"], b["detail"].get("tenant") or b["detail"].get("channel"))
            for b in idx] == [("autopilot_shed", "noisy"), ("slo_fast_burn", "ch1"),
                              ("pipeline_fail_closed", "ch1")]
    assert idx[2]["detail"]["stage"] == "commit"
    assert bb.bundle(idx[0]["seq"])["autopilot"]["decisions"][0]["knob"] == "shed"
    assert len(os.listdir(tmp_path)) == 3


_CHILD = r"""
import sys
from fabric_tpu_torch import faults
from fabric_tpu_torch.observe import blackbox
blackbox.configure(out_dir=sys.argv[1])
if sys.argv[2] == "crash":
    faults.configure("toy.point:crash")
    faults.fire("toy.point")
    raise SystemExit("unreachable: the crash fault exits first")
faults.configure("toy.point:raise:n=1")
try:
    faults.fire("toy.point")
except faults.InjectedFault:
    pass
assert "jax" not in sys.modules and "fabric_tpu" not in sys.modules
"""


@pytest.mark.parametrize("how", ["crash", "exit"])
def test_a_child_writes_its_last_gasp_bundle(tmp_path, how):
    """``crash``: the fault plan's crash exits the child with 86, after
    the armed recorder's ``faults.on_crash`` hook wrote the
    ``injected_crash`` bundle; ``exit``: a child whose plan fired but
    recorded nothing leaves the ``fault_stats_at_exit`` bundle."""
    env = {k: v for k, v in os.environ.items() if k != "FABTPU_FAULTS"}
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path), how],
                          capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == (86 if how == "crash" else 0), (proc.stdout, proc.stderr)
    kind = "injected_crash" if how == "crash" else "fault_stats_at_exit"
    (path,) = [p for p in tmp_path.iterdir() if p.name.endswith(f"{kind}.json")]
    bundle = json.loads(path.read_text())
    assert bundle["kind"] == kind
    assert bundle["faults"]["toy.point"][0]["fired"] == 1
    if how == "crash":
        assert bundle["detail"]["point"] == "toy.point"
