"""The SLO burn-rate engine (``fabric_tpu_torch/observe/slo.py``) against
the reference's (``fabric_tpu/observe/slo.py``), on fake clocks: the
same specs parse to the same objectives (and the same malformed specs to
the same errors, ``tests/test_slo.py``'s cases); the same seeded event
stream, recorded directly, through the tracer's finished roots, through
the endorse observer and through the commit feed, gives the same burns
at every checkpoint, the same ``report()``, the same fast-burn WARNs
and the same gauges and counters.  Burns compare exactly."""

import logging
import types

import numpy as np
import pytest

from fabric_tpu import ops_metrics as jmetrics
from fabric_tpu.observe import Tracer as JTracer
from fabric_tpu.observe import slo as jslo
from fabric_tpu_torch import ops_metrics as pmetrics
from fabric_tpu_torch.observe import Tracer as PTracer
from fabric_tpu_torch.observe import slo as pslo
from fabric_tpu_torch.observe.tracer import global_tracer

PKGS = {"ref": types.SimpleNamespace(slo=jslo, m=jmetrics, Tracer=JTracer),
        "port": types.SimpleNamespace(slo=pslo, m=pmetrics, Tracer=PTracer)}
SPEC = ("lat:latency:ms=100:target=0.9:windows=10,60:min_events=3:fast=4;"
        "busy:busy:pct=10:windows=20;"
        "tight:latency:ms=20:channel=ch1:min_events=1:fast=2")


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.mark.parametrize("spec", [
    "", " ; ", SPEC, "commit:latency:ms=250:target=0.95:windows=30,120:fast=6;busy:busy:pct=5",
    "t:latency:ms=10:channel=chanA", pslo.DEFAULT_ENDORSE_SLOS, pslo.DEFAULT_COMMIT_SLOS])
def test_specs_parse_to_the_references_objectives(spec):
    assert pslo.DEFAULT_ENDORSE_SLOS == jslo.DEFAULT_ENDORSE_SLOS
    assert pslo.DEFAULT_COMMIT_SLOS == jslo.DEFAULT_COMMIT_SLOS
    got = [vars(o) for o in pslo.parse_slos(spec)]
    want = [vars(o) for o in jslo.parse_slos(spec)]
    assert got == want
    assert [o.budget for o in pslo.parse_slos(spec)] == [o.budget for o in jslo.parse_slos(spec)]


@pytest.mark.parametrize("bad", [
    "nokind", "x:frobnicate:ms=5", "x:latency", "x:latency:ms=0", "x:busy", "x:busy:pct=0",
    "x:busy:pct=100", "x:latency:ms=5:target=1.5", "x:latency:ms=5:bogus=1",
    "x:latency:ms=five", "x:latency:ms=5;x:busy:pct=1", "x:latency:ms=5:windows=0",
    "x:latency:ms=5:windows=-5,60", "x:latency:ms=5:min_events=0"])
def test_malformed_specs_raise_the_references_error(bad):
    with pytest.raises(jslo.SloError) as want:
        jslo.parse_slos(bad)
    with pytest.raises(pslo.SloError) as got:
        pslo.parse_slos(bad)
    assert str(got.value) == str(want.value)


def _finish(tr, number, dur_s, ns="", **attrs):
    root = tr.begin_block(number, ns=ns, **attrs)
    root.t1 = root.t0 + dur_s
    tr.finish_block(root)


def _stream(pkg, seed, caplog):
    """One package's engine under the seeded event stream → what it
    reported along the way."""
    p = PKGS[pkg]
    clk = Clock()
    reg = p.m.Registry()
    eng = p.slo.SloEngine(p.slo.parse_slos(SPEC + ";" + p.slo.DEFAULT_ENDORSE_SLOS + ";"
                                           + p.slo.DEFAULT_COMMIT_SLOS),
                          clock=clk, registry=reg)
    tr = p.Tracer(ring_blocks=8, slow_factor=0, clock=clk)
    tr.add_listener(eng.on_block)
    endorse, commit = p.slo.endorse_observer(eng), p.slo.commit_feed(eng)
    rng = np.random.default_rng(seed)
    trail = []
    caplog.clear()
    for i in range(400):
        clk.t += float(rng.exponential(0.25))
        r = rng.random()
        if r < 0.35:
            ns = rng.choice(["", "sidecar", "autopilot", "sign"])
            chan = (f"sidecar:t{rng.integers(0, 3)}" if ns == "sidecar"
                    else str(rng.choice(["ch1", "ch2"])))
            busy = ns == "sidecar" and rng.random() < 0.15
            _finish(tr, i, float(rng.exponential(0.08)), ns=ns, channel=chan,
                    **({"busy": True} if busy else {}))
        elif r < 0.55:
            o = eng.objectives[int(rng.integers(0, 3))]
            eng.record(o, str(rng.choice(["ch1", "ch2"])), good=bool(rng.random() < 0.7))
        elif r < 0.8:
            busy = bool(rng.random() < 0.1)
            endorse(None if busy else float(rng.exponential(15.0)), busy)
        else:
            commit(float(rng.exponential(0.6)), bool(rng.random() < 0.9),
                   int(rng.integers(1, 4)))
        if i % 25 == 0:
            trail.append((eng.burns(), eng.burns(window=60.0),
                          eng.burn("lat", "ch1"), eng.burn("endorse", "endorse")))
    clk.t += 45.0  # past the short windows: the burns decay with no new traffic
    trail.append((eng.burns(), eng.burn("lat", "ch1")))
    warns = [r.getMessage() for r in caplog.records if "fast burn" in r.getMessage()]
    return {"trail": trail, "report": eng.report(), "warns": warns,
            "render": reg.render(),
            "fast": reg.counter("slo_fast_burn_total").snapshot()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_same_event_stream_burns_as_the_reference(seed, caplog):
    caplog.set_level(logging.WARNING)
    got, want = _stream("port", seed, caplog), _stream("ref", seed, caplog)
    assert got == want
    assert got["warns"] and got["fast"]  # the stream trips the fast-burn WARN
    chans = {c for o in got["report"]["objectives"] for c in o["channels"]}
    assert {"ch1", "endorse", "commit", "sidecar:t0"} <= chans
    assert "autopilot" not in str(sorted(chans))


def test_configure_attaches_the_global_engine_once():
    tr = global_tracer()
    try:
        eng = pslo.configure("g:latency:ms=999999:windows=60")
        assert eng is pslo.global_engine() and eng.objectives[0].name == "g"
        assert tr._listeners.count(eng.on_block) == 1
        pslo.configure("g:latency:ms=999999:windows=60")
        assert tr._listeners.count(eng.on_block) == 1
    finally:
        pslo.configure("")
    assert pslo.global_engine().objectives == ()
