"""The port's host staging pool (``fabric_tpu_torch/parallel/hostpool.py``)
on the cases of ``tests/test_hostpool.py`` that its callers use: the
knob's resolution (the reference's pool resolves the same knob values to
the same sizes), the constructor's guard, results in submission order,
errors that keep their type and carry the stage and worker, ``stats()``
by stage and worker, and ``BlockValidator(host_stage_workers=)`` with
its ``close()``."""

import os
import sys
import threading

import pytest

from fabric_tpu.parallel import hostpool as jhostpool
from fabric_tpu_torch import carry
from fabric_tpu_torch.parallel.hostpool import HostStagePool, resolve_host_pool
from fabric_tpu_torch.peer.validator import BlockValidator

CORES = os.cpu_count() or 1


def test_resolve_semantics():
    assert resolve_host_pool(0) is None
    assert resolve_host_pool(1) is None
    auto = resolve_host_pool(-1)
    if CORES < 2:
        assert auto is None
        return
    assert auto is not None and auto.workers == CORES
    auto.shutdown()
    for n in (2, 10_000):
        p = resolve_host_pool(n)
        assert p.workers == min(n, CORES)
        p.shutdown()


@pytest.mark.parametrize("knob", [0, 1, 2, 3, -1, 10_000])
def test_resolve_matches_reference(knob):
    got, want = resolve_host_pool(knob), jhostpool.resolve_host_pool(knob)
    try:
        assert (got is None) == (want is None)
        if got is not None:
            assert got.workers == want.workers
    finally:
        for p in (got, want):
            if p is not None:
                p.shutdown()


@pytest.mark.parametrize("workers", [-1, 0, 1])
def test_constructor_guard(workers):
    with pytest.raises(ValueError, match=">= 2 workers"):
        HostStagePool(workers)


@pytest.mark.parametrize("workers", [2, 3, 4])
def test_results_in_submission_order_and_stats(workers):
    """Futures gathered in submission order give each task's own result
    whatever order the workers finish in; ``stats()`` counts every task
    under its stage and the worker that ran it."""
    gate = threading.Event()

    def task(x):
        if x == 0:
            gate.wait(5.0)  # the first task finishes last
        return x * x

    with HostStagePool(workers) as p:
        futs = [p.submit(task, x, stage="sq") for x in range(20)]
        futs += [p.submit(lambda x: -x, x, stage="neg") for x in range(5)]
        gate.set()
        assert [f.result(timeout=10) for f in futs] == \
            [x * x for x in range(20)] + [-x for x in range(5)]
        st = p.stats()
        assert st["workers"] == workers and st["tasks"] == 25
        assert st["per_shard_p50_ms"] >= 0.0
        by = st["by_stage"]
        assert sum(w["tasks"] for w in by["sq"].values()) == 20
        assert sum(w["tasks"] for w in by["neg"].values()) == 5
        assert len(by["sq"]) <= workers
        assert all(w["seconds"] >= 0.0 for s in by.values() for w in s.values())


def test_error_carries_stage_and_worker_labels():
    """A failing task raises at ``result()`` with its type, a
    ``[host pool stage=… worker=…]`` suffix and the attributes; a second
    ``result()`` does not label it twice, and the pool still serves."""

    def boom(x):
        if x == 2:
            raise ValueError("bad shard")
        return x

    with HostStagePool(2) as p:
        futs = [p.submit(boom, x, stage="recode") for x in range(6)]
        with pytest.raises(ValueError,
                           match=r"bad shard \[host pool stage=recode worker=") as ei:
            [f.result() for f in futs]
        assert ei.value.fab_stage == "recode" and ei.value.fab_worker
        with pytest.raises(ValueError) as again:
            futs[2].result()
        assert str(again.value).count("[host pool") == 1
        assert [f.result() for f in futs if f is not futs[2]] == [0, 1, 3, 4, 5]
        assert p.submit(lambda: 7, stage="recode").result() == 7


def test_error_propagates_from_submit():
    with HostStagePool(2) as p:
        fut = p.submit(lambda: 1 / 0, stage="div")
        with pytest.raises(ZeroDivisionError) as ei:
            fut.result()
        assert ei.value.fab_stage == "div"
        assert "div" in p.stats()["by_stage"]  # a failed task is counted too


@pytest.mark.skipif(CORES < 2, reason="needs 2 cores")
def test_validator_pool_at_construction_and_close():
    state, prov, _ = carry.from_reference([], {}, [])
    v = BlockValidator(prov, state, device="cpu")
    assert v.host_pool is None and v.host_stage_workers == 0
    v.close()  # no pool: nothing to shut
    v = BlockValidator(prov, state, device="cpu", host_stage_workers=2)
    assert v.host_pool.workers == 2
    v.close()
    v.close()
    assert v.host_pool is None
    v = BlockValidator(prov, state, device="cpu", host_stage_workers=1)
    assert v.host_pool is None  # a pool of one worker is no pool


def test_stress_more_workers_than_cores_loses_no_count():
    """More workers than cores and a short switch interval: every task's
    count reaches ``stats()`` (a lost read-modify-write would not)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with HostStagePool(2 * CORES + 1) as p:
            n = 3000
            futs = [p.submit(lambda x: x + 1, x, stage="stress") for x in range(n)]
            assert [f.result() for f in futs] == list(range(1, n + 1))
        st = p.stats()  # after shutdown: every task's finally has run
        assert st["tasks"] == n
        assert sum(w["tasks"] for w in st["by_stage"]["stress"].values()) == n
    finally:
        sys.setswitchinterval(old)
