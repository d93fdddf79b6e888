"""The port's device-lane guard (``fabric_tpu_torch/peer/degrade.py``),
the validator's guarded lane, the pipeline's containment and the
resident cache's disable latch against the JAX package, on the CPU.

* Guard parity: both packages' ``DeviceLaneGuard`` driven by one
  scripted sequence of launch outcomes on a fake clock with no sleep:
  returns, the latch, probes, retries, backoff delays, fallbacks and
  degraded seconds step for step (the reference's registry against the
  port's ``stats()``).
* The validator's lane on ``device="cpu"`` (the reference's
  ``tests/test_faults.py:417-463``): guarded verdicts, a persistent
  launch fault that latches onto the synchronous launch of the same
  kernel (whose accept vector the fused stage 2 reads), a fetch-side
  failure re-verified, a failed fallback that raises, a stage-2 failure
  dispatched again on the device.  No fault sends a block to
  ``_validate_host``.
* The chaos differential: the reference's seeded plan
  (``tests/test_faults.py:713-765``) through the port's
  ``CommitPipeline(depth=2)`` with the containment loop over
  ``tests/test_torch_slice.py``'s corpus: filters, update batches and
  history equal the JAX ``BlockValidator``'s, and the faults fired at
  the guard's points equal its failures.  Latency-only chaos changes
  nothing.
* The residency latch: a failed scatter disables the port's cache as it
  disables the reference's, and the verdicts equal the reference's, also
  when the latch fires between a block's lookup and its table read.
"""

import numpy as np
import pytest
import torch

from fabric_tpu import faults as jfaults
from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.ledger.statedb import UpdateBatch as JUpdateBatch
from fabric_tpu.ops_metrics import Registry
from fabric_tpu.peer.degrade import DeviceLaneGuard as JGuard
from fabric_tpu.peer.validator import BlockValidator as JBlockValidator
from fabric_tpu.state import ResidencyManager as JResidencyManager
from fabric_tpu.utils.backoff import Backoff as JBackoff
from fabric_tpu_torch import carry, faults
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.ledger.statedb import MemVersionedDB, UpdateBatch
from fabric_tpu_torch.ops import p256v3
from fabric_tpu_torch.peer import validator as pv
from fabric_tpu_torch.peer.degrade import DeviceLaneGuard
from fabric_tpu_torch.peer.pipeline import CommitPipeline
from fabric_tpu_torch.state import ResidencyManager, residency
from fabric_tpu_torch.utils.backoff import Backoff
from test_torch_coalesce import _RowVerify
from test_torch_slice import POLICIES, _blocks, _decode, _reference, _rows, _seed_batch
from test_torch_slice import _Store, net  # noqa: F401  (module fixture)

SEED = 20260803


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_plan():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


# ---------------------------------------------------------------------------
# Guard parity


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Side:
    """One package's guard over the shared script: a step's lane fails
    at the scripted attempts; ``slow`` advances the clock by 200 ms an
    attempt."""

    def __init__(self, which, **kw):
        self.clock = _Clock()
        self.slept = []
        self.attempts = 0
        common = dict(clock=self.clock, sleep=self.slept.append, channel="t", **kw)
        if which == "ref":
            self.reg = Registry()
            self.g = JGuard(registry=self.reg, backoff=JBackoff(base=0.001, cap=0.004,
                                                                jitter=0.0), **common)
        else:
            self.reg = None
            self.g = DeviceLaneGuard(backoff=Backoff(base=0.001, cap=0.004, jitter=0.0),
                                     **common)

    def counters(self) -> dict:
        if self.reg is None:
            st = self.g.stats()
            return {"degraded": int(st["degraded"]), "retries": st["retries_total"],
                    "fallbacks": st["fallback_blocks_total"]}
        val = lambda name: (self.reg.metric(name).value(channel="t")
                            if self.reg.metric(name) else 0)
        return {"degraded": int(val("validator_degraded")),
                "retries": int(val("device_verify_retries_total")),
                "fallbacks": int(val("fallback_blocks_total"))}

    def step(self, advance, fail_attempts, eager, slow, count):
        self.clock.t += advance
        k0 = self.attempts

        def launch():
            self.attempts += 1
            if slow:
                self.clock.t += 0.2
            if self.attempts - k0 in fail_attempts:
                raise RuntimeError("lane fault")
            return "device"

        out = self.g.run_launch(launch, lambda: "fallback", eager=eager, fallback_count=count)
        return (out, self.g.degraded, self.g.consecutive_failures, self.attempts - k0,
                self.counters(), list(self.slept), round(self.g.degraded_seconds(), 9))


def _script(seed: int, n: int = 60):
    """(clock advance, failing attempt numbers, eager, slow, fallback
    count) per step."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        fails = {k for k in (1, 2, 3) if rng.random() < 0.45}
        out.append((float(rng.choice([0.0, 1.0, 4.0, 11.0])), fails, bool(rng.random() < 0.7),
                    bool(rng.random() < 0.15), int(rng.integers(1, 4))))
    return out


@pytest.mark.parametrize("kw", [
    dict(retries=2, fail_threshold=3, recovery_s=10.0),
    dict(retries=0, fail_threshold=1, recovery_s=5.0),
    dict(retries=1, fail_threshold=2, recovery_s=0.0),
    dict(retries=1, fail_threshold=2, recovery_s=3.0, deadline_ms=50.0),
], ids=["defaults", "latch_at_once", "probe_every_block", "deadline"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_guard_matches_reference_step_for_step(kw, seed):
    port, ref = _Side("port", **kw), _Side("ref", **kw)
    for st in _script(seed):
        assert port.step(*st) == ref.step(*st)
    assert port.g.degraded_seconds() == pytest.approx(ref.g.degraded_seconds())


def test_guard_counts_every_failed_attempt():
    """``failures_total``: every ``record_failure`` and every failed
    probe; a threshold of 0 is a construction error."""
    with pytest.raises(ValueError):
        DeviceLaneGuard(fail_threshold=0)
    side = _Side("port", retries=1, fail_threshold=2, recovery_s=1.0)
    side.step(0.0, {1, 2}, True, False, 1)   # two failures: latched
    side.step(0.5, {1}, True, False, 1)      # degraded, no probe due
    side.step(1.0, {1}, True, False, 1)      # a failed probe
    side.g.check_deadline(10.0)              # no deadline: not a failure
    side.step(1.0, set(), True, False, 1)    # a probe that re-arms
    st = side.g.stats()
    assert st == {"degraded": False, "consecutive_failures": 0, "failures_total": 3,
                  "retries_total": 1, "fallback_blocks_total": 3, "probes_total": 2,
                  "degraded_s": pytest.approx(2.5)}


def test_fallback_runs_shielded():
    faults.configure("validator.verify_launch:raise;p256v3.verify_launch:raise")
    g = DeviceLaneGuard(retries=0, fail_threshold=1, sleep=lambda s: None)

    def fallback():
        faults.fire("p256v3.verify_launch")  # a shared entry point
        return "fallback"

    assert g.run_launch(lambda: "device", fallback, eager=True) == "fallback"
    assert g.degraded and faults.plan().fired("p256v3.verify_launch") == 0


# ---------------------------------------------------------------------------
# The validator's lane


def _items():
    """5 signatures from ``ec_ref`` (4 valid, 1 corrupted)."""
    k = ec_ref.SigningKey(d=0x1F2E3D4C5B6A79885746352413021100DEADBEEF)
    out = []
    for i in range(5):
        e = ec_ref.digest_int(b"payload-%d" % i)
        r, s = k.sign_digest(e, k=0xA5A5A5A5 + 977 * i)
        out.append((e, r ^ (i == 4), s, *k.public))
    return out, [True, True, True, True, False]


def _validator(**kw):
    return pv.BlockValidator(pv.PolicyProvider({}), MemVersionedDB(), device="cpu", **kw)


def test_no_guard_by_default():
    v = _validator()
    assert v.device_guard is None
    items, want = _items()
    h = v.verify_launch(items)
    assert type(h) is p256v3.VerifyHandle and h.fetch() == want
    faults.configure("validator.verify_launch:raise")
    assert v.verify_launch(items).fetch() == want  # the point belongs to the guard
    faults.configure("p256v3.verify_launch:raise")
    with pytest.raises(faults.InjectedFault):
        v.verify_launch(items)


def test_guarded_device_lane_verdicts():
    items, want = _items()
    v = _validator(device_fail_threshold=3, device_retries=0)
    h = v.verify_launch(items)
    assert isinstance(h, pv._GuardedHandle) and h.device_out is not None
    assert h() == want and h.n_real == 5
    st = v.device_guard.stats()
    assert not st["degraded"] and st["failures_total"] == 0


def test_persistent_launch_fault_latches_the_fallback():
    items, want = _items()
    v = _validator(device_fail_threshold=1, device_retries=0)
    plan = faults.configure("validator.verify_launch:raise;p256v3.verify_launch:raise")
    h = v.verify_launch(items)
    assert isinstance(h, pv._SyncedHandle) and h.n_real == 5
    assert h.device_out[:5].tolist() == want and h() == want
    hs = v.verify_launch_many([items, items[:2], []])
    assert [x.fetch() for x in hs] == [want, want[:2], []]
    st = v.device_guard.stats()
    assert st["degraded"] and st["failures_total"] == 1 == plan.fired("validator.verify_launch")
    assert st["fallback_blocks_total"] == 4  # one block, then a group of three
    assert plan.fired("p256v3.verify_launch") == 0  # the fallback ran shielded


def test_fetch_side_failure_reverifies_the_block():
    items, want = _items()
    v = _validator(device_fail_threshold=2, device_retries=0)

    class DeadHandle:
        device_out = object()
        n_real = len(items)

        def fetch(self):
            raise RuntimeError("device died after launch")

    g = pv._GuardedHandle(DeadHandle(), v.device_guard, v, items)
    assert g() == want and g.fetch() == want and g.fell_back
    st = v.device_guard.stats()
    assert st["consecutive_failures"] == 1 and st["fallback_blocks_total"] == 1


def test_failed_fallback_raises(monkeypatch):
    """The fallback is the same kernel launched and synced at once: if
    that launch fails too, the block raises (nothing verifies on the
    host)."""
    items, want = _items()
    v = _validator(device_fail_threshold=1, device_retries=0)
    h = v._host_verify_fallback(items)
    assert h.fetch() == want and h.device_out.device == torch.device("cpu")
    assert v._host_verify_fallback([]).fetch() == []

    def dead(*a, **kw):
        raise RuntimeError("the verify launch failed")

    monkeypatch.setattr(p256v3, "verify_batch_packed", dead)
    with pytest.raises(RuntimeError, match="verify launch failed"):
        v._host_verify_fallback(items)
    faults.configure("validator.verify_launch:raise")
    with pytest.raises(RuntimeError, match="verify launch failed"):
        v.verify_launch(items)


# ---------------------------------------------------------------------------
# The slice corpus


@pytest.fixture(scope="module")
def stream(net):  # noqa: F811
    blocks = _blocks(net, seed=20261020, n_blocks=8, range_blocks={5})
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


@pytest.fixture
def rowverify(monkeypatch):
    rv = _RowVerify()
    monkeypatch.setattr(p256v3, "verify_batch_packed", rv)
    return rv


def _chaotic(decoded, rows, depth=2, coalesce=0, max_restarts=100, **kw):
    """The containment loop (the reference's ``_drive_chaotic``): a
    stage exception closes the pipe; a new pipe resumes from the
    committed height.  Only the plan's exception types are caught.
    ``v.host_blocks``: the numbers of the blocks that took
    ``_validate_host``, which a fault must not add to."""
    state, prov, _ = carry.from_reference(rows, POLICIES, [])
    store = _Store()
    v = pv.BlockValidator(prov, state, block_store=store, device="cpu", **kw)
    v.host_blocks = set()
    host = v._validate_host
    v._validate_host = lambda p: v.host_blocks.add(p.block.number) or host(p)
    committed: dict = {}
    first = decoded[0].number

    def commit(res):
        num = res.block.number
        assert num == first + len(committed), "commit out of order"
        state.apply_updates(res.batch)
        store.txids.update(t for t, _ in res.txids)
        committed[num] = (res.tx_filter, _rows(res.batch), res.history)

    restarts, failures = 0, []
    pipe = CommitPipeline(v, commit, depth=depth, coalesce_blocks=coalesce)
    try:
        while True:
            try:
                rest = decoded[len(committed):]
                if coalesce:
                    pipe.submit_many(rest)
                else:
                    for blk in rest:
                        pipe.submit(blk)
                pipe.flush()
                break
            except (faults.InjectedFault, ConnectionResetError):
                restarts += 1
                failures.append(pipe.last_failure)
                assert pipe.stats()["stage_failures"]
                assert restarts < max_restarts, "the chaos run does not converge"
                with pytest.raises(RuntimeError, match="closed"):
                    pipe.submit(decoded[0])
                pipe.close(flush=False)
                pipe = CommitPipeline(v, commit, depth=depth, coalesce_blocks=coalesce)
    finally:
        pipe.close(flush=False)
        v.close()
    return [committed[first + i] for i in range(len(decoded))], v, restarts, failures


_FAULT_FREE_HOST: dict = {}


def _fault_free_host(decoded, rows, **kw) -> set:
    """The blocks that take ``_validate_host`` with no fault armed (the
    corpus holds blocks the device lane does not serve)."""
    key = (len(decoded), tuple(sorted(kw.items())))
    if key not in _FAULT_FREE_HOST:
        faults.configure("")
        _, v, _, _ = _chaotic(decoded, rows, **kw)
        _FAULT_FREE_HOST[key] = v.host_blocks
    return _FAULT_FREE_HOST[key]


def test_chaos_differential_matches_reference(stream, rowverify):
    """Launch faults (seeded, p = 0.6), one staging-pool task fault, one
    prefetch cut and one commit fault through the port's pipe at depth 2
    with coalesced groups of 2 over a 2-worker pool: every block commits
    once, equal to the JAX validator's, and the guard counted one
    failure a fault fired at its points."""
    decoded, want, rows = stream
    host = _fault_free_host(decoded, rows)
    plan = faults.FaultPlan(
        "validator.verify_launch:raise:p=0.6;"
        "hostpool.task:raise:n=1:after=6;"
        "pipeline.prefetch:raise:n=1:after=4;"
        "pipeline.commit:raise:n=1:after=2", seed=SEED)
    faults.install(plan)
    got, v, restarts, failures = _chaotic(decoded, rows, coalesce=2, host_stage_workers=2,
                                          device_fail_threshold=2, device_retries=1,
                                          device_recovery_s=0.0)
    assert got == want and v.host_blocks == host
    st = v.device_guard.stats()
    assert plan.fired("validator.verify_launch") > 0
    assert plan.fired("pipeline.prefetch") == plan.fired("pipeline.commit") == 1
    assert plan.fired("hostpool.task") == 1
    assert st["failures_total"] == plan.fired("validator.verify_launch")
    assert st["fallback_blocks_total"] > 0 and st["retries_total"] > 0
    assert restarts >= 2 and {f[1] for f in failures} == {"prefetch", "commit"}


def test_chaos_single_blocks_with_stage2_and_disconnect(stream, rowverify):
    """``submit`` a block at a time: the chip smoke's plan (launch
    faults, a stage-2 fault, a prefetch disconnect, a commit fault)."""
    decoded, want, rows = stream
    host = _fault_free_host(decoded, rows)
    plan = faults.FaultPlan(
        "validator.verify_launch:raise:p=0.35;validator.stage2:raise:n=1:after=3;"
        "pipeline.prefetch:disconnect:n=1:after=5;pipeline.commit:raise:n=1:after=2",
        seed=SEED)
    faults.install(plan)
    got, v, restarts, failures = _chaotic(decoded, rows, device_fail_threshold=2,
                                          device_retries=1, device_recovery_s=0.0)
    assert got == want and v.host_blocks == host
    st = v.device_guard.stats()
    assert plan.fired("validator.stage2") == 1 and plan.fired("pipeline.prefetch") == 1
    assert st["failures_total"] == (plan.fired("validator.verify_launch")
                                    + plan.fired("validator.stage2"))
    assert restarts >= 1 and {f[1] for f in failures} <= {"prefetch", "commit"}


def test_stage2_fault_is_dispatched_again(stream, rowverify, monkeypatch):
    """A stage-2 dispatch fault, and a stage-2 sync that fails, are
    dispatched again on the device within the guard's retries; past
    them, or without a guard, the failure raises."""
    decoded, want, rows = stream
    host = _fault_free_host(decoded[:2], rows, depth=1)
    faults.configure("validator.stage2:raise:n=1")
    got, v, restarts, _ = _chaotic(decoded[:2], rows, depth=1, device_fail_threshold=3)
    assert got == want[:2] and restarts == 0 and v.host_blocks == host
    st = v.device_guard.stats()
    assert st["failures_total"] == st["retries_total"] == 1 and st["consecutive_failures"] == 0

    syncs = []
    real_run = pv.DeviceBlockPipeline.run

    def run(self, *a, **kw):
        fetch = real_run(self, *a, **kw)

        def fetch2():
            syncs.append(len(syncs))
            if len(syncs) == 1:
                raise RuntimeError("stage-2 sync failed")
            return fetch()

        return fetch2

    monkeypatch.setattr(pv.DeviceBlockPipeline, "run", run)
    faults.configure("")
    got, v, restarts, _ = _chaotic(decoded[:2], rows, depth=1, device_fail_threshold=3)
    assert got == want[:2] and restarts == 0 and len(syncs) == 3 and v.host_blocks == host
    assert v.device_guard.stats()["failures_total"] == 1
    monkeypatch.undo()

    state, prov, _ = carry.from_reference(rows, POLICIES, [])
    v = pv.BlockValidator(prov, state, device="cpu", device_fail_threshold=3,
                          device_retries=1)
    faults.configure("validator.stage2:raise:n=2")
    with pytest.raises(faults.InjectedFault):  # out of retries: the failure raises
        v.validate(decoded[0])
    assert v.device_guard.stats()["failures_total"] == 2
    v = pv.BlockValidator(prov, state, device="cpu")
    faults.configure("validator.stage2:raise:n=1")
    with pytest.raises(faults.InjectedFault):  # no guard: the failure raises
        v.validate(decoded[0])


def test_latency_chaos_changes_nothing(stream, rowverify):
    decoded, want, rows = stream
    faults.install(faults.FaultPlan(
        "validator.verify_launch:latency:ms=5:p=0.5;pipeline.commit:latency:ms=5:p=0.5",
        seed=11))
    got, v, restarts, _ = _chaotic(decoded, rows, device_fail_threshold=3, device_retries=1,
                                   device_recovery_s=0.0)
    assert restarts == 0 and got == want


# ---------------------------------------------------------------------------
# The residency latch


def test_failed_scatter_disables_like_the_reference(monkeypatch):
    """Admissions, then a commit scatter that fails: each manager
    latches off, drops its directory and reports the same stats; later
    lookups miss and nothing is admitted or scattered again."""
    res = ResidencyManager(slots=64, range_bits=3, device="cpu")
    jres = JResidencyManager(slots=64, range_bits=3)
    pairs = [("ns", f"k{i}") for i in range(10)]
    present = np.ones(10, bool)
    vers = np.array([[1, i] for i in range(10)], np.int64)
    res.admit(pairs, present, vers)
    jres.admit(pairs, present, vers)

    def boom(*a, **kw):
        raise RuntimeError("scatter failed")

    monkeypatch.setattr(res, "_scatter", boom)
    monkeypatch.setattr(jres, "_scatter", boom)
    b, jb = UpdateBatch(), JUpdateBatch()
    for batch in (b, jb):
        batch.put("ns", "k1", b"v", (2, 0))
    assert res.apply_batch(b) == jres.apply_batch(jb) == 0
    st, jst = res.stats(), jres.stats()
    assert {k: st[k] for k in jst} == jst
    assert st["enabled"] is False and not res.enabled and st["resident_keys"] == 0
    assert res.lookup(pairs).tolist() == jres.lookup(pairs)[0].tolist() == [-1] * 10
    monkeypatch.undo()
    assert res.admit(pairs, present, vers) == jres.admit(pairs, present, vers) == 0
    assert not res.table_rows().any()


def test_resident_pipeline_after_the_latch_matches_reference(stream, rowverify, monkeypatch):
    """A commit scatter fails at the third block's commit: the cache
    latches off, the later blocks read on the host, and every verdict
    equals the reference's."""
    decoded, want, rows = stream
    calls = []
    real = residency.table_scatter

    def third_commit_fails(table, idx, rows_):
        calls.append(len(idx))
        if len(calls) == 6:
            raise RuntimeError("scatter failed")
        real(table, idx, rows_)

    monkeypatch.setattr(residency, "table_scatter", third_commit_fails)
    got, v, restarts, _ = _chaotic(decoded, rows, depth=2, state_resident=True)
    assert got == want and restarts == 0 and v.host_blocks == _fault_free_host(decoded, rows)
    assert not v.resident.enabled and v.resident.stats()["enabled"] is False
    assert len(calls) == 6


def test_disabled_cache_refuses_the_read():
    """A pack whose lookup ran before the latch is not served: ``read``
    calls nothing and the block takes the host read."""
    res = ResidencyManager(slots=64, range_bits=3, device="cpu")
    pairs = [("ns", f"k{i}") for i in range(4)]
    res.admit(pairs, np.ones(4, bool), np.array([[1, i] for i in range(4)], np.int64))
    reads = []

    class State:
        def get_versions_cols(self, miss):
            with res._lock:
                res._disable_locked("scatter failed")
            return np.ones(len(miss), bool), np.zeros(len(miss), np.int64)

    pack = residency.build_launch_pack(res, pairs + [("ns", "new")], State(),
                                       read=lambda table, u: reads.append(u))
    assert pack is None and reads == [] and not res.enabled


def test_latch_between_lookup_and_read_matches_reference(stream, rowverify, monkeypatch):
    """The cache latches off inside a block's launch pack, after its
    lookup and before its table read (the committer's scatter failing
    while the next block launches), at the sixth resident read: its
    lookup hit resident keys that the block reads present, so a read of
    the dropped table would flip them to conflicts.  That block and
    every later one take the host read, and every verdict equals the
    reference's."""
    decoded, want, rows = stream
    made, reads = [], []

    def boom(*a, **kw):
        raise RuntimeError("scatter failed")

    class Manager(ResidencyManager):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def read(self, fn, u_pack):
            reads.append(int((u_pack[:, 0] >= 0).sum()))
            if len(reads) == 6:
                self._scatter = boom
                self.admit([("zz", "zz")], np.ones(1, bool), np.array([[1, 0]], np.int64))
                assert not self.enabled
            return super().read(fn, u_pack)

    monkeypatch.setattr(pv, "ResidencyManager", Manager)
    got, v, restarts, _ = _chaotic(decoded, rows, depth=2, state_resident=True)
    assert len(reads) == 6 and reads[-1] > 0
    assert got == want and restarts == 0
    assert v.host_blocks == _fault_free_host(decoded, rows)
    assert v.resident is made[0] and v.resident.stats()["enabled"] is False
