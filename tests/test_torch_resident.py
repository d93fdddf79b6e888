"""The port's device-resident MVCC state (fabric_tpu_torch/state,
peer/device_block.py::resident_ver_ok, the validator's and pipeline's
resident path) on the CPU, where the kernel wrappers run their plain
versions, held against the JAX package (fabric_tpu/state/residency.py,
peer/device_block.py::build_stage2 with ``resident_dims``) and against
the port's own host path.  Every quantity is an integer or a bit:
equality is exact."""

import numpy as np
import pytest
import torch

from fabric_tpu.crypto import policy as jpol
from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.ledger.statedb import UpdateBatch as JUpdateBatch
from fabric_tpu.peer import device_block as jdb
from fabric_tpu.peer.validator import BlockValidator as JBlockValidator
from fabric_tpu.state import ResidencyManager as JResidencyManager
from fabric_tpu.state import build_launch_pack as j_build_launch_pack
from fabric_tpu_torch import carry
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.ledger.statedb import MemVersionedDB, UpdateBatch
from fabric_tpu_torch.ops import mvcc
from fabric_tpu_torch.peer import device_block as db
from fabric_tpu_torch.peer import validator as pv
from fabric_tpu_torch.peer.pipeline import CommitPipeline
from fabric_tpu_torch.state import ResidencyManager, build_launch_pack, residency
from test_torch_slice import POLICIES, _blocks, _decode, _reference, _rows, _seed_batch
from test_torch_slice import _Store, net  # noqa: F401  (module fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and the pipeline tests run torch ops on two threads at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jtable(jres) -> np.ndarray:
    t = jres._table
    return np.zeros((jres.capacity, 3), np.int32) if t is None else np.asarray(t)


def _same_managers(res, jres):
    st, jst = res.stats(), jres.stats()
    assert {k: st[k] for k in jst} == jst
    assert np.array_equal(res.table_rows(), _jtable(jres))


def _batch(cls, puts=(), deletes=()):
    b = cls()
    for ns, key, ver in puts:
        b.put(ns, key, b"v", ver)
    for ns, key, ver in deletes:
        b.delete(ns, key, ver)
    return b


# ---------------------------------------------------------------------------
# 1. the manager against the reference's


def test_manager_ctor_checks_and_capacity():
    for kw in ({"capacity_mb": 0}, {"range_bits": 0}, {"range_bits": 25}, {"slots": 2}):
        with pytest.raises(ValueError):
            ResidencyManager(device="cpu", **kw)
    assert ResidencyManager(slots=100, device="cpu").capacity == 64
    # 64 MB at 12 bytes a slot, rounded down to a power of two
    assert ResidencyManager(device="cpu").capacity == 1 << 22
    assert ResidencyManager(capacity_mb=1, device="cpu").capacity == 1 << 16
    res, jres = ResidencyManager(device="cpu"), JResidencyManager()
    for k in (("ns", "a"), ("ns", ""), ("other", "k\x00y"), ("ns", "ключ")):
        assert res.range_of(*k) == jres.range_of(*k)


def test_manager_sequence_matches_reference():
    """One sequence of admissions, lookups (hits, misses, overlay-forced
    keys), commit scatters within the write-admission budget, LRU
    evictions, invalidation and a warm on both managers: the slots, the
    stats and the table rows agree after every step."""
    res = ResidencyManager(slots=16, range_bits=3, device="cpu")
    jres = JResidencyManager(slots=16, range_bits=3)
    rng = np.random.default_rng(7)
    keys = [("ns", f"k{i:03d}") for i in range(80)]

    def both(fn_port, fn_ref):
        a, b = fn_port(res), fn_ref(jres)
        _same_managers(res, jres)
        return a, b

    def lookup(pairs, forced=None):
        a, b = both(lambda m: m.lookup(pairs, forced_pairs=forced),
                    lambda m: m.lookup(pairs, forced_pairs=forced)[0])
        assert np.array_equal(a, b)
        return a

    def admit(pairs, evict=True):
        present = rng.random(len(pairs)) < 0.8
        vers = rng.integers(0, 1 << 32, (len(pairs), 2), dtype=np.uint64).astype(np.uint32)
        a, b = both(lambda m: m.admit(pairs, present, vers, evict=evict),
                    lambda m: m.admit(pairs, present, vers, evict=evict))
        assert a == b

    admit(keys[:10])
    s = lookup(keys[:14])
    assert (s[:10] >= 0).all() and (s[10:] < 0).all()
    lookup(keys[:14], forced={keys[2], keys[12]})
    # commit scatters: resident keys in place, deletes, new ranges within budget
    for step in range(6):
        ks = [keys[int(i)] for i in rng.choice(40, 6, replace=False)]
        puts = [(*k, (9, step)) for k in ks[:4]]
        dels = [(*k, (9, step)) for k in ks[4:]]
        a, b = both(lambda m: m.apply_batch(_batch(UpdateBatch, puts, dels)),
                    lambda m: m.apply_batch(_batch(JUpdateBatch, puts, dels)))
        assert a == b
        lookup(keys[:40])
    # churn: admissions past capacity evict least-recently-touched ranges
    for lo in range(20, 80, 7):
        admit(keys[lo:lo + 7])
        lookup(keys[lo - 10:lo + 7])
    admit(keys[:30], evict=False)
    both(lambda m: m.invalidate_keys(keys[20:40]), lambda m: m.invalidate_keys(keys[20:40]))
    lookup(keys)
    items = [(ns, k, (3, i)) for i, (ns, k) in enumerate(keys)]
    a, b = both(lambda m: m.warm(items), lambda m: m.warm(items))
    assert a == b
    st = res.stats()
    assert st["evictions_total"] > 0 and st["write_admits_total"] > 0
    assert st["hits_total"] > 0 and st["misses_total"] > 0 and st["overlay_forced_total"] == 2


def test_table_scatter_checks_indices():
    t = torch.zeros((8, 3), dtype=torch.int32)
    residency.table_scatter(t, np.array([7, 0]), np.array([[1, 2, 3], [4, 5, 6]]))
    assert t[7].tolist() == [1, 2, 3] and t[0].tolist() == [4, 5, 6]
    for bad in ([8], [-1], [3, 9]):
        with pytest.raises(IndexError):
            residency.table_scatter(t, np.array(bad), np.ones((len(bad), 3)))
    with pytest.raises(ValueError):
        residency.table_scatter(t, np.array([1, 2]), np.ones((1, 3)))


# ---------------------------------------------------------------------------
# 2. resident_ver_ok and the whole stage 2 against build_stage2(resident_dims)


KEYS = [f"k{i:02d}" for i in range(24)]


def _states(rows):
    """The same committed rows in the reference's and the port's DB."""
    js, ps = JMemDB(), MemVersionedDB()
    js.apply_updates(_batch(JUpdateBatch, rows), (1, 0))
    ps.apply_updates(_batch(UpdateBatch, rows))
    return js, ps


def _block_spec(rng, committed):
    """24 txs over KEYS: current, stale and absent reads, and writes
    that later txs of the block read (in-block conflicts)."""
    spec = []
    for j in range(24):
        reads = []
        for k in rng.choice(KEYS, size=int(rng.integers(0, 3)), replace=False):
            k = str(k)
            c = committed.get(k)
            u = rng.random()
            ver = c if (u < 0.7 and c is not None) else None if u < 0.85 else (7, 7)
            reads.append((("pub", "ns", k), ver))
        writes = [("pub", "ns", str(k)) for k in rng.choice(KEYS, 2, replace=False)]
        spec.append((reads, writes))
    return [mvcc.TxRWSet(reads=r, writes=w, range_reads=[]) for r, w in spec]


def _stage2_operands(rng, T):
    S, n_sig = 4, 48
    sig_valid = rng.random(n_sig) < 0.9
    lv = np.zeros((T, 3), np.int32)
    lv[:, 0] = rng.integers(0, n_sig, T)
    lv[:, 1] = 1
    plan = pol.compile_plan(pol.from_dsl(POLICIES["slicecc"]))
    P = len(plan.principals)
    gp = np.zeros((32, S * P + S + 1), np.int32)
    idx = np.where(rng.random((32, S)) < 0.7, rng.integers(0, n_sig, (32, S)), -1)
    gp[:, :S * P] = (rng.random((32, S * P)) < 0.5) & np.repeat(idx >= 0, P, axis=1)
    gp[:, S * P:S * P + S] = idx
    gp[:, -1] = np.where(np.arange(32) < T, np.arange(32) % T, -1)
    return sig_valid, lv, gp, S


def _run_both(res, jres, static, pstate, jstate, ops, overlay=None):
    """One block's resident stage 2 on both sides → (port packed, JAX
    packed, port ver_ok, u_pack)."""
    sig_valid, lv, gp, S = ops
    T = static.read_keys.shape[0]
    R, W, Q = static.dims
    sp = torch.from_numpy(static.packed_static())
    rpv = torch.from_numpy(static.packed_read_pv())
    plv = torch.from_numpy(lv.copy())
    seen = {}

    def read(table, u):
        seen["ver_ok"] = db.resident_ver_ok_ref(sp, table, u, rpv, R)
        db.resident_ver_ok(sp, table, u, rpv, R, plv)

    povl = jovl = None
    if overlay is not None:
        povl = _batch(UpdateBatch, *overlay)
        jovl = _batch(JUpdateBatch, *overlay)
    u_pack = build_launch_pack(res, static.u_pairs, pstate, overlay=povl,
                               u_index=static.u_index, read=read)
    jtable, ju_pack = j_build_launch_pack(jres, static.u_pairs, jstate, overlay=jovl)
    assert np.array_equal(u_pack, ju_pack)
    plan = pol.compile_plan(pol.from_dsl(POLICIES["slicecc"]))
    jplan = jpol.compile_plan(jpol.from_dsl(POLICIES["slicecc"]))
    fn = jdb.build_stage2(T, len(sig_valid), (jdb.plan_sig(jplan, 32, S),), (R, W, Q),
                          resident_dims=(ju_pack.shape[0], jres.capacity))
    want = np.asarray(fn(sig_valid, lv, gp, static.packed_static(), jtable, ju_pack,
                         static.packed_read_pv()))
    got = db.stage2(torch.from_numpy(sig_valid), plv, [(plan, torch.from_numpy(gp), 32, S)],
                    sp, (R, W, Q)).numpy()
    assert np.array_equal(got, want)
    return got, seen["ver_ok"].numpy(), u_pack


def test_resident_stage2_matches_reference_and_host_path():
    """Hit, miss, overlay-forced, deleted-key and padding lanes: the
    port's resident stage 2 equals build_stage2(resident_dims) on the
    same operands, and its ver_ok equals the host compare."""
    rng = np.random.default_rng(20261017)
    committed = {k: (1, i) for i, k in enumerate(KEYS) if i % 5 != 4}
    jstate, pstate = _states([("ns", k, v) for k, v in committed.items()])
    res = ResidencyManager(slots=64, range_bits=5, device="cpu")
    jres = JResidencyManager(slots=64, range_bits=5)
    txs = _block_spec(rng, committed)
    static = mvcc.prepare_block_static(txs, bucketed=True, unique=True)
    assert static.u_pairs and (static.read_keys < 0).any()  # padding reads
    ops = _stage2_operands(rng, static.read_keys.shape[0])

    def host_ver_ok(overlay=None):
        up, uv = pstate.get_versions_cols(static.u_pairs)
        puts, dels = overlay or ((), ())
        for ns, key, ver in puts:
            up[static.u_index[(ns, key)]], uv[static.u_index[(ns, key)]] = True, ver
        for ns, key, _ in dels:
            up[static.u_index[(ns, key)]] = False
        return static.ver_ok_from_u(up, uv)

    valid = []
    for _ in range(2):  # all miss, then all hit
        got, ver_ok, u_pack = _run_both(res, jres, static, pstate, jstate, ops)
        assert np.array_equal(ver_ok, host_ver_ok())
        valid.append(got[:len(txs)])
    U = len(static.u_pairs)
    assert (u_pack[:U, 0] >= 0).all() and res.stats()["hits_total"] == U
    assert np.array_equal(valid[0], valid[1]) and 0 < valid[0].sum() < len(txs)
    # a committed delta: a put and deletes, on both sides
    rk = [p[1] for p in static.u_pairs]
    puts, dels = [("ns", rk[0], (4, 0))], [("ns", rk[1], (4, 1)), ("ns", rk[2], (4, 2))]
    pstate.apply_updates(_batch(UpdateBatch, puts, dels))
    jstate.apply_updates(_batch(JUpdateBatch, puts, dels), (4, 0))
    res.apply_batch(_batch(UpdateBatch, puts, dels))
    jres.apply_batch(_batch(JUpdateBatch, puts, dels))
    got, ver_ok, _ = _run_both(res, jres, static, pstate, jstate, ops)
    assert np.array_equal(ver_ok, host_ver_ok())
    assert not np.array_equal(got[:len(txs)], valid[0])
    # an in-flight overlay: forced host lanes carrying its values
    overlay = ([("ns", rk[3], (6, 0))], [("ns", rk[4], (6, 1))])
    got, ver_ok, u_pack = _run_both(res, jres, static, pstate, jstate, ops, overlay)
    assert np.array_equal(ver_ok, host_ver_ok(overlay))
    assert (u_pack[[3, 4], 0] == -1).all() and res.stats()["overlay_forced_total"] == 2
    _same_managers(res, jres)


def _two_ranges(res, n):
    """n keys of range 0 and n keys of range 1 (``res.range_bits`` = 1)."""
    by = {0: [], 1: []}
    i = 0
    while min(len(v) for v in by.values()) < n:
        by[res.range_of("ns", f"x{i}")].append(f"x{i}")
        i += 1
    return by[0][:n], by[1][:n]


def test_self_eviction_reads_before_admission():
    """A 4-slot table holds Y1, Y2, H in one range (H admitted last) and
    one free slot.  The block reads H (a hit) and three misses in
    another range: the second admission evicts H's own range and the
    freed H slot goes to a missed key.  The port's verdict equals the
    reference's (build_launch_pack + resident stage 2, which reads a
    snapshot), because the port reads the table before admitting — and
    reading it after the admissions would give another verdict."""
    res = ResidencyManager(slots=4, range_bits=1, device="cpu")
    jres = JResidencyManager(slots=4, range_bits=1)
    (y1, y2, h), misses = _two_ranges(res, 3)
    rows = [("ns", k, (2, i)) for i, k in enumerate((y1, y2, h))]
    jstate, pstate = _states(rows)  # the misses are absent
    for m in (res, jres):
        m.admit([("ns", k) for k in (y1, y2, h)], np.ones(3, bool),
                np.array([(2, 0), (2, 1), (2, 2)], np.uint32))
    h_slot = res.lookup([("ns", h)])[0]
    jres.lookup([("ns", h)])
    # tx 0 reads H at its committed version; txs 1-3 read the misses as absent
    txs = [mvcc.TxRWSet(reads=[(("pub", "ns", h), (2, 2))], writes=[], range_reads=[])]
    txs += [mvcc.TxRWSet(reads=[(("pub", "ns", k), None)], writes=[], range_reads=[])
            for k in misses]
    static = mvcc.prepare_block_static(txs, bucketed=True, unique=True)
    ops = _stage2_operands(np.random.default_rng(3), static.read_keys.shape[0])
    ops[1][:, 0] = -2  # creators pass: only the MVCC verdict matters
    ops[2][:, -1] = -1
    got, ver_ok, u_pack = _run_both(res, jres, static, pstate, jstate, ops)
    assert ver_ok[:4].all() and got[:4].all()
    st = res.stats()
    assert st["evictions_total"] == 1 and st["resident_keys"] == 3
    h_pos = static.u_index[("ns", h)]
    assert u_pack[h_pos, 0] == h_slot
    reused = [int(res.lookup([("ns", k)])[0]) for k in misses]
    assert h_slot in reused, "the block's own admission did not reuse the hit slot"
    # the same block read after its admissions: the H reader goes stale
    after = db.resident_ver_ok_ref(
        torch.from_numpy(static.packed_static()), torch.from_numpy(res.table_rows()),
        torch.from_numpy(u_pack), torch.from_numpy(static.packed_read_pv()),
        static.dims[0]).numpy()
    assert not after[0]


def test_oversized_working_set_takes_host_path():
    res = ResidencyManager(slots=4, range_bits=3, device="cpu")
    state = MemVersionedDB()
    pairs = [("ns", f"big{i}") for i in range(10)]
    assert build_launch_pack(res, pairs, state) is None
    assert res.stats()["host_path_oversize_total"] == 1


# ---------------------------------------------------------------------------
# 3. whole blocks through the pipeline


@pytest.fixture(scope="module")
def stream(net):  # noqa: F811
    """10 signed blocks of the slice network; blocks 3 and 7 may carry
    range queries (the host-path routing), the rest do not (the
    resident path)."""
    blocks = _blocks(net, seed=20261018, n_blocks=10, range_blocks={3, 7})
    want = _reference(net, blocks)
    seed = JMemDB()
    seed.apply_updates(_seed_batch(), (1, 0))
    rows = [(ns, key, vv.value, vv.version) for (ns, key), vv in seed.iter_all()]
    people = [net["client"], *net["peers"]]
    idents = [(p.msp_id, p.identity.role, *p.identity.public_numbers) for p in people]
    _, _, carried = carry.from_reference(rows, POLICIES, idents)
    known = {(i.msp_id, i.role, i.qx, i.qy): i for i in carried}
    parser = JBlockValidator(net["mgr"], net["prov"], JMemDB())
    decoded = [_decode(b, parser, net["mgr"], known) for b in blocks]
    return decoded, want, rows


def _run(decoded, rows, depth, resident=None, state_resident=False):
    state, prov, _ = carry.from_reference(rows, POLICIES, [])
    store = _Store()

    def commit(res):
        state.apply_updates(res.batch)
        store.txids.update(t for t, _ in res.txids)

    v = pv.BlockValidator(prov, state, block_store=store, device="cpu",
                          state_resident=state_resident)
    if resident is not None:
        v.resident = resident
    got = []
    with CommitPipeline(v, commit, depth=depth) as pipe:
        for blk in decoded:
            res = pipe.submit(blk)
            if res is not None:
                got.append(res)
        res = pipe.flush()
        if res is not None:
            got.append(res)
    return got, state, v


@pytest.fixture(scope="module")
def host_run(stream):
    decoded, want, rows = stream
    got, state, _ = _run(decoded, rows, depth=2)
    return [(r.tx_filter, _rows(r.batch), r.history) for r in got], dict(state._data)


@pytest.mark.parametrize("case", ["depth1", "depth2", "depth3", "churn"])
def test_resident_pipeline_matches_host_and_reference(stream, host_run, case):
    decoded, want, rows = stream
    host_blocks, host_state = host_run
    depth = {"depth1": 1, "depth2": 2, "depth3": 3, "churn": 2}[case]
    small = ResidencyManager(slots=16, range_bits=3, device="cpu") if case == "churn" else None
    got, state, v = _run(decoded, rows, depth, resident=small, state_resident=True)
    assert len(got) == len(decoded)
    for r, (flt, batch_rows, hist), host in zip(got, want, host_blocks):
        assert (r.tx_filter, _rows(r.batch), r.history) == (flt, batch_rows, hist) == host
    assert dict(state._data) == host_state
    st = v.resident.stats()
    assert st["host_path_range_total"] == 2  # blocks 3 and 7 hold live range queries
    assert st["hits_total"] > 0 and st["misses_total"] > 0
    if case == "churn":
        assert st["evictions_total"] > 0
    else:
        # a key an in-flight predecessor wrote rides an overlay lane
        assert (st["overlay_forced_total"] > 0) == (depth > 1)
    # the table holds the committed state of every resident key
    table = v.resident.table_rows()
    for (ns, key), (slot, _) in v.resident._dir.items():
        vv = state._data.get((ns, key))
        want_row = [0, 0, 0] if vv is None else [1, *vv.version]
        assert table[slot].tolist() == want_row, (ns, key)


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("depth", [1, 2])
def test_scatter_failure_propagates(stream, monkeypatch, depth):
    """The disable latch: a failing commit scatter propagates into the
    cache's state, not out of the pipeline (inline at depth 1, on the
    committer thread at depth 2).  The cache reports ``enabled`` False
    with an empty directory, no later block reads the table, and the
    verdicts equal the reference's.  A bare ``resident_commit`` whose
    scatter fails latches the same way."""
    decoded, want, rows = stream
    calls = []

    def boom(table, idx, rows_):
        calls.append(len(idx))
        if len(calls) > 1:  # the first scatter is the first block's admission
            raise _Boom("scatter failed")
        residency.table_scatter_ref(table, torch.from_numpy(np.asarray(idx)),
                                    torch.from_numpy(np.asarray(rows_, np.int32)))

    monkeypatch.setattr(residency, "table_scatter", boom)
    res = ResidencyManager(slots=1024, device="cpu")
    reads = []
    orig_read = res.read
    monkeypatch.setattr(res, "read", lambda fn, u: reads.append(res.enabled) or orig_read(fn, u))
    got, _, v = _run(decoded[:4], rows, depth, resident=res, state_resident=True)
    assert [(r.tx_filter, _rows(r.batch), r.history) for r in got] == want[:4]
    st = v.resident.stats()
    assert not v.resident.enabled and st["enabled"] is False
    assert st["resident_keys"] == 0 and st["resident_ranges"] == 0
    # block 0 read the table; blocks launched after the latch read on the host
    assert all(reads) and 1 <= len(reads) <= depth
    v = pv.BlockValidator(pv.PolicyProvider({}), MemVersionedDB(), device="cpu",
                          state_resident=True)
    v.resident_commit(_batch(UpdateBatch, [("ns", "k", (1, 0))]))
    assert not v.resident.enabled
    assert v.resident.lookup([("ns", "k")]).tolist() == [-1]
