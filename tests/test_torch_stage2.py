"""The port's MVCC and fused stage 2 (fabric_tpu_torch/ops/mvcc.py,
peer/device_block.py) on the CPU, where the kernel wrappers run their
plain versions, held against the JAX package (fabric_tpu/ops/mvcc.py,
fabric_tpu/peer/device_block.py::build_stage2) and the serial MVCC
oracle.  Every quantity is boolean or integer: equality is exact."""

import jax
import numpy as np
import pytest
import torch

from fabric_tpu.crypto import policy as jpol
from fabric_tpu.ops import mvcc as jmvcc
from fabric_tpu.peer import device_block as jdb
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.ops import mvcc
from fabric_tpu_torch.peer import device_block as db

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and the pipeline tests run torch ops on two threads at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_hostver_jit = jax.jit(jmvcc.mvcc_validate_hostver)


def _case(reads_writes_ranges):
    port = [mvcc.TxRWSet(reads=list(r), writes=list(w), range_reads=list(q))
            for r, w, q in reads_writes_ranges]
    ref = [jmvcc.TxRWSet(reads=list(r), writes=list(w), range_reads=list(q))
           for r, w, q in reads_writes_ranges]
    return port, ref


def _check(spec, committed, pre_ok=None):
    """Port wrappers == JAX programs == serial oracle on one block."""
    port_txs, ref_txs = _case(spec)
    n = len(port_txs)
    pre = np.ones(n, bool) if pre_ok is None else np.asarray(pre_ok, bool)
    want = jmvcc.mvcc_serial_reference(ref_txs, committed, list(pre))
    assert mvcc.mvcc_serial_reference(port_txs, committed, list(pre)) == want
    st = mvcc.prepare_block_static(port_txs, bucketed=True)
    jst = jmvcc.prepare_block_static(ref_txs, bucketed=True)
    for f in ("read_keys", "read_present", "read_vers", "write_keys", "rq_lo", "rq_hi"):
        assert np.array_equal(getattr(st, f), getattr(jst, f)), f
    T = st.read_keys.shape[0]
    pre_b = np.zeros(T, bool)
    pre_b[:n] = pre
    ver_ok = st.host_ver_ok(committed)
    assert np.array_equal(ver_ok, jst.host_ver_ok(committed))
    cp, cv = st.fill_committed(committed)
    jout = [np.asarray(o) for o in jmvcc.mvcc_validate_jit(
        st.read_keys, st.read_present, st.read_vers, cp, cv, st.write_keys,
        st.rq_lo, st.rq_hi, pre_b)]
    args = st.device_args(committed, "cpu")
    out = [o.numpy() for o in mvcc.mvcc_validate(*args, torch.from_numpy(pre_b))]
    for a, b in zip(out, jout):
        assert np.array_equal(a, b)
    jh = [np.asarray(o) for o in _hostver_jit(st.read_keys, ver_ok, st.write_keys,
                                              st.rq_lo, st.rq_hi, pre_b)]
    t = torch.from_numpy
    oh = mvcc.mvcc_validate_hostver(t(st.read_keys), t(ver_ok), t(st.write_keys),
                                    t(st.rq_lo), t(st.rq_hi), t(pre_b))
    for a, b in zip(oh, jh):
        assert np.array_equal(a.numpy(), b)
    assert list(out[0][:n]) == want
    # the unbucketed helper agrees too
    valid, _, _ = mvcc.mvcc_validate_block(port_txs, committed, pre, device="cpu")
    assert list(valid) == want
    return want, out


def test_reference_mvcc_cases():
    committed = {"a": (1, 0), "b": (2, 3)}
    want, _ = _check([
        ([("a", (1, 0))], ["a"], []), ([("a", (1, 0))], [], []),
        ([("b", (9, 9))], [], []), ([("b", (2, 3))], ["b"], []),
        ([("zzz", None)], [], []), ([("zzz", (1, 1))], [], []),
    ], committed)
    assert want == [True, False, False, True, True, False]
    assert _check([([("x", (0, 0))], ["k"], []), ([("k", (1, 0))], [], [])],
                  {"k": (1, 0), "x": (1, 0)})[0] == [False, True]
    assert _check([
        ([("a", (1, 0))], ["b"], []), ([("b", (1, 0))], ["c"], []),
        ([("c", (1, 0))], ["d"], []), ([("d", (1, 0))], [], []),
    ], {c: (1, 0) for c in "abcd"})[0] == [True, False, True, False]
    want, out = _check([([], ["k5"], []), ([], [], [("k1", "k9")]), ([], [], [("k6", "k9")])],
                       {"k3": (1, 0)})
    assert want == [True, False, True] and list(out[2][:3]) == [False, True, False]
    assert _check([([], ["k"], []), ([("k", (1, 0))], [], [])], {"k": (1, 0)},
                  pre_ok=[False, True])[0] == [False, True]


def test_long_conflict_chain():
    spec = [([(f"c{i}", (1, 0))], [f"c{i + 1}"], []) for i in range(24)]
    want, _ = _check(spec, {f"c{i}": (1, 0) for i in range(25)})
    assert want == [i % 2 == 0 for i in range(24)]


@pytest.mark.parametrize("seed", range(6))
def test_random_blocks(seed):
    rng = np.random.default_rng(seed)
    T = int(rng.integers(2, 40))
    keys = [f"k{i:04d}" for i in range(int(rng.integers(4, 30)))]
    committed = {k: (int(rng.integers(0, 3)), int(rng.integers(0, 4)))
                 for k in keys if rng.random() < 0.8}
    spec = []
    for _ in range(T):
        reads = []
        for k in rng.choice(keys, size=rng.integers(0, 5), replace=False):
            k = str(k)
            if rng.random() < 0.75 and k in committed:
                ver = committed[k]
            elif rng.random() < 0.5:
                ver = (int(rng.integers(0, 3)), int(rng.integers(0, 4)))
            else:
                ver = None
            reads.append((k, ver))
        writes = [str(k) for k in rng.choice(keys, size=rng.integers(0, 4), replace=False)]
        rqs = []
        if rng.random() < 0.3:
            lo, hi = sorted(rng.choice(keys, size=2, replace=False))
            rqs.append((str(lo), str(hi)))
        spec.append((reads, writes, rqs))
    _check(spec, committed, list(rng.random(T) > 0.1))


def test_zipf_contention_block():
    """The reference's BASELINE config #3 case: Zipf key access over 10k
    keys, a 256-tx block."""
    rng = np.random.default_rng(99)
    nkeys, T = 10_000, 256
    committed = {f"key{i:06d}": (1, i % 7) for i in range(nkeys)}
    zipf = np.minimum(rng.zipf(1.3, size=(T, 8)) - 1, nkeys - 1)
    spec = []
    for j in range(T):
        ks = [f"key{k:06d}" for k in zipf[j]]
        reads = [(k, committed[k] if rng.random() < 0.9 else (9, 9)) for k in ks[:4]]
        spec.append((reads, ks[4:], []))
    want, _ = _check(spec, committed)
    assert any(want) and not all(want)


DSL = [
    "OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')",
    "OutOf(1, 'Org1MSP.peer', 'Org1MSP.member')",  # consumption-unsafe
    "AND('Org1MSP.member', OR('Org2MSP.peer', 'Org3MSP.peer'))",
]


def _stage2_operands(seed, T=32, n_sig=48, S=4, Eb=(32, 16, 16)):
    rng = np.random.default_rng(seed)
    sig_valid = rng.random(n_sig) < 0.8
    lv = np.zeros((T, 3), np.int32)
    lv[:, 0] = rng.integers(0, n_sig, T)
    lv[rng.choice(T, 3, replace=False), 0] = -1
    lv[rng.choice(T, 3, replace=False), 0] = -2
    lv[:, 1] = rng.random(T) < 0.9
    lv[:, 2] = rng.random(T) < 0.9
    R, W, Q = 2, 2, 1
    sp = np.full((T, R + W + 2 * Q), -1, np.int32)
    sp[:, :R + W] = rng.integers(-1, 40, (T, R + W))
    for t in range(4, 12):  # a read-after-write chain
        sp[t, 0] = 100 + t
        sp[t, R] = 101 + t
    rq = rng.choice(T, 6, replace=False)
    sp[rq, R + W] = rng.integers(0, 35, 6)
    sp[rq, R + W + Q] = sp[rq, R + W] + rng.integers(1, 6, 6)
    groups = []
    for dsl, eb in zip(DSL, Eb):
        P = len(pol.compile_plan(pol.from_dsl(dsl)).principals)
        gp = np.zeros((eb, S * P + S + 1), np.int32)
        gp[:, :S * P] = rng.random((eb, S * P)) < 0.35
        idx = np.where(rng.random((eb, S)) < 0.8, rng.integers(0, n_sig, (eb, S)), -1)
        gp[:, S * P:S * P + S] = idx
        # the validator's contract: an empty endorsement slot (-1)
        # carries an all-zero match row
        gp[:, :S * P] *= np.repeat(idx >= 0, P, axis=1)
        gp[:, -1] = np.where(rng.random(eb) < 0.9, rng.integers(0, T, eb), -1)
        groups.append((dsl, gp, eb, S))
    return sig_valid, lv, groups, sp, (R, W, Q)


@pytest.mark.parametrize("seed", range(3))
def test_stage2_matches_build_stage2(seed):
    sig_valid, lv, groups, sp, dims = _stage2_operands(seed)
    T, n_sig = lv.shape[0], sig_valid.shape[0]
    jplans = [jpol.compile_plan(jpol.from_dsl(d)) for d, *_ in groups]
    fn = jdb.build_stage2(T, n_sig, tuple(jdb.plan_sig(p, eb, S) for p, (_, _, eb, S)
                                          in zip(jplans, groups)), dims)
    want = np.asarray(fn(sig_valid, lv, *[g[1] for g in groups], sp))
    t = torch.from_numpy
    pgroups = [(pol.compile_plan(pol.from_dsl(d)), t(gp), eb, S) for d, gp, eb, S in groups]
    got = db.stage2(t(sig_valid), t(lv), pgroups, t(sp), dims).numpy()
    assert got.dtype == np.int8 and np.array_equal(got, want)
    safe = got[5 * T + n_sig:]
    assert 0 < safe.sum() < len(safe)  # consumption-unsafe rows present
    assert set(np.unique(lv[:, 0])) >= {-1, -2}
    # the policy part alone against the numpy batch plan
    for (plan, gpt, eb, S), (_, gp, _, _) in zip(pgroups, groups):
        P = len(plan.principals)
        ok, sf = db.policy_reduce_ref(t(sig_valid), gpt, S, P, plan)
        idx = gp[:, S * P:S * P + S]
        ev = np.where(idx >= 0, sig_valid[np.clip(idx, 0, None)], False)
        m3 = (gp[:, :S * P] != 0).reshape(eb, S, P) & ev[:, :, None]
        assert np.array_equal(ok.numpy(), plan.evaluate_counts_batch(m3))
        assert np.array_equal(sf.numpy(), plan.consumption_safe_batch(m3))


def test_plan_vector_layout():
    plan = pol.compile_plan(pol.from_dsl(DSL[2]))
    v = db.plan_vector(plan)
    L, G = plan.n_leaves, len(plan.gates)
    assert v[:2] == [L, G] and v[2] == sum(1 << c for c in set(plan.leaf_principal))
    assert v[4:4 + L] == plan.leaf_principal
    too_wide = pol.compile_plan(pol.from_dsl(
        "OR(" + ", ".join(f"'Org{i}MSP.peer'" for i in range(33)) + ")"))
    with pytest.raises(ValueError):
        db.plan_vector(too_wide)
