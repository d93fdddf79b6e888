#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fabric_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each: the device; the kernel build; the P-256 verify
kernel against its plain version at 3072 lanes (each rejected or edge
kind on at least 10% of them, x(R) >= n lanes that only the r + n
compare accepts included) and 64 random lanes plus 4 of each kind
against the pure-Python oracle; the stage-2
kernels against their plain versions at T = 1024, Eb = 1024, S = 4,
P = 3 (a 20-deep conflict chain, range phantoms, both creator
sentinels, consumption-unsafe rows) and the ``mvcc_validate`` entry;
the main path — blocks of 1000 transactions (3 orgs, a 2-of-3 peer
policy, rotating endorser pairs, 2 reads and 2 writes per tx, 5%
invalid) and one block with a consumption-unsafe namespace through
``CommitPipeline(depth=2)`` on the card, with the launch counts reset
just before and read just after, checked against the filters the
blocks were built to produce and against the same blocks validated
through the plain versions on the CPU; a second run of the main path
under ``torch.profiler`` gives the card's busy time and idle share.
Then the kernels line (JSON),
the card's name and power limit as nvidia-smi reports them, and the
result line.  Any mismatch raises; there is no result without CUDA.
Signatures come from a pool of RFC 6979 signatures per identity made
once with the port's pure-Python ``ec_ref`` from a fixed seed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20261017
N_BLOCKS = 4
BLOCK_TXS = 1000
POOL = 128
VERIFY_LANES = 3072
# H100 SXM: HBM3 bytes/s, and INT32 multiply-add lanes: 132 SMs x 64 x 1.98 GHz
PEAK_BYTES_S = 3.35e12
PEAK_INT32_S = 132 * 64 * 1.98e9


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes: float, int_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, int_ops / PEAK_INT32_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# Identities and signatures


class Net:
    """3 org peers + one Org1 client, each with a pool of signatures."""

    def __init__(self, seed: int):
        from fabric_tpu_torch.crypto import ec_ref
        from fabric_tpu_torch.crypto.identity import Identity

        rng = np.random.default_rng(seed)
        self.ec = ec_ref
        self.keys, self.idents, self.pools = [], [], []
        names = [("Org1MSP", "client"), ("Org1MSP", "peer"), ("Org2MSP", "peer"),
                 ("Org3MSP", "peer")]
        for msp, role in names:
            d = int.from_bytes(rng.bytes(32), "big") % (ec_ref.N - 1) + 1
            key = ec_ref.SigningKey(d=d)
            qx, qy = key.public
            self.keys.append(key)
            self.idents.append(Identity(msp, role, qx, qy, True))
            pool = []
            for j in range(POOL):
                e = int.from_bytes(rng.bytes(32), "big")
                pool.append((e, *key.sign_digest(e)))
            self.pools.append(pool)
        self.client, self.peers = self.idents[0], self.idents[1:]

    def sig(self, who: int, j: int):
        return self.pools[who][j % POOL]


# ---------------------------------------------------------------------------
# Phase 3: the verify kernel


KINDS = ("valid", "bad_r", "high_s", "r_zero", "s_ge_n", "q_off_curve", "tampered_digest",
         "zero_windows", "q_zero", "x_wrapped")


def adversarial_items(net: Net, n: int):
    """n (digest, r, s, qx, qy) lanes in shuffled order → (items, kind
    of each lane).  Every kind but plain valid lanes takes ceil(n/10)
    lanes (>= 10%): bad r, high-S, r = 0, s >= n, Q off the curve,
    tampered digest, u1 = 0 (every G-window digit 0, valid), Q = (0, 0),
    and x(R) in [n, p) — accepted only through the r + n compare —
    alternating with its tampered twin."""
    ec = net.ec
    rng = np.random.default_rng(SEED + 4)
    zero_e = [(0, *k.sign_digest(0), *k.public) for k in net.keys]
    wrapped = [ec.wrapped_x_signature(int(rng.integers(1, 1 << 62)) << 64,
                                      int.from_bytes(rng.bytes(32), "big"), ec.HALF_N - j)
               for j in range(8)]
    per = -(-n // 10)
    kinds = np.concatenate([np.zeros(n - 9 * per, np.int64), np.repeat(np.arange(1, 10), per)])
    rng.shuffle(kinds)
    items = []
    for i, kind in enumerate(kinds):
        who = i % 4
        e, r, s = net.sig(who, i // 4)
        qx, qy = net.idents[who].qx, net.idents[who].qy
        if kind == 1:
            r = (r + 1) % ec.N
        elif kind == 2:
            s = ec.N - s
        elif kind == 3:
            r = 0
        elif kind == 4:
            s = ec.N + 1
        elif kind == 5:
            qx = (qx + 1) % ec.P
        elif kind == 6:
            e ^= 1
        elif kind == 7:
            e, r, s, qx, qy = zero_e[who]
        elif kind == 8:
            qx, qy = 0, 0
        elif kind == 9:
            e, r, s, qx, qy = wrapped[i % len(wrapped)]
            e ^= (i // len(wrapped)) % 2  # every other x_wrapped lane tampered
        items.append((e, r, s, qx, qy))
    return items, kinds


def phase_verify(net: Net, dev):
    from fabric_tpu_torch.ops import p256v3 as v3

    items, kinds = adversarial_items(net, VERIFY_LANES)
    frame = torch.from_numpy(v3.stage_frame(items, v3._bucket(len(items)))).to(dev)
    got = v3.verify_batch_packed(frame)
    want = v3.verify_batch_ref(frame)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    err = int((got.int() - want.int()).abs().max())
    if mism:
        raise AssertionError(f"p256_verify: {mism} lanes differ from verify_batch_ref")
    # the oracle: 64 random lanes plus the first 4 of every kind
    rng = np.random.default_rng(SEED + 1)
    sample = set(rng.choice(len(items), 64, replace=False).tolist())
    for k in range(len(KINDS)):
        sample.update(np.flatnonzero(kinds == k)[:4].tolist())
    g = got.cpu().numpy()
    oracle_mism = 0
    for i in sorted(sample):
        e, r, s, qx, qy = items[i]
        oracle_mism += bool(g[i]) != net.ec.verify_digest((qx, qy), e, r, s)
    if oracle_mism:
        raise AssertionError(f"p256_verify: {oracle_mism} sampled lanes disagree with ec_ref")
    wrapped = kinds == 9
    wrapped_accepted = int(g[:len(items)][wrapped].sum())
    if not 0 < wrapped_accepted < int(wrapped.sum()):
        raise AssertionError("p256_verify: the x(R) >= n lanes were not split into "
                             "accepted and rejected")
    accepted = int(got.sum())
    ms = cuda_ms(lambda: v3.verify_batch_packed(frame), 10)
    plain_ms = cuda_ms(lambda: v3.verify_batch_ref(frame), 1)
    # products: 2 to_mont + 3 on-curve + 14 table adds x 14 + per step
    # 4 doublings x 13 + add 14 + mixed add 13 (only at nonzero u1
    # digits) + 4 final; 128 32x32->64 multiply-adds each, 2 INT32 ops per
    w1 = v3.recode_windows(frame[:, 64:80]).cpu().numpy()
    nonzero = int((w1 != 0).sum())
    products = frame.shape[0] * (5 + 14 * 14 + 64 * (4 * 13 + 14) + 4) + 13 * nonzero
    b_ms, b_by = bound(nbytes(frame, got) + 24 * 4 + 16 * 64, products * 128 * 2)
    log("verify", lanes=frame.shape[0], accepted=accepted, mismatches=mism,
        lanes_per_kind={k: int((kinds == i).sum()) for i, k in enumerate(KINDS)},
        x_wrapped_accepted=wrapped_accepted, oracle_lanes=len(sample),
        oracle_mismatches=oracle_mism, ms=ms, plain_ms=plain_ms)
    return {"name": "p256_verify", "route": "cuda",
            "source": "fabric_tpu_torch/kernels/csrc/p256_verify.cu",
            "replaces": "fabric_tpu/ops/p256v3.py:183", "max_abs_err": err,
            "mismatches": mism, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


# ---------------------------------------------------------------------------
# Phase 4: the stage-2 kernels


def stage2_inputs(dev, T=1024, n_sig=3072, S=4, seed=SEED + 2):
    """Synthetic stage-2 operands at the main path's shapes."""
    from fabric_tpu_torch.crypto import policy as pol

    rng = np.random.default_rng(seed)
    sig_valid = rng.random(n_sig) < 0.9
    lv = np.zeros((T, 3), np.int32)
    lv[:, 0] = rng.integers(0, n_sig, T)
    lv[rng.choice(T, 24, replace=False), 0] = -1
    lv[rng.choice(T, 24, replace=False), 0] = -2
    lv[:, 1] = rng.random(T) < 0.97
    lv[:, 2] = rng.random(T) < 0.95
    R, W, Q = 2, 2, 1
    sp = np.full((T, R + W + 2 * Q), -1, np.int32)
    sp[:, :R] = rng.integers(0, 4000, (T, R))
    sp[:, R:R + W] = rng.integers(0, 4000, (T, W))
    chain = np.arange(100, 121)  # 20-deep read-after-write chain
    for i, t in enumerate(chain):
        sp[t, 0], sp[t, 1] = 5000 + i, -1
        sp[t, R], sp[t, R + 1] = 5000 + i + 1, -1
        lv[t] = (t, 1, 1)
        sig_valid[t] = True
    rq = rng.choice(np.setdiff1d(np.arange(T), chain), 80, replace=False)
    lo = rng.integers(0, 3990, len(rq))
    sp[rq, R + W] = lo
    sp[rq, R + W + Q] = lo + rng.integers(1, 12, len(rq))

    groups = []
    for dsl, P, Eb, n_ent in (
            ("OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')", 3, 1024, 1000),
            ("OutOf(1, 'Org1MSP.peer', 'Org1MSP.member')", 2, 16, 12)):
        plan = pol.compile_plan(pol.from_dsl(dsl))
        gp = np.zeros((Eb, S * P + S + 1), np.int32)
        gp[:, S * P:] = -1
        for e in range(n_ent):
            k = int(rng.integers(1, S + 1))
            m = np.zeros((S, P), np.int32)
            m[np.arange(k), rng.integers(0, P, k)] = 1
            if rng.random() < 0.05:
                m[0, :] = 1  # one signature matching every principal: unsafe
            idx = rng.integers(0, n_sig, k)
            tx = e if P == 3 else int(rng.integers(900, T))
            if tx in chain:  # chain txs: two valid endorsements by two orgs
                k, m = 2, np.zeros((S, P), np.int32)
                m[0, 0] = m[1, 1] = 1
                idx = np.array([tx, tx + 1])
                sig_valid[idx] = True
            gp[e, :S * P] = m.reshape(-1)
            gp[e, S * P:S * P + k] = idx
            gp[e, -1] = tx
        groups.append((plan, torch.from_numpy(gp).to(dev), Eb, S))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(sig_valid), t(lv), groups, t(sp), (R, W, Q)


def phase_stage2(dev):
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.ops import mvcc as mvcc_ops
    from fabric_tpu_torch.peer import device_block as db

    sv, lv, groups, sp, dims = stage2_inputs(dev)
    T, n_sig = lv.shape[0], sv.shape[0]
    got = db.stage2(sv, lv, groups, sp, dims)
    want = db.stage2_ref(sv, lv, groups, sp, dims)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    if mism:
        raise AssertionError(f"stage2 packed output differs: {mism} bytes")
    unsafe = int((want[5 * T + n_sig:] == 0).sum())
    valid = want[:T].bool()
    log("stage2", T=T, n_sig=n_sig, groups=len(groups), mismatches=mism,
        valid=int(valid.sum()), conflict=int(want[T:2 * T].sum()),
        phantom=int(want[2 * T:3 * T].sum()), unsafe_rows=unsafe,
        chain_valid=valid[100:121].int().tolist())

    # per-kernel timings at the main path's shapes (first group)
    plan, gp, Eb, S = groups[0]
    P = len(plan.principals)
    pt = torch.tensor(db.plan_vector(plan), dtype=torch.int32, device=dev)
    R, W, Q = dims

    def policy_kernel():
        pok = torch.ones(T + 1, dtype=torch.int32, device=dev)
        safe = torch.empty(Eb, dtype=torch.int8, device=dev)
        kernels.stage2_policy(sv, gp, S, P, pt, pok, safe)
        return pok, safe

    def policy_plain():
        ok, safe = db.policy_reduce_ref(sv, gp, S, P, plan)
        pok = torch.ones(T + 1, dtype=torch.int32, device=dev)
        tx = gp[:, -1].long()
        live = (tx >= 0) & (tx < T)
        pok.scatter_reduce_(0, torch.where(live, tx, T),
                            torch.where(live, ok, True).to(torch.int32), reduce="amin")
        return pok, safe

    (pk, sk), (pp, spl) = policy_kernel(), policy_plain()
    perr = int(max((pk - pp).abs().max(), (sk.int() - spl.int()).abs().max()))
    pmism = int((pk != pp).sum() + (sk != spl).sum())
    pok = pk
    out = torch.empty(5 * T + n_sig, dtype=torch.int8, device=dev)
    mvcc_kernel = lambda: kernels.stage2_mvcc(sp, R, W, Q, lv, sv, pok, out)
    pre_ok = (lv[:, 1] != 0) & db.creator_ok_ref(sv, lv[:, 0]) & (pok[:T] != 0)
    mvcc_plain = lambda: mvcc_ops.mvcc_validate_hostver_ref(
        sp[:, :R], lv[:, 2] != 0, sp[:, R:R + W], sp[:, R + W:R + W + Q], sp[:, R + W + Q:], pre_ok)
    mvcc_kernel()
    v, c, ph = mvcc_plain()
    merr = int((out[:3 * T].int() - torch.cat([v, c, ph]).int()).abs().max())
    mmism = int((out[:3 * T] != torch.cat([v, c, ph]).to(torch.int8)).sum())
    if pmism or mmism:
        raise AssertionError(f"stage2 kernels differ alone: policy {perr}, mvcc {merr}")
    words = T * ((T + 31) // 32)
    rel_ops = T * (T - 1) // 2 * W * (R + 2 * Q)  # compares below the diagonal
    recs = []
    b_ms, b_by = bound(nbytes(sv, gp, pt, pk, sk), Eb * S * P * 2)
    recs.append({"name": "stage2_policy", "route": "cuda",
                 "source": "fabric_tpu_torch/kernels/csrc/stage2.cu",
                 "replaces": "fabric_tpu/peer/device_block.py:64", "max_abs_err": perr,
                 "mismatches": pmism,
                 "ms": cuda_ms(policy_kernel, 20), "plain_ms": cuda_ms(policy_plain, 3),
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    b_ms, b_by = bound(nbytes(sp, lv, sv, pok, out), rel_ops + 2 * words)
    recs.append({"name": "stage2_mvcc", "route": "cuda",
                 "source": "fabric_tpu_torch/kernels/csrc/stage2.cu",
                 "replaces": "fabric_tpu/ops/mvcc.py:84", "max_abs_err": merr,
                 "mismatches": mmism,
                 "ms": cuda_ms(mvcc_kernel, 20), "plain_ms": cuda_ms(mvcc_plain, 3),
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # the mvcc_validate entry (per-read compare prologue)
    rng = np.random.default_rng(SEED + 3)
    rk = sp[:, :R].contiguous()
    rp = torch.from_numpy(rng.random((T, R)) < 0.9).to(dev)
    rv = torch.from_numpy(rng.integers(0, 3, (T, R, 2)).astype(np.int32)).to(dev)
    cp = rp.clone()
    cp[torch.from_numpy(rng.random((T, R)) < 0.03).to(dev)] ^= True
    cv = rv.clone()
    cv[torch.from_numpy(rng.random((T, R)) < 0.05).to(dev)] += 1
    pre = torch.from_numpy(rng.random(T) < 0.95).to(dev)
    args = (rk, rp, rv, cp, cv, sp[:, R:R + W].contiguous(), sp[:, R + W:R + W + Q].contiguous(),
            sp[:, R + W + Q:].contiguous(), pre)
    gk = torch.cat(mvcc_ops.mvcc_validate(*args))
    gp_ = torch.cat(mvcc_ops.mvcc_validate_ref(*args))
    verr = int((gk.int() - gp_.int()).abs().max())
    vmism = int((gk != gp_).sum())
    if vmism:
        raise AssertionError(f"mvcc_validate differs from its plain version at {vmism} flags")
    log("mvcc_validate", T=T, mismatches=vmism, valid=int(gk[:T].sum()))
    b_ms, b_by = bound(nbytes(*args) + 3 * T, rel_ops + 2 * words + T * R * 3)
    recs.append({"name": "mvcc_validate", "route": "cuda",
                 "source": "fabric_tpu_torch/kernels/csrc/stage2.cu",
                 "replaces": "fabric_tpu/ops/mvcc.py:49", "max_abs_err": verr,
                 "mismatches": vmism,
                 "ms": cuda_ms(lambda: mvcc_ops.mvcc_validate(*args), 20),
                 "plain_ms": cuda_ms(lambda: mvcc_ops.mvcc_validate_ref(*args), 3),
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return recs


# ---------------------------------------------------------------------------
# Phase 5: the main path


CC, UNSAFE_CC = "benchcc", "unsafecc"


def build_blocks(net: Net):
    """N_BLOCKS bench-shaped blocks plus one block in which every 60th
    tx also writes a namespace under a consumption-unsafe policy.
    → (blocks, expected filters, seed rows)."""
    from fabric_tpu_torch.ledger.rwset import TxRWSet
    from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
    from fabric_tpu_torch.peer.validator import DecodedBlock, DecodedEndorsement, DecodedTx

    blocks, expected, seed_rows = [], [], []
    for b in range(N_BLOCKS + 1):
        unsafe_block = b == N_BLOCKS
        txs, want = [], []
        for i in range(BLOCK_TXS):
            seed_rows.append((CC, f"seed{b}_{i:05d}", b"genesis", (1, 0)))
            seed_rows.append((CC, f"ro{b}_{i:05d}", b"genesis", (1, 0)))
            bad = i % 20 == 0
            stale = bad and (i // 20) % 2 == 1
            rw = TxRWSet()
            ns = rw.ns_rwset(CC)
            ns.reads[f"seed{b}_{i:05d}"] = (9, 9) if stale else (1, 0)
            ns.reads[f"ro{b}_{i:05d}"] = (1, 0)
            ns.writes[f"w{b}_{i:05d}"] = b"value-%d" % i
            ns.writes[f"seed{b}_{i:05d}"] = b"updated"
            if unsafe_block and i % 60 == 3:  # i % 3 == 0: Org1 + Org2 peers endorse
                rw.ns_rwset(UNSAFE_CC).writes[f"u{b}_{i:05d}"] = b"x"
            n = b * BLOCK_TXS + i
            e, r, s = net.sig(0, n)
            if bad and not stale:
                e ^= 1  # the creator signature no longer matches
            ends = []
            for k in (i % 3, (i + 1) % 3):
                ee, rr, ss = net.sig(1 + k, n)
                ends.append(DecodedEndorsement(net.peers[k], ee, rr, ss))
            txs.append(DecodedTx(txid=f"tx{b}_{i:05d}", creator=net.client,
                                 creator_sig=(e, r, s), endorsements=ends, rwset=rw))
            want.append(int(C.MVCC_READ_CONFLICT) if stale
                        else int(C.BAD_CREATOR_SIGNATURE) if bad else int(C.VALID))
        blocks.append(DecodedBlock(number=2 + b, txs=txs))
        expected.append(bytes(want))
    return blocks, expected, seed_rows


def run_pipeline(blocks, seed_rows, device, depth=2):
    """→ ([CommittedBlock], seconds, per-block completion seconds)."""
    from fabric_tpu_torch import carry
    from fabric_tpu_torch.peer.pipeline import CommitPipeline
    from fabric_tpu_torch.peer.validator import BlockValidator

    state, prov, _ = carry.from_reference(seed_rows, {
        CC: "OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')",
        UNSAFE_CC: "OutOf(1, 'Org1MSP.peer', 'Org1MSP.member')"}, [])

    class Store:
        def __init__(self):
            self.txids = set()

        def tx_exists(self, txid):
            return txid in self.txids

    store = Store()

    def commit(res):
        state.apply_updates(res.batch)
        store.txids.update(t for t, _ in res.txids)

    v = BlockValidator(prov, state, block_store=store, device=device)
    out, marks = [], []
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with CommitPipeline(v, commit, depth=depth) as pipe:
        for blk in blocks:
            r = pipe.submit(blk)
            if r is not None:
                out.append(r)
                marks.append(time.perf_counter() - t0)
        r = pipe.flush()
        if r is not None:
            out.append(r)
            marks.append(time.perf_counter() - t0)
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, marks


def device_busy(blocks, seed_rows):
    """A second run of the main path under ``torch.profiler`` → (the
    union of the card's kernel and copy intervals in ms, that run's
    wall seconds, the number of device events).  0 events means the
    profiler saw no device activity: the busy time is then unknown."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, secs, _ = run_pipeline(blocks, seed_rows, "cuda")
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy_us / 1e3, secs, len(spans)


def phase_main_path(net: Net):
    from fabric_tpu_torch import kernels

    blocks, expected, seed_rows = build_blocks(net)
    kernels.reset_counts()
    res, secs, marks = run_pipeline(blocks, seed_rows, "cuda")
    counts = dict(kernels.launches)
    got = [r.tx_filter for r in res]
    if got != expected:
        bad = [(b, i, g[i], w[i]) for b, (g, w) in enumerate(zip(got, expected))
               for i in range(len(w)) if g[i] != w[i]]
        raise AssertionError(f"main path filters differ from construction at "
                             f"(block, tx, got, want) {bad[:10]}")
    n_tx = sum(len(b.txs) for b in blocks)
    log("main_path", blocks=len(blocks), txs=n_tx, depth=2, seconds=secs,
        per_block_ms=1e3 * secs / len(blocks), tx_per_s=n_tx / secs,
        completion_s=marks, valid=[r.n_valid for r in res], launches=counts)
    busy_ms, psecs_prof, n_ev = device_busy(blocks, seed_rows)
    log("device_busy", profiled_seconds=psecs_prof, device_events=n_ev,
        busy_ms=busy_ms if n_ev else None,
        busy_ms_per_block=busy_ms / len(blocks) if n_ev else None,
        idle_share_profiled=1 - busy_ms / (1e3 * psecs_prof) if n_ev else None,
        idle_share_vs_unprofiled=1 - busy_ms / (1e3 * secs) if n_ev else None)
    plain, psecs, _ = run_pipeline(blocks, seed_rows, "cpu", depth=1)
    for a, b in zip(res, plain):
        rows = lambda x: sorted((k, vv.value, vv.version) for k, vv in x.batch.items())
        if a.tx_filter != b.tx_filter or rows(a) != rows(b) or a.history != b.history:
            raise AssertionError(f"block {a.block.number}: card path differs from plain path")
    log("plain_path", blocks=len(plain), seconds=psecs, equal=True)
    zero = [k for k, v in counts.items() if v == 0]
    if zero:
        raise AssertionError(f"kernels not launched on the main path: {zero}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fabric_tpu_torch import kernels

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)
    secs = kernels.build()
    regs = [ln.strip() for text in kernels.build_log.values() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln]
    log("build", seconds=secs, ptxas=regs)
    t0 = time.perf_counter()
    net = Net(SEED)
    log("signatures", identities=len(net.keys), per_identity=POOL,
        seconds=time.perf_counter() - t0)
    dev = torch.device("cuda")
    recs = [phase_verify(net, dev)]
    recs += phase_stage2(dev)
    counts = phase_main_path(net)
    for r in recs:
        r["launches"] = counts[r["name"]]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "mismatches",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in order} for r in recs]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
