#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fabric_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each: the device; the kernel build (ptxas registers,
spills and static shared memory); the P-256 verify kernel against its
plain version at 3072 lanes (each rejected or edge kind on at least 10%
of them, x(R) >= n lanes that only the r + n compare accepts included)
and 64 random lanes plus 4 of each kind against the pure-Python oracle,
then against its plain version at the sidecar's 6,144 and 12,288 lanes
(the kernel picks its team size by batch: 8 threads a lane up to 6,144,
4 above), with two bounds each; the stage-2
kernels against their plain versions at T = 1024, Eb = 1024, S = 4,
P = 3 (a 20-deep conflict chain, range phantoms, both creator
sentinels, consumption-unsafe rows), the block's one policy launch
over its two groups and over a config-4-shaped block's three (S = 4,
4, 8; P = 3, 4, 4), and the ``mvcc_validate`` entry; ptxas's stack
frame and spills of the two redesigned kernels (0 or it fails);
the main path — blocks of 1000 transactions (3 orgs, a 2-of-3 peer
policy, rotating endorser pairs, 2 reads and 2 writes per tx, 5%
invalid) and one block with a consumption-unsafe namespace through
``CommitPipeline(depth=2)`` on the card, with the launch counts reset
just before and read just after (one ``stage2_policy`` launch a fused
block, whatever its groups), checked against the filters the
blocks were built to produce and against the same blocks validated
through the plain versions on the CPU, with the validator's phase
timers (``BlockValidator.timings``, ms a block by the reference's
phase keys, plus ``ledger_commit`` around the commit); a second run of
the main path under ``torch.profiler`` gives the card's busy time and
idle share.
The resident path: a world state of 1,000,000
keys warmed into the table, 4 bench-shaped blocks whose read-only keys
are the same in every block (a hot working set) through
``CommitPipeline`` at depths 2 and 3 with ``state_resident=True``,
checked against construction and against the same blocks without
resident state (filters, update batches, history, final state), with
one ``resident_verok`` launch per block, a hit rate >= 0.99 and no
eviction; both paths' busy time under ``torch.profiler``; then a
4,096-slot table under read keys that shift every block, which must
evict and still agree.  The resident-state kernels against their plain
versions over the default 64 MB table (4,194,304 slots, 48 MiB):
``resident_verok`` at T = 1024, R = 2, Ub = 4096 and at every pack
size the resident path launched it with, hit, miss, overlay and
deleted lanes each on >= 10% of the reads, and ``table_scatter`` at
k = 16 and 2048 beside ``index_copy_`` (8 alternating turns, medians)
with the wrapper's host microseconds per call.  The sign lane: 8 client
threads signing 500 digests through
``SignBatcher(device_sign_backend(...))``, equal to
``cpu_sign_backend``; then ``p256_sign`` against its plain version at
4,096 and 256 (the default ``batch_max``) lanes (edge nonces included)
and at every bucket the lane launched it with, up to 256 lanes of each
against ``ec_ref``, and fixed-nonce signatures against ``ec_ref`` and
through ``p256_verify``.  The wire path: 9 bench-shaped 1000-tx blocks
in wire format, built with the port's cryptogen and
``build_envelopes`` and signed on the card (27,000 digests, 64 checked
against ``ec_ref``), every 20th transaction invalid in one of nine
ways, through ``CommitPipeline(depth=2)`` with the port's MSP (the
columnar parse: one ``native/blockparse.cpp``, one
``native/ecprep.cpp`` and one ``native/mvccprep.cpp`` call a block),
the first block alone and then the other 8, each with the phase
timers; checked against construction and against the same blocks
decoded by ``decode_block`` through the ``DecodedBlock`` entry
(filters, update batches, history), with the front end's decode time
per block beside ``host_parse``, the envelopes the front end decoded,
the read/write sets parsed in Python, and the card's busy share.  The
coalesced path: the same 9 blocks through
``CommitPipeline(coalesce_blocks=4).submit_many`` (one ``p256_verify``
launch a group of 4, 12,288 lanes), with a host staging pool of one
worker a core and without, each block equal to the wire path's.  The
autopilot path (``autopilot_path``), on the same blocks: the traffic
autopilot ticked by the smoke after each submission moves the chunk
(one ``p256_verify`` launch a chunk into one output vector), the depth,
the coalescing and the staging pool; every block equal to the wire
path's, the launches to what the decisions imply, every launched shape
to its plain version; the sign lane under its batch and wait knobs
(``p256_sign`` at every bucket it launched against its plain version); a
sidecar tenant shed and unshed by a sidecar-local autopilot; and the
flight recorder's bundles at a guard's latch and a failed pipe.  The
host stage, on one block each, every result byte-equal to the plain
Python it replaces: ``stage_frame`` against ``stage_frame_ref`` at the
main path's 3,072 lanes (a decoded block's tuples and a wire block's
columns), ``prepare_block_from_flat`` against ``prepare_block_static``
(both forms), the columnar policy groups against the entry-by-entry
ones, and ``parse_envelopes`` and the whole columnar parse
beside ``decode_block``; the build line gives g++'s version and
seconds beside nvcc's.  SHA-256:
``sha256_host`` on the bench shape (4,096 x 200 B), the padding
boundaries, a ragged M = 8 batch and the first wire block's signed
messages against ``hashlib`` (its launches counted), then
``sha256_blocks`` against its plain version at each (and at the wire
block's messages as ``sha256_host`` buckets them), timed at the bench
shape and at that bucketed wire block, each beside serial ``hashlib``,
its bound and its chain floor (the round loop's SASS by pipe).  The comparison verifiers: the main
path's bench-shaped blocks through ``CommitPipeline(depth=2)`` over
``BlockValidator(kernel="v1")`` and then ``"v2"`` (no stage 2, host
policy, ``mvcc_validate``), equal to the v3 main path; then each kernel
(``p256_verify_v1``, ``p256_verify_v2``, both teams of threads a lane)
against its plain version at 3072 lanes of the adversarial mix with
Q = G and Q = -G lanes, 64 random lanes plus 4 of each kind against
``ec_ref``, timed at the shape its path launched, with the launched
kernel's team size, registers and local bytes (stack frame and spills,
``cudaFuncGetAttributes``), and two bounds (the kernels
line's, and ``bound_needed_ms``, the yardstick ``p256_verify``
shares).  The sidecar: a ``SidecarServer`` on 127.0.0.1 (coalesce 4, 8
queued blocks per tenant) serving 3 tenants of
weights 1, 1 and 2 at once, each a ``SidecarValidator`` under
``CommitPipeline(depth=2)`` over its own copy of the main path's blocks, equal to
the main path, one ``p256_verify`` launch per dispatch; then one
block's batch through a ``SidecarLink`` to a v1 and a v2 server, equal
to the in-process v3 verdicts.  BASELINE config 4's path
(``config4_path``) and config 5's (``config5_path``: an idemix org
beside three X.509 orgs, 2% anonymous creators whose proofs are checked
on the host, an epoch-record rotation at a barrier), and the ledger
and its catch-up paths (``ledger_path``: 12 chained wire blocks
committed into a sqlite-backed ``KVLedger``, reopened, crashed and
recovered on the card, replayed from its block store, and joined from
a snapshot with the resident table warmed), the observe hooks
(``observe_path``: the ledger's first 6 blocks with the span tracer,
the launch ledger and the tx-flow journal armed and disarmed in turns,
every span, ledger row, metric and flow checked, the telemetry's cost
a block), and the commit path under failure (``chaos_path``: the
ledger's blocks through a guarded
``BlockValidator`` under a seeded fault plan and the containment loop,
equal to a fault-free run, its pipe's spans by lane under a private
tracer; the resident cache's disable latch; a sidecar stopped and
restarted under the sidecar latch), and BASELINE config 1's network
(``network_path``: an ``OrdererNode`` with Raft and a ``PeerNode``
whose endorser signs on the card's sign lane, over localhost; 8 gateway
clients send 64 transactions, one block cut by the timeout with 8 MVCC
conflicts; filters against the port's serial host validation, every
key read back through Query, commit status, every endorsement verified,
the endorse latency while the block commits), BASELINE config 4 as a
network (``config4_network_path``: 3 Raft orderers in a child process,
4 peers of 4 orgs with gossip's private-data push, pull, reconciliation
and anti-entropy; 8 gateway clients, 500 transactions cut by count
with 10 MVCC conflicts; Org3's peer started late and caught up from a
peer) and the BFT ordering service (``bft_path``: 4 consenters in a
child process and a peer that checks each block's quorum attestation;
3 blocks of 16, two forgeries refused, the leader stopped, a block
after the view change), and the node as operators run it (``cli_path``:
``python -m fabric_tpu_torch.cli`` daemons in processes of their own,
one orderer, a chaincode server and two peers on the card with mutual
TLS and operations ports, the chaincode packaged, installed, approved
and committed by the CLI's verbs, 500 transactions from 8 gateway
clients cut by count with 10 MVCC conflicts, each peer's own /launches,
``ledgerutil`` and an offline ``replay`` on the card); their functions
say what each checks, and a
``phases`` line gives each phase's seconds.  Each path's launch counts are reset just
before it and read just after; a kernel's entry in the kernels line
gives its time at the shape its path launched it with most often.  Then the kernels line (JSON),
the card's name and power limit as nvidia-smi reports them, and the
result line.  Any mismatch raises; there is no result without CUDA.
Signatures come from a pool of RFC 6979 signatures per identity made
once with the port's pure-Python ``ec_ref`` from a fixed seed.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SEED = 20261017
N_BLOCKS = 2
BLOCK_TXS = 1000
POOL = 128
VERIFY_LANES = 3072
# H100 SXM: HBM3 bytes/s, and INT32 multiply-add lanes: 132 SMs x 64 x 1.98 GHz
PEAK_BYTES_S = 3.35e12
PEAK_INT32_S = 132 * 64 * 1.98e9
# the INT32 and FMA pipes together: an SM's four sub-partitions issue one
# warp instruction (32 lanes) a cycle each
PEAK_ISSUE_S = 132 * 4 * 32 * 1.98e9


_T0 = time.perf_counter()


def log(phase: str, **kw) -> None:
    """One JSON line; ``at_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, **kw, "at_s": time.perf_counter() - _T0}), flush=True)


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
        from fabric_tpu_torch.protos.messages import SerializedIdentity

        rng = np.random.default_rng(seed)
        self.ec = ec_ref
        self.keys, self.idents, self.pools, self.serialized = [], [], [], []
        names = [("Org1MSP", "client"), ("Org1MSP", "peer"), ("Org2MSP", "peer"),
                 ("Org3MSP", "peer")]
        for msp, role in names:
            d = int.from_bytes(rng.bytes(32), "big") % (ec_ref.N - 1) + 1
            key = ec_ref.SigningKey(d=d)
            qx, qy = key.public
            self.keys.append(key)
            self.idents.append(Identity(msp, role, qx, qy, True))
            # the endorsers' deduplication key; the point stands in for a certificate
            self.serialized.append(SerializedIdentity(
                mspid=msp, id_bytes=b"\x04" + qx.to_bytes(32, "big") + qy.to_bytes(32, "big"))
                .serialize())
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


def verify_bound(v3, frame, got):
    """``p256_verify``'s bound, two ways → (ms, by, needed ms, needed by).  The
    first, which the kernels line gives, counts the reference schedule's
    Montgomery products — 2 to_mont + 3 on-curve + 14 table adds x 14 +
    per step 4 doublings x 13 + add 14 + mixed add 13 (only at nonzero
    u1 digits) + 4 final — at 128 32x32->64 multiply-adds each (64 for
    a*b, 64 for m*p), 2 INT32 ops per, so that it reads the same work as
    PR 1's.  The second counts what the function needs: 64 wide products
    a product (36 for a square: 3 a doubling, 2 in the on-curve check)
    and none for the reduction, which for P-256 is limb-aligned adds."""
    w1 = v3.recode_windows(frame[:, 64:80]).cpu().numpy()
    nonzero = int((w1 != 0).sum())
    B = frame.shape[0]
    products = B * (5 + 14 * 14 + 64 * (4 * 13 + 14) + 4) + 13 * nonzero
    squares = B * (2 + 64 * 4 * 3)
    moved = nbytes(frame, got) + 24 * 4 + 16 * 64
    ms, by = bound(moved, products * 128 * 2)
    needed_ms, needed_by = bound(moved, ((products - squares) * 64 + squares * 36) * 2)
    return ms, by, needed_ms, needed_by


VERIFY_SHAPES = (6144, 12288)  # the sidecar's coalesced launches


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
    b_ms, b_by, needed_ms, _ = verify_bound(v3, frame, got)
    log("verify", lanes=frame.shape[0], accepted=accepted, mismatches=mism,
        lanes_per_kind={k: int((kinds == i).sum()) for i, k in enumerate(KINDS)},
        x_wrapped_accepted=wrapped_accepted, oracle_lanes=len(sample),
        oracle_mismatches=oracle_mism, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_needed_ms=needed_ms)
    for lanes in VERIFY_SHAPES:
        its, _ = adversarial_items(net, lanes)
        f = torch.from_numpy(v3.stage_frame(its, v3._bucket(len(its)))).to(dev)
        o = v3.verify_batch_packed(f)
        w = v3.verify_batch_ref(f)
        torch.cuda.synchronize()
        m = int((o != w).sum())
        if m:
            raise AssertionError(f"p256_verify at {lanes} lanes: {m} lanes differ from "
                                 "verify_batch_ref")
        sb_ms, _, s_needed, _ = verify_bound(v3, f, o)
        log("verify_shape", lanes=f.shape[0], accepted=int(o.sum()), mismatches=m,
            ms=cuda_ms(lambda: v3.verify_batch_packed(f), 5), bound_ms=sb_ms,
            bound_needed_ms=s_needed)
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


def config4_policy_groups(dev, T=1024, n_sig=3072, seed=SEED + 8):
    """A block's policy groups shaped like config 4's: ``basic`` (2 of 3
    peers, P = 3, S = 4, 450 entries), ``pvtcc`` (2 of 4, P = 4, S = 4,
    350) and ``sbecc`` (1 of 4, P = 4, S = 8, 200), transactions in
    order across the three, about 2% of the rows consumption-unsafe."""
    from fabric_tpu_torch.crypto import policy as pol

    rng = np.random.default_rng(seed)
    groups, tx0 = [], 0
    for ns, S, n_ent in (("basic", 4, 450), ("pvtcc", 4, 350), ("sbecc", 8, 200)):
        plan = pol.compile_plan(pol.from_dsl(CONFIG4_NS[ns]))
        P = len(plan.principals)
        Eb = 1 << max(4, (n_ent - 1).bit_length())
        gp = np.zeros((Eb, S * P + S + 1), np.int32)
        gp[:, S * P:] = -1
        for e in range(n_ent):
            k = int(rng.integers(1, min(S, P) + 1))
            m = np.zeros((S, P), np.int32)
            m[np.arange(k), rng.choice(P, k, replace=False)] = 1
            if rng.random() < 0.02:
                m[0, :] = 1  # one signature matching every principal: unsafe
            gp[e, :S * P] = m.reshape(-1)
            gp[e, S * P:S * P + k] = rng.integers(0, n_sig, k)
            gp[e, -1] = tx0 + e
        tx0 += n_ent
        groups.append((plan, torch.from_numpy(gp).to(dev), Eb, S))
    return groups


def policy_plain(sv, groups, T):
    """Plain ``stage2_policy`` over a block's groups, from
    ``policy_reduce_ref``: (fail_tx, safe) per entry, in frame order."""
    from fabric_tpu_torch.peer import device_block as db

    fails, safes = [], []
    for plan, gp, _, S in groups:
        ok, safe = db.policy_reduce_ref(sv, gp, S, len(plan.principals), plan)
        tx = gp[:, -1]
        fails.append(torch.where(~ok & (tx >= 0) & (tx < T), tx, -1).int())
        safes.append(safe.to(torch.int8))
    return torch.cat(fails), torch.cat(safes)


def policy_launch(sv, groups, T):
    """One ``stage2_policy`` launch over ``groups`` as the validator makes
    it (the frames in one buffer, the table built once) → (the launch,
    fail_tx, safe, the frames and table's bytes)."""
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.peer import device_block as db

    dev = sv.device
    frames = db.group_frames(groups).to(dev)
    table = db.policy_table([(p, eb, s) for p, _, eb, s in groups], dev)
    fail = torch.empty(table.n_entries, dtype=torch.int32, device=dev)
    safe = torch.empty(table.n_entries, dtype=torch.int8, device=dev)

    def launch():
        kernels.stage2_policy(sv, frames, table.meta, table.n_cta, table.smem, T, safe, fail)

    return launch, fail, safe, nbytes(frames, table.meta)


def phase_stage2(dev):
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.ops import mvcc as mvcc_ops
    from fabric_tpu_torch.peer import device_block as db

    sv, lv, groups, sp, dims = stage2_inputs(dev)
    T, n_sig = lv.shape[0], sv.shape[0]
    # the whole stage 2 against stage2_ref, on stage2_inputs' two groups
    # and on a config-4-shaped block's three; one policy launch each
    c4 = config4_policy_groups(dev, T, n_sig)
    mism, launches = {}, {}
    for name, gs in (("stage2_inputs", groups), ("config4_groups", c4)):
        kernels.reset_counts()
        got = db.stage2(sv, lv, gs, sp, dims)
        launches[name] = kernels.launches["stage2_policy"]
        want = db.stage2_ref(sv, lv, gs, sp, dims)
        torch.cuda.synchronize()
        mism[name] = int((got != want).sum())
        if name == "stage2_inputs":
            want0 = want
    if any(mism.values()) or set(launches.values()) != {1}:
        raise AssertionError(f"stage2 packed output differs: {mism} bytes; policy launches "
                             f"{launches}")
    want = want0
    unsafe = int((want[5 * T + n_sig:] == 0).sum())
    valid = want[:T].bool()
    counts = {"valid": int(valid.sum()), "conflict": int(want[T:2 * T].sum()),
              "phantom": int(want[2 * T:3 * T].sum()), "unsafe_rows": unsafe,
              "chain_valid": valid[100:121].int().tolist()}

    # the policy launch alone against its plain version, at the main
    # path's two groups and the config-4 block's three
    R, W, Q = dims
    pol_rec = {}
    for name, gs in (("stage2_inputs", groups), ("config4_groups", c4)):
        launch, fail, safe, table_bytes = policy_launch(sv, gs, T)
        launch()
        pf, ps = policy_plain(sv, gs, T)
        torch.cuda.synchronize()
        pm = int((fail != pf).sum() + (safe != ps).sum())
        perr = int(max((fail - pf).abs().max(), (safe.int() - ps.int()).abs().max()))
        if pm:
            raise AssertionError(f"stage2_policy on {name} differs from its plain version "
                                 f"in {pm} entries")
        E = fail.shape[0]
        ops = sum(eb * s * len(p.principals) * 2 for p, _, eb, s in gs)
        b_ms, b_by = bound(nbytes(sv) + table_bytes + E * 5, ops)
        pol_rec[name] = {"entries": E, "groups": len(gs), "mismatches": pm, "err": perr,
                         "ms": cuda_ms(launch, 20),
                         "plain_ms": cuda_ms(lambda gs=gs: policy_plain(sv, gs, T), 3),
                         "bound_ms": b_ms, "bound_by": b_by}
        if name == "stage2_inputs":
            fail0 = fail.clone()
    fail = fail0
    out = torch.empty(5 * T + n_sig, dtype=torch.int8, device=dev)
    mvcc_kernel = lambda: kernels.stage2_mvcc(sp, R, W, Q, lv, sv, fail, out)
    pre_ok = (lv[:, 1] != 0) & db.creator_ok_ref(sv, lv[:, 0]) & (want[4 * T:5 * T] != 0)
    mvcc_plain = lambda: mvcc_ops.mvcc_validate_hostver_ref(
        sp[:, :R], lv[:, 2] != 0, sp[:, R:R + W], sp[:, R + W:R + W + Q], sp[:, R + W + Q:], pre_ok)
    mvcc_kernel()
    v, c, ph = mvcc_plain()
    merr = int((out[:3 * T].int() - torch.cat([v, c, ph]).int()).abs().max())
    mmism = int((out[:3 * T] != torch.cat([v, c, ph]).to(torch.int8)).sum())
    if mmism:
        raise AssertionError(f"stage2_mvcc differs alone: {merr}")
    # each MVCC kernel alone on the device (a CUDA graph of 200 launches)
    from fabric_tpu_torch.tools.launch_steps import graph_us, mvcc_launches, mvcc_rounds

    bits, fix, _ = mvcc_launches(kernels._entries["fab_mvcc_bitsets"].fn,
                                 kernels._entries["fab_mvcc_fixpoint"].fn, sp, dims, lv, sv,
                                 fail, out.clone())
    log("stage2", T=T, n_sig=n_sig, groups=len(groups), mismatches=mism,
        policy_launches=launches, **counts, policy=pol_rec,
        rounds=mvcc_rounds(sp, dims, lv, sv, fail), fixpoint_in_smem=kernels.mvcc_fixpoint_in_smem(T),
        bitsets_device_us=graph_us(bits), fixpoint_device_us=graph_us(fix))
    words = T * ((T + 31) // 32)
    rel_ops = T * (T - 1) // 2 * W * (R + 2 * Q)  # compares below the diagonal
    recs = []
    pr = pol_rec["stage2_inputs"]  # the main path's block: its two groups, one launch
    recs.append({"name": "stage2_policy", "route": "cuda",
                 "source": "fabric_tpu_torch/kernels/csrc/stage2.cu",
                 "replaces": "fabric_tpu/peer/device_block.py:64", "max_abs_err": pr["err"],
                 "mismatches": pr["mismatches"], "ms": pr["ms"], "plain_ms": pr["plain_ms"],
                 "bound_ms": pr["bound_ms"], "bound_by": pr["bound_by"], "library_ms": None})
    b_ms, b_by = bound(nbytes(sp, lv, sv, fail, out), rel_ops + 2 * words)
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


def build_blocks(net: Net, n_blocks: int = N_BLOCKS, unsafe: bool = True,
                 ro_key=lambda b, i: f"ro{b}_{i:05d}"):
    """n_blocks bench-shaped blocks, plus (``unsafe``) one block in
    which every 60th tx also writes a namespace under a
    consumption-unsafe policy.  ``ro_key(b, i)``: the read-only key of
    tx i of block b.  → (blocks, expected filters, seed rows)."""
    from fabric_tpu_torch.ledger.rwset import TxRWSet
    from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
    from fabric_tpu_torch.peer.validator import DecodedBlock, DecodedEndorsement, DecodedTx

    blocks, expected, seed_rows, ro_seen = [], [], [], set()
    for b in range(n_blocks + unsafe):
        unsafe_block = b == n_blocks
        txs, want = [], []
        for i in range(BLOCK_TXS):
            ro = ro_key(b, i)
            seed_rows.append((CC, f"seed{b}_{i:05d}", b"genesis", (1, 0)))
            if ro not in ro_seen:
                ro_seen.add(ro)
                seed_rows.append((CC, ro, b"genesis", (1, 0)))
            bad = i % 20 == 0
            stale = bad and (i // 20) % 2 == 1
            rw = TxRWSet()
            ns = rw.ns_rwset(CC)
            ns.reads[f"seed{b}_{i:05d}"] = (9, 9) if stale else (1, 0)
            ns.reads[ro] = (1, 0)
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
                ends.append(DecodedEndorsement(net.peers[k], ee, rr, ss, net.serialized[1 + k]))
            txs.append(DecodedTx(txid=f"tx{b}_{i:05d}", creator=net.client,
                                 creator_sig=(e, r, s), endorsements=ends, rwset=rw))
            want.append(int(C.MVCC_READ_CONFLICT) if stale
                        else int(C.BAD_CREATOR_SIGNATURE) if bad else int(C.VALID))
        blocks.append(DecodedBlock(number=2 + b, txs=txs))
        expected.append(bytes(want))
    return blocks, expected, seed_rows


NAMESPACES = {CC: "OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')",
              UNSAFE_CC: "OutOf(1, 'Org1MSP.peer', 'Org1MSP.member')"}


def run_pipeline(blocks, seed_rows, device, depth=2, timings=None):
    """→ ([CommittedBlock], seconds, per-block completion seconds)."""
    from fabric_tpu_torch import carry
    from fabric_tpu_torch.peer.validator import BlockValidator

    state, prov, _ = carry.from_reference(seed_rows, NAMESPACES, [])
    return run_validator(blocks, BlockValidator(prov, state, device=device), depth,
                         timings=timings)


class TxidStore:
    def __init__(self):
        self.txids = set()

    def tx_exists(self, txid):
        return txid in self.txids


def run_validator(blocks, v, depth=2, timings=None, coalesce=0):
    """Commit ``blocks`` through ``CommitPipeline`` with the validator
    ``v`` (its ``state`` receives the commits; a txid store is attached
    unless it has one) → ([CommittedBlock], seconds, per-block
    completion seconds).  ``timings``: a dict that receives the
    validator's phase seconds (``BlockValidator.timings``) and the
    commit's as ``ledger_commit``, summed over the blocks.  ``coalesce``:
    ``CommitPipeline(coalesce_blocks=)``, the blocks fed by one
    ``submit_many``."""
    from fabric_tpu_torch.peer.pipeline import CommitPipeline

    if not isinstance(v.blocks, TxidStore):
        v.blocks = TxidStore()
    store = v.blocks
    state = v.state
    device = v.device.type
    v.timings = timings

    def commit(res):
        t0 = time.perf_counter()
        state.apply_updates(res.batch)
        store.txids.update(t for t, _ in res.txids)
        v._t("ledger_commit", t0)

    out, marks = [], []
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    # an older package's pipeline has no coalesce_blocks
    kw = {"coalesce_blocks": coalesce} if coalesce else {}
    with CommitPipeline(v, commit, depth=depth, **kw) as pipe:
        if coalesce:  # one mark for the blocks submit_many completed
            out += pipe.submit_many(blocks)
            marks += [time.perf_counter() - t0] * len(out)
        else:
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


def device_busy(blocks, seed_rows=None, validator=None, coalesce=0):
    """A second run of the main path (or of ``validator`` over
    ``blocks``) under ``torch.profiler`` → (the union of the card's
    kernel and copy intervals in ms, that run's wall seconds, the number
    of device events, their count by name).  The busy time is None when
    the trace is incomplete: no device event at all, or fewer
    ``p256_verify`` kernels in it than the run launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fabric_tpu_torch import kernels

    before = kernels.launches["p256_verify"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if validator is None:
            _, secs, _ = run_pipeline(blocks, seed_rows, "cuda")
        else:
            _, secs, _ = run_validator(blocks, validator, coalesce=coalesce)
    launched = kernels.launches["p256_verify"] - before
    # the dispatch annotations (``fabtpu.*``, record_function) also show
    # as ranges on the card's timeline; they are not device work
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not e.name.startswith("fabtpu.")]
    names = Counter(e.name[:40] for e in dev_events)
    traced = sum(n for name, n in names.items() if "p256_verify" in name)
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    complete = bool(spans) and traced >= launched
    return (busy_us / 1e3 if complete else None), secs, len(spans), names


def phase_main_path(net: Net):
    from fabric_tpu_torch import kernels

    blocks, expected, seed_rows = build_blocks(net)
    kernels.reset_counts()
    timings = {}
    with fused_blocks() as fused:
        res, secs, marks = run_pipeline(blocks, seed_rows, "cuda", timings=timings)
    counts = dict(kernels.launches)
    check_policy_launches("main path", counts, fused)
    got = [r.tx_filter for r in res]
    if got != expected:
        bad = [(b, i, g[i], w[i]) for b, (g, w) in enumerate(zip(got, expected))
               for i in range(len(w)) if g[i] != w[i]]
        raise AssertionError(f"main path filters differ from construction at "
                             f"(block, tx, got, want) {bad[:10]}")
    n_tx = sum(len(b.txs) for b in blocks)
    log("main_path", blocks=len(blocks), txs=n_tx, depth=2, seconds=secs,
        per_block_ms=1e3 * secs / len(blocks), tx_per_s=n_tx / secs,
        completion_s=marks, valid=[r.n_valid for r in res], launches=counts,
        fused_blocks=fused, phase_ms_per_block={k: 1e3 * t / len(blocks) for k, t in sorted(timings.items())})
    busy_ms, psecs_prof, n_ev, names = device_busy(blocks, seed_rows)
    ok = busy_ms is not None
    log("device_busy", profiled_seconds=psecs_prof, device_events=n_ev, by_name=names,
        busy_ms=busy_ms, busy_ms_per_block=busy_ms / len(blocks) if ok else None,
        idle_share_profiled=1 - busy_ms / (1e3 * psecs_prof) if ok else None,
        idle_share_vs_unprofiled=1 - busy_ms / (1e3 * secs) if ok else None)
    plain, psecs, _ = run_pipeline(blocks, seed_rows, "cpu", depth=1)
    for a, b in zip(res, plain):
        rows = lambda x: sorted((k, vv.value, vv.version) for k, vv in x.batch.items())
        if a.tx_filter != b.tx_filter or rows(a) != rows(b) or a.history != b.history:
            raise AssertionError(f"block {a.block.number}: card path differs from plain path")
    log("plain_path", blocks=len(plain), seconds=psecs, equal=True)
    zero = [k for k in MAIN_PATH_KERNELS if counts[k] == 0]
    if zero:
        raise AssertionError(f"kernels not launched on the main path: {zero}")
    return counts, res


MAIN_PATH_KERNELS = ("p256_verify", "stage2_policy", "stage2_mvcc", "mvcc_validate")
RESIDENT_KERNELS = ("p256_verify", "stage2_policy", "stage2_mvcc", "resident_verok",
                    "table_scatter")


@contextlib.contextmanager
def fused_blocks():
    """Count the blocks that take the fused stage 2 inside the block:
    ``blocks``, and ``with_entries`` (a policy entry at least, so one
    ``stage2_policy`` launch each)."""
    from fabric_tpu_torch.peer import device_block as db

    seen, fn = {"blocks": 0, "with_entries": 0}, db.stage2

    def wrapped(sig_valid, launch_vec, groups, *rest):
        seen["blocks"] += 1
        seen["with_entries"] += any(g[2] for g in groups)
        return fn(sig_valid, launch_vec, groups, *rest)

    db.stage2 = wrapped
    try:
        yield seen
    finally:
        db.stage2 = fn


def check_policy_launches(path: str, counts, fused) -> None:
    """A fused block's policy stage is one launch, whatever its groups."""
    if counts["stage2_policy"] != fused["with_entries"]:
        raise AssertionError(f"{path}: {counts['stage2_policy']} stage2_policy launches for "
                             f"{fused['with_entries']} fused blocks with policy entries")


@contextlib.contextmanager
def launch_shapes(name, shape_of):
    """Count the shapes kernel ``name`` is launched with inside the
    block: a Counter of ``shape_of(*args)``."""
    from fabric_tpu_torch import kernels

    seen, fn = Counter(), getattr(kernels, name)

    def wrapped(*a, **kw):
        seen[shape_of(*a, **kw)] += 1
        return fn(*a, **kw)

    setattr(kernels, name, wrapped)
    try:
        yield seen
    finally:
        setattr(kernels, name, fn)


# ---------------------------------------------------------------------------
# Phase 6: the resident-state kernels


TABLE_SLOTS = 1 << 22  # the default 64 MB table: 4,194,304 slots, 48 MiB
RES_T, RES_R, RES_UB = 1024, 2, 4096


def resident_inputs(dev, ub, seed=SEED + 5):
    """``resident_verok`` operands at T = 1024, R = 2 and ``ub`` pack
    rows over a full 64 MB table: every quarter of the pack rows is one
    lane kind — hit (slot >= 0), miss (host lane from the state read),
    overlay (host lane with an in-flight value) and deleted (a slot
    whose row says absent) — and the 2048 reads pick rows at random,
    most of them expecting the committed row, some stale or
    presence-flipped, a few padding.  → (operands, reads per kind)."""
    rng = np.random.default_rng(seed)
    table = np.zeros((TABLE_SLOTS, 3), np.int32)
    table[:, 0] = 1
    table[:, 1:] = rng.integers(1, 1 << 20, (TABLE_SLOTS, 2))
    kind = np.repeat(np.arange(4), ub // 4)
    rng.shuffle(kind)
    u_pack = np.zeros((ub, 4), np.int32)
    slots = rng.choice(TABLE_SLOTS, ub, replace=False)
    u_pack[:, 0] = np.where((kind == 0) | (kind == 3), slots, -1)
    table[slots[kind == 3], 0] = 0  # deleted: cached absence
    table[slots[kind == 3], 1:] = 0
    u_pack[:, 1] = rng.random(ub) < 0.8
    u_pack[:, 2:] = rng.integers(1, 1 << 20, (ub, 2))
    sp = np.full((RES_T, RES_R + 2 + 2), -1, np.int32)
    sp[:, :RES_R] = rng.integers(0, ub, (RES_T, RES_R))
    sp[rng.random(RES_T) < 0.05, 1] = -1  # padding reads
    ids = sp[:, :RES_R].clip(0)
    slot = u_pack[ids, 0]
    rpv = np.where((slot >= 0)[..., None], table[slot.clip(0)], u_pack[ids, 1:]).astype(np.int32)
    rpv[rng.random((RES_T, RES_R)) < 0.05, 0] ^= 1
    rpv[rng.random((RES_T, RES_R)) < 0.05, 2] += 1
    live = sp[:, :RES_R] >= 0
    per_kind = {k: int((kind[ids] == i)[live].sum())
                for i, k in enumerate(("hit", "miss", "overlay", "deleted"))}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(sp), t(table), t(u_pack), t(rpv)), per_kind


def phase_resident_kernels(dev, path_ubs: Counter):
    """``path_ubs``: the pack sizes the resident path launched
    ``resident_verok`` with; each is checked, and the kernels line gives
    the time at the most frequent."""
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.peer import device_block as db
    from fabric_tpu_torch.state import residency

    path_ub = path_ubs.most_common(1)[0][0]
    rec = None
    for ub in sorted({RES_UB, *path_ubs}, reverse=True):
        (sp, table, u_pack, rpv), per_kind = resident_inputs(dev, ub)
        if min(per_kind.values()) < RES_T * RES_R // 10:
            raise AssertionError(f"resident lanes per kind below 10%: {per_kind}")
        lv = torch.zeros((RES_T, 3), dtype=torch.int32, device=dev)
        db.resident_ver_ok(sp, table, u_pack, rpv, RES_R, lv)
        want = db.resident_ver_ok_ref(sp, table, u_pack, rpv, RES_R)
        torch.cuda.synchronize()
        got = lv[:, 2] != 0
        mism = int((got != want).sum())
        err = int((got.int() - want.int()).abs().max())
        if mism:
            raise AssertionError(f"resident_verok at Ub = {ub}: {mism} transactions differ "
                                 "from the plain version")
        ms = cuda_ms(lambda: kernels.resident_verok(sp, RES_R, table, u_pack, rpv, lv), 50)
        plain_ms = cuda_ms(lambda: db.resident_ver_ok_ref(sp, table, u_pack, rpv, RES_R), 10)
        # bytes this run's data needs: the read-key columns, the pack rows and
        # table rows the reads reach, the expected rows, the verdict column
        ids = sp[:, :RES_R][sp[:, :RES_R] >= 0].unique()
        hit_slots = u_pack[ids.long(), 0]
        n_rows = int(hit_slots[hit_slots >= 0].unique().numel())
        b_ms, b_by = bound(RES_T * RES_R * 4 + ids.numel() * 16 + n_rows * 12 + nbytes(rpv)
                           + RES_T * 4, 0)
        log("resident_verok", T=RES_T, R=RES_R, Ub=ub, path_launches=path_ubs[ub],
            table_slots=TABLE_SLOTS, table_mib=nbytes(table) / 2 ** 20,
            reads_per_kind=per_kind, mismatches=mism, valid=int(got.sum()), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms)
        if ub == path_ub:
            rec = {"name": "resident_verok", "route": "cuda",
                   "source": "fabric_tpu_torch/kernels/csrc/resident.cu",
                   "replaces": "fabric_tpu/peer/device_block.py:87", "max_abs_err": err,
                   "mismatches": mism, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": None}
    recs = [rec]

    rng = np.random.default_rng(SEED + 6)
    for k in (16, 2048):
        idx = rng.choice(TABLE_SLOTS, k, replace=False).astype(np.int32)
        rows = rng.integers(-(1 << 31), 1 << 31, (k, 3)).astype(np.int32)
        it, rt = torch.from_numpy(idx).to(dev), torch.from_numpy(rows).to(dev)
        a, b = table.clone(), table.clone()
        residency.table_scatter(a, idx, rows)
        residency.table_scatter_ref(b, it, rt)
        torch.cuda.synchronize()
        smism = int((a != b).any(dim=1).sum())
        serr = int((a.long() - b.long()).abs().max())
        if smism:
            raise AssertionError(f"table_scatter at k = {k}: {smism} rows differ")
        ilong = it.long()
        # both are host launch paths at these sizes, and the host is shared:
        # kernel and yardstick in 8 turns of 100 calls, ABBA ABBA, medians
        turns = {"kernel": [], "index_copy_": []}
        for side in ("kernel", "index_copy_", "index_copy_", "kernel") * 2:
            fn = ((lambda: kernels.table_scatter(a, it, rt)) if side == "kernel"
                  else (lambda: b.index_copy_(0, ilong, rt)))
            turns[side].append(cuda_ms(fn, 100))
        ms, lib_ms = (float(np.median(turns[k])) for k in ("kernel", "index_copy_"))
        plain_ms = cuda_ms(lambda: residency.table_scatter_ref(b, it, rt), 50)
        # the wrapper's host cost: wall time over 1,000 calls, then one synchronize
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            kernels.table_scatter(a, it, rt)
        torch.cuda.synchronize()
        host_us = (time.perf_counter() - t0) * 1e3
        b_ms, b_by = bound(k * (4 + 12) + k * 12, 0)
        log("table_scatter", k=k, mismatches=smism, ms=ms, ms_turns=turns["kernel"],
            plain_ms=plain_ms, index_copy_ms=lib_ms, index_copy_turns=turns["index_copy_"],
            host_us_per_call=host_us, bound_ms=b_ms)
    # the main path scatters a block's ~2,000-key write set: k = 2048
    recs.append({"name": "table_scatter", "route": "cuda",
                 "source": "fabric_tpu_torch/kernels/csrc/resident.cu",
                 "replaces": "fabric_tpu/state/residency.py:410", "max_abs_err": serr,
                 "mismatches": smism, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms})
    return recs


# ---------------------------------------------------------------------------
# Phase 7: the commit path with device-resident state


WORLD_KEYS = 1_000_000
RES_BLOCKS = 4
CHURN_SLOTS = 4096


class World:
    """A world state of WORLD_KEYS keys: the blocks' own keys plus
    filler, as one update batch that seeds a fresh state per run."""

    def __init__(self, seed_rows):
        from fabric_tpu_torch.ledger.statedb import UpdateBatch

        self.batch = UpdateBatch()
        for ns, key, value, ver in seed_rows:
            self.batch.put(ns, key, value, ver)
        i = 0
        while len(self.batch.updates) < WORLD_KEYS:
            self.batch.put(CC, f"fill{i:07d}", b"genesis", (1, i % 1000))
            i += 1

    def items(self):
        return ((ns, key, vv.version) for (ns, key), vv in self.batch.items())

    def validator(self, **kw):
        from fabric_tpu_torch import carry
        from fabric_tpu_torch.ledger.statedb import MemVersionedDB
        from fabric_tpu_torch.peer.validator import BlockValidator

        state = MemVersionedDB()
        state.apply_updates(self.batch)
        _, prov, _ = carry.from_reference([], NAMESPACES, [])
        return BlockValidator(prov, state, device="cuda", **kw)


def _same_runs(name, a_runs, b_runs, a_state, b_state):
    rows = lambda x: sorted((k, vv.value, vv.version) for k, vv in x.batch.items())
    for a, b in zip(a_runs, b_runs):
        if a.tx_filter != b.tx_filter or rows(a) != rows(b) or a.history != b.history:
            raise AssertionError(f"{name}: block {a.block.number} differs from the "
                                 "non-resident run")
    if a_state._data != b_state._data:
        raise AssertionError(f"{name}: final state differs from the non-resident run")


def _check_filters(name, res, expected):
    got = [r.tx_filter for r in res]
    if got != expected:
        raise AssertionError(f"{name}: filters differ from construction")


def phase_resident_path(net: Net):
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.state import ResidencyManager

    t0 = time.perf_counter()
    hot, hot_want, hot_rows = build_blocks(net, RES_BLOCKS, unsafe=False,
                                           ro_key=lambda b, i: f"ro{i:05d}")
    churn, churn_want, churn_rows = build_blocks(
        net, RES_BLOCKS, unsafe=False, ro_key=lambda b, i: f"rc{(i + 500 * b) % 4000:05d}")
    world = World(hot_rows + churn_rows)
    log("world", keys=len(world.batch.updates), seconds=time.perf_counter() - t0)

    def timed(blocks, v, depth):
        """One timed run; the host stages that differ between the two
        paths are timed on their own threads: the host read of the
        committed versions, the resident launch (lookup, miss read, the
        ``resident_verok`` enqueue, admissions) and the commit scatter."""
        spent = {}
        for name in ("_committed_versions", "_resident_launch_vec", "resident_commit"):
            def wrap(fn, name=name):
                def inner(*a, **kw):
                    t = time.perf_counter()
                    try:
                        return fn(*a, **kw)
                    finally:
                        spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
                return inner
            setattr(v, name, wrap(getattr(v, name)))
        gc.collect()  # the 1M-key world's garbage, collected outside the timed run
        out = run_validator(blocks, v, depth=depth)
        v.stage_ms_per_block = {k: 1e3 * t / len(blocks) for k, t in spent.items()}
        return out

    host_v = world.validator()
    host, host_s, _ = timed(hot, host_v, 2)
    _check_filters("host path", host, hot_want)
    log("host_path_hot", depth=2, blocks=len(hot), seconds=host_s,
        per_block_ms=1e3 * host_s / len(hot), stage_ms_per_block=host_v.stage_ms_per_block)
    counts = None
    ubs = Counter()
    for depth in (2, 3):
        v = world.validator(state_resident=True)
        t1 = time.perf_counter()
        warmed = v.resident.warm(world.items())
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t1
        kernels.reset_counts()
        with launch_shapes("resident_verok", lambda sp, R, table, u_pack, *_: u_pack.shape[0]
                           ) as seen:
            res, secs, marks = timed(hot, v, depth)
        c = dict(kernels.launches)
        ubs += seen
        st = v.resident.stats()
        _check_filters(f"resident depth {depth}", res, hot_want)
        _same_runs(f"resident depth {depth}", res, host, v.state, host_v.state)
        if c["resident_verok"] != len(hot):
            raise AssertionError(f"resident_verok launched {c['resident_verok']} times "
                                 f"for {len(hot)} blocks")
        if st["hit_rate"] is None or st["hit_rate"] < 0.99 or st["evictions_total"]:
            raise AssertionError(f"resident table after warm: {st}")
        zero = [k for k in RESIDENT_KERNELS if c[k] == 0]
        if zero:
            raise AssertionError(f"kernels not launched on the resident path: {zero}")
        log("resident_path", depth=depth, blocks=len(hot), warmed=warmed, warm_seconds=warm_s,
            seconds=secs, per_block_ms=1e3 * secs / len(hot), completion_s=marks,
            stage_ms_per_block=v.stage_ms_per_block, launches=c, pack_rows=dict(seen),
            stats=st, equal_to_host_path=True)
        if depth == 2:
            counts = c
            busy_v = world.validator(state_resident=True)
            busy_v.resident.warm(world.items())
    host3_v = world.validator()
    host3, host3_s, _ = timed(hot, host3_v, 3)
    _check_filters("host path, depth 3", host3, hot_want)
    log("host_path_hot", depth=3, blocks=len(hot), seconds=host3_s,
        per_block_ms=1e3 * host3_s / len(hot), stage_ms_per_block=host3_v.stage_ms_per_block)
    for name, v in (("resident", busy_v), ("host", world.validator())):
        gc.collect()
        busy_ms, psecs, n_ev, _ = device_busy(hot, validator=v)
        ok = busy_ms is not None
        log("device_busy_hot", path=name, profiled_seconds=psecs, device_events=n_ev,
            busy_ms_per_block=busy_ms / len(hot) if ok else None,
            idle_share_profiled=1 - busy_ms / (1e3 * psecs) if ok else None)

    # churn: a 4,096-slot table under read keys that shift every block
    host_v = world.validator()
    host, _, _ = timed(churn, host_v, 2)
    v = world.validator(state_resident=True)
    v.resident = ResidencyManager(slots=CHURN_SLOTS, device="cuda")
    res, secs, _ = timed(churn, v, 2)
    st = v.resident.stats()
    _check_filters("churn", res, churn_want)
    _same_runs("churn", res, host, v.state, host_v.state)
    if not st["evictions_total"]:
        raise AssertionError(f"the churn table never evicted: {st}")
    log("resident_churn", blocks=len(churn), slots=CHURN_SLOTS, seconds=secs, stats=st,
        equal_to_host_path=True)
    return counts, ubs


# ---------------------------------------------------------------------------
# Phase 8: the sign lane


SIGN_CLIENTS, SIGN_DIGESTS = 8, 500
SIGN_LANES = (4096, 256)  # the last is the batcher's default batch_max


def sign_scalars(n, rng):
    """``n`` nonces: the edge scalars first when ``n`` holds them all,
    then random ones (as RFC 6979 gives the sign lane)."""
    from fabric_tpu_torch.crypto import ec_ref

    N = ec_ref.N
    ks = [1, 2, N - 1, N - 2, 15, 16, 16 ** 63, 0xF << 128, (1 << 255) | 1, N >> 1]
    ks += [16 ** j for j in range(1, 63, 7)]
    ks = ks if n >= len(ks) else []
    return ks + [int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
                 for _ in range(n - len(ks))]


def phase_sign(net: Net, dev):
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.ops import p256sign, p256v3
    from fabric_tpu_torch.peer import signlane

    ec = net.ec
    rng = np.random.default_rng(SEED + 7)
    d = net.keys[1].d

    # the sign lane: 8 clients through SignBatcher(device_sign_backend(...))
    msgs = [b"proposal-%d" % i for i in range(SIGN_DIGESTS)]
    got, errors = {}, []
    batcher = signlane.SignBatcher(signlane.device_sign_backend(d))
    p256sign.sign_digests([1], d, device=dev)  # the comb table, before the clock starts
    kernels.reset_counts()

    def client(part):
        try:
            for m in part:
                got[m] = batcher.sign(m)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(msgs[i::SIGN_CLIENTS],))
               for i in range(SIGN_CLIENTS)]
    with launch_shapes("p256_sign", lambda limbs, *_: limbs.shape[0]) as lane_shapes:
        with batcher:
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            secs = time.perf_counter() - t0
            st = batcher.stats()
    counts = dict(kernels.launches)
    if errors or len(got) != SIGN_DIGESTS:
        raise AssertionError(f"sign lane: {len(got)} of {SIGN_DIGESTS} signed, errors {errors[:3]}")
    serial = signlane.cpu_sign_backend(d)
    bad = sum(got[m] != ec.der_encode_sig(*serial([ec.digest_int(m)])[0]) for m in msgs)
    if bad:
        raise AssertionError(f"sign lane: {bad} signatures differ from cpu_sign_backend")
    if counts["p256_sign"] == 0:
        raise AssertionError("p256_sign not launched on the sign lane")
    log("sign_lane", clients=SIGN_CLIENTS, digests=SIGN_DIGESTS, seconds=secs,
        signatures_per_s=SIGN_DIGESTS / secs, batches=st["batches_total"],
        occupancy=st["occupancy"], wait_ms=st["wait_ms"], launches=counts,
        lanes=dict(lane_shapes), equal_to_cpu_backend=True)

    # the kernel against its plain version at every bucket the lane
    # launched and at the batcher's largest; the kernels line gives the
    # lane's most frequent bucket
    lane_bucket = lane_shapes.most_common(1)[0][0]
    rec = None
    for lanes in sorted({*SIGN_LANES, *lane_shapes}, reverse=True):
        ks = sign_scalars(lanes, rng)
        limbs = torch.from_numpy(p256v3._limbs16(ks)).to(dev)
        out = p256sign.sign_batch_limbs(limbs)
        want = p256sign.sign_batch_ref(limbs)
        torch.cuda.synchronize()
        mism = int((out != want).any(dim=2).any(dim=1).sum())
        err = int((out.long() - want.long()).abs().max())
        if mism:
            raise AssertionError(f"p256_sign at {lanes} lanes: {mism} lanes differ")
        xz = out.cpu().numpy().view(np.uint32)
        sample = rng.choice(lanes, 256, replace=False) if lanes > 256 else np.arange(lanes)
        xs, zs = p256sign._to_ints(xz[sample, 0]), p256sign._to_ints(xz[sample, 1])
        oracle_mism = sum(X * pow(Z, -1, ec.P) % ec.P != ec.pt_mul(ks[i], ec.G)[0]
                          for i, X, Z in zip(sample.tolist(), xs, zs))
        if oracle_mism:
            raise AssertionError(f"p256_sign: {oracle_mism} sampled lanes differ from ec_ref")
        chains = p256sign.sign_chains(lanes)
        ms = cuda_ms(lambda: kernels.p256_sign(limbs, *p256sign._kernel_tables(dev), chains), 20)
        plain_ms = cuda_ms(lambda: p256sign.sign_batch_ref(limbs), 2)
        # 13 Montgomery products per nonzero digit: the reference's 128
        # multiply-adds each, or, as the work needed, 64 wide products
        # (none for P-256's reduction); neither counts the chains' combine
        nonzero = int((p256v3.recode_windows(limbs) != 0).sum())
        moved = nbytes(limbs, out) + 64 + 64 * 16 * 64
        b_ms, b_by = bound(moved, nonzero * 13 * 128 * 2)
        b_need_ms, _ = bound(moved, nonzero * 13 * 64 * 2)
        log("sign_kernel", lanes=lanes, lane_launches=lane_shapes[lanes], mismatches=mism,
            oracle_lanes=len(sample), oracle_mismatches=oracle_mism, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_needed_ms=b_need_ms,
            tpi=kernels.p256_sign_tpi(lanes), chains=chains)
        if lanes == lane_bucket:
            rec = {"name": "p256_sign", "route": "cuda",
                   "source": "fabric_tpu_torch/kernels/csrc/p256_sign.cu",
                   "replaces": "fabric_tpu/ops/p256sign.py:129", "max_abs_err": err,
                   "mismatches": mism, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": None,
                   "launches": counts["p256_sign"]}

    # whole signatures, edge nonces, and the round trip through p256_verify
    digests = [int.from_bytes(rng.bytes(32), "big") for _ in range(256)]
    fixed = sign_scalars(256, rng)
    sigs = p256sign.sign_digests(digests, d, ks=fixed, device=dev)
    if sigs != [ec.SigningKey(d).sign_digest(e, k=k) for e, k in zip(digests, fixed)]:
        raise AssertionError("p256_sign: fixed-nonce signatures differ from ec_ref")
    qx, qy = ec.SigningKey(d).public
    ok = p256v3.verify_launch([(e, r, s, qx, qy) for e, (r, s) in zip(digests, sigs)],
                              device=dev).fetch()
    if not all(ok):
        raise AssertionError("signatures from the card rejected by p256_verify")
    log("sign_roundtrip", lanes=len(sigs), edge_nonces=True, verified=sum(ok))
    return rec


# ---------------------------------------------------------------------------
# Phase 8: real wire-format blocks on the commit path


WIRE_KINDS = ("bad_creator_sig", "stale_read", "nil_envelope", "truncated_payload",
              "unbound_txid", "duplicate_txid", "expired_creator", "unknown_ca_creator",
              "outside_endorser")
WIRE_NOW = 1_790_000_000  # the certificates' "now": valid from a day before, ten years on


def card_signer(digests, keys):
    """The builder's batch signer on the card (``ops/p256sign.sign_digests``)."""
    from fabric_tpu_torch.ops import p256sign

    return p256sign.sign_digests(digests, keys, device="cuda")


class WireNet:
    """3 policy orgs, an Org4 outside the policy, an Org1 client, an
    expired Org1 client and an 'Org1MSP' client from an unknown CA; every
    certificate signed on the card."""

    def __init__(self, seed: int, sign_batch=card_signer):
        from fabric_tpu_torch.crypto import cryptogen, msp

        rng = np.random.default_rng(seed)
        self.orgs = [cryptogen.generate_org(f"Org{i}MSP", f"org{i}.smoke.example.com", rng,
                                            now=WIRE_NOW, sign_batch=sign_batch)
                     for i in (1, 2, 3, 4)]
        rogue = cryptogen.generate_org("Org1MSP", "rogue.smoke.example.com", rng,
                                       now=WIRE_NOW, sign_batch=sign_batch)
        d, pem = self.orgs[0].ca.issue("old@org1.smoke.example.com", "client",
                                       not_before=WIRE_NOW - 20 * 86400,
                                       not_after=WIRE_NOW - 86400, sign_batch=sign_batch)
        self.msp = msp.MSPManager({o.msp_id: o.msp() for o in self.orgs})
        self.client = self.orgs[0].users["User1@org1.smoke.example.com"]
        self.peers = [o.nodes[f"peer0.org{i}.smoke.example.com"]
                      for i, o in zip((1, 2, 3, 4), self.orgs)]
        self.expired = cryptogen.SigningIdentity("Org1MSP", d, pem)
        self.rogue = rogue.users["User1@rogue.smoke.example.com"]


def build_wire_blocks(wn: WireNet, n_blocks: int = N_BLOCKS, n_tx: int = BLOCK_TXS,
                      sign_batch=None, chained: bool = False):
    """Bench-shaped wire blocks (rotating endorser pairs, 2 reads and 2
    writes per tx), every 20th tx invalid in one of WIRE_KINDS in turn,
    all signatures from one batched build → (Blocks, expected filters,
    seed rows, (digests, keys, signatures) of the build's first batch).
    ``chained``: numbered from 0, each previous_hash the header hash of
    the block before, as a block store takes them."""
    from fabric_tpu_torch import protoutil
    from fabric_tpu_torch.ledger.rwset import TxRWSet
    from fabric_tpu_torch.peer import txassembly as txa
    from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
    from fabric_tpu_torch.protos import messages as m

    want_code = {"bad_creator_sig": C.BAD_CREATOR_SIGNATURE,
                 "stale_read": C.MVCC_READ_CONFLICT, "nil_envelope": C.NIL_ENVELOPE,
                 "truncated_payload": C.BAD_PAYLOAD, "unbound_txid": C.BAD_PROPOSAL_TXID,
                 "duplicate_txid": C.DUPLICATE_TXID,
                 "expired_creator": C.BAD_CREATOR_SIGNATURE,
                 "unknown_ca_creator": C.BAD_CREATOR_SIGNATURE,
                 "outside_endorser": C.ENDORSEMENT_POLICY_FAILURE}
    specs, kinds, seed_rows = [], [], []
    for b in range(n_blocks):
        for i in range(n_tx):
            kind = WIRE_KINDS[(b * n_tx + i) // 20 % len(WIRE_KINDS)] if i % 20 == 10 else None
            seed_rows += [(CC, f"seed{b}_{i:05d}", b"genesis", (1, 0)),
                          (CC, f"ro{b}_{i:05d}", b"genesis", (1, 0))]
            rw = TxRWSet()
            ns = rw.ns_rwset(CC)
            ns.reads[f"seed{b}_{i:05d}"] = (9, 9) if kind == "stale_read" else (1, 0)
            ns.reads[f"ro{b}_{i:05d}"] = (1, 0)
            ns.writes[f"w{b}_{i:05d}"] = b"value-%d" % i
            ns.writes[f"seed{b}_{i:05d}"] = b"updated"
            creator = {"expired_creator": wn.expired,
                       "unknown_ca_creator": wn.rogue}.get(kind, wn.client)
            ends = ([wn.peers[i % 3], wn.peers[3]] if kind == "outside_endorser"
                    else [wn.peers[i % 3], wn.peers[(i + 1) % 3]])
            specs.append(txa.TxSpec(creator, ends, rw.to_bytes(), CC, channel_id="smokechan"))
            kinds.append(kind)
    seen = []

    def recording(digests, keys):
        out = (sign_batch or card_signer)(digests, keys)
        if not seen:
            seen.append((digests, keys, out))
        return out

    envs = txa.build_envelopes(specs, recording)
    blocks, expected = [], []
    for b in range(n_blocks):
        part, want = envs[b * n_tx:(b + 1) * n_tx], []
        for i, kind in enumerate(kinds[b * n_tx:(b + 1) * n_tx]):
            if kind == "bad_creator_sig":
                env = m.Envelope.parse(part[i])  # the previous tx's signature: valid DER
                env.signature = m.Envelope.parse(part[i - 1]).signature
                part[i] = env.serialize()
            elif kind == "unbound_txid":  # a tx id that is not sha256(nonce ‖ creator)
                env = m.Envelope.parse(part[i])
                payload = m.Payload.parse(env.payload)
                ch = m.ChannelHeader.parse(payload.header.channel_header)
                ch.tx_id = "0" * 64
                payload.header.channel_header = ch.serialize()
                env.payload = payload.serialize()
                part[i] = env.serialize()
            elif kind == "nil_envelope":
                part[i] = b""
            elif kind == "truncated_payload":
                part[i] = part[i][:len(part[i]) // 2]
            elif kind == "duplicate_txid":
                part[i] = part[i - 1]
            want.append(int(want_code[kind]) if kind else int(C.VALID))
        if chained:
            prev = protoutil.block_header_hash(blocks[-1].header) if blocks else b""
            blocks.append(txa.build_block(b, prev, part))
        else:
            blocks.append(txa.build_block(2 + b, b"prev-%d" % b, part))
        expected.append(bytes(want))
    return blocks, expected, seed_rows, seen[0]


WIRE_NAMESPACES = {CC: NAMESPACES[CC]}
WIRE_BLOCKS = 9  # the first block reported apart, then 8


def phase_wire_path(dev):
    """Wire blocks built and signed on the card through CommitPipeline
    with the port's MSP → (launch counts, blocks)."""
    from fabric_tpu_torch import carry, kernels
    from fabric_tpu_torch.crypto import ec_ref
    from fabric_tpu_torch.peer import frontend
    from fabric_tpu_torch.peer.validator import BlockValidator
    from fabric_tpu_torch.protos import messages as m

    t0 = time.perf_counter()
    wn = WireNet(SEED + 9)
    blocks, expected, seed_rows, (digests, keys, sigs) = build_wire_blocks(wn, WIRE_BLOCKS)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 10)
    sample = rng.choice(len(digests), 64, replace=False).tolist()
    bad = sum(ec_ref.SigningKey(keys[j]).sign_digest(digests[j]) != tuple(sigs[j])
              for j in sample)
    if bad:
        raise AssertionError(f"wire path: {bad} of 64 card signatures differ from ec_ref")
    raw = [blk.serialize() for blk in blocks]
    n_tx = sum(len(b.data.data) for b in blocks)
    log("wire_build", blocks=len(blocks), txs=n_tx, signed_on_card=len(digests) + n_tx,
        seconds=build_s,
        block_bytes=[len(r) for r in raw], ec_ref_checked=len(sample))

    def validator():
        state, prov, _ = carry.from_reference(seed_rows, WIRE_NAMESPACES, [])
        return BlockValidator(prov, state, device=dev, msp=wn.msp)

    wire = [m.Block.parse(r) for r in raw]
    v = validator()
    kernels.reset_counts()
    # the first block alone (its set-up swamps a short run), then the rest
    first_t, rest_t = {}, {}
    res, first_s, _ = run_validator(wire[:1], v, depth=2, timings=first_t)
    rest, secs, marks = run_validator(wire[1:], v, depth=2, timings=rest_t)
    res += rest
    counts = dict(kernels.launches)
    got = [r.tx_filter for r in res]
    if got != expected:
        bad = [(b, i, g[i], w[i]) for b, (g, w) in enumerate(zip(got, expected))
               for i in range(len(w)) if g[i] != w[i]]
        raise AssertionError(f"wire path filters differ from construction at {bad[:10]}")
    zero = [k for k in ("p256_verify", "stage2_policy", "stage2_mvcc") if counts[k] == 0]
    if zero:
        raise AssertionError(f"kernels not launched on the wire path: {zero}")
    decode_ms, decoded = [], []
    for blk in wire:
        t1 = time.perf_counter()
        decoded.append(frontend.decode_block(blk, wn.msp))
        decode_ms.append(1e3 * (time.perf_counter() - t1))
    res2, _, _ = run_validator(decoded, validator(), depth=2)
    for a, b in zip(res, res2):
        rows = lambda x: sorted((k, vv.value, vv.version) for k, vv in x.batch.items())
        if a.tx_filter != b.tx_filter or rows(a) != rows(b) or a.history != b.history:
            raise AssertionError(f"block {a.block.number}: the wire entry differs from "
                                 "the DecodedBlock entry")
    codes = Counter(c for f in got for c in f)
    front_end = [r.pend.block.n_front_end for r in res]
    rwset_parsed = [r.pend.block.n_rwset_parsed for r in res]
    k = len(wire) - 1
    phase_ms = {key: 1e3 * t / k for key, t in sorted(rest_t.items())}
    log("wire_path", blocks=len(wire), txs=n_tx, depth=2, first_block_ms=1e3 * first_s,
        first_block_phase_ms={key: 1e3 * t for key, t in sorted(first_t.items())},
        after_first_blocks=k, seconds=secs, per_block_ms=1e3 * secs / k,
        tx_per_s=(n_tx - len(wire[0].data.data)) / secs, completion_s=marks,
        phase_ms_per_block=phase_ms,
        phases_sum_ms_per_block=sum(phase_ms.values()),
        host_parse_ms_per_block=phase_ms.get("host_parse"),
        decode_ms_per_block_after_first=sum(decode_ms[1:]) / k,
        decode_ms_per_block=decode_ms, front_end_envelopes=front_end,
        rwset_parsed_txs=rwset_parsed, codes={int(c): n for c, n in sorted(codes.items())},
        equal_to_construction=True, equal_to_decoded_entry=True, launches=counts)
    busy_ms, psecs, n_ev, names = device_busy(wire, validator=validator())
    ok = busy_ms is not None
    log("device_busy_wire", profiled_seconds=psecs, device_events=n_ev, by_name=names,
        busy_ms_per_block=busy_ms / len(wire) if ok else None,
        idle_share_profiled=1 - busy_ms / (1e3 * psecs) if ok else None)
    return {"wire": wire, "msp": wn.msp, "expected": expected, "seed_rows": seed_rows,
            "res": res, "per_block_ms": 1e3 * secs / k,
            "tx_per_s": (n_tx - len(wire[0].data.data)) / secs}


COALESCE = 4  # blocks a group on the coalesced path


def phase_coalesced_path(dev, wired):
    """The wire path's blocks through ``CommitPipeline(coalesce_blocks=4)``
    (``submit_many``: one ``preprocess_many``, so one ``p256_verify``
    launch, a group), with a staging pool of one worker a core and
    without: the first block (a group of one) apart, then the others in
    groups of 4; filters, update batches and history equal to
    the construction's and the single-block wire path's, block by
    block; then the pooled run's busy time under the profiler."""
    from fabric_tpu_torch import carry, kernels
    from fabric_tpu_torch.ops.p256v3 import _bucket as bucket
    from fabric_tpu_torch.peer.validator import BlockValidator

    wire, single = wired["wire"], wired["res"]

    def validator(workers):
        state, prov, _ = carry.from_reference(wired["seed_rows"], WIRE_NAMESPACES, [])
        return BlockValidator(prov, state, device=dev, msp=wired["msp"],
                              host_stage_workers=workers)

    rows = lambda x: sorted((k, vv.value, vv.version) for k, vv in x.batch.items())
    n_tx = sum(len(b.data.data) for b in wire[1:])
    for workers in (-1, 0):
        v = validator(workers)
        try:
            kernels.reset_counts()
            first_t, rest_t = {}, {}
            with launch_shapes("p256_verify", lambda frame, *a, **kw: frame.shape[0]) as lanes:
                res, first_s, _ = run_validator(wire[:1], v, timings=first_t,
                                                coalesce=COALESCE)
                rest, secs, _ = run_validator(wire[1:], v, timings=rest_t, coalesce=COALESCE)
            counts = dict(kernels.launches)
            res += rest
            if [r.tx_filter for r in res] != wired["expected"]:
                raise AssertionError(f"coalesced path (workers {workers}): filters differ "
                                     "from construction")
            for a, b in zip(res, single, strict=True):
                if a.tx_filter != b.tx_filter or rows(a) != rows(b) or a.history != b.history:
                    raise AssertionError(f"coalesced path (workers {workers}): block "
                                         f"{a.block.number} differs from the wire path")
            bk = [bucket(len(r.pend.items)) for r in res]
            want = Counter([bk[0]] + [bucket(sum(bk[g:g + COALESCE]))
                                      for g in range(1, len(bk), COALESCE)])
            if counts["p256_verify"] != sum(want.values()) or lanes != want:
                raise AssertionError(f"coalesced path: p256_verify launches {lanes}, "
                                     f"want {dict(want)}")
            zero = [k for k in ("stage2_policy", "stage2_mvcc") if counts[k] == 0]
            if zero:
                raise AssertionError(f"kernels not launched on the coalesced path: {zero}")
            k = len(wire) - 1
            phase_ms = {key: 1e3 * t / k for key, t in sorted(rest_t.items())}
            log("coalesced_path", host_stage_workers=workers, cpu_count=os.cpu_count(),
                pool_workers=v.host_pool.workers if v.host_pool else 0,
                pool_stats=v.host_pool.stats() if v.host_pool else None,
                blocks=len(wire), coalesce_blocks=COALESCE, first_block_ms=1e3 * first_s,
                first_block_phase_ms={key: 1e3 * t for key, t in sorted(first_t.items())},
                after_first_blocks=k, seconds=secs, per_block_ms=1e3 * secs / k,
                tx_per_s=n_tx / secs, wire_path_per_block_ms=wired["per_block_ms"],
                wire_path_tx_per_s=wired["tx_per_s"], phase_ms_per_block=phase_ms,
                p256_verify_lanes={int(n): c for n, c in sorted(lanes.items())},
                equal_to_construction=True, equal_to_wire_path=True, launches=counts)
        finally:
            v.close()
    v = validator(-1)
    try:
        busy_ms, psecs, n_ev, names = device_busy(wire, validator=v, coalesce=COALESCE)
    finally:
        v.close()
    ok = busy_ms is not None
    log("device_busy_coalesced", profiled_seconds=psecs, device_events=n_ev, by_name=names,
        busy_ms_per_block=busy_ms / len(wire) if ok else None,
        idle_share_profiled=1 - busy_ms / (1e3 * psecs) if ok else None)


# ---------------------------------------------------------------------------
# Phase 8c: the traffic autopilot and the flight recorder on the card


# (a) the peer's knobs: cool=0, and "up" bands that every reading crosses,
# so each knob takes its ladder's steps on the first ticks it reads a
# signal (one step a tick, in the controller's priority order)
AP_PEER_KNOBS = ("coalesce_blocks", "verify_chunk", "pipeline_depth", "host_stage_workers")
AP_PEER_SPEC = ("coalesce_blocks:min=0:max=2:cool=0;verify_chunk:min=512:max=1024:cool=0;"
                "pipeline_depth:min=2:max=3:cool=0;host_stage_workers:min=0:max=2:cool=0")
AP_PEER_BANDS = {"queue_hi_ms": -1.0, "launch_hi_ms": -1.0, "devq_hi_ms": -1.0,
                 "coverage_lo": -2.0, "coverage_hi": -1.0, "prefetch_hi_ms": -1.0}
AP_PASSES = 3  # at most; each into fresh state, until every knob has moved
# (b) the sign lane: 8 client threads, 8 requests in flight each; the
# lane lingers 8 ms at first, so that a flush fills past 16 lanes
AP_SIGN_SPEC = "sign_batch_max:min=16:max=64:cool=0;sign_batch_wait_ms:min=2:max=8:cool=0"
AP_SIGN_BANDS = {"sign_busy_hi": -1.0, "sign_wait_hi_ms": -1.0}
AP_SIGN_CLIENTS, AP_SIGN_INFLIGHT, AP_SIGN_ROUNDS, AP_SIGN_PER_ROUND = 8, 8, 5, 256
AP_SIGN_WAIT_MS = 8.0
# (c) the sidecar: one tenant floods, one submits serially; an objective
# that the flood's queued requests break, and a 2 s window it ages out of
AP_SIDECAR_SLO = "lat:latency:ms=15:target=0.9:windows=2:min_events=3:fast=0"
AP_SIDECAR_SPEC = "verify_chunk:min=1024:max=1024:cool=0;weight:cool=0;shed:cool=0"
AP_SIDECAR_BANDS = {"launch_hi_ms": -1.0, "devq_hi_ms": -1.0, "shed_hi": 2.0, "shed_lo": 1.0}
AP_FLOOD_REQS, AP_FLOOD_CAP, AP_FLOOD_INFLIGHT, AP_CALM_REQS = 48, 400, 8, 6
AP_SIDECAR_WAIT_S = 60.0
# (d) the flight recorder
AP_VITALS_S = 0.2


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _ap_specs(spec: str, names) -> dict:
    """Only the named knobs of a parsed spec: the others' rules never
    read a signal here, so they take no tick."""
    from fabric_tpu_torch.control import parse_knob_specs

    ks = parse_knob_specs(spec)
    return {k: ks[k] for k in names}


class _Backlog:
    """The scheduler-shaped source of the peer pass: the blocks the feed
    still holds, and the age of the oldest (``queue_age_ms``), as a
    deliver backlog."""

    def __init__(self):
        self.waiting, self.t0 = 0, time.perf_counter()

    def stats(self) -> dict:
        age = 1e3 * (time.perf_counter() - self.t0)
        n = self.waiting
        return {"deliver": {"depth": n, "share": 1.0, "busy_rate": 0.0,
                            "queue_age_ms": {"n": n, "p99": age if n else 0.0}}}


def _verify_capture():
    """Wrap ``kernels.p256_verify``: the launches by lane count, and the
    first frame and output at each (cloned on the stream)."""
    from fabric_tpu_torch import kernels

    seen, first, fn, lock = Counter(), {}, kernels.p256_verify, threading.Lock()

    def wrapped(frame, consts, out=None):
        res = fn(frame, consts) if out is None else fn(frame, consts, out=out)
        n = int(frame.shape[0])
        with lock:
            seen[n] += 1
            if n not in first:
                first[n] = (frame.clone(), res.clone())
        return res

    return wrapped, seen, first


@contextlib.contextmanager
def _captured_verify():
    from fabric_tpu_torch import kernels

    wrapped, seen, first = _verify_capture()
    fn = kernels.p256_verify
    kernels.p256_verify = wrapped
    try:
        yield seen, first
    finally:
        kernels.p256_verify = fn


def _expected_launches(n: int, chunk: int) -> int:
    from fabric_tpu_torch.ops import p256v3

    return len(p256v3._chunk_bounds(n, chunk)) if chunk and n > chunk else 1


def _ap_peer(dev, wired, ap_log, check_launches=True):
    """(a) The wire blocks through ``CommitPipeline`` over a
    ``BlockValidator``, the smoke ticking the autopilot with its real
    ``read_signals()`` after each submission; a pass into fresh state
    with the knob vector the last pass ended at, until every knob has
    moved (at most AP_PASSES)."""
    from fabric_tpu_torch import carry, kernels
    from fabric_tpu_torch.control import Autopilot
    from fabric_tpu_torch.ops import p256v3
    from fabric_tpu_torch.peer.pipeline import CommitPipeline
    from fabric_tpu_torch.peer.validator import BlockValidator

    wire, single = wired["wire"], {r.block.number: r for r in wired["res"]}
    n_sigs = [len(single[b.header.number].pend.items) for b in wire]
    rows = lambda x: sorted((k, vv.value, vv.version) for k, vv in x.batch.items())
    backlog = _Backlog()
    live = {}  # the pass's pipe and validator: apply_knob's targets

    def apply(knob, value):
        if knob == "coalesce_blocks":
            live["pipe"].set_coalesce_blocks(int(value))
        elif knob == "pipeline_depth":
            live["pipe"].set_depth(int(value))
        elif knob == "verify_chunk":
            live["v"].set_verify_chunk(int(value))
        elif knob == "host_stage_workers":
            live["v"].set_host_stage_workers(int(value))

    ap = Autopilot(_ap_specs(AP_PEER_SPEC, AP_PEER_KNOBS), apply, scheduler=backlog,
                   bands=AP_PEER_BANDS,
                   initial={"coalesce_blocks": 0, "verify_chunk": 0, "pipeline_depth": 2,
                            "host_stage_workers": 0})
    moved, passes, shapes, per_pass = set(), 0, Counter(), []
    with _captured_verify() as (seen, first):
        # a second pass runs at the vector the first ended at (the pool,
        # chunks and depth then in effect from the first block on)
        while passes < 2 or (passes < AP_PASSES and moved != set(AP_PEER_KNOBS)):
            passes += 1
            state, prov, _ = carry.from_reference(wired["seed_rows"], WIRE_NAMESPACES, [])
            vals = ap.values
            v = BlockValidator(prov, state, device=dev, msp=wired["msp"],
                               verify_chunk=vals["verify_chunk"],
                               host_stage_workers=vals["host_stage_workers"])
            v.blocks = TxidStore()

            def commit(res, v=v):
                v.state.apply_updates(res.batch)
                v.blocks.txids.update(t for t, _ in res.txids)

            pipe = CommitPipeline(v, commit, depth=vals["pipeline_depth"],
                                  coalesce_blocks=vals["coalesce_blocks"])
            live.update(pipe=pipe, v=v)
            out, subs, i = [], [], 0
            before = kernels.launches["p256_verify"]
            _sync(dev)
            t0 = time.perf_counter()
            backlog.t0, backlog.waiting = t0, len(wire)
            try:
                while i < len(wire):
                    k = max(1, ap.values["coalesce_blocks"])
                    group = wire[i:i + k]
                    chunk = ap.values["verify_chunk"]  # what this prefetch applies
                    if len(group) == 1:
                        want = _expected_launches(n_sigs[i], chunk)
                        r = pipe.submit(group[0])
                        out += [r] if r is not None else []
                    else:
                        grand = p256v3._bucket(sum(p256v3._bucket(n)
                                                   for n in n_sigs[i:i + k]))
                        want = _expected_launches(grand, chunk)
                        out += pipe.submit_many(group)
                    # the vector this submission ran under
                    subs.append({"blocks": [b.header.number for b in group],
                                 "chunk": v.verify_chunk, "depth": pipe.depth,
                                 "coalesce": pipe.coalesce_blocks,
                                 "pool": v.host_pool.workers if v.host_pool else 0,
                                 "p256_verify_want": want})
                    if v.verify_chunk != chunk:
                        raise AssertionError(f"autopilot_path (a): the validator ran chunk "
                                             f"{v.verify_chunk}, the autopilot set {chunk}")
                    i += len(group)
                    backlog.waiting = len(wire) - i
                    d = ap.tick(ap.read_signals())
                    if d is not None:
                        moved.add(d.knob)
                        ap_log.append({"pass": passes, "after_blocks": i, **d.to_dict()})
                r = pipe.flush()
                out += [r] if r is not None else []
                pipe.close()
            finally:
                v.close()
            _sync(dev)
            secs = time.perf_counter() - t0
            got = kernels.launches["p256_verify"] - before
            want = sum(s["p256_verify_want"] for s in subs)
            if check_launches and got != want:
                raise AssertionError(f"autopilot_path (a) pass {passes}: p256_verify launched "
                                     f"{got} times, the decisions imply {want}: {subs}")
            if [r.block.number for r in out] != [b.header.number for b in wire]:
                raise AssertionError(f"autopilot_path (a): blocks {[r.block.number for r in out]}")
            for r in out:
                s = single[r.block.number]
                if r.tx_filter != s.tx_filter or rows(r) != rows(s) or r.history != s.history:
                    raise AssertionError(f"autopilot_path (a) pass {passes}: block "
                                         f"{r.block.number} differs from the wire path")
            per_pass.append({"pass": passes, "seconds": secs, "submissions": subs,
                             "p256_verify": got})
    missing = set(AP_PEER_KNOBS) - moved
    if missing:
        raise AssertionError(f"autopilot_path (a): {sorted(missing)} never actuated in "
                             f"{passes} passes: {ap_log}")
    shapes.update(seen)
    return ap, per_pass, shapes, first


def _ap_sign(dev, ap_log):
    """(b) The sign lane under the sign knobs: 8 client threads, each
    with AP_SIGN_INFLIGHT requests in flight (a BUSY answer is retried
    after its hint), a tick after each round."""
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.control import Autopilot
    from fabric_tpu_torch.crypto import ec_ref
    from fabric_tpu_torch.ops import p256sign, p256v3
    from fabric_tpu_torch.peer import signlane

    rng = np.random.default_rng(SEED + 60)
    d = int.from_bytes(rng.bytes(32), "big") % (ec_ref.N - 1) + 1
    lane = signlane.SignBatcher(signlane.device_sign_backend(d, device=dev), batch_max=16,
                                wait_ms=AP_SIGN_WAIT_MS)

    def apply(knob, value):
        if knob == "sign_batch_max":
            lane.set_batch_max(int(value))
        elif knob == "sign_batch_wait_ms":
            lane.set_wait_ms(float(value))

    ap = Autopilot(_ap_specs(AP_SIGN_SPEC, ("sign_batch_max", "sign_batch_wait_ms")), apply,
                   sign_source=lane, bands=AP_SIGN_BANDS,
                   initial={"sign_batch_max": 16, "sign_batch_wait_ms": AP_SIGN_WAIT_MS})
    got, errors, busy = {}, [], Counter()

    def one(e):
        while True:
            try:
                got[e] = lane.sign_digest(e)
                return
            except signlane.SignBusy as b:
                busy["retries"] += 1
                time.sleep(b.retry_ms / 1000.0)

    def client(digests):
        try:
            with ThreadPoolExecutor(AP_SIGN_INFLIGHT) as ex:
                list(ex.map(one, digests))
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    p256sign.sign_digests([1], d, device=dev)  # the comb table, before the rounds
    moved, rounds = set(), []
    with launch_shapes("p256_sign", lambda limbs, *_: limbs.shape[0]) as buckets, \
            first_launches("p256_sign", lambda limbs, *a: limbs.shape[0]) as firsts, lane:
        for r in range(AP_SIGN_ROUNDS):
            digests = [int.from_bytes(rng.bytes(32), "big") for _ in range(AP_SIGN_PER_ROUND)]
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(digests[c::AP_SIGN_CLIENTS],))
                       for c in range(AP_SIGN_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            if errors:
                raise AssertionError(f"autopilot_path (b): {errors[:3]}")
            rounds.append({"round": r, "batch_max": lane.batch_max, "wait_ms": lane.wait_ms,
                           "seconds": time.perf_counter() - t0})
            dec = ap.tick(ap.read_signals())
            if dec is not None:
                moved.add(dec.knob)
                ap_log.append({"round": r, **dec.to_dict()})
        st = lane.stats()
    if moved != {"sign_batch_max", "sign_batch_wait_ms"}:
        raise AssertionError(f"autopilot_path (b): only {sorted(moved)} actuated")
    serial = signlane.cpu_sign_backend(d)
    keys = sorted(got)
    if [got[e] for e in keys] != serial(keys):
        raise AssertionError("autopilot_path (b): signatures differ from cpu_sign_backend")
    checked = {}
    for lanes, ((limbs, *_), out) in sorted(firsts.items()):
        want = p256sign.sign_batch_ref(limbs, chains=p256sign.sign_chains(lanes))
        torch.cuda.synchronize()
        mism = int((out != want).any(dim=2).any(dim=1).sum())
        if mism:
            raise AssertionError(f"autopilot_path (b): p256_sign at {lanes} lanes: {mism} "
                                 "lanes differ from its plain version")
        ms = cuda_ms(lambda: kernels.p256_sign(limbs, *p256sign._kernel_tables(dev),
                                               p256sign.sign_chains(lanes)), 10)
        # the bound of the work needed (64 wide products a Montgomery
        # product), the reference schedule's (128) beside it, as sign_kernel
        nonzero = int((p256v3.recode_windows(limbs) != 0).sum())
        moved = nbytes(limbs, out) + 64 + 64 * 16 * 64
        need_ms, need_by = bound(moved, nonzero * 13 * 64 * 2)
        sched_ms, _ = bound(moved, nonzero * 13 * 128 * 2)
        checked[lanes] = {"launches": buckets[lanes], "mismatches": mism, "ms": ms,
                          "bound_ms": need_ms, "bound_by": need_by,
                          "bound_schedule_ms": sched_ms}
    return {"rounds": rounds, "busy_retries": busy["retries"], "signed": len(got),
            "batches": st["batches_total"], "buckets": checked}


def _ap_sidecar(dev, wired, ap_log, check_launches=True):
    """(c) A ``SidecarServer`` with a sidecar-local autopilot over its
    scheduler and the global SLO engine: tenant "flood" keeps
    AP_FLOOD_INFLIGHT requests in flight, "calm" submits one at a time;
    the smoke ticks the controller every 50 ms until the flood was shed
    and unshed and both tenants are done."""
    from fabric_tpu_torch.control import Autopilot
    from fabric_tpu_torch.observe import slo
    from fabric_tpu_torch.ops import p256v3
    from fabric_tpu_torch.ops_metrics import global_registry
    from fabric_tpu_torch.sidecar.client import SidecarLink
    from fabric_tpu_torch.sidecar.server import SidecarServer
    from fabric_tpu_torch.utils.backoff import Backoff

    blocks = [list(r.pend.items) for r in wired["res"]]
    truth = [p256v3.verify_launch(b, device=dev).fetch() for b in blocks]
    shed_ctr = global_registry().counter("sidecar_shed_total")
    shed_before = shed_ctr.value(tenant="flood")
    engine = slo.configure(AP_SIDECAR_SLO)
    srv = SidecarServer("127.0.0.1", 0, device=dev, coalesce=4, queue_blocks=64)

    def apply(knob, value):
        if knob == "verify_chunk":
            srv.set_verify_chunk(int(value))

    ap = Autopilot(_ap_specs(AP_SIDECAR_SPEC, ("verify_chunk", "weight", "shed")), apply,
                   set_weight=srv.scheduler.set_weight, set_shed=srv.scheduler.set_shed,
                   slo=engine, scheduler=srv.scheduler, bands=AP_SIDECAR_BANDS,
                   initial={"verify_chunk": 0})
    srv.autopilot = ap
    links, results, errors = {}, {"flood": [], "calm": []}, []
    try:
        srv.start_background()
        for name in ("flood", "calm"):
            links[name] = SidecarLink("127.0.0.1", srv.port, tenant=name, timeout_s=60.0,
                                      busy_retries=100000,
                                      backoff=Backoff(base=0.02, cap=0.05, jitter=0.0))

        unshed = threading.Event()  # set by the ticking loop

        def flood():
            # at least AP_FLOOD_REQS, and on until the flood was shed and
            # unshed, so that it keeps arriving while shed
            try:
                pending, j = [], 0
                while (j < AP_FLOOD_REQS or not unshed.is_set()) and j < AP_FLOOD_CAP:
                    b = j % len(blocks)
                    pending.append((b, links["flood"].submit(blocks[b])))
                    j += 1
                    if len(pending) >= AP_FLOOD_INFLIGHT:
                        b, h = pending.pop(0)
                        results["flood"].append((b, h.fetch()))
                for b, h in pending:
                    results["flood"].append((b, h.fetch()))
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        def calm():
            try:
                for j in range(AP_CALM_REQS):
                    b = (3 * j + 1) % len(blocks)
                    results["calm"].append((b, links["calm"].submit(blocks[b]).fetch()))
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        threads = [threading.Thread(target=flood), threading.Thread(target=calm)]
        with _captured_verify() as (seen, _first):
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            shed_seen = False
            while True:
                dec = ap.tick(ap.read_signals())
                if dec is not None:
                    ap_log.append({"t_s": time.perf_counter() - t0, **dec.to_dict()})
                    shed_seen |= dec.knob == "shed" and dec.tenant == "flood"
                    if shed_seen and dec.knob == "shed" and dec.direction == "off":
                        unshed.set()
                done = not any(th.is_alive() for th in threads)
                if done and (not srv.scheduler.is_shed("flood")) and shed_seen:
                    break
                if time.perf_counter() - t0 > AP_SIDECAR_WAIT_S:
                    raise AssertionError(f"autopilot_path (c): not done in {AP_SIDECAR_WAIT_S} "
                                         f"s (shed seen {shed_seen}): {ap_log[-6:]}")
                if done and not srv.scheduler.is_shed("flood") and not shed_seen:
                    raise AssertionError("autopilot_path (c): the flood was never shed")
                time.sleep(0.05)
            secs = time.perf_counter() - t0
        for th in threads:
            th.join()
        if errors:
            raise AssertionError(f"autopilot_path (c): {errors[:3]}")
        stats, sched = srv.stats(), srv.scheduler.stats()
    finally:
        for link in links.values():
            link.close()
        srv.stop_background()
        slo.configure("")
    kinds = [(d["knob"], d["direction"], d.get("tenant")) for d in ap_log
             if "t_s" in d]
    if ("shed", "on", "flood") not in kinds or ("shed", "off", "flood") not in kinds:
        raise AssertionError(f"autopilot_path (c): the flood was not shed and unshed: {kinds}")
    busy = links["flood"].busy_total
    shed_total = shed_ctr.value(tenant="flood") - shed_before
    if not busy or busy != sched["flood"]["shed_count"] or busy != shed_total or \
            stats["requests"]["flood"].get("busy", 0):
        raise AssertionError(f"autopilot_path (c): BUSY answers {busy}, shed_count "
                             f"{sched['flood']['shed_count']}, sidecar_shed_total {shed_total}, "
                             f"requests {stats['requests']['flood']}")
    if srv.verify_chunk != 1024 or (check_launches and seen[1024] == 0):
        raise AssertionError(f"autopilot_path (c): verify_chunk {srv.verify_chunk}, "
                             f"p256_verify shapes {dict(seen)}")
    bad = [(t, b) for t in results for b, got in results[t] if got != truth[b]]
    if bad or len(results["flood"]) < AP_FLOOD_REQS or len(results["calm"]) != AP_CALM_REQS:
        raise AssertionError(f"autopilot_path (c): verdicts differ from the in-process v3's "
                             f"at {bad[:5]}")
    return {"seconds": secs, "flood_requests": len(results["flood"]), "flood_busy": busy,
            "shed_count": sched["flood"]["shed_count"],
            "requests": stats["requests"], "dispatches": stats["dispatches"],
            "verify_chunk": srv.verify_chunk, "p256_verify_lanes": dict(seen)}


def _ap_recorder(dev, wired, peer_ap):
    """(d) The SLO engine with a latency objective, the sampler every
    AP_VITALS_S and a black box writing to a temporary directory; a
    ``validator.verify_launch`` raise plan latches a guarded
    validator's lane (the block commits through the synchronous
    ``p256_verify``), then a ``pipeline.commit`` raise fails a pipe
    closed; both bundles read back from disk; /slo, /autopilot and
    /vitals read from an ``OperationsServer`` over these objects."""
    import asyncio
    import shutil
    import tempfile

    from fabric_tpu_torch import carry, faults
    from fabric_tpu_torch.observe import blackbox, slo, timeseries
    from fabric_tpu_torch.opsserver import OperationsServer
    from fabric_tpu_torch.peer.validator import BlockValidator

    root = tempfile.mkdtemp(prefix="fabtpu-blackbox-")
    single = {r.block.number: r for r in wired["res"]}
    loop = asyncio.new_event_loop()
    lt = threading.Thread(target=loop.run_forever, daemon=True)
    lt.start()
    try:
        engine = slo.configure("commit:latency:ms=5000")
        sampler = timeseries.configure(AP_VITALS_S, retention=64)
        bb = blackbox.configure(out_dir=root, sampler=sampler, autopilot=peer_ap, slo=engine)
        time.sleep(2.5 * AP_VITALS_S)  # the trails hold a few points

        def run(plan, guard, blocks):
            state, prov, _ = carry.from_reference(wired["seed_rows"], WIRE_NAMESPACES, [])
            kw = {"device_fail_threshold": 2, "device_retries": 1} if guard else {}
            v = BlockValidator(prov, state, device=dev, msp=wired["msp"], **kw)
            faults.configure(plan)
            try:
                return run_validator(blocks, v)[0], v
            finally:
                v.close()

        res, v = run("validator.verify_launch:raise:n=2", True, wired["wire"][:2])
        if not v.device_guard.degraded or [r.tx_filter for r in res] != \
                [single[r.block.number].tx_filter for r in res]:
            raise AssertionError("autopilot_path (d): the latch or its verdicts")
        failed = None
        try:
            run("pipeline.commit:raise:n=1", False, wired["wire"][:3])
        except faults.InjectedFault as e:
            failed = e
        if failed is None:
            raise AssertionError("autopilot_path (d): the failed commit did not surface")
        faults.reset()
        bundles = {}
        for path in sorted(Path(root).glob("blackbox-*.json")):
            b = json.loads(path.read_text())
            bundles[b["kind"]] = b
        need = {"vitals", "traces", "autopilot", "slo", "faults"}
        for kind in ("degrade_latch", "pipeline_fail_closed"):
            b = bundles.get(kind)
            if b is None or not need <= set(b) or not b["vitals"] or not b["traces"]:
                raise AssertionError(f"autopilot_path (d): bundle {kind}: "
                                     f"{sorted(b) if b else None}")
        if bundles["degrade_latch"]["detail"].get("fallback") != \
                "synchronous p256_verify on the card":
            raise AssertionError(f"autopilot_path (d): {bundles['degrade_latch']['detail']}")
        ops = asyncio.run_coroutine_threadsafe(
            OperationsServer(port=0, slo=engine, autopilot=peer_ap, vitals=sampler,
                             blackbox=bb).start(), loop).result(30)
        try:
            routes = {p: _http_json(ops.port, p)[1] for p in
                      ("/slo", "/autopilot", "/vitals",
                       f"/vitals?incident={bundles['degrade_latch']['seq']}")}
        finally:
            asyncio.run_coroutine_threadsafe(ops.stop(), loop).result(30)
        if ([o["name"] for o in routes["/slo"]["objectives"]] != ["commit"]
                or not routes["/autopilot"]["configured"]
                or not routes["/autopilot"]["decisions"]
                or routes["/vitals"]["samples"] < 2
                or len(routes["/vitals"]["incidents"]) != 2
                or routes[f"/vitals?incident={bundles['degrade_latch']['seq']}"]["kind"]
                != "degrade_latch"):
            raise AssertionError(f"autopilot_path (d): the routes: "
                                 f"{json.dumps(routes)[:2000]}")
        return {"bundles": {k: {"seq": b["seq"], "sections": sorted(b),
                                "bytes": len(json.dumps(b)), "detail": b["detail"]}
                            for k, b in bundles.items()},
                "vitals_samples": routes["/vitals"]["samples"],
                "vitals_series": routes["/vitals"]["series_count"]}
    finally:
        faults.reset()
        blackbox.configure(enabled=False)
        timeseries.configure(0)
        slo.configure("")
        loop.call_soon_threadsafe(loop.stop)
        lt.join(10)
        shutil.rmtree(root, ignore_errors=True)


def phase_autopilot_path(dev, wired, check_launches=True):
    """The traffic autopilot and the flight recorder on the wire path's
    blocks: (a) the peer's knobs on a live pipe, (b) the sign lane's,
    (c) a sidecar's tenants shed and unshed, (d) the incident bundles
    and the operations routes → the ``p256_verify`` and ``p256_sign``
    shapes the phase launched, each held against its plain version.
    ``check_launches=False`` rehearses it on the CPU, where the wrappers
    launch nothing."""
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.ops import p256v3

    t_phase = time.perf_counter()
    ap_log = []
    peer_ap, passes, shapes, first = _ap_peer(dev, wired, ap_log, check_launches)
    log("autopilot_peer", passes=passes, decisions=ap_log,
        knobs=peer_ap.report()["knobs"])
    verify_shapes = {}
    for lanes, (frame, out) in sorted(first.items()):
        want = p256v3.verify_batch_ref(frame)
        torch.cuda.synchronize()
        mism = int((out != want).sum())
        if mism:
            raise AssertionError(f"autopilot_path: p256_verify at {lanes} lanes: {mism} lanes "
                                 "differ from its plain version")
        consts = p256v3._kernel_consts(frame.device)
        ms = cuda_ms(lambda: kernels.p256_verify(frame, consts), 10)
        # the bound of the work needed; the reference schedule's beside it
        sched_ms, _, need_ms, need_by = verify_bound(p256v3, frame, out)
        verify_shapes[lanes] = {"launches": shapes[lanes], "mismatches": mism, "ms": ms,
                                "bound_ms": need_ms, "bound_by": need_by,
                                "bound_schedule_ms": sched_ms}
    log("autopilot_verify_shapes", shapes=verify_shapes)
    sign_log = []
    sign = _ap_sign(dev, sign_log)
    log("autopilot_sign", decisions=sign_log, **sign)
    side_log = []
    side = _ap_sidecar(dev, wired, side_log, check_launches)
    log("autopilot_sidecar", decisions=side_log, **side)
    rec = _ap_recorder(dev, wired, peer_ap)
    log("autopilot_recorder", **rec)
    secs = time.perf_counter() - t_phase
    log("autopilot_path", ok=True, seconds=secs,
        knobs_actuated=sorted({d["knob"] for d in ap_log + sign_log + side_log}))
    return {"verify_shapes": verify_shapes, "sign_buckets": sign["buckets"]}


def best_ms(fn, reps: int = 5) -> float:
    """The least host wall time of ``reps`` calls of ``fn``, in ms."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(1e3 * (time.perf_counter() - t0))
    return min(out)


def phase_host_stage(net: Net, wire, msp):
    """The commit path's host C++ at the main path's shape, each beside
    the plain Python it replaces, byte for byte: ``stage_frame`` against
    ``stage_frame_ref`` at 3,072 signatures (a main-path block's tuples
    and a wire block's columns); ``prepare_block_from_flat`` against
    ``prepare_block_static`` (both forms); ``parse_envelopes`` and the
    whole columnar parse against ``decode_block``."""
    from fabric_tpu_torch import carry, native
    from fabric_tpu_torch.native import blockparse
    from fabric_tpu_torch.ops import mvcc, p256v3
    from fabric_tpu_torch.peer import frontend
    from fabric_tpu_torch.peer.validator import BlockValidator

    blocks, _, seed_rows = build_blocks(net, n_blocks=1, unsafe=False)
    state, prov, _ = carry.from_reference(seed_rows, NAMESPACES, [])
    v = BlockValidator(prov, state, device="cpu", msp=msp)  # host work only
    _, tuples = v._parse(blocks[0])
    blk = wire[1]
    wb, txs, cols = v._parse_wire(blk)
    out = {}
    for name, items in (("tuples", tuples), ("columns", cols)):
        lanes = p256v3._bucket(len(items))
        got = p256v3.stage_frame(items, lanes)
        want = p256v3.stage_frame_ref(list(items), lanes)
        if got.tobytes() != want.tobytes():
            raise AssertionError(f"host stage: stage_frame ({name}) differs from stage_frame_ref")
        out[f"stage_frame_{name}"] = {
            "signatures": len(items), "lanes": lanes, "admitted": int(got[:, -1].sum()),
            "ms": best_ms(lambda: p256v3.stage_frame(items, lanes)),
            "plain_ms": best_ms(lambda: p256v3.stage_frame_ref(list(items), lanes), 3),
            "byte_equal": True}
    inc = np.array([t.undetermined for t in txs]) & wb.flat
    for unique in (False, True):
        flat = lambda: mvcc.prepare_block_from_flat(wb.rwp, inc, wb.lex_rank, wb.keys,
                                                    unique=unique)

        def plain():
            mt = []
            for t, u in zip(txs, inc):
                r, w, q = t.rwset.mvcc_form() if u and t.rwset is not None else ([], [], [])
                mt.append(mvcc.TxRWSet(reads=r, writes=w, range_reads=q))
            return mvcc.prepare_block_static(mt, bucketed=True, unique=unique)

        a, b = flat(), plain()
        if (a.packed_static().tobytes() != b.packed_static().tobytes()
                or a.packed_read_pv().tobytes() != b.packed_read_pv().tobytes()):
            raise AssertionError(f"host stage: prepare_block_from_flat (unique={unique}) "
                                 "differs from prepare_block_static")
        out[f"static_{'unique' if unique else 'bucketed'}"] = {
            "txs": int(inc.sum()), "shape": list(a.packed_static().shape),
            "ms": best_ms(flat), "plain_ms": best_ms(plain, 3), "byte_equal": True}
    # the policy groups: columnar against entry by entry (on the lists
    # _materialize_for_host fills), each on a fresh parse of the block;
    # both also build the same static MVCC arrays
    t_col, t_mat, t_gen = [], [], []
    for _ in range(5):
        (wa, ta, _), (wg, tg, _) = v._parse_wire(blk), v._parse_wire(blk)
        t0 = time.perf_counter()
        col = v._device_pre_columnar(ta, wa)
        t1 = time.perf_counter()
        v._materialize_for_host(tg, wg)
        t2 = time.perf_counter()
        gen = v._device_preprocess(tg, wg)
        t_col.append(1e3 * (t1 - t0))
        t_mat.append(1e3 * (t2 - t1))
        t_gen.append(1e3 * (time.perf_counter() - t2))
    if col is None or [t.code for t in ta] != [t.code for t in tg] or \
            [g.cpu().numpy().tobytes() for _, g, _, _ in col.groups] != \
            [g.cpu().numpy().tobytes() for _, g, _, _ in gen.groups] or \
            col.static.packed_static().tobytes() != gen.static.packed_static().tobytes():
        raise AssertionError("host stage: _device_pre_columnar differs from _device_preprocess")
    out["policy_groups"] = {
        "txs": len(ta), "groups": len(col.groups), "entries": [len(e) for e in col.group_entries],
        "columnar_ms": min(t_col), "entry_by_entry_ms": min(t_gen),
        "materialize_ms": min(t_mat), "equal_codes_and_gp": True}
    envs = list(blk.data.data)
    out["parse"] = {
        "envelopes": len(envs), "parse_envelopes_ms": best_ms(
            lambda: blockparse.parse_envelopes(envs)),
        "columnar_parse_ms": best_ms(lambda: v._parse_wire(blk)),
        "decode_block_ms": best_ms(lambda: frontend.decode_block(blk, msp), 3),
        "front_end_envelopes": wb.n_front_end, "rwset_parsed_txs": wb.n_rwset_parsed}
    log("host_stage", gxx_build_s=dict(native.build_seconds), **out)


# ---------------------------------------------------------------------------
# Phase 9: the SHA-256 kernel

SHA_B, SHA_LEN, SHA_M = 4096, 200, 4  # bench.py's sha256 scenario: 4,096 x 200 B
# INT32 instructions a compression, derived in sha256.cu's source note:
# schedule 48 x 10 + rounds 64 x 14 + the 8 adds of the state; of them
# the SHF and LOP3 (schedule 48 x 8, rounds 64 x 10), which only the
# INT32 pipe runs (the adds may run on the FMA pipe as IMADs)
SHA_OPS = 48 * 10 + 64 * 14 + 8
SHA_ALU_OPS = 48 * 8 + 64 * 10
SM_CLOCK_HZ = 1.98e9  # H100 SXM's boost clock, the chain floor's clock


def signed_messages(block) -> list:
    """The signed messages of a wire block in block order: a tx's
    envelope payload, then per endorsement proposal_response_payload ‖
    endorser (what the front end hashes)."""
    from fabric_tpu_torch.protos import messages as m

    out = []
    for raw in block.data.data:
        try:
            env = m.Envelope.parse(raw)
            payload = m.Payload.parse(env.payload)
            tx = m.Transaction.parse(payload.data)
            cap = m.ChaincodeActionPayload.parse(tx.actions[0].payload)
        except (ValueError, IndexError):
            continue
        out.append(env.payload)
        prp = cap.action.proposal_response_payload
        out += [prp + e.endorser for e in cap.action.endorsements]
    return out


# SASS opcodes by the pipe that issues them (a sub-partition's INT32 ALU
# and FMA pipes have 16 lanes each: a warp's instruction holds one two
# cycles); the rest are load/store or control
SASS_ALU = {"IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PRMT", "IMNMX", "VIADD", "MOV",
            "IABS", "POPC", "FLO", "BMSK", "SGXT", "PLOP3", "P2R", "R2P", "VIMNMX"}
SASS_FMA = {"IMAD", "FFMA", "FADD", "FMUL"}
SASS_LSU = {"LDS", "STS", "LDG", "STG", "LDGSTS", "SYNCS", "LD", "ST", "ATOMS", "LDC", "ULDC"}


def sass_blocks(so_path, kernel: str):
    """The basic blocks of ``kernel``'s SASS in a built library
    (``cuobjdump -sass``), each a list of opcodes (predicates dropped);
    None where the toolkit has no cuobjdump."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(so_path)], capture_output=True, text=True,
                          check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs if kernel in f.split("\n", 1)[0]), None)
    if body is None:
        return None
    blocks, cur = [], []
    for ln in body.splitlines():
        if re.match(r"\s*\.L_x_\d+:", ln):
            blocks.append(cur)
            cur = []
            continue
        mt = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if mt:
            cur.append(mt.group(1))
            if mt.group(1).split(".")[0] in ("BRA", "EXIT", "RET", "BRX", "JMP", "CALL"):
                blocks.append(cur)
                cur = []
    blocks.append(cur)
    return [b for b in blocks if b]


def sass_pipes(ops) -> dict:
    """Opcodes counted by pipe, and the issue cycles one warp alone on
    a sub-partition needs for them: at least two a pipe instruction and
    one an instruction."""
    c = {"alu": 0, "fma": 0, "lsu": 0, "other": 0}
    for op in ops:
        base = op.split(".")[0]
        c["alu" if base in SASS_ALU else "fma" if base in SASS_FMA
          else "lsu" if base in SASS_LSU else "other"] += 1
    c["total"] = len(ops)
    c["issue_cycles"] = max(2 * c["alu"], 2 * c["fma"], c["total"])
    return c


# funnel and plain shifts of a compression: 6 a round (Sigma0, Sigma1),
# 6 a schedule word (sigma0, sigma1)
SHA_ROUND_SHF, SHA_SCHEDULE_SHF = 64 * 6, 48 * 6


def sha_sass(so_path) -> dict | None:
    """A compression's instructions in ``sha256_blocks_kernel``'s SASS,
    by pipe, scaled to one compression by their shifts (so that a loop
    copied or rolled by the compiler reads the same): ``rounds_block``,
    the blocks of rounds (40 or more shifts, no shared store), the
    consumer's where they read W + K from shared memory, else (one
    thread a message) the whole loop body with its schedule; and
    ``schedule_block``, the producer's (the blocks that store to shared
    memory), where there is one."""
    blocks = sass_blocks(so_path, "sha256_blocks_kernel")
    if not blocks:
        return None
    nshf = lambda ops: sum(o.startswith("SHF") for o in ops)
    has = lambda b, op: any(o.startswith(op) for o in b)
    rounds = [o for b in blocks if nshf(b) >= 40 and not has(b, "STS") for o in b]
    schedule = [o for b in blocks if nshf(b) >= 40 and has(b, "STS") for o in b]
    if not rounds:
        return None
    k = (SHA_ROUND_SHF if has(rounds, "LDS") else SHA_ROUND_SHF + SHA_SCHEDULE_SHF) / nshf(rounds)
    out = {"rounds_block": {n: v * k for n, v in sass_pipes(rounds).items()},
           "opcodes_per_round": {n: round(v * k / 64, 3) for n, v in
                                 Counter(o.split(".")[0] for o in rounds).items()}}
    if schedule:
        ks = SHA_SCHEDULE_SHF / nshf(schedule)
        out["schedule_block"] = {n: v * ks for n, v in sass_pipes(schedule).items()}
    return out


def sha_bound(nbytes: float, comps: int):
    """``bound`` for ``comps`` SHA-256 compressions: their operations take
    at least the larger of the SHF and LOP3 over the INT32 pipe's peak
    and all of them over both pipes' issue peak."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = comps * max(SHA_ALU_OPS / PEAK_INT32_S, SHA_OPS / PEAK_ISSUE_S)
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def sha_chain_floor_ms(sass: dict | None, longest: int):
    """One warp's issue cycles a compression (``sha_sass``) times the
    longest message's compressions, at ``SM_CLOCK_HZ``."""
    if sass is None:
        return None
    return 1e3 * longest * sass["rounds_block"]["issue_cycles"] / SM_CLOCK_HZ


def phase_sha256(dev, first_block):
    """``sha256_blocks`` against its plain version and hashlib at the
    bench shape, the padding boundaries, a ragged M = 8 batch and every
    signed message of the first wire block; ``sha256_host`` counted on
    its own run → the kernels-line record.  Timed at the bench shape and
    at the wire block's messages as ``sha256_host`` buckets them
    (power-of-two batch and blocks), each beside serial ``hashlib`` of
    the same messages, its bound (``sha_bound``: the bytes of the blocks
    the messages need, and their compressions' operations by pipe) and
    its chain floor."""
    import hashlib

    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.ops import sha256 as sha
    from fabric_tpu_torch.utils.batching import next_pow2

    rng = np.random.default_rng(SEED + 11)
    bench = [rng.bytes(SHA_LEN) for _ in range(SHA_B)]
    signed = signed_messages(first_block)
    sets = {"bench": (bench, SHA_M),
            "boundaries": ([rng.bytes(n) for n in (0, 55, 56, 63, 64, 119, 120)], 4),
            "ragged": ([rng.bytes(int(n)) for n in rng.integers(0, 8 * 64 - 9, 1000)], 8),
            "wire_block": (signed, None)}
    kernels.reset_counts()
    for msgs, _ in sets.values():
        if sha.sha256_host(msgs, device=dev) != [hashlib.sha256(x).digest() for x in msgs]:
            raise AssertionError("sha256_host differs from hashlib")
    counts = dict(kernels.launches)
    sass = sha_sass(kernels._lib_path("sha256"))
    log("sha256_kernel", sass=sass)
    # the wire block's messages as sha256_host launches them
    need = max((len(x) + 8) // 64 + 1 for x in signed)
    wire_host = signed + [b""] * (next_pow2(len(signed)) - len(signed))
    sets["wire_block_bucketed"] = (wire_host, next_pow2(need))
    checks, rec = {}, None
    for name, (msgs, M) in sets.items():
        blocks, nb = sha.pad_messages(msgs, M)
        b = torch.from_numpy(blocks.view(np.int32)).to(dev)
        n = torch.from_numpy(nb).to(dev)
        got, want = sha.sha256_blocks(b, n), sha.sha256_blocks_ref(b, n)
        torch.cuda.synchronize()
        mism = int((got != want).any(dim=1).sum())
        err = int((got.long() - want.long()).abs().max())
        if mism or sha.digests_to_bytes(got) != [hashlib.sha256(x).digest() for x in msgs]:
            raise AssertionError(f"sha256_blocks at {name}: {mism} digests differ")
        checks[name] = {"B": len(msgs), "M": int(blocks.shape[1]), "mismatches": mism}
        if name not in ("bench", "wire_block_bucketed"):
            continue
        ms = cuda_ms(lambda: kernels.sha256_blocks(b, n), 20)
        plain_ms = cuda_ms(lambda: sha.sha256_blocks_ref(b, n), 2)
        real = msgs if name == "bench" else signed
        t0 = time.perf_counter()
        for x in real:
            hashlib.sha256(x).digest()
        hashlib_ms = 1e3 * (time.perf_counter() - t0)
        comps = int(nb.sum())
        b_ms, b_by = sha_bound(64 * comps + 4 * len(msgs) + 32 * len(msgs), comps)
        log(f"sha256_{name.split('_bucketed')[0]}", B=len(msgs), messages=len(real),
            M=int(blocks.shape[1]), compressions=comps, longest=int(nb.max()), ms=ms,
            plain_ms=plain_ms, hashlib_serial_ms=hashlib_ms, bound_ms=b_ms, bound_by=b_by,
            chain_floor_ms=sha_chain_floor_ms(sass, int(nb.max())),
            hashes_per_s=len(real) / (ms / 1e3))
        if name == "bench":
            rec = {"name": "sha256_blocks", "route": "cuda",
                   "source": "fabric_tpu_torch/kernels/csrc/sha256.cu",
                   "replaces": "fabric_tpu/ops/sha256.py:76", "max_abs_err": err,
                   "mismatches": mism, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": None, "launches": counts["sha256_blocks"]}
    log("sha256", checks=checks, launches=counts, equal_to_hashlib=True)
    if counts["sha256_blocks"] == 0:
        raise AssertionError("sha256_blocks not launched by sha256_host")
    return rec

# ---------------------------------------------------------------------------
# Phase 10: the comparison verifiers v1 and v2, and the comparison path


# INT32 operations per v1 Montgomery product (CIOS over eight 32-bit limbs:
# 64 + 64 32x32->64 multiply-adds, 2 INT32 operations each), and v1's
# products per lane in the reference schedule, the same for every lane:
# 8,226 mod p (2 to Montgomery form, 3 on-curve, 24 for G + Q, 256 steps x
# (8 doubling + 24 complete add), 5 final) and 428 mod n (1 + 256
# squarings + 169 at the set bits of n - 2 + 2 for u1, u2).  The kernels
# line's bound counts these.
V1_PRODUCT_OPS = 128 * 2
V1_PRODUCTS = 8226 + 428
# What v1 needs (bound_needed_ms): the complete add's doubling case only
# where it is taken, so 6,170 products mod p (2 + 3 + 16 for G + Q + 256 x
# (8 + 16) + 5), 2,311 of them squares (2 on-curve, 4 in G + Q, 256 x (5 in
# the doubling + 4 in the add), 1 final), and the 428 mod n, 256 squares
V1_NEEDED = {"p": (6170, 2311), "n": (428, 256)}
# INT32 operations of one v2 digit product's convolution (43^2
# multiply-adds); of one settle: 3 rounds x (3 passes x 43 x (mask, shift,
# add) + 43 x 3 fold multiply-adds) + the tidy pass 43 x 3 + 43; of a
# canonical form beyond its settle: 4 sweeps x 43 x 3, 3 folds x 43, 4
# compares x 43 x 4 and 4 conditional subtractions x 43.  The reduction
# runs on the int8 tensor cores: [lo | mid | hi & 63 | hi >> 6] x R, 168
# rows of 43 multiply-adds, 2 operations each.
V2_CONV_OPS = 43 * 43
V2_SETTLE_OPS = 3 * (3 * 43 * 3 + 43 * 3) + 43 * 3 + 43
V2_CANON_OPS = 4 * 43 * 3 + 3 * 43 + 4 * 43 * 4 + 4 * 43
V2_REDUCE_INT8_OPS = 2 * 168 * 43
# H100 SXM dense int8 tensor-core peak (NVIDIA's data sheet)
PEAK_INT8_S = 1979e12
COMPARISON = (("v1", "p256_verify_v1", "fabric_tpu_torch/kernels/csrc/p256_v1.cu",
               "fabric_tpu/ops/p256.py:307"),
              ("v2", "p256_verify_v2", "fabric_tpu_torch/kernels/csrc/p256_v2.cu",
               "fabric_tpu/ops/p256v2.py:279"))


def needed_ms(moved: int, lanes: int, counts: dict) -> float:
    """The verifiers' shared yardstick (``verify_bound``'s second bound):
    per 256-bit modular product 64 wide 32x32 products (36 for a square),
    none for P-256's reduction mod p (limb-aligned adds) and 64 more for
    the reduction mod n; 2 INT32 operations each.  ``counts``: {"p" | "n":
    (products, squares)} per lane."""
    wide = 0
    for mod, (prods, squares) in counts.items():
        wide += (prods - squares) * 64 + squares * 36 + (64 * prods if mod == "n" else 0)
    return bound(moved, lanes * wide * 2)[0]


def comparison_items(net: Net, n: int):
    """``adversarial_items`` with up to 32 lanes of Q = G and as many of
    Q = -G in place of valid lanes (half of them at most), every other
    one of each tampered."""
    ec = net.ec
    items, kinds = adversarial_items(net, n)
    kinds = kinds.copy()
    valid = np.flatnonzero(kinds == 0)
    m = min(32, len(valid) // 4)
    for j, i in enumerate(valid[:2 * m]):
        key = ec.SigningKey(d=1 if j < m else ec.N - 1)
        e = int.from_bytes(np.random.default_rng(SEED + 20 + j).bytes(32), "big")
        r, s = key.sign_digest(e)
        items[i] = (e ^ (j % 2), r, s, *key.public)
        kinds[i] = 10 if j < m else 11
    return items, kinds


def _v2_schedule_counts(fn):
    """Run ``fn`` counting the plain v2's DigitMod calls → (result,
    {"mul", "settle", "canonical", "p", "n"}) per lane (the plain version
    runs every lane in each call); "p" and "n" are (products, squares)
    of each modulus, from ``FV.__mul__``."""
    from fabric_tpu_torch.ops import digits as dg
    from fabric_tpu_torch.ops import p256v2

    seen = Counter()
    orig = {k: getattr(dg.DigitMod, k) for k in ("mul", "settle", "canonical")}
    fv_mul = p256v2.FV.__mul__

    def counted(name):
        def f(self, *a, **kw):
            seen[name] += 1
            return orig[name](self, *a, **kw)
        return f

    def counted_mul(a, b):
        mod = "p" if a.mod is p256v2.MODP else "n"
        seen[mod] += 1
        seen[mod + "_sq"] += a is b
        return fv_mul(a, b)

    for k in orig:
        setattr(dg.DigitMod, k, counted(k))
    p256v2.FV.__mul__ = counted_mul
    try:
        out = fn()
    finally:
        for k, f in orig.items():
            setattr(dg.DigitMod, k, f)
        p256v2.FV.__mul__ = fv_mul
    sched = {k: seen[k] for k in ("mul", "settle", "canonical")}
    sched.update({m: (seen[m], seen[m + "_sq"]) for m in ("p", "n")})
    return out, sched


def comparison_path(net: Net, kernel: str, name: str, main_res):
    """The main path's bench-shaped blocks through CommitPipeline(depth=2)
    over BlockValidator(kernel=...) → (launch counts, the lane shape the
    path launched ``name`` with most often)."""
    from fabric_tpu_torch import carry, kernels
    from fabric_tpu_torch.peer.validator import BlockValidator

    blocks, expected, seed_rows = build_blocks(net, unsafe=False)
    state, prov, _ = carry.from_reference(seed_rows, NAMESPACES, [])
    v = BlockValidator(prov, state, device="cuda", kernel=kernel)
    kernels.reset_counts()
    with launch_shapes(name, lambda frame, consts: int(frame.shape[0])) as shapes:
        res, secs, marks = run_validator(blocks, v, depth=2)
    counts = dict(kernels.launches)
    rows = lambda x: sorted((k, vv.value, vv.version) for k, vv in x.batch.items())
    for a, b in zip(res, main_res):
        if a.tx_filter != b.tx_filter or rows(a) != rows(b) or a.history != b.history:
            raise AssertionError(f"comparison path {kernel}: block {a.block.number} differs "
                                 "from the v3 main path")
    if len(res) != len(blocks) or [r.tx_filter for r in res] != expected:
        raise AssertionError(f"comparison path {kernel}: filters differ from construction")
    others = {k: n for k, n in counts.items() if k != name and k != "mvcc_validate" and n}
    if counts[name] != len(blocks) or counts["mvcc_validate"] != len(blocks) or others:
        raise AssertionError(f"comparison path {kernel}: launches {counts}")
    n_tx = sum(len(b.txs) for b in blocks)
    log("comparison_path", kernel=kernel, blocks=len(blocks), txs=n_tx, depth=2, seconds=secs,
        per_block_ms=1e3 * secs / len(blocks), tx_per_s=n_tx / secs, completion_s=marks,
        after_first_ms=1e3 * (marks[-1] - marks[0]) / (len(marks) - 1),
        lanes=dict(shapes), equal_to_main_path=True, launches=counts)
    return counts, shapes.most_common(1)[0][0]


def comparison_kernel(net: Net, dev, kernel: str, name: str, source: str, replaces: str,
                      shape: int):
    """The kernel against its plain version at 3072 lanes and 64 random
    lanes plus 4 of each kind against ec_ref; then its time, the plain
    version's and the bounds at ``shape`` lanes → the kernels-line record."""
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.ops import p256, p256v2

    stage, run, ref = ((p256.stage_frame, p256.verify_batch_v1, p256.verify_batch_v1_ref)
                       if kernel == "v1" else
                       (p256v2.stage_frame, p256v2.verify_batch_v2, p256v2.verify_batch_v2_ref))
    items, kinds = comparison_items(net, VERIFY_LANES)
    frame = torch.from_numpy(stage(items, VERIFY_LANES)).to(dev)
    got, want = run(frame), ref(frame)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    err = int((got.int() - want.int()).abs().max())
    if mism:
        raise AssertionError(f"{name}: {mism} lanes differ from its plain version")
    rng = np.random.default_rng(SEED + 21)
    sample = set(rng.choice(len(items), 64, replace=False).tolist())
    for k in range(12):
        sample.update(np.flatnonzero(kinds == k)[:4].tolist())
    g = got.cpu().numpy()
    oracle_mism = sum(bool(g[i]) != net.ec.verify_digest(items[i][3:], *items[i][:3])
                      for i in sorted(sample))
    if oracle_mism:
        raise AssertionError(f"{name}: {oracle_mism} sampled lanes disagree with ec_ref")
    kind_names = KINDS + ("q_eq_g", "q_eq_minus_g")
    accepted = {kn: int(g[kinds == k].sum()) for k, kn in enumerate(kind_names)}
    if not (accepted["q_eq_g"] and accepted["q_eq_minus_g"]
            and 0 < accepted["x_wrapped"] < int((kinds == 9).sum())):
        raise AssertionError(f"{name}: edge lanes not split as expected: {accepted}")
    # time, plain time and bounds at the path's shape: the same lanes, padded
    tframe = torch.from_numpy(stage(items, max(shape, len(items)))).to(dev)
    lanes = int(tframe.shape[0])
    out = run(tframe)
    ms = cuda_ms(lambda: run(tframe), 10)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    if kernel == "v1":
        plain = ref(tframe)
        sched = {"products": V1_PRODUCTS, **V1_NEEDED}
        const_bytes = 80 * 4
    else:
        plain, sched = _v2_schedule_counts(lambda: ref(tframe))
        const_bytes = p256v2.kernel_consts(dev).numel() * 4
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    if not torch.equal(out, plain):
        raise AssertionError(f"{name}: differs from its plain version at {shape} lanes")
    moved = nbytes(tframe, out) + const_bytes
    if kernel == "v1":
        ops = {"int32": lanes * V1_PRODUCTS * V1_PRODUCT_OPS}
        b_ms, b_by = bound(moved, ops["int32"])
    else:
        # each unit at its own peak, the slowest bounds: the convolution,
        # settles and canonical forms on the CUDA cores, the reduction on
        # the int8 tensor cores
        ops = {"int32": lanes * (sched["mul"] * V2_CONV_OPS + sched["settle"] * V2_SETTLE_OPS
                                 + sched["canonical"] * V2_CANON_OPS),
               "int8_tensor": lanes * sched["mul"] * V2_REDUCE_INT8_OPS}
        t_bytes, t_int32, t_int8 = (moved / PEAK_BYTES_S, ops["int32"] / PEAK_INT32_S,
                                    ops["int8_tensor"] / PEAK_INT8_S)
        b_ms = 1e3 * max(t_bytes, t_int32, t_int8)
        b_by = "bytes" if t_bytes >= max(t_int32, t_int8) else "operations"
    need_ms = needed_ms(moved, lanes, {m: sched[m] for m in ("p", "n")})
    log(f"verify_{kernel}", lanes=frame.shape[0], accepted=int(got.sum()), mismatches=mism,
        lanes_per_kind={kn: int((kinds == k).sum()) for k, kn in enumerate(kind_names)},
        accepted_per_kind=accepted, oracle_lanes=len(sample), oracle_mismatches=oracle_mism,
        timed_lanes=lanes, **kernels.verify_attrs(name, lanes), ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bound_needed_ms=need_ms,
        schedule_per_lane=sched, ops=ops)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": err, "mismatches": mism, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase_comparison(net: Net, dev, main_res):
    """Each comparison verifier: its path, then its kernel checks and
    timing at the shape the path launched → kernels-line records."""
    recs = []
    for kernel, name, source, replaces in COMPARISON:
        counts, shape = comparison_path(net, kernel, name, main_res)
        rec = comparison_kernel(net, dev, kernel, name, source, replaces, shape)
        rec["launches"] = counts[name]
        recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# Phase 11: the validation sidecar


SIDECAR_TENANTS = (("t1", 1.0), ("t2", 1.0), ("t3", 2.0))


def sidecar_kernel_check(frames, shapes):
    """``p256_verify`` against its plain version on the first frame the
    sidecar launched at each of its shapes (a coalesced group pads to
    ``_bucket(sum of buckets)``, so the shapes differ from the main
    path's) → per shape: launches, mismatches (0, or it raises), the
    kernel's and the plain version's ms.  These launches come after the
    path's counts were read."""
    from fabric_tpu_torch.ops import p256v3 as v3

    out = {"most_frequent": shapes.most_common(1)[0][0], "largest": max(shapes)}
    for lanes, frame in sorted(frames.items()):
        got = v3.verify_batch_packed(frame)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        want = v3.verify_batch_ref(frame)
        b.record()
        torch.cuda.synchronize()
        mism = int((got != want).sum())
        if mism:
            raise AssertionError(f"sidecar: p256_verify differs from verify_batch_ref on {mism} "
                                 f"of {lanes} lanes at the sidecar's shape")
        out[str(lanes)] = {"launches": shapes[lanes], "accepted": int(got.sum()),
                           "mismatches": mism,
                           "ms": cuda_ms(lambda: v3.verify_batch_packed(frame), 5),
                           "plain_ms": a.elapsed_time(b)}
    return out


def phase_sidecar(net: Net, main_res):
    """A SidecarServer on localhost serving 3 concurrent tenants, each a
    SidecarValidator under CommitPipeline(depth=2) over its own copy of
    the bench blocks, with ``p256_verify`` then held against its plain
    version at every shape the server launched it with; then one block's
    batch through a SidecarLink to a v1 and a v2 server against the
    in-process v3 verdicts."""
    from fabric_tpu_torch import carry, kernels
    from fabric_tpu_torch.ops import p256
    from fabric_tpu_torch.peer.validator import BlockValidator
    from fabric_tpu_torch.sidecar import SidecarLink, SidecarServer
    from fabric_tpu_torch.sidecar.validator import SidecarValidator
    from fabric_tpu_torch.utils.stats import nearest_rank

    tenants = []
    for name, weight in SIDECAR_TENANTS:
        blocks, expected, seed_rows = build_blocks(net, unsafe=False)
        state, prov, _ = carry.from_reference(seed_rows, NAMESPACES, [])
        tenants.append((name, weight, blocks, state, prov))
    srv = SidecarServer("127.0.0.1", 0, coalesce=4, queue_blocks=8).start_background()
    out, errors = {}, []
    try:
        validators = {name: SidecarValidator(prov, state, device="cuda", tenant=name,
                                             sidecar_weight=weight,
                                             sidecar_endpoint=f"127.0.0.1:{srv.port}")
                      for name, weight, _, state, prov in tenants}

        def drive(name, blocks):
            try:
                out[name] = run_validator(blocks, validators[name], depth=2)
            except BaseException as e:  # re-raised below, on the main thread
                errors.append(e)

        frames = {}  # lanes → a copy of the first frame the path launched at that shape

        def first_frame(frame, *a, **kw):
            n = int(frame.shape[0])
            if n not in frames:
                frames[n] = frame.clone()
            return n

        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with launch_shapes("p256_verify", first_frame) as shapes:
            threads = [threading.Thread(target=drive, args=(name, blocks))
                       for name, _, blocks, _, _ in tenants]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.launches)
        st = srv.stats()
        guards = {name: v.sidecar_guard.stats() for name, v in validators.items()}
        for v in validators.values():
            v.close()
    finally:
        srv.stop_background()
    if errors:
        raise errors[0]
    # the latch is always on: a fallback that no fault caused fails the run
    latched = {n: g for n, g in guards.items() if g["fallback_blocks_total"] or g["degraded"]
               or g["failures_total"]}
    if latched:
        raise AssertionError(f"sidecar: tenants fell back to the peer's verify: {latched}")
    rows = lambda x: sorted((k, vv.value, vv.version) for k, vv in x.batch.items())
    for name, (res, _, _) in out.items():
        for a, b in zip(res, main_res):
            if a.tx_filter != b.tx_filter or rows(a) != rows(b) or a.history != b.history:
                raise AssertionError(f"sidecar tenant {name}: block {a.block.number} differs "
                                     "from the main path")
        if len(res) != N_BLOCKS:
            raise AssertionError(f"sidecar tenant {name}: {len(res)} blocks committed")
    if counts["p256_verify"] != st["dispatches"] or st["dispatches"] == 0:
        raise AssertionError(f"sidecar: {counts['p256_verify']} p256_verify launches for "
                             f"{st['dispatches']} dispatches")
    if any(counts[k] for k in ("stage2_policy", "stage2_mvcc")):
        raise AssertionError(f"sidecar: stage 2 launched on the host path: {counts}")
    kernel_check = sidecar_kernel_check(frames, shapes)
    total = sorted(x for t in st["latency_s"].values() for x in t["total"])
    n_tx = {name: sum(len(b.txs) for b in blocks) for name, _, blocks, _, _ in tenants}
    sigs = sum(st["coalesce"]["signatures"])
    busy = sum(r.get("busy", 0) for r in st["requests"].values())
    log("sidecar", tenants={n: w for n, w, *_ in tenants}, coalesce=4, queue_blocks=8,
        requests=st["requests"], dispatches=st["dispatches"],
        coalesce_requests=st["coalesce"]["requests"],
        coalesce_signatures=st["coalesce"]["signatures"], busy_answers=busy,
        request_ms_p50=1e3 * nearest_rank(total, 50), request_ms_p99=1e3 * nearest_rank(total, 99),
        seconds=wall, tx_per_s={n: n_tx[n] / out[n][1] for n in out},
        tx_per_s_all=sum(n_tx.values()) / wall, signatures_per_s=sigs / wall,
        equal_to_main_path=True, launches=counts, p256_verify_lanes=kernel_check,
        fallback_blocks={n: g["fallback_blocks_total"] for n, g in guards.items()})

    # one block's batch through a v1 and a v2 server
    blocks, _, seed_rows = build_blocks(net, n_blocks=1, unsafe=False)
    state, prov, _ = carry.from_reference(seed_rows, NAMESPACES, [])
    _, items = BlockValidator(prov, state, device="cuda")._parse(blocks[0])
    want = p256.verify_host(items, kernel="v3")
    for kernel, name, _, _ in COMPARISON:
        srv = SidecarServer("127.0.0.1", 0, kernel=kernel).start_background()
        link = SidecarLink("127.0.0.1", srv.port, tenant=f"cmp_{kernel}")
        try:
            kernels.reset_counts()
            t0 = time.perf_counter()
            got = link.submit(items).fetch()
            secs = time.perf_counter() - t0
            counts = dict(kernels.launches)
        finally:
            link.close()
            srv.stop_background()
        if got != want or counts[name] != 1:
            raise AssertionError(f"sidecar under {kernel}: verdicts equal to v3: {got == want}, "
                                 f"launches {counts}")
        log("sidecar_kernel", kernel=kernel, signatures=len(items), accepted=sum(got),
            seconds=secs, equal_to_v3=True, launches={name: counts[name]})


# BASELINE config 4 (raft: 3 orderers / 4 peers, pvtdata chaincode, mixed
# endorsement policies), its peer-side validation path
CONFIG4_CHANNEL = "config4chan"
CONFIG4_NS = {
    "basic": "OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')",
    "pvtcc": "OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer', 'Org4MSP.peer')",
    "sbecc": "OutOf(1, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer', 'Org4MSP.peer')",
}
CONFIG4_BLOCKS = 10             # after the genesis block; the first reported apart
CONFIG4_SBE_BLOCKS = (3, 6, 9)  # writes to keys with a key-level policy
CONFIG4_CONFIG_AT = {7: "majority", 10: "one_admin"}
CONFIG4_STATE = {"public": 200_000, "hashed": 50_000, "sbecc": 20_000, "locked": 2_000}


def _config4_key_hash(name: str) -> bytes:
    import hashlib

    return hashlib.sha256(name.encode()).digest()


def build_config4(n_blocks=CONFIG4_BLOCKS, n_tx=BLOCK_TXS, state=CONFIG4_STATE,
                  sign_batch=None, seed=SEED + 40):
    """Config 4's channel and blocks, built with the port's cryptogen,
    configtxgen and ``build_envelopes`` → dict: the genesis block, the
    wire blocks 1..n_blocks, the seed state rows, the orgs, the
    construction's expected code of every transaction whose code the
    construction fixes (None for the rest)."""
    from fabric_tpu_torch import channelconfig as cc
    from fabric_tpu_torch.crypto import cryptogen
    from fabric_tpu_torch.crypto import policy as pol
    from fabric_tpu_torch.crypto.msp import policy_to_proto
    from fabric_tpu_torch.ledger.rwset import VALIDATION_PARAMETER, TxRWSet, encode_metadata
    from fabric_tpu_torch.peer import txassembly as txa
    from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
    from fabric_tpu_torch.protos import messages as m
    from fabric_tpu_torch.tools import configtxgen as cg

    signer = sign_batch or card_signer
    rng = np.random.default_rng(seed)
    orgs = [cryptogen.generate_org(f"Org{i}MSP", f"org{i}.config4.example.com", rng,
                                   now=WIRE_NOW, sign_batch=signer) for i in (1, 2, 3, 4)]
    peers = [o.nodes[f"peer0.org{i}.config4.example.com"] for i, o in zip((1, 2, 3, 4), orgs)]
    admins = [o.users[f"Admin@org{i}.config4.example.com"] for i, o in zip((1, 2, 3, 4), orgs)]
    client = orgs[0].users["User1@org1.config4.example.com"]
    profile = cg.Profile(CONFIG4_CHANNEL, application_orgs=[
        cg.OrgProfile(o.msp_id, o.msp()) for o in orgs],
        raft_consenters=[(f"orderer{i}.config4.example.com", 7050) for i in range(3)])
    genesis = cg.genesis_block(profile)
    bundle = cc.bundle_from_genesis(CONFIG4_CHANNEL, genesis)

    key_policy = {i: policy_to_proto(pol.from_dsl(f"OutOf(1, 'Org{i + 1}MSP.peer')")).serialize()
                  for i in range(4)}
    rows = []
    n_pub, n_hashed, n_sbe, n_locked = (state[k] for k in ("public", "hashed", "sbecc", "locked"))
    for j in range(n_pub):
        rows.append(("basic" if j % 2 else "pvtcc", f"k{j:07d}", b"genesis", (1, 0)))
    for j in range(n_hashed):
        rows.append(("pvtcc$collA#hashed", _config4_key_hash(f"h{j}").hex(),
                     _config4_key_hash(f"hv{j}"), (1, 0)))
    lock_org = {}
    for j in range(n_sbe):
        md = None
        if j < n_locked:
            lock_org[j] = j % 4
            md = encode_metadata({VALIDATION_PARAMETER: key_policy[j % 4]})
        rows.append(("sbecc", f"e{j:06d}", b"genesis", (1, 0), md))

    def config_update(kind):
        cur = bundle.config
        new = cur.copy()
        app = new.channel_group.groups["Application"]
        if kind == "majority":
            app.policies["Writers"] = cc.config_policy(
                cc.ImplicitMeta(m.IMPLICIT_MAJORITY, "Writers"))
            signers = admins[:3]
        else:
            app.policies["Readers"] = cc.config_policy(
                cc.ImplicitMeta(m.IMPLICIT_MAJORITY, "Readers"))
            signers = admins[:1]
        env = cg.sign_update(cg.compute_update(CONFIG4_CHANNEL, cur, new), signers)
        try:
            proposed = cc.authorize_update(bundle, env)
        except cc.ConfigUpdateError:
            proposed = new.copy()
            proposed.sequence = cur.sequence + 1
        return cg.config_tx(CONFIG4_CHANNEL, proposed, env, signer=admins[0]).serialize(), proposed

    specs, want, meta = [], [], []
    next_pub, next_hashed, next_sbe, next_lock = 0, 0, n_locked, 0
    for b in range(1, n_blocks + 1):
        sbe_block = b in CONFIG4_SBE_BLOCKS
        n_here = n_tx - (b in CONFIG4_CONFIG_AT)
        for i in range(n_here):
            r = (i * 37 + b) % 100
            rw = TxRWSet()
            code = C.VALID
            if r < 45:
                ns = "basic"
                key = f"k{(2 * next_pub + 1) % n_pub:07d}"
                next_pub += 1
                n = rw.ns_rwset(ns)
                n.reads[key] = (1, 0)
                n.writes[key] = b"updated"
                n.writes[f"new{b}_{i:05d}"] = b"value-%d" % i
                ends = [peers[i % 3], peers[(i + 1) % 3]]
            elif r < 80:
                ns = "pvtcc"
                key = f"k{(2 * next_pub) % n_pub:07d}"
                next_pub += 1
                kh = _config4_key_hash(f"h{next_hashed % n_hashed}")
                next_hashed += 1
                n = rw.ns_rwset(ns)
                n.reads[key] = (1, 0)
                n.writes[key] = b"updated"
                n.hashed["collA"] = {"reads": {kh: (1, 0)},
                                     "writes": {kh: (_config4_key_hash(f"nv{b}_{i}"), False)}}
                ends = [peers[i % 4], peers[(i + 1) % 4]]
            else:
                ns = "sbecc"
                n = rw.ns_rwset(ns)
                ends = [peers[i % 4], peers[(i + 2) % 4]]
                if sbe_block and i % 2:
                    j = next_lock % n_locked
                    next_lock += 1
                    key = f"e{j:06d}"
                    code = None  # the key's own policy decides
                elif sbe_block and i % 50 == 0:
                    # a metadata write: set a policy on an unlocked key
                    # (2% of the namespace's transactions)
                    key = f"e{next_sbe % n_sbe:06d}"
                    next_sbe += 1
                    n.metadata_writes[key] = {VALIDATION_PARAMETER: key_policy[i % 4]}
                    code = None
                else:
                    key = f"e{next_sbe % n_sbe:06d}"
                    next_sbe += 1
                n.reads[key] = (1, 0)
                n.writes[key] = b"updated"
            if i % 20 == 10:
                code = C.BAD_CREATOR_SIGNATURE
            specs.append(txa.TxSpec(client, ends, rw.to_bytes(), ns, channel_id=CONFIG4_CHANNEL))
            want.append(code)
            meta.append((b, i))
    envs = txa.build_envelopes(specs, signer)
    blocks, expected, k = [], [], 0
    for b in range(1, n_blocks + 1):
        n_here = n_tx - (b in CONFIG4_CONFIG_AT)
        part, codes = envs[k:k + n_here], want[k:k + n_here]
        for i, c in enumerate(codes):
            if c == C.BAD_CREATOR_SIGNATURE:  # the previous tx's signature: valid DER
                env = m.Envelope.parse(part[i])
                env.signature = m.Envelope.parse(part[i - 1]).signature
                part[i] = env.serialize()
        k += n_here
        if b in CONFIG4_CONFIG_AT:
            raw, proposed = config_update(CONFIG4_CONFIG_AT[b])
            part.insert(0, raw)
            codes = [C.VALID if CONFIG4_CONFIG_AT[b] == "majority"
                     else C.INVALID_OTHER_REASON] + codes
            if CONFIG4_CONFIG_AT[b] == "majority":
                bundle = cc.Bundle(CONFIG4_CHANNEL, proposed)
        blocks.append(txa.build_block(b, b"prev-%d" % b, part))
        expected.append(codes)
    return {"genesis": genesis, "blocks": blocks, "rows": rows, "expected": expected,
            "n_signed": len(specs) * 3}


def channel_validator(dev, channel, genesis, rows, namespaces):
    """A ``BlockValidator`` on ``dev`` over a channel's genesis block
    (its bundle's MSP manager and ``ConfigTxProcessor``), the state
    ``rows`` and the namespace policies; the genesis block validated."""
    from fabric_tpu_torch import carry
    from fabric_tpu_torch import channelconfig as cc
    from fabric_tpu_torch.crypto import policy as pol
    from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
    from fabric_tpu_torch.peer.validator import BlockValidator, NamespaceInfo, PolicyProvider

    state, _, _ = carry.from_reference(rows, {}, [])
    prov = PolicyProvider({ns: NamespaceInfo(policy=pol.from_dsl(d))
                           for ns, d in namespaces.items()})
    proc = cc.ConfigTxProcessor(cc.bundle_from_genesis(channel, genesis))
    v = BlockValidator(prov, state, device=dev, msp=proc.bundle.msp_manager,
                       config_processor=proc)
    v.blocks = TxidStore()
    flt, _, _ = v.validate(genesis)  # the channel's trust anchor
    if bytes(flt) != bytes([C.VALID]):
        raise AssertionError(f"{channel}: genesis block gave {list(flt)}")
    return v


def run_channel(v, blocks, dev, timings=None, host_only=False):
    """``blocks`` through ``CommitPipeline(depth=2)``, each committed
    config applied (``apply_committed_config``) → ([CommittedBlock],
    seconds, the numbers of the blocks that took ``_validate_host``, the
    pipeline, per-block completion seconds).  ``host_only``: every block
    forced onto ``_validate_host``."""
    from fabric_tpu_torch import channelconfig as cc
    from fabric_tpu_torch.peer.pipeline import CommitPipeline

    host_blocks = []
    orig = v._validate_host

    def host(pending):
        host_blocks.append(pending.block.number)
        return orig(pending)

    v._validate_host = host
    if host_only:
        v.validate_finish = host
    v.timings = timings

    def commit(res):
        t1 = time.perf_counter()
        v.state.apply_updates(res.batch)
        v.blocks.txids.update(t for t, _ in res.txids)
        cc.apply_committed_config(res, v)
        v._t("ledger_commit", t1)

    out, marks = [], []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    try:
        with CommitPipeline(v, commit, depth=2) as pipe:
            for blk in blocks:
                r = pipe.submit(blk)
                if r is not None:
                    out.append(r)
                    marks.append(time.perf_counter() - t1)
            r = pipe.flush()
            if r is not None:
                out.append(r)
                marks.append(time.perf_counter() - t1)
    finally:
        del v._validate_host
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t1, host_blocks, pipe, marks


@contextlib.contextmanager
def first_mvcc_validate():
    """Inside, the first ``mvcc_validate`` call on the card is kept (its
    operands and outputs, cloned) in the list this yields."""
    from fabric_tpu_torch.ops import mvcc as mvcc_ops

    seen, orig = [], mvcc_ops.mvcc_validate

    def capture(*args):
        out = orig(*args)
        if not seen and args[0].device.type == "cuda":
            seen.append(([a.clone() for a in args], [o.clone() for o in out]))
        return out

    mvcc_ops.mvcc_validate = capture
    try:
        yield seen
    finally:
        mvcc_ops.mvcc_validate = orig


def mvcc_mismatches(seen, path: str):
    """The kept ``mvcc_validate`` call against its plain version → the
    mismatched lanes (0, or it raises), None when none was kept."""
    from fabric_tpu_torch.ops import mvcc as mvcc_ops

    if not seen:
        return None
    args, outs = seen[0]
    ref = mvcc_ops.mvcc_validate_ref(*[a.cpu() for a in args])
    mism = int(sum((o.cpu() != r).sum().item() for o, r in zip(outs, ref)))
    if mism:
        raise AssertionError(f"{path}: mvcc_validate differs from its plain version "
                             f"in {mism} lanes")
    return mism


def phase_config4_path(dev, built=None, check_launches=True):
    """BASELINE config 4's validation path: the genesis block seeds the
    bundle, then the blocks through ``CommitPipeline(depth=2)`` on
    ``dev`` (fused blocks; the key-level-policy blocks on the host
    dispatch path; a config update signed by a majority of the orgs'
    admins that rotates the MSP manager at its barrier, and one signed by
    one admin that must be invalid) → the launch counts.  Every block
    equals the port's own ``_validate_host`` over the same blocks."""
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.protos import messages as m

    t0 = time.perf_counter()
    if built is None:
        built = build_config4()
    wire = [m.Block.parse(b.serialize()) for b in built["blocks"]]
    genesis = m.Block.parse(built["genesis"].serialize())
    log("config4_build", blocks=len(wire), txs=sum(len(b.data.data) for b in wire),
        signed_on_card=built["n_signed"], seconds=time.perf_counter() - t0,
        state_rows=len(built["rows"]), state=CONFIG4_STATE)

    validator = lambda: channel_validator(dev, CONFIG4_CHANNEL, genesis, built["rows"],
                                          CONFIG4_NS)
    run = lambda v, blocks, timings=None, host_only=False: run_channel(
        v, blocks, dev, timings, host_only)

    v = validator()
    msp0 = v.msp
    kernels.reset_counts()
    with first_mvcc_validate() as seen_mvcc, fused_blocks() as fused:
        first_t, rest_t = {}, {}
        res, first_s, host1, pipe1, _ = run(v, wire[:1], first_t)
        rest, secs, host2, pipe2, marks = run(v, wire[1:], rest_t)
    counts = dict(kernels.launches)
    res += rest
    host_route = set(host1 + host2)
    rotated = v.msp is not msp0

    href = run(validator(), wire, host_only=True)[0]
    rows = lambda x: sorted((k, vv.value, vv.metadata, vv.version) for k, vv in x.batch.items())
    for a, b in zip(res, href, strict=True):
        if a.tx_filter != b.tx_filter or rows(a) != rows(b) or a.history != b.history:
            raise AssertionError(f"config4 block {a.block.number}: the pipeline differs from "
                                 "the port's host path")
    bad = [(r.block.number, i, c, w) for r, want in zip(res, built["expected"])
           for i, (c, w) in enumerate(zip(r.tx_filter, want)) if w is not None and c != int(w)]
    if bad:
        raise AssertionError(f"config4 filters differ from construction at {bad[:10]}")
    routes = {r.block.number: "host" if r.block.number in host_route else "fused" for r in res}
    want_host = set(CONFIG4_SBE_BLOCKS)
    if {b for b, rt in routes.items() if rt == "host"} != want_host:
        raise AssertionError(f"config4 routes {routes}: the key-level-policy blocks "
                             f"{sorted(want_host)} must take the host path, the rest fused")
    barriers = sorted(r.block.number for r in res if r.barrier)
    if barriers != sorted(CONFIG4_CONFIG_AT) or not rotated:
        raise AssertionError(f"config4 barriers {barriers}, MSP rotated {rotated}")
    mism = mvcc_mismatches(seen_mvcc, "config4")
    if check_launches:
        zero = [k for k in MAIN_PATH_KERNELS if counts[k] == 0]
        if zero:
            raise AssertionError(f"kernels not launched on the config4 path: {zero}")
        check_policy_launches("config4 path", counts, fused)
    k = len(wire) - 1
    # ms between consecutive completions after the first block, by the
    # route of the block completed: at depth 2 a gap holds that block's
    # prefetch wait, launch and finish; the tail's (finish only) is left out
    gaps = np.diff([0.0] + marks) * 1e3
    by_route = {rt: [float(g) for g, r in zip(gaps[:-1], rest[:-1])
                     if routes[r.block.number] == rt] for rt in ("fused", "host")}
    log("config4_path", blocks=len(wire), txs=sum(len(b.data.data) for b in wire), depth=2,
        routes=[routes[b] for b in sorted(routes)],
        completion_gap_ms=[float(g) for g in gaps],
        completion_gap_ms_by_route={rt: {"blocks": len(g), "mean": float(np.mean(g)),
                                         "median": float(np.median(g))}
                                    for rt, g in by_route.items() if g},
        codes=[{int(c): n for c, n in sorted(Counter(r.tx_filter).items())} for r in res],
        first_block_ms=1e3 * first_s,
        first_block_phase_ms={key: 1e3 * t for key, t in sorted(first_t.items())},
        per_block_ms=1e3 * secs / k, tx_per_s=sum(len(b.data.data) for b in wire[1:]) / secs,
        phase_ms_per_block={key: 1e3 * t / k for key, t in sorted(rest_t.items())},
        barrier_blocks=barriers, msp_rotated=rotated,
        stale_reprocessed=pipe1.stale_prefetches + pipe2.stale_prefetches,
        launches={n: counts[n] for n in MAIN_PATH_KERNELS}, fused_blocks=fused,
        mvcc_validate_checked_lanes=(int(seen_mvcc[0][0][0].shape[0]) if seen_mvcc else 0),
        mvcc_validate_mismatches=mism, equal_to_host_path=True, equal_to_construction=True)
    return counts


# BASELINE config 5 (integration/idemix: an idemix client org beside X.509
# peer orgs, anonymous-credential creators), its peer-side validation path
CONFIG5_CHANNEL = "config5chan"
CONFIG5_IDX = "IdemixOrgMSP"
CONFIG5_NS = {"basic": "OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')"}
CONFIG5_BLOCKS = 6             # after the genesis block; the first reported apart
CONFIG5_ROTATE_AT = 5          # the epoch-record rotation's config block
CONFIG5_ANON_EVERY = 50        # one idemix creator in 50 transactions (2%)
CONFIG5_HOLDERS = 4            # idemix clients; the last is revoked at the rotation
CONFIG5_STATE = 200_000        # public keys
CONFIG5_ISSUER_BITS = 2048     # the reference's default modulus


class HostSigner:
    """An idemix holder's signer (``IdemixSigningIdentity``) whose
    serialized identity may disclose another ``role`` than its
    credential holds (its proofs then fail), adding its signing seconds
    and count to ``clock``."""

    def __init__(self, signer, clock: dict, role: str | None = None):
        self.signer, self.clock, self.role = signer, clock, role

    @property
    def serialized(self) -> bytes:
        if self.role is None:
            return self.signer.serialized
        from fabric_tpu_torch.protos import messages as m

        attrs = {"type": "idemix", "ou": self.signer.cred.ou, "role": self.role}
        return m.SerializedIdentity(mspid=self.signer.msp_id, id_bytes=json.dumps(
            attrs, sort_keys=True).encode()).serialize()

    def sign(self, message: bytes) -> bytes:
        t0 = time.perf_counter()
        out = self.signer.sign(message)
        self.clock["seconds"] += time.perf_counter() - t0
        self.clock["presentations"] += 1
        return out


def build_config5(n_blocks=CONFIG5_BLOCKS, n_tx=BLOCK_TXS, state=CONFIG5_STATE,
                  bits=CONFIG5_ISSUER_BITS, sign_batch=None, seed=SEED + 50):
    """Config 5's channel and blocks → dict: the genesis block (Org1-3
    X.509 with one peer each, and ``IdemixOrgMSP`` with its epoch-0
    record), the wire blocks, the seed state rows, the construction's
    code of every transaction, the signing clocks.  Each transaction
    reads and writes 2 keys; one in 50 has an idemix creator, from
    ``CONFIG5_HOLDERS`` holders (in each block the first one's proof is
    tampered with and the second discloses the wrong role); one a block
    has an idemix second endorser (dropped: the 2-of-3 policy fails);
    5% of the X.509 creator signatures are bad.  Block
    ``CONFIG5_ROTATE_AT`` replaces the idemix org's MSP config with the
    epoch-1 record (the last holder revoked, the others re-issued),
    signed by the Org1 and Org2 admins and an idemix admin's
    presentation; after it the revoked holder's creators fail and the
    others present epoch-1 credentials."""
    import random

    from fabric_tpu_torch import channelconfig as cc
    from fabric_tpu_torch.crypto import cryptogen, idemix
    from fabric_tpu_torch.ledger.rwset import TxRWSet
    from fabric_tpu_torch.peer import txassembly as txa
    from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
    from fabric_tpu_torch.protos import messages as m
    from fabric_tpu_torch.tools import configtxgen as cg

    signer = sign_batch or card_signer
    rng = np.random.default_rng(seed)
    prng = random.Random(seed)
    t0 = time.perf_counter()
    orgs = [cryptogen.generate_org(f"Org{i}MSP", f"org{i}.config5.example.com", rng,
                                   now=WIRE_NOW, sign_batch=signer) for i in (1, 2, 3)]
    peers = [o.nodes[f"peer0.org{i}.config5.example.com"] for i, o in zip((1, 2, 3), orgs)]
    admins = [o.users[f"Admin@org{i}.config5.example.com"] for i, o in zip((1, 2, 3), orgs)]
    client = orgs[0].users["User1@org1.config5.example.com"]
    t1 = time.perf_counter()
    iss = idemix.IdemixIssuer(CONFIG5_IDX, bits=bits, rng=prng)
    keygen_s = time.perf_counter() - t1
    holders, creds0 = {}, {}
    names = [f"holder{k}" for k in range(CONFIG5_HOLDERS)] + ["admin"]
    for name in names:
        role = "admin" if name == "admin" else "client"
        h = idemix.IdemixHolder(iss.ipk, prng)
        U, proof = h.commitment()
        creds0[name] = h.assemble(*iss.issue(U, proof, ou="org1", role=role, handle=name),
                                  ou="org1", role=role, epoch=iss.epoch)
        holders[name] = h
    rec0 = iss.epoch_record
    revoked = names[CONFIG5_HOLDERS - 1]
    iss.revoke(revoked)
    rec1 = iss.epoch_record
    creds1 = {}
    for name in names:
        if name != revoked:
            role = creds0[name].role
            U, proof = holders[name].commitment()
            creds1[name] = holders[name].assemble(
                *iss.issue(U, proof, ou="org1", role=role, handle=name), ou="org1", role=role,
                epoch=iss.epoch)
    issue_s = time.perf_counter() - t1 - keygen_s
    clock = {"seconds": 0.0, "presentations": 0}

    def anon(name, epoch, role=None):
        cred = (creds0 if epoch == 0 else creds1)[name]
        return HostSigner(idemix.IdemixSigningIdentity(CONFIG5_IDX, iss.ipk, cred, prng),
                          clock, role)

    profile = cg.Profile(CONFIG5_CHANNEL, application_orgs=[
        cg.OrgProfile(o.msp_id, o.msp()) for o in orgs] + [
        cg.OrgProfile(CONFIG5_IDX, idemix.IdemixMSP(CONFIG5_IDX, iss.ipk, rec0))],
        raft_consenters=[(f"orderer{i}.config5.example.com", 7050) for i in range(3)])
    genesis = cg.genesis_block(profile)
    bundle = cc.bundle_from_genesis(CONFIG5_CHANNEL, genesis)
    rows = [("basic", f"k{j:07d}", b"genesis", (1, 0)) for j in range(state)]

    def rotation():
        cur = bundle.config
        new = cur.copy()
        new.channel_group.groups["Application"].groups[CONFIG5_IDX].values["MSP"].value = \
            idemix.IdemixMSP(CONFIG5_IDX, iss.ipk, rec1).to_proto().serialize()
        env = cg.sign_update(cg.compute_update(CONFIG5_CHANNEL, cur, new),
                             [admins[0], admins[1], anon("admin", 0)])
        proposed = cc.authorize_update(bundle, env)  # raises unless authorized
        return cg.config_tx(CONFIG5_CHANNEL, proposed, env, signer=admins[0]).serialize()

    specs, want, tamper = [], [], []
    nxt = 0
    for b in range(1, n_blocks + 1):
        after = b > CONFIG5_ROTATE_AT
        for i in range(n_tx - (b == CONFIG5_ROTATE_AT)):
            rw = TxRWSet()
            n = rw.ns_rwset("basic")
            for _ in range(2):
                key = f"k{nxt % state:07d}"
                nxt += 1
                n.reads[key] = (1, 0)
                n.writes[key] = b"updated-%d" % b
            creator, ends, code = client, [peers[i % 3], peers[(i + 1) % 3]], C.VALID
            if i % CONFIG5_ANON_EVERY == CONFIG5_ANON_EVERY // 2:
                k = i // CONFIG5_ANON_EVERY
                name = names[k % CONFIG5_HOLDERS]
                wrong_role = "peer" if k == 1 else None
                creator = anon(name, 1 if after and name != revoked else 0, wrong_role)
                if k <= 1 or (after and name == revoked):
                    code = C.BAD_CREATOR_SIGNATURE
            elif i == 7:
                ends = [peers[i % 3], anon("admin", 1 if after else 0)]
                code = C.ENDORSEMENT_POLICY_FAILURE
            elif i % 20 == 10:
                code = C.BAD_CREATOR_SIGNATURE
            specs.append(txa.TxSpec(creator, ends, rw.to_bytes(), "basic",
                                    channel_id=CONFIG5_CHANNEL))
            want.append(code)
            tamper.append(isinstance(creator, HostSigner) and
                          i // CONFIG5_ANON_EVERY == 0)
    t1 = time.perf_counter()
    envs = txa.build_envelopes(specs, signer)
    envelopes_s = time.perf_counter() - t1
    host_signed, host_sign_s = clock["presentations"], clock["seconds"]
    blocks, expected, k = [], [], 0
    for b in range(1, n_blocks + 1):
        n_here = n_tx - (b == CONFIG5_ROTATE_AT)
        part, codes = envs[k:k + n_here], want[k:k + n_here]
        for i, c in enumerate(codes):
            if tamper[k + i]:  # a proof whose challenge no longer matches
                env = m.Envelope.parse(part[i])
                proof = json.loads(env.signature)
                proof["c"] = hex(int(proof["c"], 16) ^ 1)
                env.signature = json.dumps(proof).encode()
                part[i] = env.serialize()
            elif c == C.BAD_CREATOR_SIGNATURE and not isinstance(specs[k + i].creator,
                                                                 HostSigner):
                env = m.Envelope.parse(part[i])  # the previous tx's signature: valid DER
                env.signature = m.Envelope.parse(part[i - 1]).signature
                part[i] = env.serialize()
        k += n_here
        if b == CONFIG5_ROTATE_AT:
            part.insert(0, rotation())
            codes = [C.VALID] + codes
        blocks.append(txa.build_block(b, b"prev-%d" % b, part))
        expected.append(codes)
    return {"genesis": genesis, "blocks": blocks, "rows": rows, "expected": expected,
            "x509_signed": sum(len(sp.endorsers) + 1 for sp in specs) - host_signed,
            "idemix_signed": host_signed, "idemix_sign_s": host_sign_s,
            "idemix_creators": sum(isinstance(sp.creator, HostSigner) for sp in specs),
            "issuer_bits": bits, "issuer_keygen_s": keygen_s, "issuance_s": issue_s,
            "envelopes_s": envelopes_s,
            "seconds": time.perf_counter() - t0, "revoked": revoked}


def phase_config5_path(dev, built=None, check_launches=True):
    """BASELINE config 5's validation path: the genesis block seeds the
    bundle (with the idemix org), then the blocks through
    ``CommitPipeline(depth=2)`` on ``dev``.  Every idemix creator's proof
    is verified on the host and takes the creator lane -2; block
    ``CONFIG5_ROTATE_AT`` rotates the idemix org's epoch record at its
    barrier, so the successor staged before it is preprocessed again and
    its proofs verified under the new record.  Every block equals the
    port's own ``_validate_host`` over the same blocks and the
    construction; one fused stage 2 of the path with -2 lanes is held
    against ``stage2_ref`` → the launch counts."""
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.crypto import idemix
    from fabric_tpu_torch.peer import device_block as db
    from fabric_tpu_torch.protos import messages as m

    if built is None:
        built = build_config5()
    wire = [m.Block.parse(b.serialize()) for b in built["blocks"]]
    genesis = m.Block.parse(built["genesis"].serialize())
    log("config5_build", blocks=len(wire), txs=sum(len(b.data.data) for b in wire),
        seconds=built["seconds"], x509_signed_on_card=built["x509_signed"],
        envelopes_s=built["envelopes_s"], idemix_presentations=built["idemix_signed"],
        idemix_sign_s=built["idemix_sign_s"],
        idemix_sign_ms_per_presentation=1e3 * built["idemix_sign_s"] / built["idemix_signed"],
        issuer_bits=built["issuer_bits"], issuer_keygen_s=built["issuer_keygen_s"],
        issuance_s=built["issuance_s"], state_rows=len(built["rows"]),
        idemix_creators=built["idemix_creators"])
    validator = lambda: channel_validator(dev, CONFIG5_CHANNEL, genesis, built["rows"],
                                          CONFIG5_NS)

    # the proof checks: count, seconds, and each proof's (epoch, verdict) pairs
    proofs = {"n": 0, "seconds": 0.0, "by_sig": {}}
    orig_verify = idemix.IdemixMSP.verify

    def verify(self, ou, role, message, sig):
        t1 = time.perf_counter()
        ok = orig_verify(self, ou, role, message, sig)
        proofs["seconds"] += time.perf_counter() - t1
        proofs["n"] += 1
        rec = self.epoch_record
        proofs["by_sig"].setdefault(sig, set()).add((rec.epoch if rec else None, ok))
        return ok

    # one fused stage 2 of the path whose launch frame holds -2 lanes
    seen_s2 = []
    orig_stage2 = db.stage2

    def capture_s2(sig_valid, launch_vec, groups, static_p, dims, *rest):
        out = orig_stage2(sig_valid, launch_vec, groups, static_p, dims, *rest)
        if not seen_s2 and bool((launch_vec[:, 0] == -2).any()):
            seen_s2.append((sig_valid.clone(), launch_vec.clone(),
                            [(p, gp.clone(), eb, s) for p, gp, eb, s in groups],
                            static_p.clone(), dims, out.clone()))
        return out

    v = validator()
    msp0 = v.msp
    idemix.IdemixMSP.verify = verify
    db.stage2 = capture_s2
    kernels.reset_counts()
    try:
        first_t, rest_t = {}, {}
        res, first_s, host1, pipe1, _ = run_channel(v, wire[:1], dev, first_t)
        rest, secs, host2, pipe2, marks = run_channel(v, wire[1:], dev, rest_t)
    finally:
        idemix.IdemixMSP.verify = orig_verify
        db.stage2 = orig_stage2
    counts = dict(kernels.launches)
    proofs_path = {"n": proofs["n"], "seconds": proofs["seconds"]}
    res += rest
    rotated = v.msp is not msp0
    reverified = sum(1 for pairs in proofs["by_sig"].values()
                     if {e for e, _ in pairs} >= {0, 1})

    # the same blocks forced onto the host path
    kernels.reset_counts()
    with first_mvcc_validate() as seen_mvcc:
        href, host_s, _, _, _ = run_channel(validator(), wire, dev, host_only=True)
    host_counts = dict(kernels.launches)

    rows = lambda x: sorted((k, vv.value, vv.version) for k, vv in x.batch.items())
    for a, b in zip(res, href, strict=True):
        if a.tx_filter != b.tx_filter or rows(a) != rows(b) or a.history != b.history:
            raise AssertionError(f"config5 block {a.block.number}: the pipeline differs from "
                                 "the port's host path")
    bad = [(r.block.number, i, c, int(w)) for r, want in zip(res, built["expected"])
           for i, (c, w) in enumerate(zip(r.tx_filter, want)) if c != int(w)]
    if bad:
        raise AssertionError(f"config5 filters differ from construction at {bad[:10]}")
    host_route = sorted(set(host1 + host2))
    barriers = sorted(r.block.number for r in res if r.barrier)
    stale = pipe1.stale_prefetches + pipe2.stale_prefetches
    if host_route or barriers != [CONFIG5_ROTATE_AT] or not rotated or stale < 1 \
            or reverified == 0:
        raise AssertionError(f"config5: host-route blocks {host_route}, barriers {barriers}, "
                             f"MSP rotated {rotated}, stale re-preprocesses {stale}, proofs "
                             f"verified under both records {reverified}")
    if not seen_s2:
        raise AssertionError("config5: no fused stage 2 launched with a -2 creator lane")
    sv, lv, groups, sp, dims, got = seen_s2[0]
    want = db.stage2_ref(sv.cpu(), lv.cpu(), [(p, gp.cpu(), eb, s) for p, gp, eb, s in groups],
                         sp.cpu(), dims)
    s2_mism = int((got.cpu() != want).sum())
    if s2_mism:
        raise AssertionError(f"config5: stage2 on a frame with -2 creator lanes differs from "
                             f"stage2_ref in {s2_mism} bytes")
    mism = mvcc_mismatches(seen_mvcc, "config5")
    if check_launches:
        zero = [k for k in ("p256_verify", "stage2_policy", "stage2_mvcc") if counts[k] == 0]
        zero += [f"{k} (host path)" for k in ("p256_verify", "mvcc_validate")
                 if host_counts[k] == 0]
        if zero:
            raise AssertionError(f"kernels not launched on the config5 path: {zero}")
    k = len(wire) - 1
    n_tx = sum(len(b.data.data) for b in wire[1:])
    gaps = np.diff([0.0] + marks) * 1e3
    log("config5_path", blocks=len(wire), txs=sum(len(b.data.data) for b in wire), depth=2,
        routes=["fused"] * len(res), barrier_blocks=barriers, msp_rotated=rotated,
        stale_reprocessed=stale, proofs_verified_under_both_records=reverified,
        codes=[{int(c): n for c, n in sorted(Counter(r.tx_filter).items())} for r in res],
        host_creator_lanes=[sum(p.host_creator_ok for p in r.pend.txs) for r in res],
        first_block_ms=1e3 * first_s,
        first_block_phase_ms={key: 1e3 * t for key, t in sorted(first_t.items())},
        per_block_ms=1e3 * secs / k, tx_per_s=n_tx / secs,
        phase_ms_per_block={key: 1e3 * t / k for key, t in sorted(rest_t.items())},
        completion_gap_ms=[float(g) for g in gaps],
        idemix_verifies=proofs_path["n"],
        idemix_verify_ms_per_presentation=1e3 * proofs_path["seconds"] / proofs_path["n"],
        idemix_verify_ms_per_block=1e3 * proofs_path["seconds"] / len(wire),
        launches={n: counts[n] for n in MAIN_PATH_KERNELS},
        host_path_launches={n: host_counts[n] for n in MAIN_PATH_KERNELS},
        host_path_per_block_ms=1e3 * host_s / len(wire),
        stage2_minus2_lanes=int((lv[:, 0] == -2).sum()), stage2_checked_T=int(lv.shape[0]),
        stage2_mismatches=s2_mism,
        mvcc_validate_checked_lanes=(int(seen_mvcc[0][0][0].shape[0]) if seen_mvcc else 0),
        mvcc_validate_mismatches=mism, equal_to_host_path=True, equal_to_construction=True)
    return counts


# ---------------------------------------------------------------------------
# The ledger and catch-up: KVLedger over a block store and sqlite state


LEDGER_BLOCKS = 12     # bench.py::_bench_chain_replay's chain: 12 blocks of 1,000 txs
LEDGER_CRASH_AT = 8    # ledger.apply.before fires as block 8 applies
LEDGER_SNAP_AT = 6     # the snapshot's height
LEDGER_KERNELS = ("p256_verify", "stage2_policy", "stage2_mvcc")


def build_ledger(n_blocks=LEDGER_BLOCKS, n_tx=BLOCK_TXS, sign_batch=card_signer):
    """The wire network's chained blocks 0..n-1 (``build_wire_blocks``:
    3 orgs, a 2-of-3 policy, 2 reads and 2 writes a tx, every 20th tx
    invalid) as bytes, their expected filters and the seed rows."""
    t0 = time.perf_counter()
    wn = WireNet(SEED + 31, sign_batch=sign_batch)
    blocks, expected, rows, _ = build_wire_blocks(wn, n_blocks, n_tx, sign_batch=sign_batch,
                                                  chained=True)
    return {"raw": [b.serialize() for b in blocks], "expected": expected, "rows": rows,
            "msp": wn.msp, "roots": [(o.msp_id, o.ca.cert_pem) for o in wn.orgs],
            "n_tx": n_blocks * n_tx, "build_s": time.perf_counter() - t0}


def _seeded_ledger(path, rows, async_commit):
    """A ``KVLedger`` over sqlite with history, its state seeded (no
    savepoint) before block 0, as the reference's bench seeds it."""
    from fabric_tpu_torch.ledger.kvledger import KVLedger
    from fabric_tpu_torch.ledger.statedb import UpdateBatch

    lg = KVLedger(path, async_commit=async_commit)
    seed = UpdateBatch()
    for ns, key, value, ver in rows:
        seed.put(ns, key, value, ver)
    lg.state.apply_updates(seed)
    lg.drain_state()
    return lg


def _ledger_validator(dev, lg, built, **kw):
    from fabric_tpu_torch import carry
    from fabric_tpu_torch.peer.validator import BlockValidator

    _, prov, _ = carry.from_reference([], WIRE_NAMESPACES, [])
    return BlockValidator(prov, lg.state, block_store=lg.blocks, device=dev, msp=built["msp"],
                          **kw)


def _ledger_commit(lg):
    return lambda res: lg.commit_block(res.pend.wire, res.tx_filter, res.batch, res.history,
                                       None, res.txids, res.pend.hd_bytes)


def _commit_blocks(v, lg, raw) -> list:
    """Wire blocks parsed from ``raw`` through ``CommitPipeline(depth=2)``
    into ``lg`` → [CommittedBlock]."""
    from fabric_tpu_torch.peer.pipeline import CommitPipeline
    from fabric_tpu_torch.protos import messages as m

    out = []
    with CommitPipeline(v, _ledger_commit(lg), depth=2) as pipe:
        for r in raw:
            got = pipe.submit(m.Block.parse(r))
            if got is not None:
                out.append(got)
        tail = pipe.flush()
        if tail is not None:
            out.append(tail)
    return out


def _ledger_view(lg) -> dict:
    first = (lg.blocks.bootstrap_info() or (0,))[0]
    return {"height": lg.height, "commit_hash": (lg.commit_hash or b"").hex(),
            "digest": lg.state_digest(),
            "blocks": [b.serialize() for b in lg.blocks.iter_blocks(first)]}


def _same_ledger(name, got, want, keys=("height", "commit_hash", "digest")):
    bad = [k for k in keys if got[k] != want[k]]
    if bad:
        raise AssertionError(f"ledger_path {name}: {bad} differ from the source ledger "
                             f"({ {k: got[k] for k in bad if k != 'blocks'} } against "
                             f"{ {k: want[k] for k in bad if k != 'blocks'} })")


def _need_launches(name, counts, kernels_needed, check):
    zero = [k for k in kernels_needed if counts.get(k, 0) == 0]
    if check and zero:
        raise AssertionError(f"ledger_path {name}: kernels not launched: {zero}")


def _per_block_ms(d: dict, n: int) -> dict:
    return {k: 1e3 * t / n for k, t in sorted(d.items())}


def phase_ledger_path(dev, built=None, check_launches=True):
    """The ledger and its catch-up paths on ``dev``: the chain through
    ``CommitPipeline(depth=2)`` into a ``KVLedger`` (sqlite state,
    history, the async applier), each filter equal to construction;
    reopened equal; a ledger stopped by ``ledger.apply.before`` at block
    8, reopened and recovered through a ``BlockValidator`` on ``dev``,
    then given the rest, equal to the source; ``replay_into`` from the
    source's block store into a fresh ledger, equal; a snapshot of the
    chain at height 6, a ledger created from it, its resident table
    warmed from the snapshot, and the suffix replayed, equal.  Every
    check raises.  The ledgers live in a temporary directory removed at
    the end."""
    import itertools
    import shutil
    import tempfile

    from fabric_tpu_torch import faults, kernels
    from fabric_tpu_torch.ledger import snapshot
    from fabric_tpu_torch.ledger.kvledger import KVLedger, validating_replayer
    from fabric_tpu_torch.peer.replay import ReplayCheckpoint, ReplayDriver, replay_into

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    if built is None:
        built = build_ledger()
    raw, rows, n_tx = built["raw"], built["rows"], built["n_tx"]
    n_blocks = len(raw)
    log("ledger_build", blocks=n_blocks, txs=n_tx, seconds=built["build_s"],
        state_rows=len(rows), block_bytes=sum(len(r) for r in raw))
    root = tempfile.mkdtemp(prefix="fabtorch-ledger-")
    try:
        # -- the source ledger -------------------------------------------------
        src_dir = os.path.join(root, "source")
        src = _seeded_ledger(src_dir, rows, async_commit=True)
        v = _ledger_validator(dev, src, built)
        v.timings = {}
        kernels.reset_counts()
        sync()
        t0 = time.perf_counter()
        res = _commit_blocks(v, src, raw)
        src.drain_state()
        sync()
        secs = time.perf_counter() - t0
        counts = dict(kernels.launches)
        got = [bytes(r.tx_filter) for r in res]
        if got != built["expected"]:
            bad = [(b, i, g[i], w[i]) for b, (g, w) in enumerate(zip(got, built["expected"]))
                   for i in range(len(w)) if g[i] != w[i]]
            raise AssertionError(f"ledger_path source: filters differ from construction at "
                                 f"{bad[:10]}")
        _need_launches("source", counts, LEDGER_KERNELS, check_launches)
        want = _ledger_view(src)
        if want["height"] != n_blocks:
            raise AssertionError(f"ledger_path source: height {want['height']}")
        log("ledger_source", blocks=n_blocks, txs=n_tx, depth=2, async_commit=True,
            seconds=secs, per_block_ms=1e3 * secs / n_blocks,
            phase_ms_per_block={**_per_block_ms(v.timings, n_blocks),
                                **_per_block_ms(src.commit_seconds, n_blocks)},
            fsyncs=src.blocks.stats()["fsyncs"], applier=src.engine.stats(),
            equal_to_construction=True, launches=counts)
        src.close()

        # -- reopen ------------------------------------------------------------
        src = KVLedger(src_dir)
        again = _ledger_view(src)
        _same_ledger("reopen", again, want, keys=("height", "commit_hash", "digest", "blocks"))
        log("ledger_reopen", height=again["height"], commit_hash=again["commit_hash"],
            digest=again["digest"], blocks_equal=True, equal=True)

        # -- crash and recover ---------------------------------------------------
        crash_dir = os.path.join(root, "crash")
        lg = _seeded_ledger(crash_dir, rows, async_commit=True)
        plan = faults.configure(f"ledger.apply.before:raise:after={LEDGER_CRASH_AT}:n=1")
        try:
            _commit_blocks(_ledger_validator(dev, lg, built), lg, raw)
            lg.drain_state()
        except RuntimeError as e:
            if not isinstance(e.__cause__, faults.InjectedFault):
                raise
        else:
            raise AssertionError("ledger_path crash: the armed fault did not stop the ledger")
        finally:
            faults.reset()
        if plan.fired("ledger.apply.before") != 1:
            raise AssertionError(f"ledger_path crash: fault plan {plan.stats()}")
        stopped = lg.height
        lg.abort()
        lg = KVLedger(crash_dir)
        sp = lg.state.savepoint()
        if tuple(sp) != (LEDGER_CRASH_AT - 1, 0):
            raise AssertionError(f"ledger_path crash: savepoint {sp} after reopen")
        v = _ledger_validator(dev, lg, built)
        kernels.reset_counts()
        sync()
        t0 = time.perf_counter()
        recovered = lg.recover(validating_replayer(v, lg.blocks))
        sync()
        rec_s = time.perf_counter() - t0
        rec_counts = dict(kernels.launches)
        _need_launches("recover", rec_counts, LEDGER_KERNELS, check_launches)
        rest = raw[lg.height:]
        _commit_blocks(_ledger_validator(dev, lg, built), lg, rest)
        _same_ledger("crash and recover", _ledger_view(lg), want)
        log("ledger_crash", fault="ledger.apply.before", at_block=LEDGER_CRASH_AT,
            height_at_stop=stopped, savepoint_after_reopen=list(sp),
            recovered_blocks=recovered, recover_ms=1e3 * rec_s,
            recover_ms_per_block=1e3 * rec_s / max(recovered, 1), redelivered_blocks=len(rest),
            launches=rec_counts, digest_equal=True, commit_hash_equal=True)
        lg.close()

        # -- replay from the source's block store ---------------------------------
        dst = _seeded_ledger(os.path.join(root, "replay"), rows, async_commit=True)
        v = _ledger_validator(dev, dst, built)
        v.timings = {}
        ckpt = os.path.join(root, "replay.ckpt")
        kernels.reset_counts()
        sync()
        stats = replay_into(dst, v, src.blocks, depth=2, checkpoint=ckpt)
        sync()
        counts = dict(kernels.launches)
        _need_launches("replay", counts, LEDGER_KERNELS, check_launches)
        _same_ledger("replay", _ledger_view(dst), want, keys=("height", "commit_hash", "digest",
                                                               "blocks"))
        if ReplayCheckpoint(ckpt).load() != n_blocks:
            raise AssertionError(f"ledger_path replay: checkpoint {ReplayCheckpoint(ckpt).load()}")
        first_s, k = stats["first_commit_s"], stats["blocks"] - 1
        log("ledger_replay", blocks=stats["blocks"], txs=n_tx, depth=2, seconds=stats["seconds"],
            first_block_ms=1e3 * first_s,
            per_block_ms_after_first=1e3 * (stats["seconds"] - first_s) / k,
            per_block_ms=1e3 * stats["seconds"] / stats["blocks"],
            tx_per_s=n_tx / stats["seconds"], valid_tx_per_s=stats["tx_per_s"],
            phase_ms_per_block={**_per_block_ms(v.timings, stats["blocks"]),
                                **_per_block_ms(dst.commit_seconds, stats["blocks"])},
            fsyncs=dst.blocks.stats()["fsyncs"], applier=dst.engine.stats(),
            checkpoint=ReplayCheckpoint(ckpt).load(), launches=counts,
            digest_equal=True, commit_hash_equal=True, blocks_equal=True)
        full_replay_s = stats["seconds"]
        dst.close()

        # -- snapshot join --------------------------------------------------------
        six = _seeded_ledger(os.path.join(root, "six"), rows, async_commit=False)
        ReplayDriver(_ledger_validator(dev, six, built), _ledger_commit(six), depth=2).run(
            itertools.islice(src.blocks.iter_blocks(0), LEDGER_SNAP_AT))
        if six.height != LEDGER_SNAP_AT:
            raise AssertionError(f"ledger_path join: the snapshot ledger's height {six.height}")
        snap_dir = os.path.join(root, "snapshot")
        t0 = time.perf_counter()
        meta = snapshot.generate_snapshot(six, snap_dir, channel_id="smokechan")
        export_s = time.perf_counter() - t0
        six.close()
        t0 = time.perf_counter()
        joined, _ = snapshot.create_from_snapshot(snap_dir, os.path.join(root, "joined"),
                                                  async_commit=True)
        import_s = time.perf_counter() - t0
        v = _ledger_validator(dev, joined, built, state_resident=True)
        t0 = time.perf_counter()
        warmed = snapshot.warm_resident(v.resident, snap_dir)
        warm_s = time.perf_counter() - t0
        n_records = sum(1 for _ in snapshot.iter_state_records(snap_dir))
        if warmed != n_records:
            raise AssertionError(f"ledger_path join: warmed {warmed} of {n_records} keys")
        kernels.reset_counts()
        sync()
        jstats = replay_into(joined, v, src.blocks, depth=2)
        sync()
        jcounts = dict(kernels.launches)
        _need_launches("join", jcounts, LEDGER_KERNELS + ("resident_verok", "table_scatter"),
                       check_launches)
        _same_ledger("join", _ledger_view(joined), want)
        if jstats["resumed_from"] != LEDGER_SNAP_AT:
            raise AssertionError(f"ledger_path join: resumed from {jstats['resumed_from']}")
        res_stats = v.resident.stats()
        join_s = export_s + import_s + warm_s + jstats["seconds"]
        log("ledger_join", snapshot_height=meta["height"], state_records=n_records,
            keys_warmed=warmed, export_ms=1e3 * export_s, import_ms=1e3 * import_s,
            warm_ms=1e3 * warm_s, suffix_blocks=jstats["blocks"],
            suffix_ms=1e3 * jstats["seconds"],
            suffix_ms_per_block=1e3 * jstats["seconds"] / jstats["blocks"],
            join_ms=1e3 * join_s, full_replay_ms=1e3 * full_replay_s,
            resident_hits=res_stats["hits_total"], resident_misses=res_stats["misses_total"],
            launches=jcounts, digest_equal=True, commit_hash_equal=True)
        joined.close()
        src.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("ledger_path", blocks=n_blocks, txs=n_tx, equal=True)


# the observe hooks on the card (observe/{tracer,ledger,txflow,overlap}.py)
OBSERVE_BLOCKS = 6        # the ledger's first 6 blocks
OBSERVE_TURNS = 3         # armed and disarmed in turns, ABABAB
OBSERVE_RING = 64         # the global tracer's ring while armed
OBSERVE_SIGN_DIGESTS = 64
OBSERVE_STAGES = ("prefetch", "prefetch_wait", "launch", "finish", "commit_wait", "commit")
# the validator's stage spans under the pipeline's (BlockValidator._t)
OBSERVE_NESTED = {"prefetch": {"host_parse", "sig_prepare_launch", "device_pre", "hd_frame"},
                  "launch": {"state_fill", "stage2_dispatch"},
                  "finish": {"device_wait", "postprocess"}}
# ledger kernel name → the launch counter that kernel's record stands for
OBSERVE_ROWS = {"verify": "p256_verify", "stage2": "stage2_mvcc",
                "resident_scatter": "table_scatter", "sign": "p256_sign"}


def _identity_ok(r) -> bool:
    """The reference's attribution identity (tests/test_ledger.py:626-632)."""
    parts = r["compile_ms"] + r["queue_ms"] + r["execute_ms"] + r["h2d_ms"]
    return abs(r["wall_ms"] - parts) <= 0.05 * r["wall_ms"] + r["dispatch_ms"] + 0.01


def _observe_sign_burst(dev, reg):
    """64 digests from 8 threads through the card's ``SignBatcher``
    under the armed ledger, its observer the journal's → (launches,
    seconds); signatures equal to the serial oracle's."""
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.observe import txflow
    from fabric_tpu_torch.peer import signlane

    d = 0x5EED0B5 + SEED
    digests = [int.from_bytes(np.random.default_rng(SEED + 41 + i).bytes(32), "big")
               for i in range(OBSERVE_SIGN_DIGESTS)]
    before = kernels.launches["p256_sign"]
    t0 = time.perf_counter()
    with signlane.SignBatcher(signlane.device_sign_backend(d, device=dev), batch_max=64,
                              wait_ms=5.0, registry=reg,
                              observer=txflow.sign_observer()) as sb:
        with ThreadPoolExecutor(8) as ex:
            sigs = list(ex.map(sb.sign_digest, digests))
    secs = time.perf_counter() - t0
    if sigs != signlane.cpu_sign_backend(d)(digests):
        raise AssertionError("observe_path: the sign burst differs from the serial oracle")
    return kernels.launches["p256_sign"] - before, secs


def _observe_run(dev, built, root_dir, name, armed, sign=False):
    """The ledger's first ``OBSERVE_BLOCKS`` wire blocks through
    ``CommitPipeline(depth=2)`` into a fresh sqlite ``KVLedger`` (a
    copy of ``root_dir``'s seeded ``seed`` ledger) with the async
    applier, over a ``state_resident=True`` validator.  Armed: the
    global tracer's ring on, the launch ledger and the tx-flow journal
    on private registries (``sign``: then the sign burst, same ledger);
    disarmed: the ring at 0, ledger and journal off.  The pipe's own
    metrics go to a private registry either way."""
    import shutil

    from fabric_tpu_torch import kernels, observe
    from fabric_tpu_torch.ledger.kvledger import KVLedger
    from fabric_tpu_torch.observe import ledger, txflow
    from fabric_tpu_torch.ops_metrics import Registry
    from fabric_tpu_torch.peer.pipeline import CommitPipeline
    from fabric_tpu_torch.protos import messages as m

    blocks = [m.Block.parse(r) for r in built["raw"][:OBSERVE_BLOCKS]]
    shutil.copytree(os.path.join(root_dir, "seed"), os.path.join(root_dir, name))
    lg = KVLedger(os.path.join(root_dir, name), async_commit=True)
    v = _ledger_validator(dev, lg, built, state_resident=True)
    reg, lreg = Registry(), Registry()
    tr = observe.global_tracer()
    observe.configure(ring_blocks=OBSERVE_RING if armed else 0)
    led = ledger.configure(registry=lreg, tracer=tr) if armed else ledger.configure(False)
    journal = txflow.configure(registry=reg, tracer=tr) if armed else txflow.configure(False)
    first = {k: kernels.first_launch(c) for k, c in OBSERVE_ROWS.items()}
    kernels.reset_counts()
    out = []
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    with CommitPipeline(v, _ledger_commit(lg), depth=2, channel=name, registry=reg) as pipe:
        for b in blocks:
            got = pipe.submit(b)
            if got is not None:
                out.append(got)
        got = pipe.flush()
        if got is not None:
            out.append(got)
    lg.drain_state()
    sync()
    secs = time.perf_counter() - t0
    counts = dict(kernels.launches)
    run = {"name": name, "armed": armed, "secs": secs, "res": out, "counts": counts,
           "view": {"height": lg.height, "commit_hash": lg.commit_hash,
                    "digest": lg.state_digest()},
           "reg": reg, "first": first,
           "tables": len(v._stage2._tables)}
    if armed:
        run["roots"] = [r for r in tr.recent_roots() if r.attrs.get("channel") == name]
        table = v.resident._table
        run["table_bytes"] = None if table is None else table.nbytes
        if cuda:
            run["live"] = (ledger.live_device_bytes(dev), torch.cuda.memory_allocated(dev))
        if sign:
            run["sign"] = _observe_sign_burst(dev, reg)
        run["lreg"], run["journal"] = lreg, journal
        run["ledger_stats"], run["rows"] = led.stats(), led.rows()
    ledger.configure(False)
    txflow.configure(False)
    observe.configure(ring_blocks=observe.DEFAULT_RING_BLOCKS)
    lg.close()
    v.close()
    return run


def _check_observed(run, expected, check_launches):
    """Every check of the armed run ``run``; raises on the first miss."""
    from fabric_tpu_torch.peer.txcodes import TxValidationCode

    name = run["name"]
    fail = lambda what: AssertionError(f"observe_path {name}: {what}")
    roots, res = run["roots"], run["res"]
    if [bytes(r.tx_filter) for r in res] != expected:
        raise fail("filters differ from construction")
    # -- span trees ------------------------------------------------------------
    if sorted(r.attrs["block"] for r in roots) != [r.block.number for r in res]:
        raise fail(f"roots {[r.attrs['block'] for r in roots]}: not one a block")
    fused = 0
    for root in roots:
        by = {}
        for c in root.children:
            by.setdefault(c.name, []).append(c)
        for st in OBSERVE_STAGES:
            if len(by.get(st, ())) != 1:
                raise fail(f"block {root.attrs['block']}: {len(by.get(st, ()))} {st} spans")
            sp = by[st][0]
            if sp.t1 is None or sp.t0 < root.t0 - 1e-6 or sp.t1 > root.t1 + 1e-6:
                raise fail(f"block {root.attrs['block']}: {st} outside the root's window")
        want_thread = {"prefetch": "fabtpu-prefetch", "prefetch_wait": "MainThread",
                       "launch": "MainThread", "finish": "MainThread",
                       "commit_wait": "MainThread",
                       "commit": "MainThread" if root.attrs.get("tail") else "fabtpu-committer"}
        for st, th in want_thread.items():
            if not by[st][0].thread.startswith(th):
                raise fail(f"block {root.attrs['block']}: {st} on {by[st][0].thread}")
        for st, need in OBSERVE_NESTED.items():
            have = {c.name for c in by[st][0].children}
            if not need <= have:
                raise fail(f"block {root.attrs['block']}: {st} lacks {sorted(need - have)}")
        fused += bool(by["launch"][0].attrs.get("device"))
    if not roots[-1].attrs.get("tail"):
        raise fail("the last block's root has no tail mark")
    # -- ledger rows ---------------------------------------------------------------
    rows, counts = run["rows"], run["counts"]
    by_kernel = Counter(r["kernel"] for r in rows)
    verify_rows = [r for r in rows if r["kernel"] == "verify"]
    if len(verify_rows) != len(res) or by_kernel["stage2"] != fused:
        raise fail(f"{len(verify_rows)} verify and {by_kernel['stage2']} stage2 rows for "
                   f"{len(res)} blocks, {fused} fused")
    if sum(r["wall_ms"] is None for r in verify_rows) != fused:
        raise fail("a fused block's verify row was not completed enqueue-only")
    if check_launches:
        for k in ("resident_scatter", "sign"):
            launched = counts[OBSERVE_ROWS[k]] if k != "sign" else run.get("sign", (0,))[0]
            if by_kernel[k] != launched:
                raise fail(f"{by_kernel[k]} {k} rows for {launched} launches")
    bad = [r for r in rows if r["wall_ms"] is not None and not _identity_ok(r)]
    if bad:
        raise fail(f"rows off the attribution identity: {bad[:3]}")
    misses = Counter(r["kernel"] for r in rows if r["cache"] == "miss")
    want = {k: int(run["first"][k]) for k in ("verify", "resident_scatter", "sign")}
    want["stage2"] = run["tables"] if fused else 0
    if check_launches and {k: misses[k] for k in want} != want:
        raise fail(f"cache misses {dict(misses)}, expected {want} (a miss is the kernel's "
                   "first launch in the process, for stage 2 a policy table built)")
    # -- registry ------------------------------------------------------------------------
    snap = run["lreg"].counter("device_launches_total").snapshot()
    per = Counter()
    for key, n in snap.items():
        per[dict(key)["kernel"]] += n
    if dict(per) != dict(by_kernel):
        raise fail(f"device_launches_total {dict(per)} against rows {dict(by_kernel)}")
    blocks_total = sum(run["reg"].counter("commit_pipeline_blocks_total").snapshot().values())
    if blocks_total != len(res):
        raise fail(f"commit_pipeline_blocks_total {blocks_total}")
    # -- tx-flow journal --------------------------------------------------------------
    flows: dict = {}
    for r in run["journal"].rows():
        if (r["outcome"] != TxValidationCode(r["code"]).name
                or list(r["milestones"]) != ["included", "durable", "applied"]):
            raise fail(f"journal row {r}")
        flows.setdefault(r["block"], Counter())[(r["tx_id"], r["code"])] += 1
    for cb in res:
        want_flows = Counter((p.txid, int(cb.tx_filter[p.idx])) for p in cb.pend.txs if p.txid)
        if flows.get(cb.block.number) != want_flows:
            raise fail(f"block {cb.block.number}: the journal's verdicts differ from its filter")
    waits = run["journal"].stats()["sign_wait_ms"] or {"n": 0}
    if waits["n"] != OBSERVE_SIGN_DIGESTS * ("sign" in run):
        raise fail(f"sign_wait samples {waits}")
    # -- device memory ------------------------------------------------------------------
    hbm = run["ledger_stats"]["hbm"]
    if hbm.get("resident_table", {}).get("current_bytes") != run["table_bytes"]:
        raise fail(f"hbm.resident_table {hbm.get('resident_table')} against the table's "
                   f"{run['table_bytes']} bytes")
    if "live" in run and run["live"][0] != run["live"][1]:
        raise fail(f"live_device_bytes {run['live'][0]} against memory_allocated "
                   f"{run['live'][1]}")
    return fused


def _observe_annotations(dev, built, root_dir) -> tuple:
    """One armed block's preprocess and launch on this thread under
    ``torch.profiler``'s CPU activity (it records the capturing thread's
    events only), its finish after → (the events' names, the ledger's
    rows, the captured seconds)."""
    from torch.profiler import ProfilerActivity, profile

    from fabric_tpu_torch import observe
    from fabric_tpu_torch.ledger.kvledger import KVLedger
    from fabric_tpu_torch.observe import ledger
    from fabric_tpu_torch.ops_metrics import Registry
    from fabric_tpu_torch.protos import messages as m

    lg = KVLedger(os.path.join(root_dir, "seed"))
    v = _ledger_validator(dev, lg, built, state_resident=True)
    block = m.Block.parse(built["raw"][0])
    led = ledger.configure(registry=Registry(), tracer=observe.global_tracer())
    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pend = v.validate_launch(block, pre=v.preprocess(block))
        secs = time.perf_counter() - t0
        v.validate_finish(pend)
        return {e.name for e in prof.events()}, led.rows(), secs
    finally:
        ledger.configure(False)
        lg.close()
        v.close()


def phase_observe_path(dev, built=None, check_launches=True):
    """The observe hooks on ``dev`` at the ledger's first 6 wire blocks:
    ``CommitPipeline(depth=2)`` into a fresh sqlite ``KVLedger`` (async
    applier) over ``state_resident=True``, armed (the global tracer, the
    launch ledger and the tx-flow journal on private registries) and
    disarmed (the tracer's ring at 0, ledger and journal off) in turns,
    ABABAB; the first armed run also signs a 64-digest burst through
    the card's ``SignBatcher``.  Checks, each raising: one root a block
    with the six stage spans once each, inside its window, on the
    reference's threads, the validator's stages under them; one verify
    row a block (enqueue-only when fused) and one stage-2 row a fused
    block; scatter and sign rows equal to their launches; every synced
    row on the attribution identity; a miss exactly where the kernel
    launched first in the process (for stage 2, where a policy table
    was built); ``device_launches_total`` equal to the rows and
    ``commit_pipeline_blocks_total`` to the blocks; every transaction's
    journal row included, durable, applied with its filter's verdict;
    the resident table's bytes on ``hbm.resident_table``;
    ``live_device_bytes()`` equal to ``torch.cuda.memory_allocated()``;
    every run's filters, digest and commit hash equal.  Then one armed
    block under ``torch.profiler`` must show ``fabtpu.verify_dispatch``
    and ``fabtpu.stage2_dispatch``.  Prints the cost a block, the
    ledger's decomposition by kernel, coverage and the journal's
    stages."""
    import shutil
    import tempfile

    from fabric_tpu_torch import observe
    from fabric_tpu_torch.utils.stats import nearest_rank

    if built is None:
        built = build_ledger()
    expected = built["expected"][:OBSERVE_BLOCKS]
    root_dir = tempfile.mkdtemp(prefix="fabtorch-observe-")
    t_phase = time.perf_counter()
    try:
        _seeded_ledger(os.path.join(root_dir, "seed"), built["rows"], async_commit=True).close()
        runs = []
        for turn in range(OBSERVE_TURNS):
            for armed in (True, False):
                runs.append(_observe_run(dev, built, root_dir,
                                         f"obs{turn}{'a' if armed else 'd'}", armed,
                                         sign=armed and turn == 0))
        names, prof_rows, prof_s = _observe_annotations(dev, built, root_dir)
    finally:
        shutil.rmtree(root_dir, ignore_errors=True)
    armed_runs = [r for r in runs if r["armed"]]
    fused = [_check_observed(r, expected, check_launches) for r in armed_runs]
    base = runs[0]
    for r in runs[1:]:
        if [bytes(c.tx_filter) for c in r["res"]] != expected:
            raise AssertionError(f"observe_path {r['name']}: filters differ")
        _same_ledger(f"observe {r['name']}", r["view"], base["view"],
                     keys=("height", "commit_hash", "digest"))
    missing = {"fabtpu.verify_dispatch", "fabtpu.stage2_dispatch"} - names
    if missing:
        raise AssertionError(f"observe_path: the profiled block shows no {sorted(missing)}")
    ms = lambda r: 1e3 * r["secs"] / OBSERVE_BLOCKS
    a_ms = [ms(r) for r in runs if r["armed"]]
    d_ms = [ms(r) for r in runs if not r["armed"]]
    med = lambda x: sorted(x)[len(x) // 2]
    log("observe_cost", blocks=OBSERVE_BLOCKS, turns="ABABAB", armed_ms_per_block=a_ms,
        disarmed_ms_per_block=d_ms, armed_median=med(a_ms), disarmed_median=med(d_ms),
        cost_ms_per_block=med(a_ms) - med(d_ms),
        cost_pct=100.0 * (med(a_ms) - med(d_ms)) / med(d_ms))
    first = armed_runs[0]
    log("observe_ledger", kernels=first["ledger_stats"]["kernels"],
        hbm=first["ledger_stats"]["hbm"], sign_launches=first["sign"][0],
        sign_burst_s=first["sign"][1],
        profiled_block={"rows": [{k: r[k] for k in ("kernel", "cache", "dispatch_ms",
                                                    "compile_ms", "queue_ms", "execute_ms",
                                                    "h2d_bytes", "d2h_bytes", "wall_ms")}
                                 for r in prof_rows]})
    cov = observe.coverage_from_roots(first["roots"], window=1)
    log("observe_coverage", window=1, mean=cov["mean"], p50=cov["p50"], min=cov["min"],
        per_block=cov["per_block"])
    stages = {}
    for root in first["roots"]:
        for c in root.children:
            stages.setdefault(c.name, []).append(1e3 * c.dur)
    jst = first["journal"].stats()
    log("observe_txflow", flows_completed=jst["flows_completed"],
        flows_partial=jst["flows_partial"], stages_ms=jst["stages_ms"], e2e_ms=jst["e2e_ms"],
        visibility_lag_ms=jst["visibility_lag_ms"], sign_wait_ms=jst["sign_wait_ms"])
    log("observe_path", blocks=OBSERVE_BLOCKS, runs=len(runs), fused_blocks=fused,
        span_ms_p50={k: nearest_rank(sorted(v), 50) for k, v in sorted(stages.items())},
        launches=first["counts"], profiled_s=prof_s, seconds=time.perf_counter() - t_phase,
        filters_digest_commit_hash_equal=True, checks_passed=True)


# the commit path under failure (bench.py::_bench_block_commit_chaos :1042)
CHAOS_SPEC = ("validator.verify_launch:raise:p=0.35;validator.stage2:raise:n=1:after=3;"
              "hostpool.task:raise:n=1:after=6;pipeline.prefetch:disconnect:n=1:after=6;"
              "pipeline.commit:raise:n=1:after=2")
CHAOS_SEED = 20260803
CHAOS_GUARD = {"device_fail_threshold": 2, "device_retries": 1,  # bench.py:1070-1072
               "device_recovery_s": 0.2}
CHAOS_COALESCE = 2          # groups of 2 through preprocess_many, so the pool's tasks run
CHAOS_RESIDENT_BLOCKS = 6   # the resident variant's blocks; a commit scatter fails at the 2nd
CHAOS_SIDECAR_BLOCKS = 8    # the sidecar variant's: stopped after block 3, back before 6
CHAOS_SIDECAR_RECOVERY_S = 0.2
# (a)'s kernels: a fault never sends a block to ``_validate_host`` (``mvcc_validate``)
CHAOS_KERNELS = ("p256_verify", "stage2_policy", "stage2_mvcc")
CHAOS_RING = 64  # the device lane's private tracer: every root, re-runs included
CHAOS_SPAN_STAGES = ("prefetch_wait", "launch", "finish", "commit_wait", "commit")


def _host_path_blocks(v) -> list:
    """Record the numbers of the blocks that take ``v._validate_host``
    (policy in Python, MVCC by ``mvcc_validate``) → the list it fills."""
    host, orig = [], v._validate_host
    v._validate_host = lambda p: host.append(p.block.number) or orig(p)
    return host


def _chaos_drive(v, lg, raw, coalesce, marks, tracer=None, fails=None):
    """The containment loop (``bench.py:1120-1140``): the wire blocks
    from the ledger's height through a ``CommitPipeline(depth=2)``; a
    stage exception of the plan's own types (``InjectedFault``, and the
    ``ConnectionResetError`` of ``disconnect``) closes the pipe, and a
    new one resumes from the committed height.  Any other exception
    fails the run.  ``marks`` receives (block, pipe, commit time, took
    the fallback) a commit; ``fails`` (when given) (the new pipe, the
    time the failure surfaced) a restart; ``tracer``: the pipes'.
    → (restarts, [(block, stage)])."""
    from fabric_tpu_torch import faults
    from fabric_tpu_torch.peer.pipeline import CommitPipeline
    from fabric_tpu_torch.peer.validator import _SyncedHandle
    from fabric_tpu_torch.protos import messages as m

    commit = _ledger_commit(lg)
    pipes = [0]

    def commit_fn(res):
        commit(res)
        h = res.pend.handle
        marks.append((res.block.number, pipes[0], time.perf_counter(),
                      isinstance(h, _SyncedHandle) or getattr(h, "fell_back", False)))

    restarts, failures = 0, []
    pipe = CommitPipeline(v, commit_fn, depth=2, coalesce_blocks=coalesce, tracer=tracer)
    try:
        while True:
            try:
                rest = [m.Block.parse(r) for r in raw[lg.height:]]
                if coalesce:
                    pipe.submit_many(rest)
                else:
                    for blk in rest:
                        pipe.submit(blk)
                pipe.flush()
                break
            except (faults.InjectedFault, ConnectionResetError):
                t_fail = time.perf_counter()
                restarts += 1
                failures.append(pipe.last_failure)
                if restarts > 50:
                    raise AssertionError("chaos_path: the containment loop does not converge")
                pipe.close(flush=False)
                pipes[0] += 1
                if fails is not None:
                    fails.append((pipes[0], t_fail))
                pipe = CommitPipeline(v, commit_fn, depth=2, coalesce_blocks=coalesce,
                                      tracer=tracer)
    finally:
        pipe.close(flush=False)
    return restarts, failures


def _block_walls(marks):
    """Per-block wall ms: each commit after the previous one of the same
    pipe (the first of a pipe is left out: it carries the restart) →
    ({block: ms}, {block: took the fallback})."""
    walls, lane = {}, {}
    prev = None
    for num, pipe, t, fallback in marks:
        lane[num] = fallback
        if prev is not None and prev[0] == pipe:
            walls[num] = 1e3 * (t - prev[1])
        prev = (pipe, t)
    return walls, lane


def _same_blocks(name, got, want):
    """CommittedBlocks against the fault-free run's: filters, update
    batches, history."""
    rows = lambda r: sorted((k, vv.value, vv.version) for k, vv in r.batch.updates.items())
    for a, b in zip(got, want):
        if (a.tx_filter, rows(a), a.history) != (b.tx_filter, rows(b), b.history):
            raise AssertionError(f"chaos_path {name}: block {a.block.number} differs from "
                                 "the fault-free run")


def phase_chaos_path(dev, built=None, check_launches=True):
    """The commit path under failure, on ``dev``, at the ledger path's
    blocks (12 chained wire blocks of 1,000 txs, 3 orgs, 2-of-3):
    (a) the blocks through a ``BlockValidator`` with the reference chaos
    bench's guard (threshold 2, 1 retry, a probe every 0.2 s) and a
    2-worker staging pool, ``CommitPipeline(depth=2)`` in coalesced
    groups of 2, under the seeded ``CHAOS_SPEC`` and the containment
    loop, into a sqlite ``KVLedger``: its height, commit hash, digest
    and blocks equal a fault-free run's, at least one restart and one
    fallback block, the guard's failures equal to the faults fired at
    its points, every main-path kernel launched, and no block on
    ``_validate_host`` that the fault-free run did not put there (a
    fallback block verifies on the card and keeps the fused stage 2);
    (b) ``state_resident=True`` with the second commit scatter failing:
    the cache ends disabled, no block reads the table after it, the
    verdicts are the fault-free run's, no block on the host path; (c) one ``SidecarValidator`` tenant whose server
    stops after block 3 and comes back on its port before block 6: the
    latch engages, those blocks verify on this card, a probe
    re-attaches, every failure falls between the stop and the restart,
    the verdicts are the fault-free run's.  Every check raises."""
    import shutil
    import tempfile

    from fabric_tpu_torch import carry, faults, kernels, observe
    from fabric_tpu_torch.sidecar import SidecarServer
    from fabric_tpu_torch.sidecar.validator import SidecarValidator
    from fabric_tpu_torch.utils.stats import nearest_rank

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    if built is None:
        built = build_ledger()
    raw, rows = built["raw"], built["rows"]
    n_blocks = len(raw)
    root = tempfile.mkdtemp(prefix="fabtorch-chaos-")
    try:
        # -- the fault-free run ---------------------------------------------------
        lg = _seeded_ledger(os.path.join(root, "clean"), rows, async_commit=True)
        v = _ledger_validator(dev, lg, built)
        clean_host = _host_path_blocks(v)
        sync()
        t0 = time.perf_counter()
        clean = _commit_blocks(v, lg, raw)
        lg.drain_state()
        sync()
        clean_s = time.perf_counter() - t0
        want = _ledger_view(lg)
        lg.close()
        if [bytes(r.tx_filter) for r in clean] != built["expected"]:
            raise AssertionError("chaos_path: the fault-free run differs from construction")

        # -- (a) the device lane under the plan --------------------------------------
        lg = _seeded_ledger(os.path.join(root, "chaos"), rows, async_commit=True)
        v = _ledger_validator(dev, lg, built, host_stage_workers=2, **CHAOS_GUARD)
        chaos_host = _host_path_blocks(v)
        plan = faults.FaultPlan(CHAOS_SPEC, seed=CHAOS_SEED)
        marks: list = []
        fails: list = []
        ctr = observe.Tracer(ring_blocks=CHAOS_RING, slow_factor=0)
        kernels.reset_counts()
        sync()
        t0 = time.perf_counter()
        faults.install(plan)
        try:
            restarts, failures = _chaos_drive(v, lg, raw, CHAOS_COALESCE, marks, tracer=ctr,
                                              fails=fails)
        finally:
            faults.reset()
        lg.drain_state()
        sync()
        chaos_s = time.perf_counter() - t0
        counts = dict(kernels.launches)
        got = _ledger_view(lg)
        lg.close()
        v.close()
        _same_ledger("chaos", got, want, keys=("height", "commit_hash", "digest", "blocks"))
        gst = v.device_guard.stats()
        injected = plan.fired("validator.verify_launch") + plan.fired("validator.stage2")
        if gst["failures_total"] != injected:
            raise AssertionError(f"chaos_path: the guard counted {gst['failures_total']} "
                                 f"failures for {injected} injected faults: a real fault?")
        if restarts < 1 or gst["fallback_blocks_total"] < 1:
            raise AssertionError(f"chaos_path: {restarts} restarts, "
                                 f"{gst['fallback_blocks_total']} fallback blocks")
        _need_launches("chaos", counts, CHAOS_KERNELS, check_launches)
        if set(chaos_host) != set(clean_host):
            raise AssertionError(f"chaos_path: blocks {sorted(set(chaos_host))} took the host "
                                 f"path, {sorted(set(clean_host))} without faults")
        walls, lane = _block_walls(marks)
        ms = sorted(walls.values())
        # the pipe's spans a block (its last root: a re-run after a
        # restart replaces the failed one), by lane, and each restart's
        # wait from the failure to its pipe's first commit
        last = {r.attrs["block"]: r for r in ctr.recent_roots()}
        spans = {k: {st: [] for st in CHAOS_SPAN_STAGES} for k in ("device", "fallback")}
        for num, r in last.items():
            if num in lane:
                for c in r.children:
                    if c.name in CHAOS_SPAN_STAGES:
                        spans["fallback" if lane[num] else "device"][c.name].append(1e3 * c.dur)
        span_p50 = {k: {st: nearest_rank(sorted(x), 50) if x else None for st, x in v_.items()}
                    for k, v_ in spans.items()}
        restart_ms = [1e3 * (min(t for _, p_, t, _ in marks if p_ == p) - t_fail)
                      for p, t_fail in fails if any(p_ == p for _, p_, _, _ in marks)]
        by_lane = {k: [w for b, w in walls.items() if lane[b] == (k == "fallback")]
                   for k in ("device", "fallback")}
        device_lane = {
            "blocks": n_blocks, "restarts": restarts, "failed_stages": failures,
            "faults": plan.stats(), "faults_fired": plan.fired(),
            "guard": gst, "launches": counts, "seconds": chaos_s,
            "host_path_blocks": sorted(set(chaos_host)),
            "block_ms_p50": nearest_rank(ms, 50), "block_ms_p99": nearest_rank(ms, 99),
            "block_ms_mean_by_lane": {k: (sum(x) / len(x) if x else None)
                                      for k, x in by_lane.items()},
            "blocks_by_lane": {k: len(x) for k, x in by_lane.items()},
            "fault_free_ms_per_block": 1e3 * clean_s / n_blocks,
            "span_ms_p50_by_lane": span_p50,
            "span_blocks_by_lane": {k: len(x["commit"]) for k, x in spans.items()},
            "restart_wait_ms": restart_ms,
            "restart_wait_ms_p50": nearest_rank(sorted(restart_ms), 50) if restart_ms else None,
            "digest_equal": True, "commit_hash_equal": True, "blocks_equal": True}
        log("chaos_device_lane", **device_lane)

        # -- (b) the resident cache's latch ------------------------------------------
        k_res = CHAOS_RESIDENT_BLOCKS
        lg = _seeded_ledger(os.path.join(root, "resident"), rows, async_commit=True)
        v = _ledger_validator(dev, lg, built, state_resident=True)
        res_host = _host_path_blocks(v)
        res = v.resident
        real_scatter, real_apply, real_read = res._scatter, res.apply_batch, res.read
        shot = {"applies": 0, "armed": False, "fired": 0}
        reads = []

        def scatter(idx, rows_):
            if shot["armed"] and not shot["fired"]:
                shot["fired"] += 1
                raise RuntimeError("table_scatter failed (injected by the smoke)")
            return real_scatter(idx, rows_)

        def apply_batch(batch):
            shot["applies"] += 1
            shot["armed"] = shot["applies"] == 2
            try:
                return real_apply(batch)
            finally:
                shot["armed"] = False

        res._scatter, res.apply_batch = scatter, apply_batch
        res.read = lambda fn, u: reads.append(res.enabled) or real_read(fn, u)
        kernels.reset_counts()
        sync()
        rgot = _commit_blocks(v, lg, raw[:k_res])
        lg.drain_state()
        sync()
        rcounts = dict(kernels.launches)
        rst = res.stats()
        lg.close()
        _same_blocks("resident", rgot, clean[:k_res])
        if shot["fired"] != 1 or res.enabled or rst["enabled"] or not all(reads):
            raise AssertionError(f"chaos_path resident: scatter failures {shot['fired']}, "
                                 f"enabled {rst['enabled']}, reads while enabled {reads}")
        if set(res_host) != set(clean_host) & {b.block.number for b in rgot}:
            raise AssertionError(f"chaos_path resident: blocks {res_host} took the host path")
        if len(reads) >= k_res or (check_launches and rcounts["resident_verok"] != len(reads)):
            raise AssertionError(f"chaos_path resident: {len(reads)} table reads, "
                                 f"{rcounts['resident_verok']} resident_verok launches")
        log("chaos_resident", blocks=k_res, scatter_failed_at_commit=2,
            table_reads=len(reads), blocks_on_host_reads=k_res - len(reads),
            enabled=rst["enabled"], launches=rcounts, equal_to_fault_free=True)

        # -- (c) the sidecar's latch and re-attach -----------------------------------
        k_sc = CHAOS_SIDECAR_BLOCKS
        srv = SidecarServer("127.0.0.1", 0, device=dev).start_background()
        port = srv.port
        lg = _seeded_ledger(os.path.join(root, "sidecar"), rows, async_commit=True)
        _, prov, _ = carry.from_reference([], WIRE_NAMESPACES, [])
        v = SidecarValidator(prov, lg.state, block_store=lg.blocks, device=dev,
                             msp=built["msp"], tenant="chaos",
                             sidecar_endpoint=f"127.0.0.1:{port}",
                             sidecar_recovery_s=CHAOS_SIDECAR_RECOVERY_S)
        guard = v.sidecar_guard
        from fabric_tpu_torch.peer.pipeline import CommitPipeline
        from fabric_tpu_torch.protos import messages as m

        scgot = []
        kernels.reset_counts()
        try:
            with CommitPipeline(v, _ledger_commit(lg), depth=2) as pipe:
                def feed(lo, hi):
                    for r in raw[lo:hi]:
                        out = pipe.submit(m.Block.parse(r))
                        if out is not None:
                            scgot.append(out)
                    out = pipe.flush()
                    if out is not None:
                        scgot.append(out)

                feed(0, 4)
                before_stop = guard.stats()
                srv.stop_background()
                t_stop = time.perf_counter()
                feed(4, 6)
                latched = guard.stats()
                srv = SidecarServer("127.0.0.1", port, device=dev).start_background()
                t_restart = time.perf_counter()
                time.sleep(CHAOS_SIDECAR_RECOVERY_S)
                feed(6, 7)  # the probe; the next block's launch then sees the re-armed lane
                feed(7, k_sc)
            sync()
            after = guard.stats()
            attached = v.link.attached
            srv_stats = srv.stats()
        finally:
            v.close()
            srv.stop_background()
            lg.close()
        sccounts = dict(kernels.launches)
        _same_blocks("sidecar", scgot, clean[:k_sc])
        if len(scgot) != k_sc:
            raise AssertionError(f"chaos_path sidecar: {len(scgot)} blocks committed")
        if (before_stop["failures_total"] or not latched["degraded"]
                or after["failures_total"] != latched["failures_total"]
                or after["degraded"] or not attached
                or latched["fallback_blocks_total"] != 2
                or after["fallback_blocks_total"] != 2):
            raise AssertionError(f"chaos_path sidecar: before the stop {before_stop}, "
                                 f"stopped {latched}, after the restart {after}, "
                                 f"attached {attached}")
        if check_launches and (sccounts["p256_verify"] < 1 or sccounts["mvcc_validate"] < k_sc):
            raise AssertionError(f"chaos_path sidecar: launches {sccounts}")
        log("chaos_sidecar", blocks=k_sc, stopped_after_block=3, restarted_before_block=6,
            guard_before_stop=before_stop, guard_stopped=latched, guard_after=after,
            latch_to_reattach_s=after["degraded_s"], stop_to_restart_s=t_restart - t_stop,
            attached=attached, server_requests=srv_stats["requests"], launches=sccounts,
            equal_to_fault_free=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("chaos_path", restarts=restarts, faults_fired=device_lane["faults"],
        retries_total=gst["retries_total"], fallback_blocks_total=gst["fallback_blocks_total"],
        degraded_s=gst["degraded_s"], launches=counts,
        block_ms_p50=device_lane["block_ms_p50"], block_ms_p99=device_lane["block_ms_p99"],
        block_ms_by_lane=device_lane["block_ms_mean_by_lane"],
        span_ms_p50_by_lane=span_p50, restart_wait_ms_p50=device_lane["restart_wait_ms_p50"],
        fault_free_ms_per_block=device_lane["fault_free_ms_per_block"],
        resident_enabled=rst["enabled"], sidecar_latch_to_reattach_s=after["degraded_s"],
        equal=True)


# ---------------------------------------------------------------------------
# BASELINE config 1: the network from a client's proposal to the commit


NETWORK_CHANNEL = "basicchan"
NETWORK_CC = "basic"
NETWORK_TXS = 32         # one block cut by the timeout (config 4's and the CLI's networks cut 500 by count)
NETWORK_CLIENTS = 8
NETWORK_CONFLICTS = 8    # keys each read and written by two txs of the first block
NETWORK_POLICY = "OutOf(1, 'Org1MSP.member')"
NETWORK_HOST_CHECKS = 16  # proposals whose host check is timed alone
NETWORK_KERNELS = ("p256_sign", "p256_verify", "stage2_policy", "stage2_mvcc")


def network_txs(n_tx: int, first: int, conflicts: int):
    """The chaincode calls → (the first block's, the second's).  The
    first block: ``conflicts`` pairs that read and write one key each
    (``transfer c_i → d_i`` and ``c_i → e_i`` of 0: one of each pair
    ends MVCC_READ_CONFLICT), then puts of ``acct_j``; the second:
    transfers between the accounts the first block wrote."""
    a = []
    for i in range(conflicts):
        a += [[b"transfer", b"c%d" % i, b"d%d" % i, b"0"],
              [b"transfer", b"c%d" % i, b"e%d" % i, b"0"]]
    a += [[b"put", b"acct%d" % j, b"%d" % (100 + j)] for j in range(first - 2 * conflicts)]
    b = [[b"transfer", b"acct%d" % (2 * j), b"acct%d" % (2 * j + 1), b"5"]
         for j in range(n_tx - first)]
    return a, b


def network_expected(blocks, calls) -> tuple[list, dict]:
    """The orderer's blocks and the call of each tx id → (the codes a
    block by construction, {key: (value, version)}): in a conflict
    pair the first in block order wins."""
    from fabric_tpu_torch import protoutil
    from fabric_tpu_torch.peer.txcodes import TxValidationCode as C

    codes, state, read = [], {}, set()
    for blk in blocks:
        out = []
        for i, env in enumerate(blk.data.data):
            args = calls[protoutil.channel_header(env).tx_id]
            ver = (blk.header.number, i)
            if args[0] == b"put":
                state[args[1].decode()] = (args[2], ver)
                out.append(C.VALID)
                continue
            frm, to, amt = args[1].decode(), args[2].decode(), int(args[3])
            if amt == 0 and frm in read:
                out.append(C.MVCC_READ_CONFLICT)
                continue
            read.add(frm)
            a = int(state.get(frm, (b"0",))[0]) - amt
            b = int(state.get(to, (b"0",))[0]) + amt
            state[frm], state[to] = (b"%d" % a, ver), (b"%d" % b, ver)
            out.append(C.VALID)
        codes.append(bytes(out))
    return codes, state


@contextlib.contextmanager
def first_launches(name, key):
    """Inside, the first launch of kernel ``name`` at each ``key(*args)``
    is kept (its operands and output, cloned) in the dict this yields."""
    from fabric_tpu_torch import kernels

    seen, fn, lock = {}, getattr(kernels, name), threading.Lock()

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        k = key(*a)
        with lock:
            if k not in seen:
                seen[k] = ([x.clone() if torch.is_tensor(x) else x for x in a], out.clone())
        return out

    setattr(kernels, name, wrapped)
    try:
        yield seen
    finally:
        setattr(kernels, name, fn)


def _lat(vals) -> dict:
    from fabric_tpu_torch.utils.stats import nearest_rank

    vals = sorted(vals)
    return {"n": len(vals), "p50": nearest_rank(vals, 50) if vals else None,
            "p99": nearest_rank(vals, 99) if vals else None}


async def _network_run(dev, org, n_tx, first, conflicts, clients, batch, root):
    """One orderer and one peer over localhost, driven by ``clients``
    gateway clients → what the checks read."""
    import asyncio

    from fabric_tpu_torch import kernels, observe
    from fabric_tpu_torch.comm.rpc import RpcClient
    from fabric_tpu_torch.crypto import policy as pol
    from fabric_tpu_torch.crypto.msp import MSPManager
    from fabric_tpu_torch.ordering import OrdererNode
    from fabric_tpu_torch.peer import signlane
    from fabric_tpu_torch.peer.chaincode import ChaincodeRuntime, KVContract
    from fabric_tpu_torch.peer.gateway import GatewayClient
    from fabric_tpu_torch.peer.node import PeerNode
    from fabric_tpu_torch.peer.validator import NamespaceInfo, PolicyProvider

    ch_id, cc = NETWORK_CHANNEL, NETWORK_CC
    peer_signer = org.nodes["peer0.org1.basic.example.com"]
    user = org.users["User1@org1.basic.example.com"]
    mgr = MSPManager({"Org1MSP": org.msp()})
    orderer = OrdererNode("orderer0", f"{root}/orderer", {}, batch_config=batch)
    await orderer.start()
    orderer.cluster["orderer0"] = ("127.0.0.1", orderer.port)
    chain = orderer.join_channel(ch_id)
    rt = ChaincodeRuntime()
    rt.register(cc, KVContract())
    peer = PeerNode("peer0", f"{root}/peer", mgr, peer_signer, rt, device=dev,
                    sign_device=True, pipeline_depth=2)
    await peer.start()
    ch = peer.join_channel(ch_id, PolicyProvider(
        {cc: NamespaceInfo(policy=pol.from_dsl(NETWORK_POLICY))}))
    # when the orderer cut each block, and when the peer committed it
    cut_at, committed_at = {}, {}
    add_block, signal = chain.blocks.add_block, ch._signal_height

    def timed_add(blk, *a, **kw):
        cut_at[blk.header.number] = time.perf_counter()
        return add_block(blk, *a, **kw)

    def timed_signal():
        committed_at[ch.height - 1] = time.perf_counter()
        signal()

    chain.blocks.add_block, ch._signal_height = timed_add, timed_signal
    ch.start_deliver([orderer.cluster["orderer0"]])
    # the clients sign on the card too, through a lane of their own
    client_lane = signlane.SignBatcher(signlane.device_sign_backend(user.d, device=dev)).start()
    signer = signlane.BatchedSigner(user, client_lane)
    gcs = [GatewayClient("127.0.0.1", peer.port, signer) for _ in range(clients)]
    out = {"calls": {}, "status": {}, "endorse_ms": [], "submit_status_ms": [],
           "probes": [], "cut_at": cut_at, "committed_at": committed_at}
    try:
        loop = asyncio.get_event_loop()
        deadline = loop.time() + 30
        while chain.raft.state != "leader":
            if loop.time() > deadline:
                raise AssertionError("network_path: the orderer elected no leader")
            await asyncio.sleep(0.02)

        async def endorse_all(calls):
            envs = []

            async def client(ci):
                for args in calls[ci::clients]:
                    t0 = time.perf_counter()
                    tx_id, env = await gcs[ci].endorse(ch_id, cc, args)
                    out["endorse_ms"].append(1e3 * (time.perf_counter() - t0))
                    out["calls"][tx_id] = args
                    envs.append((ci, tx_id, env))

            await asyncio.gather(*(client(ci) for ci in range(clients)))
            return envs

        async def submit_all(envs):
            """Every envelope submitted, then the commit statuses
            awaited (asked once the submissions are in, so that they
            take no event-loop time from them; the latency runs from
            each submit)."""
            sent = []

            async def status(ci, tx_id, t0):
                out["status"][tx_id] = await gcs[ci].commit_status(ch_id, tx_id)
                out["submit_status_ms"].append(1e3 * (time.perf_counter() - t0))

            async def client(ci):
                for c, tx_id, env in envs:
                    if c == ci:
                        t0 = time.perf_counter()
                        await gcs[ci].submit(ch_id, env)
                        sent.append((ci, tx_id, t0))

            await asyncio.gather(*(client(ci) for ci in range(clients)))
            return [asyncio.ensure_future(status(*x)) for x in sent]

        async def probe_commit(height):
            """Endorsements (evaluated, not submitted) from every client
            while block ``height - 1`` is cut and not yet committed."""
            while chain.height < height:
                await asyncio.sleep(0.002)

            async def client(ci):
                while ch.height < height:
                    t0 = time.perf_counter()
                    r = await gcs[ci].evaluate(ch_id, cc, [b"put", b"probe%d" % ci, b"x"])
                    if r.status != 200:
                        raise AssertionError(f"network_path: a probe endorsement gave {r}")
                    out["probes"].append((t0, time.perf_counter()))

            await asyncio.gather(*(client(ci) for ci in range(clients)))

        calls_a, calls_b = network_txs(n_tx, first, conflicts)
        t0 = time.perf_counter()
        envs = await endorse_all(calls_a)
        out["endorse_a_s"] = time.perf_counter() - t0
        t1 = out["submit_a_at"] = time.perf_counter()
        waits = await submit_all(envs)
        # a block cut by count needs all its envelopes at the orderer
        # inside its batch timeout
        out["submit_a_s"] = time.perf_counter() - t1
        await probe_commit(1)
        await asyncio.gather(*waits)
        if calls_b:
            envs = await endorse_all(calls_b)
            out["submit_b_at"] = time.perf_counter()
            waits = await submit_all(envs)
            await probe_commit(2)
            await asyncio.gather(*waits)
        out["wall_s"] = time.perf_counter() - t0
        out["launches"] = dict(kernels.launches)
        out["peer_lane"] = peer.sign_batcher.stats()
        out["client_lane"] = client_lane.stats()
        ch.ledger.drain_state()
        out["query"] = {}
        cli = RpcClient("127.0.0.1", peer.port)
        await cli.connect()
        for key in sorted({a.decode() for args in out["calls"].values() for a in args[1:3]}):
            out["query"][key] = json.loads(await cli.unary("Query", json.dumps(
                {"channel": ch_id, "ns": cc, "key": key}).encode()))
        await cli.close()
        # each block's trip through the peer's pipe: its root's children
        # (prefetch, launch, finish, commit, ledger_commit, fsync) in ms
        out["spans_ms"] = {}
        for r in observe.global_tracer().recent_roots():
            if r.attrs.get("channel") == ch_id:
                d = out["spans_ms"][r.attrs["block"]] = {"total": 1e3 * r.dur}
                for c in r.children:
                    d[c.name] = d.get(c.name, 0.0) + 1e3 * c.dur
        out["orderer_blocks"] = [chain.blocks.get_block(n) for n in range(chain.height)]
        out["peer_blocks"] = [ch.ledger.blocks.get_block(n) for n in range(ch.height)]
        out["peer_public"] = peer_signer.public
        out["msp"] = mgr
    finally:
        for g in gcs:
            await g.close()
        client_lane.stop()
        await peer.stop()
        await orderer.stop()
    return out


def network_host_check_ms(org, n: int = NETWORK_HOST_CHECKS) -> float:
    """The endorser's proposal check alone (identity, ``ec_ref``
    signature, tx id): ms a proposal, over ``n`` proposals."""
    from fabric_tpu_torch import protoutil
    from fabric_tpu_torch.crypto.msp import MSPManager, verify_signature
    from fabric_tpu_torch.peer import txassembly as txa
    from fabric_tpu_torch.protos import messages as m

    user = org.users["User1@org1.basic.example.com"]
    props = [txa.create_signed_proposal(user, NETWORK_CHANNEL, NETWORK_CC, [b"get", b"k%d" % i])[0]
             for i in range(n)]
    mgr = MSPManager({"Org1MSP": org.msp()})
    t0 = time.perf_counter()
    for sp in props:
        hdr = m.Header.parse(m.Proposal.parse(sp.proposal_bytes).header)
        ch, sh = m.ChannelHeader.parse(hdr.channel_header), m.SignatureHeader.parse(hdr.signature_header)
        ident = mgr.deserialize_identity(sh.creator)
        if not (ident.is_valid and verify_signature(ident, sp.proposal_bytes, sp.signature)
                and ch.tx_id == protoutil.compute_tx_id(sh.nonce, sh.creator)):
            raise AssertionError("network_path: a proposal failed its host check")
    return 1e3 * (time.perf_counter() - t0) / n


def phase_network_path(dev, n_tx=NETWORK_TXS, conflicts=NETWORK_CONFLICTS,
                       clients=NETWORK_CLIENTS, batch=None, check_launches=True,
                       sign_batch=card_signer):
    """BASELINE config 1 (the e2e basic network: one peer, a solo
    orderer, a sample chaincode) on ``dev``, through the entry points a
    user calls: an ``OrdererNode`` (one-node Raft, ``BatchConfig()``:
    500 messages, 2 MiB, 10 MiB, 2 s) and a ``PeerNode(device=dev,
    sign_device=True, pipeline_depth=2)`` of Org1 with ``KVContract``
    under a 1-of-1 Org1 member policy, one process over localhost.
    ``clients`` ``GatewayClient``s endorse the first block's ``first``
    transactions (``n_tx`` when it is below the batch's count) and
    submit them, then endorse and submit any rest (cut by the timeout,
    reading keys the first committed); endorsements evaluated from every
    client while each block commits
    give the endorse latency under commit.  Checks: each block's filter
    equals the port's serial host validation of the orderer's block
    bytes and construction (``conflicts`` MVCC conflicts in the first);
    every committed key reads back through Query at its version; commit
    status gives every tx its final code; every endorsement verifies
    under the peer's key; the four kernels launched (``check_launches``)
    and each held against its plain version at the shapes the path
    launched.  The channel is joined in dev mode (the peer's MSP and
    policy given, no genesis block): the orderer admits by size, as the
    reference's does without a genesis config."""
    import asyncio
    import shutil
    import tempfile

    from fabric_tpu_torch import kernels, protoutil
    from fabric_tpu_torch.crypto import cryptogen, ec_ref
    from fabric_tpu_torch.crypto import policy as pol
    from fabric_tpu_torch.ops import p256v3
    from fabric_tpu_torch.ordering import BatchConfig
    from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
    from fabric_tpu_torch.peer.validator import NamespaceInfo, PolicyProvider
    from fabric_tpu_torch.protos import messages as m

    t_phase = time.perf_counter()
    batch = batch or BatchConfig()
    first = min(batch.max_message_count, n_tx)
    org = cryptogen.generate_org("Org1MSP", "org1.basic.example.com",
                                 np.random.default_rng(SEED + 41), now=WIRE_NOW,
                                 sign_batch=sign_batch)
    host_check_ms = network_host_check_ms(org)
    gc.collect()  # the earlier paths' garbage, collected outside the run
    root = tempfile.mkdtemp(prefix="network_path-")
    kernels.reset_counts()
    try:
        with first_launches("p256_sign", lambda limbs, *a: limbs.shape[0]) as signs, \
                first_launches("p256_verify", lambda frame, *a, **kw: frame.shape[0]) as verifies:
            run = asyncio.run(_network_run(dev, org, n_tx, first, conflicts, clients, batch,
                                           root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts = run["launches"]
    missing = [k for k in NETWORK_KERNELS if counts.get(k, 0) == 0]
    if check_launches and missing:
        raise AssertionError(f"network_path: kernels not launched: {missing} ({counts})")

    # the blocks: sizes, construction, the serial host validation
    oblocks = [m.Block.parse(b.serialize()) for b in run["orderer_blocks"]]
    sizes = [len(b.data.data) for b in oblocks]
    if sizes != [s for s in (first, n_tx - first) if s]:
        raise AssertionError(f"network_path: blocks of {sizes} txs, expected "
                             f"{[first, n_tx - first]}")
    want_codes, want_state = network_expected(oblocks, run["calls"])
    got = [protoutil.get_tx_filter(b) for b in run["peer_blocks"]]
    host = host_filters(dev, oblocks, PolicyProvider({NETWORK_CC: NamespaceInfo(
        policy=pol.from_dsl(NETWORK_POLICY))}), run["msp"])
    if got != host or got != want_codes:
        raise AssertionError(f"network_path: filters differ (peer / host validation / "
                             f"construction): {[list(g) for g in got]} {[list(h) for h in host]}")
    conflicts_got = got[0].count(bytes([C.MVCC_READ_CONFLICT]))
    if conflicts_got != conflicts or got[0].count(bytes([C.VALID])) != first - conflicts \
            or got[1:] != [bytes([C.VALID]) * (n_tx - first)] * (n_tx > first):
        raise AssertionError(f"network_path: codes {[list(g) for g in got]}")
    codes = {protoutil.channel_header(env).tx_id: got[n][i]
             for n, b in enumerate(oblocks) for i, env in enumerate(b.data.data)}
    bad_status = [t for t, st in run["status"].items() if st["code"] != codes[t]]
    if len(run["status"]) != n_tx or bad_status:
        raise AssertionError(f"network_path: {len(run['status'])} commit statuses, "
                             f"{len(bad_status)} wrong")
    bad_keys = [k for k, (val, ver) in want_state.items()
                if run["query"][k]["value"] != val.hex() or tuple(run["query"][k]["version"]) != ver]
    if bad_keys or any(run["query"][k]["status"] != 404 for k in run["query"] if k not in want_state):
        raise AssertionError(f"network_path: {len(bad_keys)} keys read back wrong: {bad_keys[:5]}")

    # every endorsement under the peer's key, on the card in one launch
    qx, qy = run["peer_public"]
    items = []
    for b in oblocks:
        for env in b.data.data:
            _, _, cap, prp, _ = protoutil.extract_action(m.Envelope.parse(env))
            for e in cap.action.endorsements:
                r, s = ec_ref.der_decode_sig(e.signature)
                items.append((ec_ref.digest_int(cap.action.proposal_response_payload + e.endorser),
                              r, s, qx, qy))
    ok = p256v3.verify_launch(items, device=dev).fetch()
    if len(items) != n_tx or not all(ok):
        raise AssertionError(f"network_path: {len(items) - sum(ok)} of {len(items)} "
                             "endorsements do not verify under the peer's key")

    # each kernel against its plain version at the shapes the path launched
    held = held_to_plain("network_path", signs, verifies)

    cut, done = run["cut_at"], run["committed_at"]
    windows = [(cut[n], done[n]) for n in sorted(done) if n in cut]
    during = [1e3 * (b - a) for a, b in run["probes"]
              if any(a < w1 and b > w0 for w0, w1 in windows)]
    log("network_blocks", blocks=[{
        "number": n, "txs": sizes[n], "cut_by": "count" if sizes[n] == batch.max_message_count
        else "timeout", "commit_wall_ms": 1e3 * (done[n] - cut[n]),
        "valid": got[n].count(bytes([C.VALID])),
        "mvcc_read_conflict": got[n].count(bytes([C.MVCC_READ_CONFLICT])),
        "spans_ms": run["spans_ms"].get(n)}
        for n in range(len(sizes))],
        last_cut_after_submit_s=cut[len(sizes) - 1] - run.get("submit_b_at", run["submit_a_at"]),
        batch_timeout_s=batch.batch_timeout_s)
    log("network_latency", endorse_ms_idle=_lat(run["endorse_ms"]),
        endorse_ms_while_committing=_lat(during), probes=len(run["probes"]),
        submit_to_status_ms=_lat(run["submit_status_ms"]),
        host_check_ms_per_proposal=host_check_ms,
        host_check_share_of_endorse_p50=host_check_ms / _lat(run["endorse_ms"])["p50"],
        first_block_endorse_s=run["endorse_a_s"], first_block_submit_s=run["submit_a_s"])
    lane = run["peer_lane"]
    log("network_path", txs=n_tx, clients=clients, launches=counts,
        sign_lane={"signed": lane["signed_total"], "batches": lane["batches_total"],
                   "occupancy": lane["occupancy"], "wait_ms": lane["wait_ms"],
                   "busy": lane["busy_total"]},
        client_lane_batches=run["client_lane"]["batches_total"],
        sign_lanes_launched=sorted(signs), verify_lanes_launched=sorted(verifies),
        plain_mismatches=held, tx_per_s=n_tx / run["wall_s"], wall_s=run["wall_s"],
        host_validation_equal=True, keys_read_back=len(want_state),
        endorsements_verified=sum(ok), seconds=time.perf_counter() - t_phase)
    return counts


# ---------------------------------------------------------------------------
# The ordering service: each orderer in a child process of its own, as a
# deployment runs them.  Its event loop and its interpreter lock are
# apart from the peers' and from the other orderers', so neither a
# peer's commit nor the leader's replication of a 500-transaction entry
# (3.3 MB, re-sent on every heartbeat until acknowledged) starves a
# follower's Raft timers or BFT's view timer


def _orderer_child(conn, spec, oid, index):
    """Child process: orderer ``oid`` of ``spec``, serving the parent's
    commands on ``conn`` until ``exit``."""
    import asyncio
    import traceback

    try:
        asyncio.run(_orderer_main(conn, spec, oid, index))
    except BaseException:
        conn.send(("error", traceback.format_exc()))


async def _orderer_main(conn, spec, oid, index):
    import asyncio
    import random

    from fabric_tpu_torch.ordering import BatchConfig, OrdererNode
    from fabric_tpu_torch.protos import messages as m

    async def recv():
        while not conn.poll():
            await asyncio.sleep(0.01)
        return conn.recv()

    ch_id = spec["channel"]
    node = OrdererNode(oid, f"{spec['dir']}/{oid}", {},
                       batch_config=BatchConfig(**spec["batch"]), consensus=spec["consensus"],
                       signer=(spec.get("signers") or {}).get(oid),
                       verifiers=spec.get("verifiers"),
                       view_timeout=spec.get("view_timeout", 2.0),
                       rng=random.Random(spec["seed"] + index))
    await node.start()
    conn.send(("ok", node.port))
    _, cluster = await recv()
    node.cluster.update(cluster)
    chain = node.join_channel(ch_id, m.Block.parse(spec["genesis"]) if spec.get("genesis")
                              else None)
    if spec.get("raft_options"):
        # Raft's timers as a deployment's channel config sets them
        # (Fabric's EtcdRaft Options); the node and the chain take no
        # such knob, the reference's neither
        chain.raft.heartbeat = spec["raft_options"]["heartbeat"]
        chain.raft.election_timeout = tuple(spec["raft_options"]["election_timeout"])
    cut_at = {}  # block number → when this orderer materialized it

    def timed(blk, *a, _add=chain.blocks.add_block, **kw):
        cut_at.setdefault(blk.header.number, time.monotonic())
        return _add(blk, *a, **kw)

    chain.blocks.add_block = timed
    conn.send(("ok", None))
    changes, seen, live = [], None, True
    # how late this process's loop wakes from its 10 ms sleeps: a late
    # wake is a stretch in which no Raft or BFT timer could run
    lags, t_wake = [], None

    def consensus():
        r = chain.raft
        return {"state": r.state, "leader": r.leader_id,
                "term": r.wal.term if spec["consensus"] == "raft" else None,
                "view": getattr(r, "view", None), "height": chain.height}

    while True:
        if live:  # leader changes, as this node sees them
            c = consensus()
            key = (c["state"], c["leader"], c["term"], c["view"])
            if key != seen:
                seen = key
                changes.append({"t": time.monotonic(), "node": oid, **c})
        if not conn.poll():
            t_wake = time.monotonic() + 0.01
            await asyncio.sleep(0.01)
            lag = time.monotonic() - t_wake
            if lag > 0.05:
                lags.append((t_wake, lag))
            continue
        cmd, *_ = conn.recv()
        if cmd == "info":
            conn.send(("ok", consensus()))
        elif cmd == "blocks":
            conn.send(("ok", [chain.blocks.get_block(k).serialize()
                              for k in range(chain.height)]))
        elif cmd in ("stop", "exit"):
            if live:
                await node.stop()
                live = False
            conn.send(("ok", {"changes": changes, "cut_at": cut_at, "lags": lags}))
            if cmd == "exit":
                return


class OrderingService:
    """``spec["ids"]``'s orderers, each in a ``_orderer_child`` process,
    and their command pipes; ``cluster``: {orderer id: (host, port)}."""

    def __init__(self, spec):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")  # never fork a process that holds a CUDA context
        self.procs, self.conns, self.records = {}, {}, {}
        self._lock = threading.Lock()
        for i, oid in enumerate(spec["ids"]):
            self.conns[oid], child = ctx.Pipe()
            self.procs[oid] = ctx.Process(target=_orderer_child, args=(child, spec, oid, i),
                                          daemon=True)
            self.procs[oid].start()
            child.close()
        self.cluster = {oid: ("127.0.0.1", self._recv(oid, 120)) for oid in spec["ids"]}
        for oid in spec["ids"]:
            self.conns[oid].send(("cluster", self.cluster))
        for oid in spec["ids"]:
            self._recv(oid, 60)
        self.live = list(spec["ids"])

    def _recv(self, oid, timeout):
        if not self.conns[oid].poll(timeout):
            raise AssertionError(f"ordering service: {oid} does not answer")
        tag, payload = self.conns[oid].recv()
        if tag == "error":
            raise AssertionError(f"ordering service: {oid} failed:\n{payload}")
        return payload

    def call(self, oid, cmd, timeout=60):
        with self._lock:
            self.conns[oid].send((cmd,))
            return self._recv(oid, timeout)

    def info(self) -> dict:
        return {oid: self.call(oid, "info") for oid in self.live}

    def blocks(self, oid=None) -> list:
        return self.call(oid or self.live[0], "blocks")

    def stop_leader(self) -> dict:
        before = self.info()
        oid = next(o for o, c in before.items() if c["state"] == "leader")
        self.records[oid] = self.call(oid, "stop")
        self.live.remove(oid)
        return {"stopped": oid, "before": before}

    async def acall(self, method, *args):
        import asyncio

        return await asyncio.get_event_loop().run_in_executor(
            None, lambda: getattr(self, method)(*args))

    async def wait_leader(self, timeout=30.0) -> str:
        import asyncio

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            leaders = [o for o, c in (await self.acall("info")).items() if c["state"] == "leader"]
            if leaders:
                return leaders[0]
            await asyncio.sleep(0.05)
        raise AssertionError("ordering service: no leader")

    def close(self) -> dict:
        """→ the orderers' leader changes (in time order), each
        block's first cut time and each orderer's late wakes over 50 ms
        ((when, seconds late)); every process is gone after."""
        for oid, proc in self.procs.items():
            if proc.is_alive():
                try:
                    self.records[oid] = self.call(oid, "exit", timeout=30)
                except (AssertionError, OSError, EOFError):
                    pass
            proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join(5)
        cut_at = {}
        for rec in self.records.values():
            for n, t in rec["cut_at"].items():
                cut_at[n] = min(t, cut_at.get(n, t))
        return {"changes": sorted((c for r in self.records.values() for c in r["changes"]),
                                  key=lambda c: c["t"]),
                "cut_at": cut_at,
                "lags": {oid: r["lags"] for oid, r in self.records.items()}}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def launches_by_owner(names, owners: dict):
    """Inside, every call of a kernel wrapper in ``names`` is counted
    under the owner (``owners``: {id(object): label}) of the nearest
    frame up its stack whose ``self`` is one of ``owners``' objects: a
    peer's validator or its sign lane, say (``other`` when none is)."""
    from fabric_tpu_torch import kernels

    counts, lock = Counter(), threading.Lock()
    fns = {n: getattr(kernels, n) for n in names}

    def wrap(name, fn):
        def wrapped(*a, **kw):
            who, f = "other", sys._getframe(1)
            while f is not None:
                me = f.f_locals.get("self")
                label = owners.get(id(me)) if me is not None else None
                if label is not None:
                    who = label
                    break
                f = f.f_back
            with lock:
                counts[who, name] += 1
            return fn(*a, **kw)
        return wrapped

    for n, fn in fns.items():
        setattr(kernels, n, wrap(n, fn))
    try:
        yield counts
    finally:
        for n, fn in fns.items():
            setattr(kernels, n, fn)


def _public_digest(state) -> str:
    """``snapshot.state_digest``'s XOR of records over the state without
    the private collections' cleartext namespaces (``ns$coll``): what
    every peer of a channel holds alike, members or not."""
    from fabric_tpu_torch.ledger.snapshot import state_digest

    class Public:
        def iter_all(self):
            return ((k, vv) for k, vv in state.iter_all()
                    if "$" not in k[0] or k[0].endswith("#hashed"))

    return state_digest(Public())


def held_to_plain(name: str, signs: dict, verifies: dict) -> dict:
    """``p256_sign`` and ``p256_verify`` at each shape a path launched
    them with (``first_launches``) against their plain versions →
    {kernel@lanes: mismatches}."""
    from fabric_tpu_torch.ops import p256sign, p256v3

    held = {}
    for lanes, (args, out) in sorted(signs.items()):
        want = p256sign.sign_batch_ref(args[0], chains=args[3])
        held[f"p256_sign@{lanes}"] = int((out != want).any(dim=2).any(dim=1).sum())
    for lanes, (args, out) in sorted(verifies.items()):
        held[f"p256_verify@{lanes}"] = int((out != p256v3.verify_batch_ref(args[0])).sum())
    if any(held.values()):
        raise AssertionError(f"{name}: kernels differ from their plain versions: {held}")
    return held


def host_filters(dev, blocks, provider, msp) -> list:
    """The port's serial host validation (``_validate_host``) of
    ``blocks`` over an empty state → their filters."""
    from fabric_tpu_torch.ledger.statedb import MemVersionedDB
    from fabric_tpu_torch.peer.validator import BlockValidator

    v = BlockValidator(provider, MemVersionedDB(), device=dev, msp=msp)
    v.blocks = TxidStore()
    v.validate_finish = v._validate_host
    out = []
    for b in blocks:
        flt, upd, _ = v.validate(b)
        v.state.apply_updates(upd)
        v.blocks.txids.update(p.txid for p in v.last_parsed if p.txid)
        out.append(bytes(flt))
    return out


# ---------------------------------------------------------------------------
# BASELINE config 4 as a network: 3 Raft orderers, 4 peers of 4 orgs,
# gossip's private-data push, pull, reconciliation and anti-entropy


CONFIG4_NET_TXS = 500       # one block cut by count (BatchConfig's 500)
CONFIG4_NET_CLIENTS = 8     # 3 on Org1's gateway, 3 on Org2's, 2 on Org4's
CONFIG4_NET_CONFLICTS = 10  # basic key pairs: one tx of each ends MVCC_READ_CONFLICT
CONFIG4_COLLECTIONS = {"pvtcc": {"collA": {
    "member_orgs": ["Org1MSP", "Org2MSP", "Org3MSP"], "required_peer_count": 1,
    "max_peer_count": 2, "btl": 0}}}
CONFIG4_LATE = 2            # Org3's peer starts after the block commits on the others
CONFIG4_NET_KERNELS = ("p256_verify", "stage2_policy", "stage2_mvcc")
# the peers' deliver censorship check (Fabric's BlockCensorshipTimeout
# default): the monitor takes a block slower to commit than this window
# for a withholding orderer, so it must exceed a block's commit
CENSORSHIP_CHECK_S = 30.0
CONFIG4_PROBE_GAP_S = 0.1  # a client's pause between evaluations while blocks commit
# a submission a deposed Raft leader held in its block cutter is lost
# (the reference's ordering, as Fabric's): a client whose transaction
# has no commit status after this wait submits it again, twice at most
CONFIG4_STATUS_WAIT_S = 20.0
CONFIG4_RESUBMITS = 2
# Fabric's sample etcdraft options (configtx.yaml: TickInterval 500 ms,
# ElectionTick 10, HeartbeatTick 1): a 500 ms heartbeat and a 5-10 s
# election timeout.  The port's defaults (the reference's: 50 ms and
# 0.15-0.30 s) elected new leaders mid-burst: a 500-transaction entry's
# encoding and fsync held the leader's loop 134 ms (PERF.md, PR 18 call 6)
CONFIG4_RAFT_OPTIONS = {"heartbeat": 0.5, "election_timeout": (5.0, 10.0)}


def config4_calls(n_tx: int, conflicts: int) -> list:
    """→ [(chaincode, args, transient)]: ``conflicts`` pairs of
    ``basic`` transfers that read and write one key each, then
    ``build_config4``'s mix (``r = 37 i mod 100``): 45% ``basic`` puts,
    35% ``pvtcc`` private writes to ``collA`` (the value in the
    transient map), 20% ``sbecc`` puts."""
    calls = []
    for i in range(conflicts):
        calls += [("basic", [b"transfer", b"c%d" % i, b"d%d" % i, b"0"], None),
                  ("basic", [b"transfer", b"c%d" % i, b"e%d" % i, b"0"], None)]
    for i in range(n_tx - 2 * conflicts):
        r = (i * 37) % 100
        if r < 45:
            calls.append(("basic", [b"put", b"k%05d" % i, b"v%d" % i], None))
        elif r < 80:
            calls.append(("pvtcc", [b"put_private", b"collA", b"pk%05d" % i],
                          {"value": b"secret-%d" % i}))
        else:
            calls.append(("sbecc", [b"put", b"e%05d" % i, b"v%d" % i], None))
    return calls


def config4_expected(blocks, calls) -> list:
    """The codes by construction, in block order: VALID, but the second
    transfer of a conflict pair is MVCC_READ_CONFLICT and a transaction
    submitted again after it was ordered is DUPLICATE_TXID."""
    from fabric_tpu_torch import protoutil
    from fabric_tpu_torch.peer.txcodes import TxValidationCode as C

    read, seen, out = set(), set(), []
    for blk in blocks:
        codes = []
        for env in blk.data.data:
            tx_id = protoutil.channel_header(env).tx_id
            if tx_id in seen:
                codes.append(C.DUPLICATE_TXID)
                continue
            seen.add(tx_id)
            _, args, _ = calls[tx_id]
            if args[0] == b"transfer" and args[1] in read:
                codes.append(C.MVCC_READ_CONFLICT)
                continue
            if args[0] == b"transfer":
                read.add(args[1])
            codes.append(C.VALID)
        out.append(bytes(codes))
    return out


def config4_provider():
    from fabric_tpu_torch.crypto import policy as pol
    from fabric_tpu_torch.peer.validator import NamespaceInfo, PolicyProvider

    return PolicyProvider({ns: NamespaceInfo(policy=pol.from_dsl(d),
                                             collections=dict(CONFIG4_COLLECTIONS.get(ns, {})))
                           for ns, d in CONFIG4_NS.items()})


async def _config4_network_run(dev, orgs, n_tx, conflicts, clients, batch, root,
                               sign_device=True):
    """The ordering service (3 Raft orderers, a child process), the
    peers of Org1, Org2 and Org4, ``clients`` gateway clients that
    endorse every transaction and then submit them in one burst; Org3's
    peer after the commit, caught up by anti-entropy → what the checks
    read."""
    import asyncio

    from fabric_tpu_torch import kernels, observe
    from fabric_tpu_torch.crypto.msp import MSPManager
    from fabric_tpu_torch.discovery import PeerInfo
    from fabric_tpu_torch.peer import signlane
    from fabric_tpu_torch.peer.chaincode import ChaincodeRuntime, KVContract
    from fabric_tpu_torch.peer.gateway import GatewayClient, GatewayError
    from fabric_tpu_torch.peer.node import PeerNode

    ch_id = CONFIG4_CHANNEL
    user = orgs[0].users["User1@org1.config4.example.com"]
    signers = [o.nodes[f"peer0.org{i + 1}.config4.example.com"] for i, o in enumerate(orgs)]
    mgr = MSPManager({o.msp_id: o.msp() for o in orgs})
    svc = OrderingService({"channel": ch_id, "ids": ["orderer0", "orderer1", "orderer2"],
                           "consensus": "raft", "dir": f"{root}/orderers", "seed": SEED + 43,
                           "raft_options": CONFIG4_RAFT_OPTIONS,
                           "batch": {"max_message_count": batch.max_message_count,
                                     "preferred_max_bytes": batch.preferred_max_bytes,
                                     "absolute_max_bytes": batch.absolute_max_bytes,
                                     "batch_timeout_s": batch.batch_timeout_s}})
    ports = [None, None, free_port(), None]
    peers, chans = [None] * 4, [None] * 4
    committed_at = [{} for _ in range(4)]
    owners = {}

    def make_peer(i):
        rt = ChaincodeRuntime()
        for ns in CONFIG4_NS:
            rt.register(ns, KVContract())
        return PeerNode(f"peer0.org{i + 1}", f"{root}/peer{i}", mgr, signers[i], rt,
                        port=ports[i] or 0, device=dev, sign_device=sign_device,
                        pipeline_depth=2)

    async def up(i):
        p = make_peer(i)
        await p.start()
        ports[i], peers[i] = p.port, p
        ch = chans[i] = p.join_channel(ch_id, config4_provider())
        ch.tracer = observe.Tracer(ring_blocks=16, slow_factor=0)  # this peer's spans
        signal = ch._signal_height

        def timed_signal(i=i, ch=ch, signal=signal):
            committed_at[i][ch.height - 1] = time.monotonic()
            signal()

        ch._signal_height = timed_signal
        owners[id(ch.validator)] = f"org{i + 1}"
        if p.sign_batcher is not None:
            owners[id(p.sign_batcher)] = f"org{i + 1}"
        return p

    out = {"calls": {}, "status": {}, "endorse_ms": [], "submit_status_ms": [], "probes": [],
           "committed_at": committed_at, "resubmitted": []}
    gcs, client_lane = [], None

    def txs_held(ch):
        lg = ch.ledger
        return sum(len(lg.blocks.get_block(k).data.data) for k in range(lg.blocks.height))

    async def watch(t0=time.perf_counter()):
        """A progress line every 15 s while the run lasts."""
        while True:
            await asyncio.sleep(15)
            log("config4_network_progress", s=time.perf_counter() - t0,
                endorsed=len(out["calls"]), statuses=len(out["status"]),
                probes=len(out["probes"]),
                heights=[ch.height if ch is not None else None for ch in chans],
                txs_held=[txs_held(ch) if ch is not None else None for ch in chans],
                orderers=await svc.acall("info"),
                gossip=[p.gossip_service.stats if p is not None else None for p in peers])

    log("config4_network_start", threads=threading.active_count(), loadavg=os.getloadavg())
    watcher = asyncio.ensure_future(watch())
    # the loop serves four peers and eight clients: four peers' share of
    # worker threads for their endorsers, sign-lane waits and gossip's
    # host signatures
    asyncio.get_event_loop().set_default_executor(ThreadPoolExecutor(64))
    try:
        # the peers list the leader first: a follower answers a
        # broadcast with a redirect, and the client backs off 50 ms
        # before it retries (``BroadcastClient``), which would stretch
        # the burst past the batch timeout
        leader = await svc.wait_leader()
        addrs = [svc.cluster[leader]] + [a for o, a in svc.cluster.items() if o != leader]
        for i in (0, 1, 3):
            await up(i)
        for i in range(4):
            for j in range(4):
                if j != i and peers[i] is not None:
                    peers[i].registry.add(PeerInfo(orgs[j].msp_id, "127.0.0.1", ports[j]))
        for i in (0, 1, 3):
            chans[i].start_deliver(addrs, censorship_check_s=CENSORSHIP_CHECK_S)
            peers[i].gossip_service.start_reconciler(ch_id, interval=0.5)
        # the clients sign on the card too, through a lane of their own
        signer = user
        if sign_device:
            client_lane = signlane.SignBatcher(
                signlane.device_sign_backend(user.d, device=dev)).start()
            owners[id(client_lane)] = "clients"
            signer = signlane.BatchedSigner(user, client_lane)
        gw_of = [0, 0, 0, 1, 1, 1, 3, 3][:clients]  # the peer each client's gateway is
        gcs = [GatewayClient("127.0.0.1", ports[gw_of[c]], signer) for c in range(clients)]
        calls = config4_calls(n_tx, conflicts)
        member_clients = [c for c in range(clients) if gw_of[c] != 3]
        plan = [[] for _ in range(clients)]
        for k, call in enumerate(calls):  # a private write goes through a member's gateway
            plan[member_clients[k % len(member_clients)] if call[0] == "pvtcc"
                 else k % clients].append(call)

        with launches_by_owner(("p256_verify", "stage2_policy", "stage2_mvcc", "p256_sign"),
                               owners) as by_owner:
            kernels.reset_counts()
            t0 = time.perf_counter()
            envs = []

            async def endorse(ci):
                for cc, args, transient in plan[ci]:
                    t = time.perf_counter()
                    tx_id, env = await gcs[ci].endorse(ch_id, cc, args, transient)
                    out["endorse_ms"].append(1e3 * (time.perf_counter() - t))
                    out["calls"][tx_id] = (cc, args, transient)
                    envs.append((ci, tx_id, env))

            await asyncio.gather(*(endorse(ci) for ci in range(clients)))
            out["endorse_s"] = time.perf_counter() - t0
            # let the endorsement-time pushes land before the burst
            await asyncio.sleep(0.5)
            sent = []

            async def submit(ci):
                for c, tx_id, env in envs:
                    if c == ci:
                        t = time.perf_counter()
                        await gcs[ci].submit(ch_id, env)
                        sent.append((ci, tx_id, t, env))

            t1 = time.perf_counter()
            await asyncio.gather(*(submit(ci) for ci in range(clients)))
            # every submission must reach the orderer inside the batch
            # timeout for the block to be cut by count
            out["first_block_submit_s"] = time.perf_counter() - t1

            async def status(ci, tx_id, t, env):
                for attempt in range(CONFIG4_RESUBMITS + 1):
                    try:
                        st = await gcs[ci].commit_status(ch_id, tx_id,
                                                         timeout=CONFIG4_STATUS_WAIT_S)
                        break
                    except GatewayError as e:
                        if e.status != 408 or attempt == CONFIG4_RESUBMITS:
                            raise
                        out["resubmitted"].append(tx_id)
                        await gcs[ci].submit(ch_id, env)
                out["status"][tx_id] = st
                out["submit_status_ms"].append(1e3 * (time.perf_counter() - t))

            waits = [asyncio.ensure_future(status(*x)) for x in sent]

            def all_in(i):
                if time.perf_counter() - t1 > 180:
                    raise AssertionError(f"config4_network_path: after 180 s the live peers "
                                         f"hold {[txs_held(chans[j]) for j in (0, 1, 3)]} "
                                         f"of {n_tx} transactions")
                return txs_held(chans[i]) >= n_tx

            async def probe(ci):
                """Evaluations from each client, ``CONFIG4_PROBE_GAP_S``
                apart, until every live peer holds every transaction:
                the endorse latency while blocks commit."""
                while not all(all_in(i) for i in (0, 1, 3)):
                    t = time.monotonic()
                    r = await gcs[ci].evaluate(ch_id, "basic", [b"put", b"probe%d" % ci, b"x"])
                    if r.status != 200:
                        raise AssertionError(f"config4_network_path: a probe gave {r}")
                    out["probes"].append((t, time.monotonic()))
                    await asyncio.sleep(CONFIG4_PROBE_GAP_S)

            await asyncio.gather(*(probe(ci) for ci in range(clients)))
            await asyncio.gather(*waits)
            out["committed_s"] = time.perf_counter() - t0

            # Org3's peer: started now, caught up from a peer by
            # anti-entropy, its collA cleartext pulled at commit or
            # reconciled after
            height = chans[0].height
            t2 = time.perf_counter()
            await up(CONFIG4_LATE)
            for j in (0, 1, 3):
                peers[CONFIG4_LATE].registry.add(PeerInfo(orgs[j].msp_id, "127.0.0.1", ports[j]))
            late = peers[CONFIG4_LATE].gossip_service
            late.start_anti_entropy(ch_id, interval=0.2)
            late.start_reconciler(ch_id, interval=0.5)
            lch = chans[CONFIG4_LATE]
            deadline = time.monotonic() + 120
            while lch.height < height or lch.ledger.pvtdata.missing_data(height):
                if time.monotonic() > deadline:
                    raise AssertionError(f"config4_network_path: the late peer reached height "
                                         f"{lch.height} of {height}")
                await asyncio.sleep(0.05)
            out["late_catchup_s"] = time.perf_counter() - t2
            out["wall_s"] = time.perf_counter() - t0
            out["launches"] = dict(kernels.launches)
        out["by_owner"] = {f"{who}:{k}": n for (who, k), n in sorted(by_owner.items())}
        out["peer_lanes"] = [p.sign_batcher.stats() if sign_device else {} for p in peers]
        out["client_lane"] = client_lane.stats() if sign_device else {}
        out["gossip"] = [dict(p.gossip_service.stats) for p in peers]
        out["peers"] = []
        for i, (p, ch) in enumerate(zip(peers, chans)):
            lg = ch.ledger
            lg.drain_state()
            spans = {}
            for r in ch.tracer.recent_roots():
                d = spans[r.attrs["block"]] = {"total": 1e3 * r.dur}
                for c in r.children:
                    d[c.name] = d.get(c.name, 0.0) + 1e3 * c.dur
            pvt_rows = [row for n in range(lg.height) for row in lg.pvtdata.get_pvt_data(n)]
            out["peers"].append({
                "blocks": [lg.blocks.get_block(n).serialize() for n in range(lg.height)],
                "digest": lg.state_digest(), "public_digest": _public_digest(lg.state),
                "commit_hash": (lg.commit_hash or b"").hex(),
                "clear": {k: vv.value for (ns, k), vv in lg.state.iter_all()
                          if ns == "pvtcc$collA"},
                "hashed": {k: vv.value for (ns, k), vv in lg.state.iter_all()
                           if ns == "pvtcc$collA#hashed"},
                "pvt_rows": pvt_rows,
                "transient": sum(len(ch.transient.get(t)) for t in out["calls"]),
                "missing": lg.pvtdata.missing_data(lg.height),
                "missing_all": lg.pvtdata.missing_data(lg.height, eligible_only=False),
                "spans_ms": spans})
        out["orderer_blocks"] = await svc.acall("blocks")
        out["msp"] = mgr
    finally:
        watcher.cancel()
        for g in gcs:
            await g.close()
        if client_lane is not None:
            client_lane.stop()
        for p in peers:
            if p is not None:
                await p.stop()
        record = out["ordering"] = svc.close()
        log("config4_network_orderers", changes=[
            {k: c[k] for k in ("t", "node", "state", "leader", "term")}
            for c in (record or {}).get("changes", ())],
            late_wakes=(record or {}).get("lags"))
    return out


def phase_config4_network_path(dev, n_tx=CONFIG4_NET_TXS, conflicts=CONFIG4_NET_CONFLICTS,
                               clients=CONFIG4_NET_CLIENTS, batch=None, check_launches=True,
                               sign_batch=card_signer, sign_device=True):
    """BASELINE config 4 (``raft network: 3 orderers / 4 peers, pvtdata
    chaincode, mixed endorsement policies``) as a network on ``dev``,
    through the entry points a user calls: three ``OrdererNode``s of one
    Raft cluster (``BatchConfig()``: 500 messages, 2 MiB, 10 MiB, 2 s) in
    a child process; four ``PeerNode(device=dev, sign_device=True,
    pipeline_depth=2)`` of Org1–Org4, each knowing the other three and
    running gossip; ``CONFIG4_NS``'s policies in dev mode, ``pvtcc``'s
    ``collA`` shared by Org1–Org3 (required 1, max 2, BTL 0).  ``clients``
    gateway clients (on Org1's, Org2's and Org4's gateways; a private
    write through a member's) endorse ``n_tx`` transactions (``conflicts``
    conflict pairs and ``build_config4``'s mix), then submit them in one
    burst; Org3's peer starts after the block has committed on the
    others and catches up by anti-entropy from a peer, its ``collA``
    cleartext by pull at commit or by the reconciler.  Checks: the same
    block bytes, filters (the port's serial host validation of the
    orderers' bytes, and the construction), commit hashes and public
    digests on the four peers, full state digests on Org1–3; every
    ``collA`` write as cleartext on Org1–3 and as its hash on all four,
    none of it in Org4's transient or pvtdata store and no eligible
    missing entry there, no missing entry left on a member; commit
    status for every transaction; ``p256_verify``, ``stage2_policy`` and
    ``stage2_mvcc`` launched by every peer at least once a block, and
    ``p256_sign`` (``check_launches``), ``p256_sign`` and ``p256_verify``
    held against their plain versions at the path's shapes.
    ``sign_device=False`` (a CPU rehearsal) signs on the host instead."""
    import asyncio
    import hashlib
    import shutil
    import tempfile

    from fabric_tpu_torch import protoutil
    from fabric_tpu_torch.crypto import cryptogen
    from fabric_tpu_torch.ordering import BatchConfig
    from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
    from fabric_tpu_torch.protos import messages as m

    t_phase = time.perf_counter()
    batch = batch or BatchConfig()
    rng = np.random.default_rng(SEED + 42)
    orgs = [cryptogen.generate_org(f"Org{i}MSP", f"org{i}.config4.example.com", rng,
                                   now=WIRE_NOW, sign_batch=sign_batch) for i in (1, 2, 3, 4)]
    gc.collect()
    root = tempfile.mkdtemp(prefix="config4_network-")
    try:
        with first_launches("p256_sign", lambda limbs, *a: limbs.shape[0]) as signs, \
                first_launches("p256_verify", lambda frame, *a, **kw: frame.shape[0]) as verifies:
            run = asyncio.run(_config4_network_run(dev, orgs, n_tx, conflicts, clients, batch,
                                                   root, sign_device))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts, peers = run["launches"], run["peers"]
    oblocks = [m.Block.parse(b) for b in run["orderer_blocks"]]
    n_blocks = len(oblocks)
    ordered = [protoutil.channel_header(env).tx_id for b in oblocks for env in b.data.data]
    if set(ordered) != set(run["calls"]) or len(ordered) > n_tx + len(run["resubmitted"]):
        raise AssertionError(f"config4_network_path: the orderers hold "
                             f"{[len(b.data.data) for b in oblocks]} txs, {len(set(ordered))} "
                             f"distinct, of {n_tx} ({len(run['resubmitted'])} submitted again)")
    per_peer = {f"org{i + 1}": {k: run["by_owner"].get(f"org{i + 1}:{k}", 0)
                                for k in CONFIG4_NET_KERNELS} for i in range(4)}
    short = {p: c for p, c in per_peer.items() if min(c.values()) < n_blocks}
    if check_launches and (short or counts.get("p256_sign", 0) == 0):
        raise AssertionError(f"config4_network_path: a peer launched a kernel fewer times than "
                             f"its {n_blocks} blocks: {short}, or p256_sign never ({counts})")

    # the same blocks, filters, hashes and digests on every peer
    ref = peers[0]
    for i, p in enumerate(peers):
        if p["blocks"] != ref["blocks"] or p["commit_hash"] != ref["commit_hash"] \
                or p["public_digest"] != ref["public_digest"]:
            raise AssertionError(f"config4_network_path: org{i + 1}'s peer differs from org1's "
                                 f"(blocks {p['blocks'] == ref['blocks']}, commit hash, digest)")
        if i < 3 and p["digest"] != ref["digest"]:
            raise AssertionError(f"config4_network_path: org{i + 1}'s full state digest differs")
    pblocks = [m.Block.parse(b) for b in ref["blocks"]]
    for a, b in zip(pblocks, oblocks):
        if a.header.serialize() != b.header.serialize() or a.data.serialize() != b.data.serialize():
            raise AssertionError("config4_network_path: a peer's block differs from the orderers'")
    got = [protoutil.get_tx_filter(b) for b in pblocks]
    host = host_filters(dev, oblocks, config4_provider(), run["msp"])
    want = config4_expected(oblocks, run["calls"])
    if got != host or got != want:
        raise AssertionError(f"config4_network_path: filters differ (peer / host validation / "
                             f"construction): {[list(g) for g in got]} {[list(h) for h in host]}")
    codes = {}  # a tx id's code: its first occurrence's
    for n, b in enumerate(oblocks):
        for i, env in enumerate(b.data.data):
            codes.setdefault(protoutil.channel_header(env).tx_id, got[n][i])
    bad_status = [t for t, st in run["status"].items() if st["code"] != codes[t]]
    if len(run["status"]) != n_tx or bad_status:
        raise AssertionError(f"config4_network_path: {len(run['status'])} commit statuses, "
                             f"{len(bad_status)} wrong")
    n_conflicts = sum(g.count(bytes([C.MVCC_READ_CONFLICT])) for g in got)
    if n_conflicts != conflicts:
        raise AssertionError(f"config4_network_path: {n_conflicts} MVCC conflicts, "
                             f"expected {conflicts}")

    # collA: cleartext on the members, its hash everywhere, nothing on Org4
    writes = {args[2].decode(): tr["value"] for cc, args, tr in run["calls"].values()
              if cc == "pvtcc"}
    hashed = {hashlib.sha256(k.encode()).hexdigest(): hashlib.sha256(v).digest()
              for k, v in writes.items()}
    for i, p in enumerate(peers):
        if p["hashed"] != hashed:
            raise AssertionError(f"config4_network_path: org{i + 1}'s collA hashes differ")
        member = i < 3
        if member and (p["clear"] != writes or p["missing"]):
            raise AssertionError(f"config4_network_path: org{i + 1} holds "
                                 f"{len(p['clear'])} of {len(writes)} collA values, "
                                 f"{len(p['missing'])} missing")
        if not member and (p["clear"] or p["transient"] or p["pvt_rows"] or p["missing"]):
            raise AssertionError(f"config4_network_path: org4 (no member) holds collA data: "
                                 f"{len(p['clear'])} values, {p['transient']} transient, "
                                 f"{len(p['pvt_rows'])} store rows, {len(p['missing'])} "
                                 "eligible missing")
    held = held_to_plain("config4_network_path", signs, verifies)

    cut = (run["ordering"] or {}).get("cut_at", {})
    windows = [(cut[n], at[n]) for at in run["committed_at"] for n in at if n in cut]
    during = [1e3 * (b - a) for a, b in run["probes"]
              if any(a < w1 and b > w0 for w0, w1 in windows)]
    changes = (run["ordering"] or {}).get("changes", [])
    leaders = [(c["node"], c["term"]) for c in changes if c["state"] == "leader"]
    log("config4_network_gossip",
        pushes=[g["pushes"] for g in run["gossip"]], acks=[g["acks"] for g in run["gossip"]],
        pulls_served=[g["pulls"] for g in run["gossip"]],
        pulled=[g["pulled"] for g in run["gossip"]],
        reconciled=[g["reconciled"] for g in run["gossip"]],
        anti_entropy_blocks=run["gossip"][CONFIG4_LATE]["ae_blocks"],
        late_catchup_s=run["late_catchup_s"], collA_writes=len(writes),
        ineligible_missing_org4=len(peers[3]["missing_all"]))
    log("config4_network_leaders", leader_elections=leaders,
        leader_changes=max(0, len(leaders) - 1), resubmitted=len(run["resubmitted"]),
        duplicates=len(ordered) - n_tx)
    log("config4_network_blocks", blocks=[{
        "number": n, "txs": len(oblocks[n].data.data),
        "cut_by": "count" if len(oblocks[n].data.data) == batch.max_message_count else "timeout",
        "valid": got[n].count(bytes([C.VALID])),
        "mvcc_read_conflict": got[n].count(bytes([C.MVCC_READ_CONFLICT])),
        "cut_to_committed_ms": {f"org{i + 1}": 1e3 * (at[n] - cut[n])
                                for i, at in enumerate(run["committed_at"])
                                if n in at and n in cut},
        "spans_ms": {f"org{i + 1}": p["spans_ms"].get(n) for i, p in enumerate(peers)}}
        for n in range(n_blocks)])
    log("config4_network_latency", endorse_ms_idle=_lat(run["endorse_ms"]),
        endorse_ms_while_committing=_lat(during), probes=len(run["probes"]),
        submit_to_status_ms=_lat(run["submit_status_ms"]), endorse_s=run["endorse_s"],
        first_block_submit_s=run["first_block_submit_s"],
        batch_timeout_s=batch.batch_timeout_s)
    log("config4_network_path", txs=n_tx, clients=clients, blocks=n_blocks, launches=counts,
        launches_by_peer=per_peer,
        sign_lanes={f"org{i + 1}": {k: lane.get(k) for k in ("signed_total", "batches_total")}
                    for i, lane in enumerate(run["peer_lanes"])},
        client_lane_batches=run["client_lane"].get("batches_total"),
        sign_lanes_launched=sorted(signs), verify_lanes_launched=sorted(verifies),
        plain_mismatches=held, tx_per_s=n_tx / run["committed_s"], wall_s=run["wall_s"],
        host_validation_equal=True, commit_hash=ref["commit_hash"],
        seconds=time.perf_counter() - t_phase)
    return counts


# ---------------------------------------------------------------------------
# The BFT ordering service: 4 consenters (f = 1) and a peer that checks
# each block's quorum attestation before its launch


BFT_CHANNEL = "bftchan"
BFT_BLOCKS = 3         # blocks before the leader is stopped; one more after
BFT_BLOCK_TXS = 16     # a block, cut by count
BFT_VIEW_TIMEOUT = 6.0  # beyond a normal block's ~1-2 s of ec_ref work on the orderers' core
BFT_POLICY = "OutOf(1, 'Org1MSP.peer')"


def bft_material(sign_batch=card_signer, seed=SEED + 44):
    """An orderer org of 4 consenters (carried through
    ``carry.from_cryptogen``), Org1 with a peer and a client, the genesis
    block (``consensus_type="bft"``, the consenters' identities)."""
    from fabric_tpu_torch import carry
    from fabric_tpu_torch.crypto import cryptogen, der
    from fabric_tpu_torch.crypto.msp import MSPManager
    from fabric_tpu_torch.tools import configtxgen as cg

    rng = np.random.default_rng(seed)
    org1 = cryptogen.generate_org("Org1MSP", "org1.bft.example.com", rng, now=WIRE_NOW,
                                  sign_batch=sign_batch)
    ca = cryptogen.CA.create("ord.bft.example.com", rng, now=WIRE_NOW, sign_batch=sign_batch)
    names = [f"orderer{i}.ord.bft.example.com" for i in range(4)]
    made = ca.issue_many([(n, "orderer") for n in names], sign_batch)
    carried, omsp = carry.from_cryptogen("OrdererMSP", der.pem_certificate(ca.cert_pem), {
        n: (der.pem_certificate(pem), d) for n, (d, pem) in zip(names, made)})
    ids = [f"o{i}" for i in range(4)]
    signers = {oid: carried[n] for oid, n in zip(ids, names)}
    omgr = MSPManager({"OrdererMSP": omsp})
    verifiers = {oid: omgr.deserialize_identity(s.serialized) for oid, s in signers.items()}
    profile = cg.Profile(BFT_CHANNEL, application_orgs=[cg.OrgProfile("Org1MSP", org1.msp())],
                         orderer_orgs=[cg.OrgProfile("OrdererMSP", omsp)], consensus_type="bft",
                         raft_consenters=[("127.0.0.1", 7050 + i, signers[oid].serialized, oid)
                                          for i, oid in enumerate(ids)],
                         max_message_count=BFT_BLOCK_TXS)
    return {"ids": ids, "signers": signers, "verifiers": verifiers, "org1": org1,
            "genesis": cg.genesis_block(profile)}


def bft_envelopes(org1, n_blocks, n_tx, sign_batch=card_signer) -> list:
    """``n_blocks`` x ``n_tx`` ``basic`` puts of the Org1 client, endorsed
    by Org1's peer → serialized envelopes, a list a block."""
    from fabric_tpu_torch.ledger.rwset import TxRWSet
    from fabric_tpu_torch.peer import txassembly as txa

    client = org1.users["User1@org1.bft.example.com"]
    peer = org1.nodes["peer0.org1.bft.example.com"]
    specs = []
    for b in range(n_blocks):
        for i in range(n_tx):
            rw = TxRWSet()
            rw.ns_rwset("basic").writes[f"b{b}_{i:03d}"] = b"v%d" % i
            specs.append(txa.TxSpec(client, [peer], rw.to_bytes(), "basic",
                                    channel_id=BFT_CHANNEL))
    envs = txa.build_envelopes(specs, sign_batch)
    return [envs[b * n_tx:(b + 1) * n_tx] for b in range(n_blocks)]


def bft_forgeries(mat, good, prev_hash: bytes) -> dict:
    """Two forgeries of the block after ``good`` (the last block of the
    stream), its transactions but the last, both signed by consenter o0
    as a byzantine orderer: one whose proof holds its own COMMIT alone,
    one that carries ``good``'s proof (2f+1 real signatures over another
    digest)."""
    import hashlib

    from fabric_tpu_torch import protoutil
    from fabric_tpu_torch.ordering.bft import _signable
    from fabric_tpu_torch.protos import messages as m

    evil = mat["signers"]["o0"]
    out = {}
    for kind in ("one_signature", "other_digest"):
        blk = protoutil.new_block(good.header.number + 1, prev_hash)
        blk.data.data.extend(good.data.data[:-1])  # replayed transactions
        blk = protoutil.finalize_block(blk)
        seq = json.loads(bytes(good.metadata.metadata[m.META_ORDERER]))["index"] + 1
        if kind == "one_signature":
            d = hashlib.sha256(json.dumps([bytes(e).hex() for e in blk.data.data])
                               .encode()).hexdigest()
            msg = {"type": "bft_commit", "from": "o0", "view": 0, "seq": seq, "digest": d}
            msg["sig"] = evil.sign(_signable(msg)).hex()
            msg["from_cert"] = evil.serialized.hex()
            meta = {"term": 0, "index": seq, "bft_proof": [msg]}
        else:
            meta = json.loads(bytes(good.metadata.metadata[m.META_ORDERER]))
        blk.metadata.metadata[m.META_ORDERER] = json.dumps(meta).encode()
        protoutil.sign_block(blk, evil)
        out[kind] = blk
    return out


async def _bft_run(dev, mat, blocks_envs, root, sign_device=True):
    """The BFT ordering service (a child process) and the Org1 peer:
    ``BFT_BLOCKS`` blocks, the forgeries, the leader stopped, one block
    more → what the checks read."""
    import asyncio

    from fabric_tpu_torch import kernels, protoutil
    from fabric_tpu_torch.crypto import policy as pol
    from fabric_tpu_torch.ordering import BroadcastClient
    from fabric_tpu_torch.peer.chaincode import ChaincodeRuntime
    from fabric_tpu_torch.peer.node import PeerNode
    from fabric_tpu_torch.peer.validator import NamespaceInfo, PolicyProvider

    org1 = mat["org1"]
    svc = OrderingService({
        "channel": BFT_CHANNEL, "ids": mat["ids"], "consensus": "bft", "dir": f"{root}/orderers",
        "seed": SEED + 45, "genesis": mat["genesis"].serialize(), "signers": mat["signers"],
        "verifiers": mat["verifiers"], "view_timeout": BFT_VIEW_TIMEOUT,
        "batch": {"max_message_count": BFT_BLOCK_TXS, "batch_timeout_s": 2.0}})
    addrs = list(svc.cluster.values())
    peer = PeerNode("peer0.org1", f"{root}/peer", None, org1.nodes["peer0.org1.bft.example.com"],
                    ChaincodeRuntime(), device=dev, sign_device=sign_device, pipeline_depth=2)
    bc = BroadcastClient(addrs)
    out = {"accepted": [], "refused": {}, "commit_s": []}
    try:
        await peer.start()
        ch = peer.join_channel(BFT_CHANNEL, PolicyProvider(
            {"basic": NamespaceInfo(policy=pol.from_dsl(BFT_POLICY))}), genesis_block=mat["genesis"])
        attest = ch._verify_bft_attestation

        def recorded(blk, bundle):
            attest(blk, bundle)
            out["accepted"].append(blk.header.number)

        ch._verify_bft_attestation = recorded
        ch.start_deliver(addrs, censorship_check_s=CENSORSHIP_CHECK_S)
        kernels.reset_counts()

        def txs_held():
            return sum(len(ch.ledger.blocks.get_block(k).data.data)
                       for k in range(1, ch.height))

        async def block(envs):
            """``envs`` broadcast together, until the peer holds them all
            (one block cut by count; after the leader's stop, the retried
            broadcasts may arrive spread over more than one)."""
            want, t = txs_held() + len(envs), time.perf_counter()
            res = await asyncio.gather(*(bc.broadcast(BFT_CHANNEL, e, retries=200)
                                         for e in envs))
            bad = [r for r in res if r.get("status") != 200]
            if bad:
                raise AssertionError(f"bft_path: broadcasts refused: {bad[:3]}")
            deadline = time.monotonic() + 60
            while txs_held() < want:
                if time.monotonic() > deadline:
                    raise AssertionError(f"bft_path: the peer holds {txs_held()} of {want} "
                                         "transactions")
                await asyncio.sleep(0.02)
            out["commit_s"].append(time.perf_counter() - t)

        for envs in blocks_envs[:-1]:
            await block(envs)
        info = await svc.acall("info")
        out["views_before_stop"] = {o: c["view"] for o, c in info.items()}
        # forgeries of the next block, from the stream's own material
        good = ch.ledger.blocks.get_block(ch.height - 1)
        h = ch.height
        for kind, blk in bft_forgeries(mat, good, protoutil.block_header_hash(good.header)).items():
            try:
                await ch.commit_block(blk)
                out["refused"][kind] = None
            except ValueError as e:
                out["refused"][kind] = str(e)
        out["height_after_forgeries"] = (h, ch.height)
        stopped = await svc.acall("stop_leader")
        out["stopped"] = stopped["stopped"]
        t = time.perf_counter()
        await block(blocks_envs[-1])
        out["view_change_block_s"] = time.perf_counter() - t
        out["launches"] = dict(kernels.launches)
        info = await svc.acall("info")
        out["views_after"] = {o: c["view"] for o, c in info.items()}
        out["orderer_blocks"] = {o: await svc.acall("blocks", o) for o in info}
        ch.ledger.drain_state()
        out["peer_blocks"] = [ch.ledger.blocks.get_block(n) for n in range(ch.height)]
        out["msp"] = ch.validator.msp
    finally:
        await bc.close()
        await peer.stop()
        out["ordering"] = svc.close()
    return out


def phase_bft_path(dev, n_blocks=BFT_BLOCKS, n_tx=BFT_BLOCK_TXS, check_launches=True,
                   sign_batch=card_signer, sign_device=True):
    """The BFT ordering service on ``dev``: four ``OrdererNode(consensus=
    "bft")`` of an orderer org (f = 1) with ``signer`` and ``verifiers``
    from ``carry.from_cryptogen``, on a channel made from a genesis
    block with ``consensus_type="bft"`` and the consenters' identities, in
    a child process, and a ``PeerNode(device=dev, sign_device=True)`` of
    Org1 joined from that genesis block, which checks each block's
    orderer signature and quorum attestation at ``pre_launch_fn``.
    ``n_blocks`` blocks of ``n_tx`` transactions cut by count, two
    forged blocks (one COMMIT signature; another block's proof), the
    leader stopped, one block more after the view change.  Checks: each
    block carries 3 or more distinct consenter COMMIT signatures and the
    peer accepted each; the forgeries are refused and the height stays;
    no view change before the leader stopped, one after; the surviving
    orderers' blocks are equal; the peer's filters equal the host
    validation; ``p256_verify`` launched (``check_launches``).
    ``sign_device=False`` (a CPU rehearsal) keeps the peer's sign lane
    off."""
    import asyncio
    import shutil
    import tempfile

    from fabric_tpu_torch import protoutil
    from fabric_tpu_torch.crypto import policy as pol
    from fabric_tpu_torch.peer.validator import NamespaceInfo, PolicyProvider
    from fabric_tpu_torch.protos import messages as m

    t_phase = time.perf_counter()
    mat = bft_material(sign_batch)
    envs = bft_envelopes(mat["org1"], n_blocks + 1, n_tx, sign_batch)
    root = tempfile.mkdtemp(prefix="bft_path-")
    try:
        run = asyncio.run(_bft_run(dev, mat, envs, root, sign_device))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts = run["launches"]
    if check_launches and counts.get("p256_verify", 0) < n_blocks + 1:
        raise AssertionError(f"bft_path: p256_verify launched {counts.get('p256_verify', 0)} "
                             f"times for {n_blocks + 1} blocks")
    pblocks = run["peer_blocks"]
    want_numbers = list(range(1, len(pblocks)))
    sizes = [len(b.data.data) for b in pblocks[1:]]
    if sizes[:n_blocks] != [n_tx] * n_blocks or sum(sizes) != n_tx * (n_blocks + 1) or \
            sorted(set(run["accepted"])) != want_numbers:
        raise AssertionError(f"bft_path: the peer holds blocks of {sizes} txs, accepted "
                             f"{sorted(set(run['accepted']))}")
    if any(v is None for v in run["refused"].values()) or \
            run["height_after_forgeries"][0] != run["height_after_forgeries"][1]:
        raise AssertionError(f"bft_path: a forged block was not refused: {run['refused']}")
    if any(v != 0 for v in run["views_before_stop"].values()) or \
            not all(v >= 1 for v in run["views_after"].values()):
        raise AssertionError(f"bft_path: views {run['views_before_stop']} before the stop, "
                             f"{run['views_after']} after")
    proofs = []
    for b in pblocks[1:]:
        meta = json.loads(bytes(b.metadata.metadata[m.META_ORDERER]))
        signers = {c["from_cert"] for c in meta["bft_proof"]}
        proofs.append(len(signers))
    if min(proofs) < 3:
        raise AssertionError(f"bft_path: COMMIT signatures a block {proofs}")
    survivors = [[m.Block.parse(raw) for raw in blks] for blks in run["orderer_blocks"].values()]
    heads = [[(b.header.serialize(), b.data.serialize()) for b in blks] for blks in survivors]
    if any(h != heads[0] for h in heads) or len(heads[0]) != len(pblocks):
        raise AssertionError("bft_path: the surviving orderers' blocks differ")
    for a, b in zip(pblocks, survivors[0]):
        if a.header.serialize() != b.header.serialize():
            raise AssertionError("bft_path: the peer's blocks differ from the orderers'")
    got = [protoutil.get_tx_filter(b) for b in pblocks[1:]]
    host = host_filters(dev, survivors[0][1:], PolicyProvider(
        {"basic": NamespaceInfo(policy=pol.from_dsl(BFT_POLICY))}), run["msp"])
    if got != host or any(g != bytes(len(g)) for g in got):
        raise AssertionError(f"bft_path: filters {[list(g) for g in got]} against the host's "
                             f"{[list(h) for h in host]}")
    changes = (run["ordering"] or {}).get("changes", [])
    log("bft_path", blocks=len(pblocks) - 1, txs=sizes, commit_signatures=proofs,
        accepted=sorted(set(run["accepted"])),
        refused={k: v.split(":")[-1].strip() for k, v in run["refused"].items()},
        stopped_leader=run["stopped"], views_before_stop=run["views_before_stop"],
        views_after=run["views_after"],
        view_changes=sum(1 for c in changes if c["state"] == "leader") - 1,
        block_commit_s=run["commit_s"], view_change_block_s=run["view_change_block_s"],
        view_timeout_s=BFT_VIEW_TIMEOUT, launches=counts, host_validation_equal=True,
        seconds=time.perf_counter() - t_phase)
    return counts



# ---------------------------------------------------------------------------
# The node as operators run it: the CLI's daemons


CLI_CHANNEL = "clichan"
CLI_CC = "clicc"
CLI_TXS = 500            # one block at BatchConfig()'s max_message_count
CLI_CONFLICTS = 10       # planned conflict pairs in the burst
CLI_CLIENTS = 8
CLI_SETUP_TIMEOUT_S = 0.2   # OrdererConfig's batch timeout while the lifecycle is set up
CLI_BURST_TIMEOUT_S = 300.0  # the burst's: its block must be cut by count
CLI_WAIT_S = 180
CLI_STATUS_WAIT_S = 360
CLI_PEER_KERNELS = ("p256_verify", "stage2_policy", "stage2_mvcc", "p256_sign")
# Org2's peer: the autopilot, an SLO and the flight recorder (and its blackbox_dir)
CLI_OBSERVE = {"autopilot": True, "slos": "commit:latency:ms=2000", "vitals_interval_s": 0.5}
CLI_RESIDENT_KERNELS = ("resident_verok", "table_scatter")


class CliNetwork:
    """Daemons started by ``python -m fabric_tpu_torch.cli`` in
    ``subprocess.Popen`` children (a fresh interpreter each: no process
    holding a CUDA context is forked), their output in files."""

    def __init__(self, root: str, env: dict):
        self.root, self.env, self.procs = root, env, {}

    def cli(self, *args, timeout=CLI_WAIT_S) -> str:
        """One verb to its end → its stdout; a non-zero exit raises."""
        res = subprocess.run([sys.executable, "-m", "fabric_tpu_torch.cli", *args],
                             cwd=str(Path(__file__).resolve().parent), env=self.env,
                             capture_output=True, text=True, timeout=timeout)
        if res.returncode != 0:
            raise AssertionError(f"cli_path: `{' '.join(args[:8])}` exited {res.returncode}: "
                                 f"{res.stdout[-2000:]}{res.stderr[-4000:]}")
        return res.stdout

    def cli_json(self, *args, **kw):
        return json.loads(self.cli(*args, **kw).strip().splitlines()[-1])

    def spawn(self, name: str, *args, port: int) -> float:
        """Start a daemon → seconds from spawn to its port open."""
        log_path = f"{self.root}/{name}.log"
        t0 = time.perf_counter()
        with open(log_path, "ab") as out:
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-m", "fabric_tpu_torch.cli", *args],
                cwd=str(Path(__file__).resolve().parent), env=self.env, stdout=out,
                stderr=subprocess.STDOUT)
        import socket

        deadline = t0 + CLI_WAIT_S
        while time.perf_counter() < deadline:
            if self.procs[name].poll() is not None:
                raise AssertionError(f"cli_path: {name} exited {self.procs[name].returncode} "
                                     f"before its port opened")
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                return time.perf_counter() - t0
            except OSError:
                time.sleep(0.1)
        raise AssertionError(f"cli_path: {name}'s port {port} did not open in {CLI_WAIT_S} s")

    def stop(self, name: str) -> None:
        """SIGINT, then a kill after 10 s."""
        import signal

        p = self.procs.pop(name)
        p.send_signal(signal.SIGINT)
        try:
            p.wait(10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()

    def stop_all(self) -> None:
        for name in list(self.procs):
            self.stop(name)

    def cpu_s(self) -> dict:
        """CPU seconds (user + system) each daemon and this process have
        used so far, read from /proc."""
        tick = os.sysconf("SC_CLK_TCK")
        out = {"smoke": sum(os.times()[:2])}
        for name, p in self.procs.items():
            try:
                with open(f"/proc/{p.pid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
                out[name] = (int(fields[11]) + int(fields[12])) / tick
            except (OSError, IndexError, ValueError):
                out[name] = None
        return out

    def logs(self) -> str:
        out = []
        for path in sorted(Path(self.root).glob("*.log")):
            out.append(f"----- {path.name} -----\n{path.read_text(errors='replace')[-6000:]}")
        return "\n".join(out)


def _http_json(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read())


def _http_text(port: int, path: str) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read().decode()


async def _cli_transport_refused(port, ctx) -> bool:
    """Whether a client with ``ctx`` (None: plaintext) is refused at the
    transport: its ``Info`` call fails or is cut."""
    from fabric_tpu_torch.comm.rpc import RpcClient

    cli = RpcClient("127.0.0.1", port, ssl_ctx=ctx)
    try:
        await cli.connect()
        await cli.unary("Info", b'{"channel": "x"}', timeout=30)
        return False
    except Exception:
        return True
    finally:
        await cli.close()


async def _cli_burst(dev, port, ssl_ctx, user, calls, clients, sign_device, cpu_s):
    """``calls`` from ``clients`` gateway clients over mTLS, each client
    endorsing a transaction and submitting it at once, then every commit
    status awaited → what the checks read, with ``cpu_s()`` (each
    process's CPU seconds) at the start, after the submissions and at
    the end.  The clients sign on a sign lane of their own."""
    import asyncio

    from fabric_tpu_torch.peer import signlane
    from fabric_tpu_torch.peer.gateway import GatewayClient

    lane = None
    signer = user
    if sign_device:
        lane = signlane.SignBatcher(signlane.device_sign_backend(user.d, device=dev)).start()
        signer = signlane.BatchedSigner(user, lane)
    gcs = [GatewayClient("127.0.0.1", port, signer, ssl_ctx=ssl_ctx) for _ in range(clients)]
    out = {"calls": {}, "status": {}, "endorse_ms": [], "submit_ms": [],
           "submit_status_ms": []}
    try:
        sent = []

        async def client(ci):
            for args in calls[ci::clients]:
                t0 = time.perf_counter()
                tx_id, env = await gcs[ci].endorse(CLI_CHANNEL, CLI_CC, args)
                t1 = time.perf_counter()
                out["endorse_ms"].append(1e3 * (t1 - t0))
                out["calls"][tx_id] = args
                await gcs[ci].submit(CLI_CHANNEL, env)
                out["submit_ms"].append(1e3 * (time.perf_counter() - t1))
                sent.append((ci, tx_id, t1))

        async def status(ci, tx_id, t):
            out["status"][tx_id] = await gcs[ci].commit_status(CLI_CHANNEL, tx_id,
                                                               timeout=CLI_STATUS_WAIT_S)
            out["submit_status_ms"].append(1e3 * (time.perf_counter() - t))

        out["cpu_s"] = [cpu_s()]
        t0 = time.perf_counter()
        await asyncio.gather(*(client(ci) for ci in range(clients)))
        out["submitted_s"] = time.perf_counter() - t0
        out["cpu_s"].append(cpu_s())
        await asyncio.gather(*(status(*x) for x in sent))
        out["burst_s"] = time.perf_counter() - t0
        out["cpu_s"].append(cpu_s())
        out["client_lane"] = lane.stats() if lane is not None else None
    finally:
        for g in gcs:
            await g.close()
        if lane is not None:
            lane.stop()
    return out


def phase_cli_path(dev, n_tx=CLI_TXS, conflicts=CLI_CONFLICTS, clients=CLI_CLIENTS,
                   check_launches=True, sign_device=True, root=None):
    """``tests/test_cli_network.py``'s network, started only through
    ``python -m fabric_tpu_torch.cli``: cryptogen (Org1, Org2 and an
    orderer org; certificates signed by ``p256_sign`` on the card), a
    genesis block with the orderer org (peers check every block's
    signature), one Raft orderer, one ``chaincode`` server (``kv``) and
    two peers on the card (``sign_device``, ``pipeline_depth`` 2; Org1's
    with ``state_resident``), mutual TLS on every node's listener and an
    operations port on every node.  The verbs set up the chaincode
    (ccpackage, ccinstall on both peers, ccqueryinstalled, approve from
    each org binding the package id, commit; no chaincode registered
    statically), then invoke, query, discover.  The orderer is restarted
    with a batch timeout past the burst's admission (its Writers check
    of each envelope is a host ``ec_ref`` check), and 8 gateway clients
    in this process, over the mTLS client profile and a sign lane of
    their own, endorse ``n_tx`` transactions on both peers (the
    lifecycle's MAJORITY ``Endorsement``), each submitted once endorsed:
    one block cut by count, ``conflicts`` of them MVCC_READ_CONFLICT.  Checks: the
    codes against construction, /healthz on every node,
    ``ledger_blockchain_height`` in /metrics, each peer's /launches
    (its own process's kernel counts), plaintext and uncertified clients
    refused by every listener, the two ledgers ``ledgerutil`` identical
    and verified, and ``replay`` of Org2's config from Org1's block
    store on the card identical to Org1's ledger."""
    import asyncio
    import shutil
    import tempfile

    from fabric_tpu_torch import kernels, protoutil
    from fabric_tpu_torch.comm.rpc import make_client_tls
    from fabric_tpu_torch.crypto.cryptogen import load_signing_identity
    from fabric_tpu_torch.ledger.blockstore import BlockStore
    from fabric_tpu_torch.peer.txcodes import TxValidationCode as C

    own = root is None
    root = root or tempfile.mkdtemp(prefix="fabtpu-cli-")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent)
    env.pop("FABTPU_FAULTS", None)
    net = CliNetwork(root, env)
    device = dev.type
    kernels.reset_counts()
    t_phase = time.perf_counter()
    try:
        crypto = f"{root}/crypto"
        t0 = time.perf_counter()
        net.cli("cryptogen", "--device", device, "--org", "Org1MSP:org1.example.com",
                "--org", "Org2MSP:org2.example.com", "--org", "OrdererMSP:ord.example.com",
                "--orderers", "1", "--output", crypto)
        cryptogen_s = time.perf_counter() - t0
        org1, org2, ordorg = (f"{crypto}/{d}.example.com" for d in ("org1", "org2", "ord"))
        ca_bundle = f"{root}/tls-ca-bundle.pem"
        with open(ca_bundle, "wb") as bf:
            for od in (org1, org2, ordorg):
                bf.write(Path(f"{od}/tlsca/tlsca-cert.pem").read_bytes())

        def tls_cfg(org_dir, node):
            tdir = f"{org_dir}/nodes/{node}/tls"
            return {"cert": f"{tdir}/server.pem", "key": f"{tdir}/key.pem", "ca": ca_bundle}

        with open(f"{root}/profile.json", "w") as f:
            json.dump({"channel": CLI_CHANNEL,
                       "application_orgs": [{"msp_id": "Org1MSP", "dir": org1},
                                            {"msp_id": "Org2MSP", "dir": org2}],
                       "orderer_orgs": [{"msp_id": "OrdererMSP", "dir": ordorg}],
                       "max_message_count": n_tx}, f)
        genesis = f"{root}/genesis.block"
        net.cli("configtxgen", "--profile", f"{root}/profile.json", "--output", genesis)

        cc_port, ord_port, p1_port, p2_port = (free_port() for _ in range(4))
        ops = {"orderer": free_port(), "p1": free_port(), "p2": free_port()}

        def write_orderer(timeout_s):
            with open(f"{root}/orderer.json", "w") as f:
                json.dump({"id": "o0", "data_dir": f"{root}/o0", "port": ord_port,
                           "cluster": {"o0": ["127.0.0.1", ord_port]},
                           "max_message_count": n_tx, "batch_timeout_s": timeout_s,
                           "msp_id": "OrdererMSP",
                           "msp_dir": f"{ordorg}/nodes/orderer0.ord.example.com/msp",
                           "tls": tls_cfg(ordorg, "orderer0.ord.example.com"),
                           "operations_port": ops["orderer"],
                           "channels": [{"name": CLI_CHANNEL, "genesis": genesis}]}, f)

        def peer_cfg(pid, port, org_dir, msp_id, other_port, other_msp, resident):
            node = f"peer0.{os.path.basename(org_dir)}"
            return {"id": pid, "data_dir": f"{root}/{pid}", "port": port, "msp_id": msp_id,
                    "msp_dir": f"{org_dir}/nodes/{node}/msp", "tls": tls_cfg(org_dir, node),
                    "org_msps": [org1, org2], "device": device, "sign_device": sign_device,
                    "pipeline_depth": 2, "state_resident": resident,
                    "peers": [{"msp_id": other_msp, "host": "127.0.0.1", "port": other_port}],
                    "channels": [{"name": CLI_CHANNEL, "genesis": genesis,
                                  "orderers": [["127.0.0.1", ord_port]]}],
                    "operations_port": ops[pid]}

        cfgs = {"p1": peer_cfg("p1", p1_port, org1, "Org1MSP", p2_port, "Org2MSP", True),
                "p2": peer_cfg("p2", p2_port, org2, "Org2MSP", p1_port, "Org1MSP", False)}
        # Org2's peer arms the traffic autopilot, the SLO engine and the
        # flight recorder: its blocks must still equal Org1's
        cfgs["p2"].update(CLI_OBSERVE)
        cfgs["p2"]["blackbox_dir"] = f"{root}/p2-blackbox"
        for pid, cfg in cfgs.items():
            with open(f"{root}/{pid}.json", "w") as f:
                json.dump(cfg, f)
        write_orderer(CLI_SETUP_TIMEOUT_S)
        spawn_s = {"chaincode": net.spawn("chaincode", "chaincode", "--name", CLI_CC,
                                          "--port", str(cc_port), port=cc_port),
                   "orderer": net.spawn("orderer", "orderer", "--config",
                                        f"{root}/orderer.json", port=ord_port)}
        with ThreadPoolExecutor(2) as pool:  # both peers start together
            futs = {pid: pool.submit(net.spawn, pid, "peer", "--config", f"{root}/{pid}.json",
                                     port=port) for pid, port in (("p1", p1_port),
                                                                  ("p2", p2_port))}
            spawn_s.update({pid: f.result() for pid, f in futs.items()})

        ptls = f"{org1}/nodes/peer0.org1.example.com/tls"
        cli_tls = ("--tls-ca", ca_bundle, "--tls-cert", f"{ptls}/server.pem",
                   "--tls-key", f"{ptls}/key.pem")
        verbs = {}

        def verb(name, *args):
            t = time.perf_counter()
            got = net.cli_json(*args)
            verbs.setdefault(name, []).append(time.perf_counter() - t)
            return got

        pkg = f"{root}/kv.tgz"
        pkg_id = verb("ccpackage", "ccpackage", "--label", "kv_1", "--address",
                      f"127.0.0.1:{cc_port}", "--output", pkg)["package_id"]
        for pp in (p1_port, p2_port):
            got = verb("ccinstall", *cli_tls, "ccinstall", "--port", str(pp), "--package", pkg)
            if got["status"] != 200 or got["package_id"] != pkg_id:
                raise AssertionError(f"cli_path: ccinstall gave {got}")
        got = verb("ccqueryinstalled", *cli_tls, "ccqueryinstalled", "--port", str(p1_port))
        if got["installed"] != [{"package_id": pkg_id, "label": "kv_1"}]:
            raise AssertionError(f"cli_path: ccqueryinstalled gave {got}")
        spec = json.dumps({"policy": {"ref": "Endorsement"}, "package_id": pkg_id})
        for msp_id, org_dir in (("Org1MSP", org1), ("Org2MSP", org2)):
            u = f"{org_dir}/users/User1@{os.path.basename(org_dir)}/msp"
            got = verb("approve", *cli_tls, "invoke", "--port", str(p1_port), "--channel",
                       CLI_CHANNEL, "--chaincode", "_lifecycle", "--msp-dir", u, "--msp-id",
                       msp_id, "approve", CLI_CC, "1", spec)
            if got.get("code") != 0:
                raise AssertionError(f"cli_path: approve by {msp_id} gave {got}")
        user_msp = f"{org1}/users/User1@org1.example.com/msp"
        got = verb("commit", *cli_tls, "invoke", "--port", str(p1_port), "--channel",
                   CLI_CHANNEL, "--chaincode", "_lifecycle", "--msp-dir", user_msp,
                   "--msp-id", "Org1MSP", "commit", CLI_CC, "1", spec)
        if got.get("code") != 0:
            raise AssertionError(f"cli_path: commit gave {got}")
        got = verb("invoke", *cli_tls, "invoke", "--port", str(p1_port), "--channel",
                   CLI_CHANNEL, "--chaincode", CLI_CC, "--msp-dir", user_msp, "--msp-id",
                   "Org1MSP", "put", "city", "lucerne")
        if got.get("code_name") != "VALID":
            raise AssertionError(f"cli_path: invoke gave {got}")
        got = verb("query", *cli_tls, "query", "--port", str(p2_port), "--channel",
                   CLI_CHANNEL, "--chaincode", CLI_CC, "--msp-dir", user_msp, "--msp-id",
                   "Org1MSP", "get", "city")
        if got.get("payload") != "lucerne":
            raise AssertionError(f"cli_path: query gave {got}")
        got = verb("discover", *cli_tls, "discover", "--port", str(p1_port), "--channel",
                   CLI_CHANNEL, "--query", "endorsers", "--chaincode", CLI_CC)
        if got.get("status") != 200 or \
                {"Org1MSP": 1, "Org2MSP": 1} not in got["descriptor"]["layouts"]:
            raise AssertionError(f"cli_path: discover gave {got}")
        setup_s = time.perf_counter() - t_phase
        log("cli_path_setup", spawn_to_port_s=spawn_s, cryptogen_s=cryptogen_s,
            verb_s=verbs, setup_s=setup_s, package_id=pkg_id)

        # the burst's block is cut by count: the orderer restarts with a
        # batch timeout past the burst's admission
        net.stop("orderer")
        write_orderer(CLI_BURST_TIMEOUT_S)
        spawn_s["orderer_restart"] = net.spawn("orderer", "orderer", "--config",
                                               f"{root}/orderer.json", port=ord_port)
        user = load_signing_identity(user_msp, "Org1MSP")
        ctx = make_client_tls(Path(ca_bundle).read_bytes(),
                              Path(f"{ptls}/server.pem").read_bytes(),
                              Path(f"{ptls}/key.pem").read_bytes())
        calls, _ = network_txs(n_tx, n_tx, conflicts)
        burst = asyncio.run(_cli_burst(dev, p1_port, ctx, user, calls, clients, sign_device,
                                       net.cpu_s))
        smoke_launches = dict(kernels.launches)

        # every listener refuses plaintext and uncertified clients
        plain_ctx = make_client_tls(Path(ca_bundle).read_bytes())

        async def refusals():
            out = {}
            for name, port in (("orderer", ord_port), ("p1", p1_port), ("p2", p2_port)):
                out[name] = (await _cli_transport_refused(port, None),
                             await _cli_transport_refused(port, plain_ctx))
            await asyncio.sleep(0.1)  # the cut connections' pumps end
            return out

        refused = asyncio.run(refusals())
        if not all(a and b for a, b in refused.values()):
            raise AssertionError(f"cli_path: a listener served a plaintext or uncertified "
                                 f"client: {refused}")
        health, heights, launches, traces, ledgers = {}, {}, {}, {}, {}
        for name, port in ops.items():
            status, body = _http_json(port, "/healthz")
            health[name] = body["status"]
            if status != 200 or body["status"] != "OK":
                raise AssertionError(f"cli_path: /healthz of {name}: {status} {body}")
        def metrics_height(pid):
            hl = [ln for ln in _http_text(ops[pid], "/metrics").splitlines()
                  if ln.startswith("ledger_blockchain_height")]
            return float(hl[0].rsplit(" ", 1)[1]) if hl else None

        # the burst's statuses come from Org1's peer: Org2's may still be
        # committing the block
        deadline = time.perf_counter() + CLI_WAIT_S
        while True:
            heights.update({pid: metrics_height(pid) for pid in ("p1", "p2")})
            if heights["p1"] == heights["p2"] or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
        for pid in ("p1", "p2"):
            _, body = _http_json(ops[pid], "/launches?n=0")
            launches[pid] = {
                "kernel_launches": body["kernel_launches"],
                # the ledger's stats cover its retained rows only
                "ledger_rows_retained": body["rows_retained"],
                "ledger": {k: {"launches": v["launches"], "execute_ms": v["execute_ms"]}
                           for k, v in body["kernels"].items()}}
        log("cli_path_launches", smoke=smoke_launches, peers=launches)
        observed = {path: _http_json(ops["p2"], path)[1] for path in ("/slo", "/autopilot",
                                                                      "/vitals")}
        if ("commit" not in [o["name"] for o in observed["/slo"]["objectives"]]
                or not (observed["/autopilot"]["configured"]
                        and observed["/autopilot"]["enabled"])
                or not observed["/vitals"]["enabled"] or observed["/vitals"]["samples"] < 1):
            raise AssertionError(f"cli_path: Org2's /slo, /autopilot or /vitals: "
                                 f"{json.dumps(observed)[:3000]}")
        log("cli_path_observe",
            slo={o["name"]: o["channels"] for o in observed["/slo"]["objectives"]},
            autopilot={"knobs": {k: v["value"] for k, v in
                                 observed["/autopilot"]["knobs"].items()},
                       "decisions": observed["/autopilot"]["decisions"]},
            vitals={"samples": observed["/vitals"]["samples"],
                    "series": observed["/vitals"]["series_count"],
                    "incidents": observed["/vitals"]["incidents"]})
        burst_block = None
        status_codes = {s.get("code_name") for s in burst["status"].values()}
        block_nums = {s.get("block") for s in burst["status"].values()}
        for pid in ("p1", "p2"):
            for num in sorted(n for n in block_nums if n is not None):
                code, tree = 0, None
                try:
                    code, tree = _http_json(ops[pid], f"/trace?block={num}")
                except Exception as e:
                    tree = {"error": str(e)}
                if code == 200:
                    traces.setdefault(pid, {})[num] = {
                        "total_ms": tree["dur_ms"],
                        "spans_ms": {c["name"]: c["dur_ms"] for c in tree.get("children", [])}}
        log("cli_path_traces", peers=traces)
    except BaseException:
        print(net.logs(), file=sys.stderr, flush=True)
        raise
    finally:
        net.stop_all()

    try:
        p1_dir, p2_dir = f"{root}/p1/{CLI_CHANNEL}", f"{root}/p2/{CLI_CHANNEL}"
        store = BlockStore(f"{p1_dir}/chains")
        try:
            blocks = [store.get_block(n) for n in range(store.height)]
        finally:
            store.close()
        burst_blocks = [b for b in blocks
                        if any(protoutil.channel_header(e).tx_id in burst["calls"]
                               for e in b.data.data)]
        expected, _ = network_expected(burst_blocks, burst["calls"])
        got_codes = [protoutil.get_tx_filter(b) for b in burst_blocks]
        n_conflicts = sum(c == C.MVCC_READ_CONFLICT for f in got_codes for c in f)
        if [len(b.data.data) for b in burst_blocks] != [n_tx]:
            raise AssertionError(f"cli_path: the burst took blocks of "
                                 f"{[len(b.data.data) for b in burst_blocks]} txs, not one of "
                                 f"{n_tx} cut by count")
        if got_codes != expected or n_conflicts != conflicts:
            raise AssertionError(f"cli_path: the burst's codes differ from construction "
                                 f"({n_conflicts} conflicts)")
        height = len(blocks)
        if any(h != height for h in heights.values()):
            raise AssertionError(f"cli_path: /metrics heights {heights}, ledger {height}")
        for pid in ("p1", "p2"):
            ledgers[pid] = net.cli_json("ledgerutil", "verify", f"{root}/{pid}/{CLI_CHANNEL}")
            if not ledgers[pid]["ok"] or ledgers[pid]["height"] != height:
                raise AssertionError(f"cli_path: ledgerutil verify {pid}: {ledgers[pid]}")
        compare = net.cli_json("ledgerutil", "compare", p1_dir, p2_dir)
        if not compare["identical"]:
            raise AssertionError(f"cli_path: the resident and plain peers differ: {compare}")
        rcfg = dict(cfgs["p2"], data_dir=f"{root}/p2r", operations_port=None,
                    blackbox_dir="")
        with open(f"{root}/p2r.json", "w") as f:
            json.dump(rcfg, f)
        t0 = time.perf_counter()
        replay = net.cli_json("replay", "--config", f"{root}/p2r.json", "--channel",
                              CLI_CHANNEL, "--source", f"{p1_dir}/chains")
        replay["wall_s"] = time.perf_counter() - t0
        rcompare = net.cli_json("ledgerutil", "compare", p1_dir, f"{root}/p2r/{CLI_CHANNEL}")
        if replay["height"] != height or not rcompare["identical"]:
            raise AssertionError(f"cli_path: the replay reached {replay['height']} of "
                                 f"{height}: {rcompare}")
        log("cli_path_replay", **{k: v for k, v in replay.items()
                                  if k != "pipeline_overlap_coverage"},
            overlap=replay.get("pipeline_overlap_coverage"))
    except BaseException:
        print(net.logs(), file=sys.stderr, flush=True)
        raise
    if check_launches:
        for pid in ("p1", "p2"):
            kl = launches[pid]["kernel_launches"]
            need = CLI_PEER_KERNELS + (CLI_RESIDENT_KERNELS if pid == "p1" else ())
            if any(kl[k] == 0 for k in need):
                raise AssertionError(f"cli_path: peer {pid} launched none of some of {need}: "
                                     f"{kl}")
            if pid == "p2" and any(kl[k] for k in CLI_RESIDENT_KERNELS):
                raise AssertionError(f"cli_path: the non-resident peer launched "
                                     f"{CLI_RESIDENT_KERNELS}: {kl}")
        if smoke_launches["p256_sign"] == 0:
            raise AssertionError("cli_path: the clients' sign lane launched no p256_sign")
    n = len(burst["submit_status_ms"])
    log("cli_path_burst", txs=n, blocks=[len(b.data.data) for b in burst_blocks],
        conflicts=n_conflicts, submitted_s=burst["submitted_s"], burst_s=burst["burst_s"],
        tx_per_s=n / burst["burst_s"], submit_ms=_lat(burst["submit_ms"]),
        submit_to_status_ms=_lat(burst["submit_status_ms"]),
        endorse_ms=_lat(burst["endorse_ms"]), status_codes=sorted(map(str, status_codes)),
        cpu_s_to_submitted={k: v - burst["cpu_s"][0][k] for k, v in burst["cpu_s"][1].items()
                            if v is not None and burst["cpu_s"][0].get(k) is not None},
        cpu_s_to_committed={k: v - burst["cpu_s"][1][k] for k, v in burst["cpu_s"][2].items()
                            if v is not None and burst["cpu_s"][1].get(k) is not None},
        client_lane=burst["client_lane"])
    log("cli_path", ok=True, height=height, health=health, metrics_height=heights,
        refused=refused, ledgers=ledgers, identical=compare["identical"],
        replay_identical=rcompare["identical"], seconds=time.perf_counter() - t_phase)
    if own:
        shutil.rmtree(root, ignore_errors=True)
    return {pid: launches[pid]["kernel_launches"] for pid in ("p1", "p2")}


def kernel_frames(build_log: dict, names) -> dict:
    """ptxas's report for the kernels whose mangled names hold one of
    ``names``: {name: {stack, spill_stores, spill_loads, registers}}
    (bytes and registers a thread); a name the log lacks (a library
    loaded from the build cache) is left out."""
    out = {}
    for text in build_log.values():
        for m in re.finditer(r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, "
                             r"(\d+) bytes spill stores, (\d+) bytes spill loads"
                             r"(?:\n.*?Used (\d+) registers)?", text):
            for n in names:
                if n in m.group(1):
                    out[n] = {"stack": int(m.group(2)), "spill_stores": int(m.group(3)),
                              "spill_loads": int(m.group(4)),
                              "registers": int(m.group(5)) if m.group(5) else None}
    return out


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from fabric_tpu_torch import kernels, native
    except ModuleNotFoundError as e:
        if e.name != "fabric_tpu_torch":
            raise
        print(f"chip_smoke: cannot import fabric_tpu_torch ({e}) — run it from the root of "
              f"the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)
    phases = {}  # each phase's seconds, the phases line

    def timed(name, fn, *a):
        t = time.perf_counter()
        try:
            return fn(*a)
        finally:
            phases[name] = time.perf_counter() - t

    t_build = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ beside nvcc
        host = pool.submit(native.build)
        secs = kernels.build()
        host_secs = host.result()
    phases["build"] = time.perf_counter() - t_build
    regs = {n: [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
            for n, text in kernels.build_log.items()}
    # static shared memory per block of each kernel, as ptxas reports it
    smem = {n: [int(m) for m in re.findall(r"(\d+) bytes smem", text)]
            for n, text in kernels.build_log.items()}
    log("build", seconds=secs, ptxas=regs, static_smem_bytes=smem,
        host_cpp={"compiler": native.compiler_version(), "seconds": host_secs,
                  "per_library_s": dict(native.build_seconds)})
    redesigned = {"stage2_policy_kernel": "stage2", "resident_verok_kernel": "resident",
                  "sha256_blocks_kernel": "sha256"}
    frames = kernel_frames(kernels.build_log, redesigned)
    log("kernel_frames", **frames)
    unread = [n for n, lib in redesigned.items() if lib in kernels.build_log and n not in frames]
    if unread or any(v["stack"] or v["spill_stores"] or v["spill_loads"]
                     for v in frames.values()):
        raise AssertionError(f"a redesigned kernel keeps a stack frame or spills, or ptxas "
                             f"did not report it: {frames}, unread {unread}")
    t0 = time.perf_counter()
    net = Net(SEED)
    phases["signatures"] = time.perf_counter() - t0
    log("signatures", identities=len(net.keys), per_identity=POOL,
        seconds=time.perf_counter() - t0)
    dev = torch.device("cuda")
    recs = [timed("verify", phase_verify, net, dev)]
    recs += timed("stage2", phase_stage2, dev)
    counts, main_res = timed("main_path", phase_main_path, net)
    for r in recs:
        r["launches"] = counts[r["name"]]
    counts, path_ubs = timed("resident_path", phase_resident_path, net)
    res_recs = timed("resident_kernels", phase_resident_kernels, dev, path_ubs)
    for r in res_recs:
        r["launches"] = counts[r["name"]]
    recs += res_recs
    recs.append(timed("sign", phase_sign, net, dev))
    wired = timed("wire_path", phase_wire_path, dev)
    wire, msp = wired["wire"], wired["msp"]
    timed("coalesced_path", phase_coalesced_path, dev, wired)
    ap_shapes = timed("autopilot_path", phase_autopilot_path, dev, wired)
    timed("host_stage", phase_host_stage, net, wire, msp)
    recs.append(timed("sha256", phase_sha256, dev, wire[0]))
    recs += timed("comparison", phase_comparison, net, dev, main_res)
    timed("sidecar", phase_sidecar, net, main_res)
    timed("config4_path", phase_config4_path, dev)
    timed("config5_path", phase_config5_path, dev)
    ledger_built = timed("ledger_build", build_ledger)
    timed("ledger_path", phase_ledger_path, dev, ledger_built)
    timed("observe_path", phase_observe_path, dev, ledger_built)
    timed("chaos_path", phase_chaos_path, dev, ledger_built)
    timed("network_path", phase_network_path, dev)
    # the kernels line gives the launches of the peers' kernels on
    # config 4's network: the four peers' commit paths and sign lanes
    net_counts = timed("config4_network_path", phase_config4_network_path, dev)
    for r in recs:
        if r["name"] in NETWORK_KERNELS:
            r["launches"] = net_counts[r["name"]]
    timed("bft_path", phase_bft_path, dev)
    timed("cli_path", phase_cli_path, dev)
    log("phases", seconds=phases, total_s=sum(phases.values()))
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "mismatches",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the autopilot path's launches of the shapes the knobs moved to
    for r in recs:
        if r["name"] == "p256_verify":
            r["autopilot_shapes"] = ap_shapes["verify_shapes"]
        elif r["name"] == "p256_sign":
            r["autopilot_shapes"] = ap_shapes["sign_buckets"]
    print(json.dumps({"kernels": [{**{k: r[k] for k in order},
                                   **({"autopilot_shapes": r["autopilot_shapes"]}
                                      if "autopilot_shapes" in r else {})}
                                  for r in recs]}), flush=True)
    log("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
