"""The port's hand-written CUDA kernels against their plain versions on
the card.  Marked ``cuda``: on a host without a CUDA device every test
skips.  On a GPU host (which need not have JAX) run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Exact equality throughout: every output is a bit or an integer."""

import numpy as np
import pytest
import torch

from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.ops import mvcc
from fabric_tpu_torch.ops import p256v3 as v3
from fabric_tpu_torch.peer import device_block as db

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the sm_90a kernels run only on an NVIDIA GPU")
    return torch.device("cuda")


def _items(n):
    rng = np.random.default_rng(3)
    keys = [ec_ref.SigningKey(d=int(rng.integers(1, 1 << 62))) for _ in range(3)]
    base = []
    for k in keys:
        for j in range(4):
            e = int.from_bytes(rng.bytes(32), "big")
            base.append((e, *k.sign_digest(e), *k.public))
    base += [(0, *k.sign_digest(0), *k.public) for k in keys]  # zero u1 windows
    wrapped = [ec_ref.wrapped_x_signature(int(rng.integers(1, 1 << 62)) << 64,
                                          int.from_bytes(rng.bytes(32), "big"),
                                          ec_ref.HALF_N - j) for j in range(2)]
    out = []
    for i in range(n):
        e, r, s, qx, qy = base[i % len(base)]
        kind = i % 10
        if kind == 1:
            r = (r + 1) % ec_ref.N
        elif kind == 2:
            s = ec_ref.N - s
        elif kind == 3:
            qx = (qx + 1) % ec_ref.P
        elif kind == 4:
            e ^= 2
        elif kind == 5:
            s = ec_ref.N + 1
        elif kind in (6, 7):  # x(R) in [n, p): accepted only through r + n
            e, r, s, qx, qy = wrapped[i % 2]
            e ^= kind == 7
        elif kind == 8:
            qx, qy = 0, 0
        out.append((e, r, s, qx, qy))
    return out


def test_p256_verify_kernel_matches_plain(cuda):
    items = _items(200)
    frame = torch.from_numpy(v3.stage_frame(items, v3._bucket(len(items)))).to(cuda)
    got = v3.verify_batch_packed(frame)
    assert torch.equal(got, v3.verify_batch_ref(frame))
    want = [ec_ref.verify_digest((x, y), e, r, s) for e, r, s, x, y in items]
    assert got[:len(items)].tolist() == want and any(want) and not all(want)


# the largest batch p256_verify.cu runs at 8 threads a lane (FAB_TEAM8_LANES)
TEAM8_LANES = 6144


@pytest.mark.parametrize("lanes", [1, 33, 3071, TEAM8_LANES, TEAM8_LANES + 1])
def test_p256_verify_kernel_ragged_and_large(cuda, lanes):
    """Unpadded batches that fill no whole block (1, 33, 3,071 lanes: a
    partial last block, its spare teams on a dummy row), and one batch on
    each side of the team-size switch: 6,144 lanes (a sidecar shape) at
    8 threads a lane, 6,145 at 4."""
    from fabric_tpu_torch import kernels

    frame = torch.from_numpy(v3.stage_frame(_items(lanes), lanes)).to(cuda)
    got = kernels.p256_verify(frame, v3._kernel_consts(cuda))
    torch.cuda.synchronize()
    assert got.shape == (lanes,) and torch.equal(got, v3.verify_batch_ref(frame))


def test_p256_verify_launch_many_four_blocks(cuda):
    """One ``verify_launch_many`` over four blocks' batches (4 x 3,072 =
    12,288 lanes: the coalesced path's launch, at 4 threads a lane) gives
    each block the bits of its own single launch and of the plain version
    over the same frame, in one launch."""
    from fabric_tpu_torch import kernels

    base = _items(3000)
    blocks = [base[7 * b:] + base[:7 * b] for b in range(4)]
    before = kernels.launches["p256_verify"]
    many = v3.verify_launch_many(blocks, device=cuda)
    torch.cuda.synchronize()
    assert kernels.launches["p256_verify"] - before == 1
    frame = torch.from_numpy(np.concatenate([v3.stage_frame(b, 3072) for b in blocks])).to(cuda)
    plain = v3.verify_batch_ref(frame)
    for b, (items, h) in enumerate(zip(blocks, many)):
        assert h.device_out.shape == (3072,) and h.n_real == 3000
        assert torch.equal(h.device_out, plain[3072 * b:3072 * (b + 1)])
        assert h.fetch() == v3.verify_launch(items, device=cuda).fetch()


def _stage2_operands(dev, T=256, n_sig=512, S=4, seed=5):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    sig_valid = rng.random(n_sig) < 0.85
    lv = np.zeros((T, 3), np.int32)
    lv[:, 0] = rng.integers(-2, n_sig, T)
    lv[:, 1] = rng.random(T) < 0.95
    lv[:, 2] = rng.random(T) < 0.9
    R, W, Q = 2, 2, 1
    sp = np.full((T, R + W + 2 * Q), -1, np.int32)
    sp[:, :R + W] = rng.integers(-1, 300, (T, R + W))
    for i in range(20):  # 20-deep chain
        sp[10 + i, 0], sp[10 + i, R] = 1000 + i, 1001 + i
        lv[10 + i] = (-2, 1, 1)
    rq = rng.choice(T, 30, replace=False)
    sp[rq, R + W] = rng.integers(0, 290, 30)
    sp[rq, R + W + Q] = sp[rq, R + W] + rng.integers(1, 10, 30)
    groups = []
    for dsl, eb in (("OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')", 256),
                    ("OutOf(1, 'Org1MSP.peer', 'Org1MSP.member')", 32)):
        plan = pol.compile_plan(pol.from_dsl(dsl))
        P = len(plan.principals)
        gp = np.zeros((eb, S * P + S + 1), np.int32)
        idx = np.where(rng.random((eb, S)) < 0.8, rng.integers(0, n_sig, (eb, S)), -1)
        gp[:, :S * P] = (rng.random((eb, S * P)) < 0.4) & np.repeat(idx >= 0, P, axis=1)
        gp[:, S * P:S * P + S] = idx
        gp[:, -1] = rng.integers(-1, T, eb)
        groups.append((plan, t(gp), eb, S))
    return t(sig_valid), t(lv), groups, t(sp), (R, W, Q)


@pytest.mark.parametrize("chunk,pooled", [(512, False), (1024, True), (4096, False)])
def test_p256_verify_chunked_launches_equal_a_monolithic_launch(cuda, chunk, pooled):
    """``verify_launch(chunk=)`` on the card: one ``p256_verify`` launch a
    ``_chunk_bounds`` chunk (pinned frames, ``non_blocking`` copies, a
    pool's lookahead when pooled), written into one output vector equal
    to a monolithic launch's and to the plain version's."""
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.parallel.hostpool import HostStagePool

    items = _items(3000)
    mono = v3.verify_launch(items, device=cuda)
    pool = HostStagePool(2) if pooled else None
    before = kernels.launches["p256_verify"]
    try:
        h = v3.verify_launch(items, device=cuda, chunk=chunk, pool=pool)
        torch.cuda.synchronize()
    finally:
        if pool is not None:
            pool.shutdown()
    assert kernels.launches["p256_verify"] - before == len(v3._chunk_bounds(3000, chunk))
    assert h.device_out.shape == (3072,) and torch.equal(h.device_out, mono.device_out)
    frame = torch.from_numpy(v3.stage_frame(items, 3072)).to(cuda)
    assert torch.equal(h.device_out, v3.verify_batch_ref(frame))


def test_stage2_kernels_match_plain(cuda):
    sv, lv, groups, sp, dims = _stage2_operands(cuda)
    got = db.stage2(sv, lv, groups, sp, dims)
    want = db.stage2_ref(sv, lv, groups, sp, dims)
    assert torch.equal(got, want)
    T = lv.shape[0]
    assert 0 < int(want[:T].sum()) < T


@pytest.mark.parametrize("share", [0.02, 0.5])
def test_stage2_host_verified_creator_lanes(cuda, share):
    """The fused stage 2 (``stage2_policy`` then ``stage2_mvcc``) at a
    block's shape with host-verified (idemix) creators: ``share`` of the
    lanes -2, a few -1, against the plain version; every -2 lane's
    creator bit is True, every -1 lane's False."""
    sv, lv, groups, sp, dims = _stage2_operands(cuda, T=1024, n_sig=3072, seed=13)
    rng = np.random.default_rng(17)
    lanes = lv[:, 0].cpu().numpy()
    lanes[:] = rng.integers(0, 3072, 1024)
    lanes[rng.random(1024) < share] = -2
    lanes[rng.choice(1024, 8, replace=False)] = -1
    lv[:, 0] = torch.from_numpy(lanes).to(cuda)
    got = db.stage2(sv, lv, groups, sp, dims)
    want = db.stage2_ref(sv, lv, groups, sp, dims)
    assert torch.equal(got, want)
    creator_ok = got[3 * 1024:4 * 1024].cpu().numpy().astype(bool)
    assert creator_ok[lanes == -2].all() and not creator_ok[lanes == -1].any()
    assert (lanes == -2).sum() > 0


POLICY_DSL = ("OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')",
              "OutOf(1, 'Org1MSP.peer', 'Org1MSP.member')",
              "AND('Org1MSP.member', OR('Org2MSP.peer', 'Org3MSP.peer'))")


def _policy_case(dev, case, T, seed=7):
    """Operands whose MVCC part is empty, so that the policy launch
    decides (as ``test_torch_kernels_host._policy_case``): ``empty``,
    ``tx_range``, ``spread``, ``wide`` (S = 64) or ``random``."""
    rng = np.random.default_rng(seed + T)
    n_sig = 2 * T + 40
    sv = rng.random(n_sig) < 0.85
    lv = np.zeros((T, 3), np.int32)
    lv[:, 0] = -2
    lv[:, 1] = lv[:, 2] = 1
    sp = np.full((T, 6), -1, np.int32)
    S = 64 if case == "wide" else 4
    sizes = {"empty": (64, 0, 32), "wide": (100, 16, 40)}.get(case, (128, 16, 32))
    groups = []
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for g, (dsl, eb) in enumerate(zip(POLICY_DSL, sizes)):
        plan = pol.compile_plan(pol.from_dsl(dsl))
        P = len(plan.principals)
        gp = np.zeros((eb, S * P + S + 1), np.int32)
        k = 2 if case == "wide" else S
        idx = np.full((eb, S), -1, np.int32)
        idx[:, :k] = np.where(rng.random((eb, k)) < 0.8, rng.integers(0, n_sig, (eb, k)), -1)
        if case == "wide":
            idx[::3, S - 1] = rng.integers(0, n_sig, len(idx[::3]))
        gp[:, :S * P] = (rng.random((eb, S * P)) < 0.4) & np.repeat(idx >= 0, P, axis=1)
        gp[:, S * P:S * P + S] = idx
        gp[:, -1] = rng.integers(0, T, eb)
        if case == "tx_range":
            gp[::4, -1] = -1
            gp[1::4, -1] = T
            gp[2::8, -1] = T + 5 + g
        if case == "spread":
            gp[:, -1] = np.arange(eb) % T
        groups.append((plan, t(gp), eb, S))
    return t(sv), t(lv), groups, t(sp), (2, 2, 1)


@pytest.mark.parametrize("case,T", [("empty", 96), ("tx_range", 96), ("spread", 48),
                                    ("wide", 96), ("random", 1), ("random", 31),
                                    ("random", 33), ("random", 1024)])
def test_stage2_policy_at_edges(cuda, case, T):
    """The one policy launch of a block at its edges (an empty group,
    tx_of -1 and >= T, a transaction's entries across groups, 31
    entries a CTA, T at the word edges and 1,024): the packed output
    equal to ``stage2_ref``, one ``stage2_policy`` launch for all the
    groups, with the frames in one buffer or given group by group."""
    from fabric_tpu_torch import kernels

    sv, lv, groups, sp, dims = _policy_case(cuda, case, T)
    want = db.stage2_ref(sv, lv, groups, sp, dims)
    kernels.reset_counts()
    got = db.stage2(sv, lv, groups, sp, dims)
    torch.cuda.synchronize()
    assert kernels.launches["stage2_policy"] == 1
    assert torch.equal(got, want)
    frames = db.group_frames(groups)
    table = db.policy_table([(p, e, s) for p, _, e, s in groups], cuda)
    assert torch.equal(db.stage2(sv, lv, groups, sp, dims, table, frames), want)


def test_mvcc_validate_kernel_matches_plain(cuda):
    _, lv, _, sp, (R, W, Q) = _stage2_operands(cuda, seed=9)
    rng = np.random.default_rng(9)
    T = sp.shape[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    rp = rng.random((T, R)) < 0.9
    rv = rng.integers(0, 3, (T, R, 2)).astype(np.int32)
    cp = rp ^ (rng.random((T, R)) < 0.03)
    cv = rv + (rng.random((T, R, 2)) < 0.03)
    args = (sp[:, :R].contiguous(), t(rp), t(rv), t(cp), t(cv.astype(np.int32)),
            sp[:, R:R + W].contiguous(), sp[:, R + W:R + W + Q].contiguous(),
            sp[:, R + W + Q:].contiguous(), t(rng.random(T) < 0.95))
    for a, b in zip(mvcc.mvcc_validate(*args), mvcc.mvcc_validate_ref(*args)):
        assert torch.equal(a, b)
    ver_ok, pre = lv[:, 2] != 0, lv[:, 1] != 0
    hv = (sp[:, :R].contiguous(), ver_ok, sp[:, R:R + W].contiguous(),
          sp[:, R + W:R + W + Q].contiguous(), sp[:, R + W + Q:].contiguous(), pre)
    for a, b in zip(mvcc.mvcc_validate_hostver(*hv), mvcc.mvcc_validate_hostver_ref(*hv)):
        assert torch.equal(a, b)


def _resident_operands(dev, seed=13, T=512, R=2, U=600, cap=1024, bad=0.1):
    rng = np.random.default_rng(seed)
    Ub = 1024
    sp = np.full((T, R + 4), -1, np.int32)
    sp[:, :R] = np.where(rng.random((T, R)) < 0.85, rng.integers(0, U, (T, R)), -1)
    sp[:4, 0] = [U, Ub, Ub + 5, U + 3]  # ids past the real keys and past the pack
    table = rng.integers(-2, 3, (cap, 3)).astype(np.int32)
    table[:, 0] = rng.random(cap) < 0.8
    u_pack = np.zeros((Ub, 4), np.int32)
    u_pack[:, 0] = np.where(rng.random(Ub) < 0.6, rng.integers(0, cap, Ub), -1)
    u_pack[5, 0] = cap + 7  # a slot past the table clamps to its last row
    u_pack[:, 1] = rng.random(Ub) < 0.8
    u_pack[:, 2:4] = rng.integers(-2, 3, (Ub, 2))
    ids = np.clip(sp[:, :R], 0, Ub - 1)
    slot = u_pack[ids, 0]
    read_pv = np.where((slot >= 0)[..., None], table[np.clip(slot, 0, cap - 1)],
                       u_pack[ids, 1:4]).astype(np.int32)
    read_pv[rng.random((T, R)) < bad, 0] ^= 1
    read_pv[rng.random((T, R)) < bad, 2] += 1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(sp), t(table), t(u_pack), t(read_pv), R


def test_resident_verok_kernel_matches_plain(cuda):
    sp, table, u_pack, read_pv, R = _resident_operands(cuda)
    lv = torch.zeros((sp.shape[0], 3), dtype=torch.int32, device=cuda)
    db.resident_ver_ok(sp, table, u_pack, read_pv, R, lv)
    want = db.resident_ver_ok_ref(sp, table, u_pack, read_pv, R)
    assert torch.equal(lv[:, 2] != 0, want)
    assert 0 < int(want.sum()) < want.shape[0]


@pytest.mark.parametrize("R", [1, 2, 3, 5, 40])
def test_resident_verok_at_read_counts(cuda, R):
    """A thread per (transaction, read) at R = 1, 2, 3, 5 (lanes padded
    to a power of two) and 40 (a warp a transaction walking its reads),
    against the plain version; the other columns stay untouched."""
    sp, table, u_pack, read_pv, _ = _resident_operands(cuda, seed=40 + R, T=700, R=R,
                                                       bad=0.2 / R)
    lv = torch.full((sp.shape[0], 3), 7, dtype=torch.int32, device=cuda)
    db.resident_ver_ok(sp, table, u_pack, read_pv, R, lv)
    want = db.resident_ver_ok_ref(sp, table, u_pack, read_pv, R)
    assert torch.equal(lv[:, 2] != 0, want)
    assert bool(((lv[:, 2] == 0) | (lv[:, 2] == 1)).all()) and bool((lv[:, :2] == 7).all())
    assert 0 < int(want.sum()) < want.shape[0]


def test_table_scatter_kernel_matches_plain(cuda):
    from fabric_tpu_torch.state import residency

    rng = np.random.default_rng(17)
    cap = 4096
    base = torch.from_numpy(rng.integers(-9, 9, (cap, 3)).astype(np.int32)).to(cuda)
    for k in (1, 16, 2048):
        idx = rng.choice(cap - 1, k, replace=False).astype(np.int32)
        idx[-1] = cap - 1  # the table's last row
        rows = rng.integers(-(1 << 31), 1 << 31, (k, 3)).astype(np.int32)
        got, want = base.clone(), base.clone()
        residency.table_scatter(got, idx, rows)
        residency.table_scatter_ref(want, torch.from_numpy(idx).to(cuda),
                                    torch.from_numpy(rows).to(cuda))
        assert torch.equal(got, want)
        assert torch.equal(got[cap - 1], torch.from_numpy(rows[-1]).to(cuda))
    with pytest.raises(IndexError):
        residency.table_scatter(base, np.array([cap]), np.zeros((1, 3)))


def test_resident_manager_on_card_matches_cpu(cuda):
    """The same admissions, scatters and block reads through a CUDA
    manager (its own stream) and a CPU manager."""
    from fabric_tpu_torch.ledger.statedb import MemVersionedDB, UpdateBatch
    from fabric_tpu_torch.state import ResidencyManager, build_launch_pack

    state = MemVersionedDB()
    seed = UpdateBatch()
    for i in range(300):
        if i % 7:
            seed.put("ns", f"k{i}", b"v", (1, i))
    state.apply_updates(seed)
    rng = np.random.default_rng(19)
    mgrs = [ResidencyManager(slots=128, range_bits=5, device=d) for d in ("cpu", cuda)]
    for step in range(6):
        pairs = sorted({("ns", f"k{int(i)}") for i in rng.choice(300, 100, replace=False)})
        T = 64
        sp = np.full((T, 2), -1, np.int32)
        sp[:, 0] = rng.integers(0, len(pairs), T)
        rpv = np.zeros((T, 2, 3), np.int32)
        rpv[:, 0] = [(1, 1, int(pairs[i][1][1:])) if int(pairs[i][1][1:]) % 7 else (0, 0, 0)
                     for i in sp[:, 0]]
        batch = UpdateBatch()
        for i in rng.choice(300, 20, replace=False):
            batch.put("ns", f"k{int(i)}", b"w", (2 + step, int(i)))
        outs = []
        for m in mgrs:
            dev = m.device
            spt, rpt = torch.from_numpy(sp).to(dev), torch.from_numpy(rpv).to(dev)
            lv = torch.zeros((T, 3), dtype=torch.int32, device=dev)
            build_launch_pack(m, pairs, state, read=lambda table, u: db.resident_ver_ok(
                spt, table, u, rpt, 2, lv))
            m.apply_batch(batch)
            outs.append(lv.cpu())
        state.apply_updates(batch)
        assert torch.equal(outs[0], outs[1])
        assert np.array_equal(mgrs[0].table_rows(), mgrs[1].table_rows())
        assert mgrs[0].stats() == mgrs[1].stats()
    assert mgrs[1].stats()["evictions_total"] > 0


def test_p256_sign_kernel_matches_plain_and_oracle(cuda):
    from fabric_tpu_torch.ops import p256sign

    N = ec_ref.N
    rng = np.random.default_rng(23)
    ks = [1, 2, N - 1, N - 2, 16, 16 ** 63, 0x0F << 200, (1 << 255) | 1]
    ks += [int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1 for _ in range(300)]
    limbs = np.zeros((v3._bucket(len(ks)), 16), np.int16)
    limbs[:len(ks)] = v3._limbs16(ks)
    limbs[len(ks):, -1] = 1
    lt = torch.from_numpy(limbs).to(cuda)
    got = p256sign.sign_batch_limbs(lt)
    assert torch.equal(got, p256sign.sign_batch_ref(lt))
    d = int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
    digests = [int.from_bytes(rng.bytes(32), "big") for _ in range(40)]
    sigs = p256sign.sign_digests(digests, d, device=cuda, verify_after=True)
    assert sigs == [ec_ref.SigningKey(d).sign_digest(e) for e in digests]


# the chain-count switch points of sign_chains, and the source's
# FAB_SIGN_TEAM8_LANES (the TPI switch)
SIGN_SWITCHES = (256, 768, 1664, 3072)


@pytest.mark.parametrize("lanes", sorted({1, 15, 16, 17, 256, 4096,
                                          *(b + d for b in SIGN_SWITCHES for d in (-1, 0, 1))}))
def test_p256_sign_kernel_at_lane_counts(cuda, lanes):
    """Unpadded batches on each side of every chain-count and team-size
    switch: bit-equal to the plain version at the chain count the
    wrapper picks, and X / Z of a few lanes equal to ``ec_ref``'s x."""
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.ops import p256sign

    N = ec_ref.N
    rng = np.random.default_rng(lanes)
    ks = [1, N - 1, 0xFFFFFFFF << 224, (1 << 128) - 1, 7 << 252][:lanes]
    ks += [int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1 for _ in range(lanes - len(ks))]
    lt = torch.from_numpy(v3._limbs16(ks)).to(cuda)
    C = p256sign.sign_chains(lanes)
    got = kernels.p256_sign(lt, *p256sign._kernel_tables(cuda), C)
    torch.cuda.synchronize()
    assert torch.equal(got, p256sign.sign_batch_ref(lt, chains=C))
    assert torch.equal(got, p256sign.sign_batch_limbs(lt))
    xz = got.cpu().numpy().view(np.uint32)
    for i in {0, lanes // 2, lanes - 1}:
        X, Z = p256sign._to_ints(xz[i:i + 1, 0])[0], p256sign._to_ints(xz[i:i + 1, 1])[0]
        assert X * pow(Z, -1, ec_ref.P) % ec_ref.P == ec_ref.pt_mul(ks[i], ec_ref.G)[0]


@pytest.mark.parametrize("chains", [1, 2, 4, 8, 16])
def test_p256_sign_kernel_at_every_chain_count(cuda, chains):
    from fabric_tpu_torch import kernels
    from fabric_tpu_torch.ops import p256sign

    rng = np.random.default_rng(29)
    ks = [int.from_bytes(rng.bytes(32), "big") % (ec_ref.N - 1) + 1 for _ in range(37)]
    lt = torch.from_numpy(v3._limbs16(ks)).to(cuda)
    got = kernels.p256_sign(lt, *p256sign._kernel_tables(cuda), chains)
    torch.cuda.synchronize()
    assert torch.equal(got, p256sign.sign_batch_ref(lt, chains=chains))


def _mvcc_operands(dev, T, seed=31):
    """Random keys, a conflict chain up to 60 deep across the words, and
    range reads holding phantoms; a stage-2 launch vector."""
    rng = np.random.default_rng(seed)
    R, W, Q = 2, 2, 1
    sp = np.full((T, R + W + 2 * Q), -1, np.int32)
    sp[:, :R + W] = rng.integers(-1, max(4, T), (T, R + W))
    depth = min(T - 1, 60)
    for i in range(depth):
        j = T - depth + i
        sp[j, 0], sp[j - 1, R] = 10 * T + i, 10 * T + i
    nq = max(1, T // 8)
    rq = rng.choice(T, nq, replace=False)
    sp[rq, R + W] = rng.integers(0, max(4, T), nq)
    sp[rq, R + W + Q] = sp[rq, R + W] + rng.integers(1, 12, nq)
    n_sig = 2 * T + 8
    sv = rng.random(n_sig) < 0.9
    lv = np.zeros((T, 3), np.int32)
    lv[:, 0] = rng.integers(-2, n_sig, T)
    lv[:, 1] = rng.random(T) < 0.95
    lv[:, 2] = rng.random(T) < 0.9
    lv[T - depth - 1:, :] = (-2, 1, 1)
    pok = (rng.random(T + 1) < 0.95).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(sp), (R, W, Q), t(sv), t(lv), t(pok)


def _largest_smem_t():
    from fabric_tpu_torch import kernels

    T = 1
    while kernels.mvcc_fixpoint_in_smem(T + 1):
        T += 1
    return T


@pytest.mark.parametrize("where", ["1", "33", "1024", "smem_max", "smem_max+1"])
def test_mvcc_kernels_at_sizes(cuda, where):
    """``stage2_mvcc`` and ``mvcc_validate_hostver`` at T = 1, 33, 1024,
    the largest T whose fixpoint stages its rows in shared memory, and
    one past it (the rounds read global memory), bit-equal to the plain
    relations and fixpoint."""
    from fabric_tpu_torch import kernels

    T = _largest_smem_t() + where.endswith("+1") if where.startswith("smem") else int(where)
    assert kernels.mvcc_fixpoint_in_smem(T) == (where != "smem_max+1")
    sp, (R, W, Q), sv, lv, pok = _mvcc_operands(cuda, T)
    cols = lambda a, b: sp[:, a:b].contiguous()
    n_sig = sv.shape[0]
    out = torch.zeros(5 * T + n_sig, dtype=torch.int8, device=cuda)
    # the policy verdicts as stage2_policy hands them over: each failing
    # transaction named (twice, some), among -1 words
    bad = torch.nonzero(pok[:T] == 0).flatten().int()
    fail = torch.cat([bad, bad[:3], torch.full((5,), -1, dtype=torch.int32, device=cuda)])
    kernels.stage2_mvcc(sp, R, W, Q, lv, sv, fail, out)
    direct, phantom = mvcc._relations(cols(0, R), cols(R, R + W), cols(R + W, R + W + Q),
                                      cols(R + W + Q, R + W + 2 * Q))
    cok = db.creator_ok_ref(sv, lv[:, 0])
    pre = (lv[:, 1] != 0) & cok & (pok[:T] != 0)
    v, c, ph = mvcc._fixpoint(direct, phantom, (lv[:, 2] != 0) & pre)
    want = torch.cat([v, c, ph, cok, pok[:T] != 0, sv]).to(torch.int8)
    assert torch.equal(out, want)
    hv = (cols(0, R), lv[:, 2] != 0, cols(R, R + W), cols(R + W, R + W + Q),
          cols(R + W + Q, R + W + 2 * Q), pre)
    for a, b in zip(mvcc.mvcc_validate_hostver(*hv), mvcc.mvcc_validate_hostver_ref(*hv)):
        assert torch.equal(a, b)
    if T > 64:
        assert 0 < int(v.sum()) < T and bool(c.any()) and bool(ph.any())


def test_sha256_kernel_matches_plain_and_hashlib(cuda):
    import hashlib

    from fabric_tpu_torch.ops import sha256 as psha

    rng = np.random.default_rng(9)
    for msgs, M in (([rng.bytes(200) for _ in range(4096)], 4),
                    ([rng.bytes(n) for n in (0, 55, 56, 63, 64, 119, 120)], 4),
                    ([rng.bytes(int(n)) for n in rng.integers(0, 8 * 64 - 9, 300)], 8)):
        blocks, nb = psha.pad_messages(msgs, max_blocks=M)
        b = torch.from_numpy(blocks.view(np.int32)).to(cuda)
        n = torch.from_numpy(nb).to(cuda)
        got = psha.sha256_blocks(b, n)
        want = psha.sha256_blocks_ref(b, n)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert psha.digests_to_bytes(got) == [hashlib.sha256(m).digest() for m in msgs]
    assert psha.sha256_host([b"abc"]) == [hashlib.sha256(b"abc").digest()]


def _sha_on_card(cuda, msgs, M, zero=()):
    """``msgs`` padded to M blocks, the rows in ``zero`` given no block,
    through the kernel → bit-equal to ``sha256_blocks_ref`` and hashlib."""
    import hashlib

    from fabric_tpu_torch.ops import sha256 as psha

    blocks, nb = psha.pad_messages(msgs, max_blocks=M)
    nb[list(zero)] = 0
    b = torch.from_numpy(blocks.view(np.int32)).to(cuda)
    n = torch.from_numpy(nb).to(cuda)
    got = psha.sha256_blocks(b, n)
    want = psha.sha256_blocks_ref(b, n)
    torch.cuda.synchronize()
    assert got.shape == (len(msgs), 8) and torch.equal(got, want)
    h0 = psha.H0.astype(">u4").tobytes()
    assert psha.digests_to_bytes(got) == [h0 if i in zero else hashlib.sha256(m).digest()
                                          for i, m in enumerate(msgs)]


@pytest.mark.parametrize("case", ["block_mix", "one_message", "zero_rows", "empty"])
def test_sha256_kernel_at_block_shapes(cuda, case):
    """A commit block's signed messages (1,000 envelope payloads of
    3,285 B, 52 blocks, and 2,000 endorsement messages of 837 B, 14, in
    the block's order, at M = 64), B = 1, rows with no block, B = 0."""
    rng = np.random.default_rng(10)
    if case == "block_mix":
        msgs = [rng.bytes(n) for _ in range(1000) for n in (3285, 837, 837)]
        _sha_on_card(cuda, msgs, 64)
    elif case == "one_message":
        _sha_on_card(cuda, [b"abc"], 1)
    elif case == "zero_rows":
        msgs = [rng.bytes(int(n)) for n in rng.integers(0, 200, 200)]
        _sha_on_card(cuda, msgs, 4, zero=(0, 31, 32, 64, 127, 199))
    else:
        _sha_on_card(cuda, [], 1)


def test_sha256_kernel_refuses_unaligned_blocks(cuda):
    """The producers stage 16 bytes a copy: a view 4 bytes into its
    storage raises instead of launching."""
    from fabric_tpu_torch.ops import sha256 as psha

    flat = torch.zeros(1 + 2 * 16, dtype=torch.int32, device=cuda)
    blocks = flat[1:].view(2, 1, 16)
    with pytest.raises(ValueError, match="16 bytes"):
        psha.sha256_blocks(blocks, torch.ones(2, dtype=torch.int32, device=cuda))


def _comparison_items():
    items = _items(120)
    e = 0x1234567
    items.append((e, *ec_ref.SigningKey(d=1).sign_digest(e), ec_ref.GX, ec_ref.GY))
    neg = ec_ref.SigningKey(d=ec_ref.N - 1)
    items.append((e ^ 1, *neg.sign_digest(e ^ 1), *neg.public))
    return items


def test_p256_verify_v1_kernel_matches_plain(cuda):
    from fabric_tpu_torch.ops import p256

    items = _comparison_items()
    frame = torch.from_numpy(p256.stage_frame(items, p256.bucket(len(items)))).to(cuda)
    got = p256.verify_batch_v1(frame)
    assert torch.equal(got, p256.verify_batch_v1_ref(frame))
    want = [ec_ref.verify_digest((x, y), e, r, s) for e, r, s, x, y in items]
    assert got[:len(items)].tolist() == want and want[-2:] == [True, True] and not all(want)
    assert p256.verify_host(items, kernel="v1") == want


def test_p256_verify_v2_kernel_matches_plain(cuda):
    from fabric_tpu_torch.ops import p256, p256v2

    items = _comparison_items()
    frame = torch.from_numpy(p256v2.stage_frame(items, p256v2.bucket(len(items)))).to(cuda)
    got = p256v2.verify_batch_v2(frame)
    assert torch.equal(got, p256v2.verify_batch_v2_ref(frame))
    want = [ec_ref.verify_digest((x, y), e, r, s) for e, r, s, x, y in items]
    assert got[:len(items)].tolist() == want and want[-2:] == [True, True] and not all(want)
    assert p256.verify_host(items, kernel="v2") == want
    # a launch on another stream gives the same verdicts
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = p256v2.verify_batch_v2(frame)
    side.synchronize()
    assert torch.equal(again, got)


@pytest.mark.parametrize("kernel", ["v1", "v2"])
@pytest.mark.parametrize("lanes", [16, 33, 4096, 6144])
def test_comparison_kernels_at_lane_counts(cuda, kernel, lanes):
    """Each comparison verifier on unpadded batches of 16 and 33 lanes (33
    leaves spare teams in its last block) and 4,096 and 6,144 (the
    comparison path's bucket and a sidecar shape), bit-equal to its plain
    version, with Q = G and Q = -G lanes, and 24 lanes against ec_ref."""
    from fabric_tpu_torch.ops import p256, p256v2

    stage, run, ref = ((p256.stage_frame, p256.verify_batch_v1, p256.verify_batch_v1_ref)
                       if kernel == "v1" else
                       (p256v2.stage_frame, p256v2.verify_batch_v2, p256v2.verify_batch_v2_ref))
    items = _comparison_items()[-2:] + _items(lanes - 2)
    frame = torch.from_numpy(stage(items, lanes)).to(cuda)
    got = run(frame)
    torch.cuda.synchronize()
    assert got.shape == (lanes,) and torch.equal(got, ref(frame))
    sample = sorted(set(range(12)) | set(range(lanes - 12, lanes)))
    assert [bool(got[i]) for i in sample] == [
        ec_ref.verify_digest(items[i][3:], *items[i][:3]) for i in sample]
    assert bool(got[0]) and bool(got[1])


def test_guarded_launch_matches_unguarded_and_launches_the_kernel(cuda):
    """``BlockValidator(device_fail_threshold=...)``: the guarded launch
    gives the unguarded verdicts and launches ``p256_verify`` once; a
    fallback forced by a persistent launch fault verifies with
    ``p256_verify`` on the card, launched and synced at once, and hands
    its accept vector on the card to the stage 2; the plain version
    never runs on a card tensor."""
    from fabric_tpu_torch import faults, kernels
    from fabric_tpu_torch.ledger.statedb import MemVersionedDB
    from fabric_tpu_torch.peer import validator as pv

    items = _items(96)
    want = [ec_ref.verify_digest((qx, qy), e, r, s) for e, r, s, qx, qy in items]
    plain = pv.BlockValidator(pv.PolicyProvider({}), MemVersionedDB(), device=cuda)
    guarded = pv.BlockValidator(pv.PolicyProvider({}), MemVersionedDB(), device=cuda,
                                device_fail_threshold=1, device_retries=0)
    assert plain.device_guard is None
    kernels.reset_counts()
    h = guarded.verify_launch(items)
    assert isinstance(h, pv._GuardedHandle) and h.device_out.is_cuda
    assert h.fetch() == plain.verify_launch(items).fetch() == want
    assert kernels.launches["p256_verify"] == 2
    refs = []
    real_ref = v3.verify_batch_ref
    v3.verify_batch_ref = lambda *a, **kw: refs.append(1) or real_ref(*a, **kw)
    faults.configure("validator.verify_launch:raise")
    try:
        kernels.reset_counts()
        h = guarded.verify_launch(items)
        assert isinstance(h, pv._SyncedHandle) and h.device_out.is_cuda
        assert h.fetch() == want and h.device_out[:len(items)].tolist() == want
        assert kernels.launches["p256_verify"] == 1 and not refs
        assert guarded.device_guard.stats()["fallback_blocks_total"] == 1
    finally:
        faults.reset()
        v3.verify_batch_ref = real_ref


def test_launch_ledger_rows_on_the_card(cuda):
    """One ``p256_verify`` launch and one fused stage 2 under an armed
    launch ledger: the verify row completes enqueue-only (the fused path
    never fetches it), the stage-2 row meets the reference's identity
    (|wall - (compile + queue + execute + h2d)| <= 0.05 wall + dispatch
    + 0.01 ms), and a row is a cache miss exactly when its launch was
    the kernel's first in the process.  A launch given an operand on the
    wrong device raises through the armed hook."""
    from fabric_tpu_torch import kernels, ops_metrics
    from fabric_tpu_torch.observe import ledger, tracer

    led = ledger.configure(registry=ops_metrics.Registry(),
                           tracer=tracer.Tracer(ring_blocks=4))
    try:
        first_verify = kernels.first_launch("p256_verify")
        h = v3.verify_launch(_items(512), device=cuda)
        sv, lv, groups, sp, dims = _stage2_operands(cuda)
        assert h.device_out.shape == sv.shape
        pipe = db.DeviceBlockPipeline()
        out = pipe.run(h, lv, groups, sp, dims, lv.shape[0])()
        want = db.stage2_ref(h.device_out, lv, groups, sp, dims).cpu().numpy().astype(bool)
        assert np.array_equal(out["valid"], want[:lv.shape[0]])
        (vrow,) = led.rows(kernel="verify")
        (srow,) = led.rows(kernel="stage2")
        assert vrow["wall_ms"] is None and vrow["queue_ms"] is None
        assert vrow["cache"] == ("miss" if first_verify else "hit")
        assert srow["cache"] == "miss"  # a new pipeline's policy table is built
        parts = srow["compile_ms"] + srow["queue_ms"] + srow["execute_ms"] + srow["h2d_ms"]
        assert abs(srow["wall_ms"] - parts) <= (0.05 * srow["wall_ms"] + srow["dispatch_ms"]
                                                + 0.01), srow
        assert srow["d2h_bytes"] > 0 and srow["h2d_bytes"] == lv.nbytes
        with pytest.raises(ValueError, match="CUDA tensors"):
            pipe.run(h, lv.cpu(), groups, sp, dims, lv.shape[0])
        assert len(led.rows(kernel="stage2")) == 1
    finally:
        ledger.configure(enabled=False)


def test_two_peers_share_a_private_write_over_gossip_on_the_card(cuda, tmp_path):
    """Two port peers of two orgs on the card, gossip on: a ``collA``
    private write endorsed on the first is pushed to the second's
    transient store at endorsement, and both commit it alike (state
    digest, commit hash, the cleartext), each peer's commit path
    launching ``p256_verify``, ``stage2_policy`` and ``stage2_mvcc``."""
    import asyncio

    from chip_smoke import launches_by_owner
    from fabric_tpu_torch.comm.rpc import RpcClient
    from fabric_tpu_torch.crypto import cryptogen
    from fabric_tpu_torch.crypto.msp import MSPManager
    from fabric_tpu_torch.discovery import PeerInfo
    from fabric_tpu_torch.ordering import BatchConfig, BroadcastClient, OrdererNode
    from fabric_tpu_torch.peer import txassembly as txa
    from fabric_tpu_torch.peer.chaincode import ChaincodeRuntime, KVContract
    from fabric_tpu_torch.peer.node import PeerNode
    from fabric_tpu_torch.peer.validator import NamespaceInfo, PolicyProvider
    from fabric_tpu_torch.protos import messages as M

    rng = np.random.default_rng(11)
    orgs = [cryptogen.generate_org(f"Org{i}MSP", f"org{i}.gossip.example.com", rng)
            for i in (1, 2)]
    mgr = MSPManager({o.msp_id: o.msp() for o in orgs})
    client = orgs[0].users["User1@org1.gossip.example.com"]
    colls = {"collA": {"member_orgs": ["Org1MSP", "Org2MSP"], "required_peer_count": 1,
                       "max_peer_count": 1, "btl": 0}}

    async def scenario():
        orderer = OrdererNode("o0", str(tmp_path / "o0"), {},
                              batch_config=BatchConfig(max_message_count=1, batch_timeout_s=0.2))
        await orderer.start()
        orderer.cluster["o0"] = ("127.0.0.1", orderer.port)
        orderer.join_channel("gchan")
        peers, chans = [], []
        for i, o in enumerate(orgs):
            rt = ChaincodeRuntime()
            rt.register("pvtcc", KVContract())
            p = PeerNode(f"p{i}", str(tmp_path / f"p{i}"), mgr,
                         o.nodes[f"peer0.org{i + 1}.gossip.example.com"], rt, device=cuda)
            await p.start()
            chans.append(p.join_channel("gchan", PolicyProvider({"pvtcc": NamespaceInfo(
                policy=pol.from_dsl("OutOf(1, 'Org1MSP.peer', 'Org2MSP.peer')"),
                collections=colls)})))
            peers.append(p)
        for i, p in enumerate(peers):
            p.registry.add(PeerInfo(orgs[1 - i].msp_id, "127.0.0.1", peers[1 - i].port))
        owners = {id(ch.validator): f"p{i}" for i, ch in enumerate(chans)}
        try:
            with launches_by_owner(("p256_verify", "stage2_policy", "stage2_mvcc"),
                                   owners) as counts:
                for ch in chans:
                    ch.start_deliver([orderer.cluster["o0"]])
                signed, tx_id, prop = txa.create_signed_proposal(
                    client, "gchan", "pvtcc", [b"put_private", b"collA", b"card-key"],
                    transient={"value": b"card-value"})
                cli = RpcClient("127.0.0.1", peers[0].port)
                await cli.connect()
                pr = M.ProposalResponse.parse(await cli.unary("Endorse", signed.serialize()))
                await cli.close()
                assert pr.response.status == 200, pr.response.message
                deadline = asyncio.get_event_loop().time() + 30
                while not chans[1].transient.get(tx_id):  # the push
                    assert asyncio.get_event_loop().time() < deadline
                    await asyncio.sleep(0.02)
                bc = BroadcastClient([orderer.cluster["o0"]])
                env = txa.assemble_transaction(prop, [pr], client)
                assert (await bc.broadcast("gchan", env.serialize()))["status"] == 200
                await bc.close()
                while not all(ch.height == 1 for ch in chans):
                    assert asyncio.get_event_loop().time() < deadline
                    await asyncio.sleep(0.02)
            for ch in chans:
                ch.ledger.drain_state()
                assert ch.ledger.state.get_state("pvtcc$collA", "card-key").value == b"card-value"
            assert chans[0].ledger.state_digest() == chans[1].ledger.state_digest()
            assert chans[0].ledger.commit_hash == chans[1].ledger.commit_hash
            assert peers[0].gossip_service.stats["acks"] == {"collA": 1}
            for who in ("p0", "p1"):
                assert all(counts[who, k] >= 1
                           for k in ("p256_verify", "stage2_policy", "stage2_mvcc")), counts
        finally:
            for p in peers:
                await p.stop()
            await orderer.stop()

    asyncio.run(asyncio.wait_for(scenario(), 120))
