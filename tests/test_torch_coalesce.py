"""The port's multi-block commit path on the CPU: the coalesced
signature frame, ``BlockValidator.preprocess_many`` (one verify launch
for a group of blocks), ``CommitPipeline(coalesce_blocks=k).submit_many``,
the columnar policy groups (``_device_pre_columnar``) and the lazy
endorser lists (``_materialize_for_host``).

* ``verify_launch_many`` over 2-4 blocks of n in {0, 1, 15, 16, 17,
  3,072, 3,073} rows holds each block's solo frame byte for byte at its
  offset, and over ragged groups hands each block its slice.
* Wire blocks (signed with the JAX package's cryptogen): an explicit
  pair that every group size k in {2, 3, 4} keeps in one group (block
  k+1 reads a key block k writes; a tx id of block k again in block k+1;
  a consumption-unsafe row in block k; an unknown namespace and a
  transaction with none), then randomized blocks of
  ``tests/test_torch_slice.py`` (one with range queries, one with a
  live envelope the front end decodes).  ``preprocess_many``, pooled
  and serial, equals ``preprocess`` per block; ``submit_many`` at
  k = 2, 3, 4, pooled and serial, equals per-block ``submit`` and the
  JAX ``CommitPipeline(coalesce_blocks=k)`` over a JAX
  ``BlockValidator(host_stage_workers=2)`` (filters, update batches,
  history), with one verify launch a group.
* ``_device_pre_columnar`` builds ``_device_preprocess``'s gp arrays
  byte for byte (so the same match row for every (tx, endorser) pair),
  group order and static arrays, a live envelope the front end decoded
  included when its set is flat, or hands a block with a live non-flat
  transaction to it; the lazy lists, once filled, are the
  ``DecodedBlock`` entry's, and the host paths (v1, v2, the sidecar's
  validator) give the v3 verdicts.
* ``submit_many`` is one ``submit`` a block at k < 2 or depth 1, and a
  failed group fails the pipeline closed with the pool's stage label.

The verify kernel's place is taken by a lookup of each distinct frame
row's verdict from the plain version (``_RowVerify``), so the staging,
the coalesced frame and its slices are the real ones.  Exact equality
throughout."""

import random

import numpy as np
import pytest
import torch
from test_torch_frontend import _odd_endorsement, _port_msp
from test_torch_native import _stage2_verdicts
from test_torch_slice import (  # noqa: F401 — net is a fixture
    CC,
    CC_UNSAFE,
    CHANNEL,
    POLICIES,
    _blocks,
    _rand_tx,
    _rows,
    _seed_batch,
    _Store,
    net,
)
from test_torch_wire import _CachedVerify

from fabric_tpu import protoutil as pu
from fabric_tpu.ledger.rwset import TxRWSet as JTxRWSet
from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.peer import txassembly as txa
from fabric_tpu.peer import validator as jvalidator
from fabric_tpu.peer.pipeline import CommitPipeline as JCommitPipeline
from fabric_tpu.peer.validator import BlockValidator as JBlockValidator
from fabric_tpu_torch import carry
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.ops import p256, p256v3
from fabric_tpu_torch.parallel.hostpool import HostStagePool
from fabric_tpu_torch.peer import frontend
from fabric_tpu_torch.peer import validator as pv
from fabric_tpu_torch.peer.pipeline import CommitPipeline
from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
from fabric_tpu_torch.protos import messages as M
from fabric_tpu_torch.sidecar.validator import SidecarValidator

SEED = 20261018
N_RANDOM = 8
RANGE_BLOCK = 5      # of the randomized blocks: range queries (sets parsed in Python)
FRONT_END_BLOCK = 2  # of the randomized blocks: a live envelope the front end decodes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Signature frames


def _items(n: int, seed: int):
    """n (digest, r, s, qx, qy) tuples over 4 keys, ~1 in 5 rejected on
    the host (r or s out of range, high s, Q = (0, 0))."""
    rng = random.Random(seed)
    keys = [ec_ref.SigningKey(rng.randrange(1, ec_ref.N)).public for _ in range(4)] + [(0, 0)]
    out = []
    for i in range(n):
        qx, qy = keys[i % 5]
        r, s = rng.randrange(1, ec_ref.N), rng.randrange(1, ec_ref.HALF_N)
        if i % 7 == 3:
            s = ec_ref.N - s
        if i % 11 == 5:
            r = 0
        out.append((rng.getrandbits(256), r, s, qx, qy))
    return out


def _capture(monkeypatch):
    """``verify_batch_packed`` recording each launch's frame; lane i's
    bit is i % 3 == 0."""
    frames = []
    monkeypatch.setattr(p256v3, "verify_batch_packed",
                        lambda f: frames.append(f.numpy().copy()) or
                        torch.arange(f.shape[0]) % 3 == 0)
    return frames


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 3072, 3073])
def test_coalesced_frame_holds_each_solo_frame(monkeypatch, n, k):
    """k blocks of n rows in one launch: block b's rows are its solo
    frame byte for byte at b buckets in, the tail all zero."""
    frames = _capture(monkeypatch)
    batches = [_items(n, seed=n + b) for b in range(k)]
    handles = p256v3.verify_launch_many(batches, device="cpu")
    bk = p256v3._bucket(n) if n else 0
    assert len(frames) == (1 if n else 0) and len(handles) == k
    for b, (items, h) in enumerate(zip(batches, handles)):
        assert h.n_real == n
        if n:
            solo = p256v3.stage_frame(items, bk)
            assert frames[0][b * bk:(b + 1) * bk].tobytes() == solo.tobytes()
            if n <= 17:
                assert solo.tobytes() == p256v3.stage_frame_ref(items, bk).tobytes()
    if n:
        assert len(frames[0]) == p256v3._bucket(k * bk)
        assert not frames[0][k * bk:].any()


@pytest.mark.parametrize("sizes", [(40, 0, 600, 5), (0, 0, 3), (3073, 1), (16, 16, 16, 16)])
def test_verify_launch_many_stages_each_block_in_place(monkeypatch, sizes):
    """Block b's rows land at its offset in the one frame, each padded to
    its own bucket; each handle is its slice."""
    frames = _capture(monkeypatch)
    batches = [_items(m, b + 1) for b, m in enumerate(sizes)]
    handles = p256v3.verify_launch_many(batches, device="cpu")
    assert len(frames) == 1
    buckets = [p256v3._bucket(len(b)) if b else 0 for b in batches]
    frame = frames[0]
    assert len(frame) == p256v3._bucket(sum(buckets))
    off = 0
    for b, bk, h in zip(batches, buckets, handles):
        assert h.n_real == len(b) and h.device_out.shape[0] == bk
        if b:
            assert frame[off:off + bk].tobytes() == p256v3.stage_frame(b, bk).tobytes()
            assert h.fetch() == [(off + i) % 3 == 0 for i in range(len(b))]
        off += bk
    assert not frame[off:].any()


# ---------------------------------------------------------------------------
# The blocks


class _RowVerify:
    """``p256v3.verify_batch_packed`` by lookup: each distinct frame
    row's verdict from ``verify_batch_ref``, run once over the rows it
    has not seen; ``lanes`` records each launch's rows."""

    def __init__(self):
        self.bits: dict = {}
        self.lanes: list = []

    def __call__(self, frame):
        rows = frame.numpy()
        keys = [r.tobytes() for r in rows]
        todo = list(dict.fromkeys(k for k in keys if k not in self.bits))
        if todo:
            f = np.frombuffer(b"".join(todo), np.int16).reshape(len(todo), -1).copy()
            self.bits.update(zip(todo, p256v3.verify_batch_ref(torch.from_numpy(f)).tolist()))
        self.lanes.append(len(rows))
        return torch.tensor([self.bits[k] for k in keys], dtype=torch.bool)


def _tx(net, ops: dict, endorsers, salt: bytes, raw: bytes | None = None) -> bytes:
    """An envelope whose set holds ``ops``: {namespace: (reads, writes[,
    range queries])}, or is the bytes ``raw``."""
    tx = JTxRWSet()
    for ns, (reads, writes, *ranges) in ops.items():
        n = tx.ns_rwset(ns)
        n.reads.update(reads)
        n.writes.update(writes)
        n.range_queries += ranges
    rw = tx.to_proto().SerializeToString() if raw is None else raw
    cc = next(iter(ops), CC)
    _, _, prop = txa.create_signed_proposal(net["client"], CHANNEL, cc, [b"c", salt])
    resps = [txa.create_proposal_response(prop, rw, e, cc) for e in endorsers]
    return txa.assemble_transaction(prop, resps, net["client"]).SerializeToString()


def _assemble(env_lists):
    out = []
    for b, envs in enumerate(env_lists):
        blk = pu.new_block(2 + b, b"prev-%d" % b)
        for e in envs:
            blk.data.data.append(e)
        out.append(pu.finalize_block(blk))
    return out


@pytest.fixture(scope="module")
def stream(net):
    """(JAX blocks, wire blocks, seed rows, port MSP, JAX verify cache)."""
    p = net["peers"]
    t = _tx(net, {CC: ({}, {"w9": b"t"})}, [p[1], p[2]], b"t")
    pair = [
        [_tx(net, {CC: ({"s1": (1, 1)}, {"s1": b"new"})}, [p[0], p[1]], b"a"), t,
         _tx(net, {CC_UNSAFE: ({"u1": (1, 1)}, {"w8": b"d"})}, [p[0]], b"d")],
        [_tx(net, {CC: ({"s1": (1, 1)}, {"w7": b"b"})}, [p[0], p[2]], b"b"), t,
         _tx(net, {CC: ({"s2": (1, 2)}, {"w6": b"v"})}, [p[1], p[2]], b"v"),
         _tx(net, {"nosuchcc": ({}, {"x": b"1"})}, [p[0], p[1]], b"u"),
         # a set of no namespace (data_model given, so the field is there)
         _tx(net, {}, [p[0], p[1]], b"z", raw=b"\x08\x00")],
    ]
    rand = [list(b.data.data) for b in _blocks(net, seed=SEED, n_blocks=N_RANDOM,
                                                 range_blocks={RANGE_BLOCK})]
    rng = random.Random(SEED)
    rand[FRONT_END_BLOCK].insert(3, _odd_endorsement(_rand_tx(net, rng, ranges=False),
                                                     net["client"]))
    rand[RANGE_BLOCK][2:2] = [  # a range query (a set parsed in Python); no set at all
        _tx(net, {CC: ({"s3": (1, 3)}, {"w5": b"r"}, ("s0", "s2", [("s0", (1, 0)),
                                                                   ("s1", (1, 1))]))},
            [p[0], p[2]], b"r"),
        _tx(net, {}, [p[1], p[2]], b"e")]
    blocks = _assemble(pair + rand)
    jcache = _CachedVerify(jax=True)
    parser = JBlockValidator(net["mgr"], net["prov"], JMemDB())
    jcache.fill([it for b in blocks for it in parser._parse(b)[1].tuples()])
    seed = JMemDB()
    seed.apply_updates(_seed_batch(), (1, 0))
    rows = [(ns, key, vv.value, vv.version) for (ns, key), vv in seed.iter_all()]
    wire = [M.Block.parse(b.SerializeToString()) for b in blocks]
    return blocks, wire, rows, _port_msp(net["mgr"]), jcache


@pytest.fixture(scope="module")
def rowverify():
    return _RowVerify()


@pytest.fixture
def pverify(monkeypatch, rowverify):
    monkeypatch.setattr(p256v3, "verify_batch_packed", rowverify)
    rowverify.lanes.clear()
    return rowverify


def _validator(stream, workers=0):
    _, _, rows, pmgr, _ = stream
    state, prov, _ = carry.from_reference(rows, POLICIES, [])
    return pv.BlockValidator(prov, state, block_store=_Store(), device="cpu", msp=pmgr,
                             host_stage_workers=workers)


def _commit(v):
    def commit(res):
        v.state.apply_updates(res.batch)
        v.blocks.txids.update(t for t, _ in res.txids)
    return commit


def _run(v, wire, k=0):
    """``wire`` through ``CommitPipeline(depth=2, coalesce_blocks=k)``:
    ``submit_many`` when k, else ``submit`` a block → [(filter, rows,
    history)]."""
    got = []
    try:
        with CommitPipeline(v, _commit(v), depth=2, coalesce_blocks=k) as pipe:
            if k:
                got += pipe.submit_many(wire)
            else:
                got += [r for r in (pipe.submit(b) for b in wire) if r is not None]
            tail = pipe.flush()
            if tail is not None:
                got.append(tail)
    finally:
        v.close()
    return [(bytes(r.tx_filter), _rows(r.batch), list(r.history)) for r in got]


@pytest.fixture(scope="module")
def serial(stream, rowverify):
    """Per-block ``submit`` of the wire blocks (the module's oracle)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(p256v3, "verify_batch_packed", rowverify)
        return _run(_validator(stream), stream[1])


def test_stream_has_the_cases(serial):
    f0, f1 = serial[0][0], serial[1][0]
    assert list(f0) == [C.VALID, C.VALID, C.VALID]
    assert list(f1) == [C.MVCC_READ_CONFLICT, C.DUPLICATE_TXID, C.VALID,
                        C.INVALID_CHAINCODE, C.INVALID_CHAINCODE]
    codes = {c for f, _, _ in serial for c in f}
    assert {C.ENDORSEMENT_POLICY_FAILURE, C.BAD_CREATOR_SIGNATURE, C.NIL_ENVELOPE,
            C.BAD_PAYLOAD} <= codes, sorted(codes)


@pytest.fixture(scope="module")
def jax_runs(net, stream):
    """The JAX coalesced pipeline over a pooled JAX validator, per k."""
    blocks, jcache = stream[0], stream[4]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvalidator.p256, "verify_launch", jcache)
        mp.setattr(jvalidator.p256, "verify_launch_many",
                   lambda batches, **_: [jcache(b) for b in batches])
        for k in (2, 3, 4):
            state = JMemDB()
            state.apply_updates(_seed_batch(), (1, 0))
            store = _Store()
            v = JBlockValidator(net["mgr"], net["prov"], state, block_store=store,
                                host_stage_workers=2)

            def commit(res, state=state, store=store):
                state.apply_updates(res.batch, (res.block.header.number, 0))
                store.txids.update(t for t, _ in res.txids)

            got = []
            try:
                with JCommitPipeline(v, commit, depth=2, coalesce_blocks=k) as pipe:
                    got += pipe.submit_many(blocks)
                    tail = pipe.flush()
                    if tail is not None:
                        got.append(tail)
            finally:
                v.close()
            out[k] = [(bytes(r.tx_filter), _rows(r.batch), list(r.history)) for r in got]
    return out


@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_submit_many_matches_submit_and_reference(stream, serial, jax_runs, pverify,
                                                  monkeypatch, k, pooled):
    wire = stream[1]
    v = _validator(stream, workers=2 if pooled else 0)
    groups, host = [], []
    many, host_fn = v.preprocess_many, v._validate_host
    monkeypatch.setattr(v, "preprocess_many", lambda bs: groups.append(len(bs)) or many(bs))
    monkeypatch.setattr(v, "_validate_host", lambda p: host.append(p.block.number) or
                        host_fn(p))
    got = _run(v, wire, k=k)
    assert got == serial
    assert got == jax_runs[k]
    sizes = [min(k, len(wire) - g) for g in range(0, len(wire), k)]
    assert groups == sizes
    assert len(pverify.lanes) == len(sizes)  # one verify launch a group
    assert 2 in host  # block 0's consumption-unsafe row: its own host redo


@pytest.mark.parametrize("pooled", [False, True])
def test_preprocess_many_matches_preprocess(stream, serial, pverify, pooled):
    """Each result of ``preprocess_many`` is a drop-in ``pre``: the same
    parse, verdict bits, groups and static arrays as ``preprocess``, and
    the same block results."""
    wire = stream[1]
    v = _validator(stream, workers=3 if pooled else 0)
    solo = _validator(stream)
    got = []
    try:
        for g in range(0, len(wire), 4):
            group = wire[g:g + 4]
            pres = v.preprocess_many(group)
            for blk, pre in zip(group, pres):
                want = solo.preprocess(blk)
                assert [(t.code, t.txid, t.creator_item_idx, t.namespaces) for t in pre.txs] \
                    == [(t.code, t.txid, t.creator_item_idx, t.namespaces) for t in want.txs]
                assert pre.handle.fetch() == want.handle.fetch()
                assert pre.dpre.static.packed_static().tobytes() == \
                    want.dpre.static.packed_static().tobytes()
                assert [gp.numpy().tobytes() for _, gp, _, _ in pre.dpre.groups] == \
                    [gp.numpy().tobytes() for _, gp, _, _ in want.dpre.groups]
                flt, batch, hist = v.validate_finish(v.validate_launch(blk, pre=pre))
                v.state.apply_updates(batch)
                v.blocks.txids.update(t.txid for t in pre.txs if t.txid)
                solo.validate_finish(solo.validate_launch(blk, pre=want))
                got.append((bytes(flt), _rows(batch), list(hist)))
        if pooled:
            st = v.host_pool.stats()["by_stage"]
            assert set(st) == {"host_parse", "device_pre"}
            assert sum(w["tasks"] for w in st["host_parse"].values()) == len(wire)
    finally:
        v.close()
    assert got == serial


@pytest.mark.parametrize("depth,k", [(2, 0), (2, 1), (1, 4)])
def test_submit_many_falls_back_to_submit(stream, serial, pverify, monkeypatch, depth, k):
    """Below 2 blocks a group, or in a serial pipe, ``submit_many`` is one
    ``submit`` a block (the reference's rule): no ``preprocess_many``,
    one verify launch a block, the per-block results."""
    wire = stream[1]
    v = _validator(stream)
    groups = []
    many = v.preprocess_many
    monkeypatch.setattr(v, "preprocess_many", lambda bs: groups.append(len(bs)) or many(bs))
    got = []
    try:
        with CommitPipeline(v, _commit(v), depth=depth, coalesce_blocks=k) as pipe:
            got += pipe.submit_many(wire)
            tail = pipe.flush()
            if tail is not None:
                got.append(tail)
    finally:
        v.close()
    assert groups == []
    assert len(pverify.lanes) == len(wire)
    assert [(bytes(r.tx_filter), _rows(r.batch), list(r.history)) for r in got] == serial


@pytest.mark.parametrize("pooled", [False, True])
def test_failed_group_fails_the_pipeline_closed(stream, pverify, monkeypatch, pooled):
    wire = stream[1]
    v = _validator(stream, workers=2 if pooled else 0)
    parse = v._parse_wire

    def bad(block):
        if block.header.number == 4:
            raise KeyError("staging failed")
        return parse(block)

    monkeypatch.setattr(v, "_parse_wire", bad)
    pipe = CommitPipeline(v, _commit(v), depth=2, coalesce_blocks=4)
    with pytest.raises(KeyError, match="staging failed") as ei:
        pipe.submit_many(wire[:4])
    assert getattr(ei.value, "fab_stage", None) == ("host_parse" if pooled else None)
    with pytest.raises(RuntimeError, match="closed"):
        pipe.submit_many(wire[4:])
    with pytest.raises(RuntimeError, match="closed"):
        pipe.submit(wire[4])
    v.close()


# ---------------------------------------------------------------------------
# Columnar policy groups and lazy endorser lists


def _non_flat_live(txs, wb) -> bool:
    live = np.array([t.undetermined for t in txs])
    return bool((live & ~wb.flat).any())


def _same_pre(a: pv.DevicePre, b: pv.DevicePre):
    assert [(p.principals, E, S) for p, _, E, S in a.groups] == \
        [(p.principals, E, S) for p, _, E, S in b.groups]
    assert [g.numpy().tobytes() for _, g, _, _ in a.groups] == \
        [g.numpy().tobytes() for _, g, _, _ in b.groups]
    assert [len(e) for e in a.group_entries] == [len(e) for e in b.group_entries]
    assert a.static.packed_static().tobytes() == b.static.packed_static().tobytes()
    assert a.has_range == b.has_range


def test_columnar_groups_equal_entry_groups(stream):
    """Per block: the columnar gp arrays (match rows gathered through
    ``uid_mat``) are ``_device_preprocess``'s byte for byte, with the same
    codes; the front-end block's live envelope (an odd endorsement) joins
    the columnar arrays, and blocks with a live non-flat transaction fall
    back."""
    v = _validator(stream)
    taken = []
    for blk in stream[1]:
        wb, txs, items = v._parse_wire(blk)
        wb2, txs2, _ = v._parse_wire(blk)
        col = v._device_pre_columnar(txs, wb)
        assert (col is None) == _non_flat_live(txs2, wb2), blk.header.number
        gen = v._device_preprocess(txs2, wb2)
        assert wb2.materialized and not wb.materialized
        if col is not None:
            _same_pre(col, gen)
            assert [t.code for t in txs] == [t.code for t in txs2]
            assert torch.equal(_stage2_verdicts(col, txs, len(items), blk.header.number),
                               _stage2_verdicts(gen, txs2, len(items), blk.header.number))
        taken.append(col is not None)
    # the front-end block stays columnar; the range block falls back
    assert taken[2 + FRONT_END_BLOCK] is True and taken[2 + RANGE_BLOCK] is False
    assert sum(taken) >= 6
    # block 1's unknown namespace and empty set: INVALID_CHAINCODE by masks
    wb, txs, _ = v._parse_wire(stream[1][1])
    assert v._device_pre_columnar(txs, wb) is not None
    assert [t.code for t in txs][3:] == [C.INVALID_CHAINCODE] * 2
    assert all(t.endorsers == [] for t in txs)  # still lazy


def test_device_pre_picks_columnar_or_fallback(stream, monkeypatch):
    v = _validator(stream)
    seen = []
    col, gen = v._device_pre_columnar, v._device_preprocess
    monkeypatch.setattr(v, "_device_pre_columnar",
                        lambda t, b: seen.append(("col", b.number)) or col(t, b))
    monkeypatch.setattr(v, "_device_preprocess",
                        lambda t, b=None: seen.append(("gen", b.number)) or gen(t, b))
    for blk in stream[1]:
        wb, txs, _ = v._parse_wire(blk)
        v._device_pre(txs, wb)
    gens = {n for kind, n in seen if kind == "gen"}
    assert gens == {2 + 2 + RANGE_BLOCK}


def test_materialize_for_host_fills_the_decoded_entrys_lists(stream):
    """The filled lists name the same identities and signatures as the
    ``DecodedBlock`` entry's; a second call changes nothing."""
    v = _validator(stream)
    for blk in stream[1]:
        wb, txs, items = v._parse_wire(blk)
        dtxs, ditems = v._parse(frontend.decode_block(blk, v.msp))
        v._materialize_for_host(txs, wb)
        snap = [(list(t.endorsers), list(t.endo_item_idx)) for t in txs]
        v._materialize_for_host(txs, wb)
        assert [(list(t.endorsers), list(t.endo_item_idx)) for t in txs] == snap
        tw = list(items)
        for t, d in zip(txs, dtxs):
            assert t.endorsers == d.endorsers, (blk.header.number, t.idx)
            assert [tw[j] for j in t.endo_item_idx] == [ditems[j] for j in d.endo_item_idx]


class _Link:
    """A sidecar link answering from the plain verify, in process."""

    def submit(self, items):
        return p256v3.verify_launch(items, device="cpu")

    def submit_many(self, itemsets):
        return [self.submit(it) for it in itemsets]

    def close(self):
        pass


@pytest.mark.parametrize("path", ["v1", "v2", "sidecar"])
def test_host_paths_after_materialize(stream, serial, pverify, monkeypatch, path):
    """Under v1, v2 and the sidecar's validator every block takes the
    host path on lists ``_materialize_for_host`` filled: the v3 results,
    serial and coalesced."""
    verify = _CachedVerify()
    monkeypatch.setattr(p256, "verify_launch", lambda items, **kw: verify(items))
    monkeypatch.setattr(p256, "verify_launch_many",
                        lambda bs, **kw: [verify(b) for b in bs])
    host = []
    orig = pv.BlockValidator._validate_host
    monkeypatch.setattr(pv.BlockValidator, "_validate_host",
                        lambda self, p: (orig(self, p), host.append(p.block.materialized))[0])

    def make():
        _, _, rows, pmgr, _ = stream
        state, prov, _ = carry.from_reference(rows, POLICIES, [])
        if path == "sidecar":
            return SidecarValidator(prov, state, _Store(), link=_Link(), device="cpu", msp=pmgr)
        return pv.BlockValidator(prov, state, _Store(), device="cpu", msp=pmgr, kernel=path)

    assert _run(make(), stream[1]) == serial
    assert _run(make(), stream[1], k=3) == serial
    assert host and all(host)
