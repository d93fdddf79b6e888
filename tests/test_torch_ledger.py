"""The port's ledger (``fabric_tpu_torch/ledger``) against the JAX
package's, on the CPU, exact equality throughout.

One chain of wire blocks (``_chain``: block 0 writes the seed keys, then
blocks of 12 transactions over 3 orgs with stale and absent reads,
overwrites, deletes, range queries, bad endorsements, nil and garbage
envelopes and duplicates within and across blocks; each header chained
to the last) is signed with the JAX package's cryptogen and handed to
each package as its own messages through the bytes.  Each package
validates it with its own ``BlockValidator`` through its own
``CommitPipeline`` (the port on ``device="cpu"``, its verify kernel
replaced by a per-row lookup of the plain version; the reference
through a cached run of its own verify) and commits it into its own
``KVLedger``:

* commit, serial and async, history on: the segment files and each
  block read back (filter and commit hash included), the commit
  hashes, ``state_digest``, the history rows and the savepoints are
  byte-equal; the async engine's reads through its pending overlay
  equal a serial engine's, and the reference engine's;
* cross-reading: each package opens the other's directory (height,
  blocks, tx-id lookups, digest, commit hash);
* crash and recover: a ``raise`` at each of the four fault points
  stops the ledger (``KVLedger.abort``, and ``_die`` for the
  reference's: nothing synced or drained, as a process death leaves it), at the window's edge and inside it (group commit
  of 4; the fsync points fire only at an edge, so at the first and the
  second); the reopened ledger's ``recover`` through the port's
  validator (``validating_replayer``) and the rest of the chain give
  the height, commit hash and digest of the run without the fault and
  of the reference under the same fault;
* the validator that ``recover`` validated with, reused on the rest
  of the chain and on a block of committed tx ids, flags them
  DUPLICATE_TXID as the reference's does (also after a recover of no
  block);
* a savepoint ahead of the block store (a crash-truncated tail under a
  durable state) is reconciled as the reference does: flagged, then
  overwritten by the redelivered blocks;
* ``SqliteVersionedDB``: range reads, rich queries, bulk and columnar
  version reads on the same rows; the fault plan's spec language.

Every test writes only under pytest's ``tmp_path``."""

import os
import random
import sqlite3

import numpy as np
import pytest
import torch
from test_torch_coalesce import _RowVerify, _tx
from test_torch_frontend import _port_msp
from test_torch_slice import CC, CC_UNSAFE, POLICIES, net  # noqa: F401 — net is a fixture
from test_torch_wire import _CachedVerify

from fabric_tpu import faults as jfaults
from fabric_tpu import protoutil as pu
from fabric_tpu.ledger.committer import AsyncApplyEngine as JAsyncApplyEngine
from fabric_tpu.ledger.kvledger import KVLedger as JKVLedger
from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.ledger.statedb import SqliteVersionedDB as JSqliteDB
from fabric_tpu.ledger.statedb import UpdateBatch as JUpdateBatch
from fabric_tpu.peer import validator as jvalidator
from fabric_tpu.peer.pipeline import CommitPipeline as JCommitPipeline
from fabric_tpu.peer.validator import BlockValidator as JBlockValidator
from fabric_tpu.protos import common_pb2
from fabric_tpu_torch import carry
from fabric_tpu_torch import faults as pfaults
from fabric_tpu_torch import protoutil as ptu
from fabric_tpu_torch.ledger.committer import AsyncApplyEngine
from fabric_tpu_torch.ledger.kvledger import KVLedger, validating_replayer
from fabric_tpu_torch.ledger.statedb import MemVersionedDB, SqliteVersionedDB, UpdateBatch
from fabric_tpu_torch.ops import p256v3
from fabric_tpu_torch.peer import validator as pv
from fabric_tpu_torch.peer.pipeline import CommitPipeline
from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
from fabric_tpu_torch.protos import messages as M

SEED = 20261019
N_BLOCKS = 10
TXS_PER_BLOCK = 12
GROUP = 4  # the tests' group-commit window (the default is 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jverify():
    """The reference validators verify through one cached, fixed-shape
    run of their own kernel."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvalidator.p256, "verify_launch", _CachedVerify(jax=True))
        yield


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    pfaults.reset()
    jfaults.reset()


_ROWS = _RowVerify()


@pytest.fixture(autouse=True)
def pverify(monkeypatch):
    monkeypatch.setattr(p256v3, "verify_batch_packed", _ROWS)
    return _ROWS


# ---------------------------------------------------------------------------
# The chain


def _seed_envs(net):
    """Block 0: s0..s7 in ``CC`` at (0, i), u0..u3 in ``CC_UNSAFE`` at
    (0, 8 + i)."""
    p = net["peers"]
    out = [_tx(net, {CC: ({}, {f"s{i}": b"seed%d" % i})}, [p[0], p[1 + i % 2]], b"s%d" % i)
           for i in range(8)]
    out += [_tx(net, {CC_UNSAFE: ({}, {f"u{i}": b"useed"})}, [p[0]], b"u%d" % i)
            for i in range(4)]
    return out


def _rand_env(net, rng) -> bytes:
    p = net["peers"]
    unsafe = rng.random() < 0.15
    ns, pre, base, nk = (CC_UNSAFE, "u", 8, 4) if unsafe else (CC, "s", 0, 8)
    reads, writes, ranges = {}, {}, []
    for _ in range(rng.randrange(0, 3)):
        i = rng.randrange(nk)
        k = rng.random()
        reads[f"{pre}{i}" if k < 0.85 else f"absent{i}"] = (
            (0, base + i) if k < 0.7 else (0, 99) if k < 0.85 else None)
    for _ in range(rng.randrange(1, 3)):
        writes[f"w{rng.randrange(12)}"] = b"x%d" % rng.randrange(100)
    if rng.random() < 0.1:
        writes[f"{pre}{rng.randrange(nk)}"] = b"over"  # later reads of it go stale
    if rng.random() < 0.08:
        writes[f"w{rng.randrange(12)}"] = None         # a delete
    if not unsafe and rng.random() < 0.12:
        ranges.append(("s0", "s3", [(f"s{i}", (0, i)) for i in range(3)]))
    c = rng.random()
    endorsers = ([p[0]] if unsafe else rng.sample(p, 2) if c < 0.75
                 else [rng.choice(p)] if c < 0.88 else [p[1], net["rogue"]])
    return _tx(net, {ns: (reads, writes, *ranges)}, endorsers, b"%d" % rng.randrange(10**9))


def _chain(net, n_blocks=N_BLOCKS, seed=SEED) -> list:
    """Serialized reference Blocks 0..n-1, each header chained to the
    last."""
    rng = random.Random(seed)
    out, pool, prev = [], [], b""
    for b in range(n_blocks):
        envs = _seed_envs(net) if b == 0 else []
        while len(envs) < TXS_PER_BLOCK:
            r = rng.random()
            if r < 0.03:
                envs.append(b"")
            elif r < 0.05:
                envs.append(b"\x13garbage-bytes")
            elif r < 0.09 and envs:
                envs.append(rng.choice(envs))
            elif r < 0.13 and pool:
                envs.append(rng.choice(pool))
            else:
                envs.append(_rand_env(net, rng))
        pool.extend(e for e in envs if len(e) > 20)
        blk = pu.new_block(b, prev)
        for e in envs:
            blk.data.data.append(e)
        blk = pu.finalize_block(blk)
        prev = pu.block_header_hash(blk.header)
        out.append(blk.SerializeToString())
    return out


@pytest.fixture(scope="module")
def chain(net):
    raws = _chain(net)
    return raws, _port_msp(net["mgr"])


# ---------------------------------------------------------------------------
# The two packages' ledgers, validators and commit loops


def _ledger(pkg, d, async_commit=False, state=None):
    """A ledger of ``pkg`` ("port" or "ref") in ``d``; ``state`` "mem"
    for the in-memory backend, else sqlite.  Group commit of ``GROUP``,
    no lag trigger."""
    if pkg == "port":
        lg = KVLedger(str(d), state_db=MemVersionedDB() if state == "mem" else None,
                      async_commit=async_commit)
    else:
        lg = JKVLedger(str(d), state_db=JMemDB() if state == "mem" else None,
                       async_commit=async_commit)
    lg.blocks.group_commit = GROUP
    lg.blocks.group_max_lag_s = 1e9
    return lg


def _validator(pkg, lg, net, pmgr, **kw):
    if pkg == "port":
        _, prov, _ = carry.from_reference([], POLICIES, [])
        return pv.BlockValidator(prov, lg.state, block_store=lg.blocks, device="cpu",
                                 msp=pmgr, **kw)
    return JBlockValidator(net["mgr"], net["prov"], lg.state, block_store=lg.blocks)


def _block(pkg, raw):
    return M.Block.parse(raw) if pkg == "port" else common_pb2.Block.FromString(raw)


def _commit_fn(pkg, lg):
    if pkg == "port":
        return lambda res: lg.commit_block(res.pend.wire, res.tx_filter, res.batch,
                                           res.history, None, res.txids, res.pend.hd_bytes)
    return lambda res: lg.commit_block(res.block, res.tx_filter, res.batch, res.history,
                                       None, res.txids, res.pend.hd_bytes)


def _commit_chain(pkg, lg, v, raws, depth=2):
    """``raws`` through the package's ``CommitPipeline`` into ``lg``."""
    Pipe = CommitPipeline if pkg == "port" else JCommitPipeline
    pipe = Pipe(v, _commit_fn(pkg, lg), depth=depth)
    try:
        for raw in raws:
            pipe.submit(_block(pkg, raw))
        pipe.flush()
    finally:
        pipe.close(flush=False)


def _run(pkg, d, net, chain, async_commit=False, state=None, raws=None):
    raws = chain[0] if raws is None else raws
    lg = _ledger(pkg, d, async_commit, state)
    v = _validator(pkg, lg, net, chain[1])
    _commit_chain(pkg, lg, v, raws)
    lg.drain_state()
    return lg


def _serialize(blk) -> bytes:
    return blk.serialize() if isinstance(blk, M.Block) else blk.SerializeToString()


def _summary(lg) -> dict:
    """Everything the tests compare of a ledger, as bytes and ints,
    after the async applier drains (it writes the history too)."""
    lg.drain_state()
    d = lg.dir
    hist = sqlite3.connect(os.path.join(d, "history.db"))
    try:
        hrows = hist.execute("SELECT ns, key, block, txnum FROM hist "
                             "ORDER BY ns, key, block, txnum").fetchall()
        hsp = hist.execute("SELECT block FROM savepoint WHERE id=0").fetchone()
    finally:
        hist.close()
    chains = os.path.join(d, "chains")
    segs = sorted(n for n in os.listdir(chains) if n.startswith("blocks_"))
    return {
        "height": lg.height,
        "commit_hash": lg.commit_hash,
        "digest": lg.state_digest(),
        "savepoint": tuple(lg.state.savepoint()) if lg.state.savepoint() else None,
        "history": hrows,
        "history_savepoint": hsp,
        "blocks": [_serialize(b) for b in
                   lg.blocks.iter_blocks((lg.blocks.bootstrap_info() or (0,))[0])],
        "segments": [open(os.path.join(chains, n), "rb").read() for n in segs],
    }


def _chain_hashes(lg) -> list:
    return [b.metadata.metadata[4] for b in lg.blocks.iter_blocks()]


# ---------------------------------------------------------------------------
# Commit, serial and async


@pytest.fixture(scope="module")
def ref_serial(net, chain, tmp_path_factory):
    lg = _run("ref", tmp_path_factory.mktemp("ref_serial"), net, chain)
    out = _summary(lg)
    out["hashes"] = _chain_hashes(lg)
    out["filters"] = [pu.get_tx_filter(b) for b in lg.blocks.iter_blocks()]
    lg.close()
    return out


@pytest.mark.parametrize("async_commit", [False, True], ids=["serial", "async"])
def test_commit_matches_reference(net, chain, ref_serial, tmp_path, async_commit):
    lg = _run("port", tmp_path / "port", net, chain, async_commit=async_commit)
    got = _summary(lg)
    got["hashes"] = _chain_hashes(lg)
    got["filters"] = [bytes(b.metadata.metadata[2]) for b in lg.blocks.iter_blocks()]
    lg.close()
    assert got["height"] == N_BLOCKS
    for key in ("filters", "hashes", "commit_hash", "digest", "savepoint", "history",
                "history_savepoint", "blocks", "segments"):
        assert got[key] == ref_serial[key], key
    if async_commit:
        ref = _run("ref", tmp_path / "ref", net, chain, async_commit=True)
        want = _summary(ref)
        ref.close()
        assert {k: got[k] for k in want} == want
    # every filter holds more than one code, and some tx of the chain is valid
    codes = {c for f in got["filters"] for c in f}
    assert 0 in codes and len(codes) >= 5, codes


def test_history_and_config_history_match_reference(net, chain, tmp_path):
    """Each package's history DB answers for every key of the chain as
    the other's, over the same file; the config history likewise."""
    from fabric_tpu.ledger.confighistory import ConfigHistoryDB as JConfigHistoryDB
    from fabric_tpu.ledger.history import HistoryDB as JHistoryDB
    from fabric_tpu_torch.ledger.confighistory import ConfigHistoryDB
    from fabric_tpu_torch.ledger.history import HistoryDB

    lg = _run("port", tmp_path / "l", net, chain)
    keys = sorted({(ns, key) for (ns, key, _, _) in _summary(lg)["history"]})
    lg.close()
    path = os.path.join(tmp_path, "l", "history.db")
    port, ref = HistoryDB(path), JHistoryDB(path)
    assert len(keys) > 10 and port.savepoint() == ref.savepoint() == N_BLOCKS - 1
    for ns, key in keys + [(CC, "nokey")]:
        assert list(port.get_history_for_key(ns, key)) == list(ref.get_history_for_key(ns, key))
    port.close()
    ref.close()
    cpath = str(tmp_path / "confighistory.db")
    port, ref = ConfigHistoryDB(cpath), JConfigHistoryDB(cpath)
    port.record(3, "cc", b"def-3")
    ref.record(7, "cc", b"def-7")
    port.record(5, "other", b"o")
    for ns, block in (("cc", 2), ("cc", 3), ("cc", 6), ("cc", 9), ("other", 5), ("x", 9)):
        assert port.most_recent_below(ns, block) == ref.most_recent_below(ns, block)
    assert port.most_recent_below("cc", 9) == (7, b"def-7")
    port.close()
    ref.close()


def test_reopen_keeps_everything(net, chain, tmp_path):
    lg = _run("port", tmp_path / "l", net, chain, async_commit=True)
    before = _summary(lg)
    lg.close()
    lg = _ledger("port", tmp_path / "l")
    assert _summary(lg) == before
    assert lg.blocks.get_tx_loc("nosuchtx") is None
    lg.close()


class _GatedSqlite(SqliteVersionedDB):
    """Applies only once ``gate`` is set."""

    def __init__(self, path, gate):
        super().__init__(path)
        self.gate = gate

    def apply_updates(self, batch, savepoint=None):
        self.gate.wait()
        super().apply_updates(batch, savepoint)


class _JGatedSqlite(JSqliteDB):
    def __init__(self, path, gate):
        super().__init__(path)
        self.gate = gate

    def apply_updates(self, batch, savepoint):
        self.gate.wait()
        super().apply_updates(batch, savepoint)


def _overlay_batches(Batch):
    """A committed base and three pending batches over it: rewrites,
    deletes, new keys, JSON values that stop or start matching a
    selector."""
    rows = [[(f"k{i:02d}", b'{"color": "red", "n": %d}' % i if i % 3 else b'"plain"', (1, i))
             for i in range(20)]]
    rows.append([("k03", None, (2, 0)), ("k05", b'{"color": "blue"}', (2, 1)),
                 ("k20", b'{"color": "red"}', (2, 2))])
    rows.append([("k04", b'{"color": "red"}', (3, 0)), ("k05", None, (3, 1)),
                 ("k00", b'{"color": "red", "n": 0}', (3, 2))])
    rows.append([("k07", b'{"color": "green"}', (4, 0)), ("k21", b'{"color": "x"}', (4, 1)),
                 ("k20", None, (4, 2))])
    out = []
    for batch_rows in rows:
        b = Batch()
        for key, value, ver in batch_rows:
            b.put("cc", key, value, ver)
        out.append(b)
    return out


def _reads(db) -> list:
    keys = [("cc", f"k{i:02d}") for i in range(23)] + [("other", "k01")]
    present, vers = db.get_versions_cols(keys)
    out = [sorted(db.get_versions_bulk(keys).items()), present.tolist(), vers.tolist()]
    for ns, key in keys:
        vv = db.get_state(ns, key)
        out.append(None if vv is None else (vv.value, tuple(vv.version)))
    for start, end, limit in (("", "", 0), ("k03", "k08", 0), ("k02", "", 3), ("k19", "k22", 1)):
        out.append([(k, vv.value, tuple(vv.version))
                    for k, vv in db.get_state_range("cc", start, end, limit)])
    for sel, limit in (({"color": "red"}, 0), ({"color": "red"}, 2), ({"color": "blue"}, 0)):
        out.append([(k, vv.value, tuple(vv.version))
                    for k, vv in db.execute_query("cc", {"selector": sel}, limit)])
    out.append(tuple(db.savepoint()))
    return out


def test_async_overlay_reads_equal_serial(tmp_path):
    """Reads through the engine with three batches pending equal a
    serial DB's with all applied, and the reference engine's."""
    import threading

    got = {}
    for pkg, Engine, Gated, Batch, Serial in (
            ("port", AsyncApplyEngine, _GatedSqlite, UpdateBatch, SqliteVersionedDB),
            ("ref", JAsyncApplyEngine, _JGatedSqlite, JUpdateBatch, JSqliteDB)):
        gate = threading.Event()
        inner = Gated(str(tmp_path / f"{pkg}_async.db"), gate)
        inner.open()
        base, *pending = _overlay_batches(Batch)
        gate.set()
        inner.apply_updates(base, (1, 0))
        gate.clear()
        eng = Engine(inner, queue_blocks=4)
        for n, b in enumerate(pending, 2):
            eng.submit(n, b, (n, 0))
        assert eng.stats()["queue_depth"] == 3
        reads = _reads(eng)
        serial = Serial(str(tmp_path / f"{pkg}_serial.db"))
        serial.open()
        for n, b in enumerate(_overlay_batches(Batch), 1):
            serial.apply_updates(b, (n, 0))
        assert reads == _reads(serial), pkg
        gate.set()
        assert eng.wait_applied(4, timeout=30.0)
        eng.drain()
        assert _reads(eng) == reads
        assert eng.stats()["applies_total"] == 3
        eng.close()
        serial.close()
        got[pkg] = reads
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# Cross-reading


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_cross_reading(net, chain, tmp_path, writer):
    reader = "ref" if writer == "port" else "port"
    lg = _run(writer, tmp_path / "l", net, chain)
    want = _summary(lg)
    txids = [t for t, _ in lg.blocks.iter_txid_codes()]
    locs = [lg.blocks.get_tx_loc(t) for t in txids]
    lg.close()
    other = _ledger(reader, tmp_path / "l")
    got = _summary(other)
    assert [other.blocks.get_tx_loc(t) for t in txids] == locs and len(txids) > 50
    hash_of = (ptu if reader == "port" else pu).block_header_hash
    for num in range(N_BLOCKS):
        blk = other.blocks.get_block(num)
        assert _serialize(blk) == want["blocks"][num]
        assert _serialize(other.blocks.get_block_by_hash(hash_of(blk.header))) == \
            want["blocks"][num]
    assert got == want
    # the reader extends the writer's chain: an empty block past the tip
    blk = _block(reader, _empty_next(want["blocks"][-1]))
    other.commit_block(blk, b"", (UpdateBatch if reader == "port" else JUpdateBatch)())
    assert other.height == N_BLOCKS + 1
    other.close()


def _empty_next(last_raw: bytes) -> bytes:
    last = common_pb2.Block.FromString(last_raw)
    blk = pu.finalize_block(pu.new_block(last.header.number + 1,
                                         pu.block_header_hash(last.header)))
    return blk.SerializeToString()


# ---------------------------------------------------------------------------
# Crash and recover

CRASHES = [
    # (point, the block it fires at, serial or async engine, state backend)
    ("ledger.fsync.before", 3, False, "mem"),
    ("ledger.fsync.before", 7, False, "mem"),
    ("ledger.fsync.after", 3, False, "mem"),
    ("ledger.fsync.after", 7, False, "mem"),
    ("ledger.apply.before", 5, True, None),
    ("ledger.apply.before", 7, True, None),
    ("ledger.apply.after", 5, True, None),
    ("ledger.apply.after", 7, True, None),
]


def _spec(point: str, block: int) -> str:
    """The point's spec firing at ``block``: an fsync point closes a
    window every ``GROUP`` blocks, an apply point runs once a block."""
    after = block // GROUP if "fsync" in point else block
    return f"{point}:raise:after={after}:n=1"


def _die(lg) -> None:
    """Leave the reference's ledger as a dead process would (the port's
    ``KVLedger.abort``): the apply queue dropped, nothing synced,
    flushed appends in the files."""
    if lg.engine is not None:
        lg.engine.abort()
    else:
        lg.state.close()
    lg.blocks._fh.close()
    lg.blocks._idx.close()
    lg.history.close()
    lg.pvtdata.close()


def _jreplayer(v, blocks):
    """The reference's replayer: its validator, with the tx-id index cut
    at the replayed block (the port's ``validating_replayer``)."""

    class Below:
        below = 0

        def tx_exists(self, txid):
            loc = blocks.get_tx_loc(txid)
            return loc is not None and loc[0] < self.below

    idx = Below()

    def replay(block):
        idx.below = block.header.number
        own, v.blocks = v.blocks, idx
        try:
            flt, batch, hist = v.validate(block)
        finally:
            v.blocks = own
        assert bytes(flt) == bytes(pu.get_tx_filter(block))
        return flt, batch, hist

    return replay


def _crash_run(pkg, d, net, chain, point, block, async_commit, state):
    """Commit the chain with the fault armed, die, reopen, recover, and
    commit the rest → (after reopen, after recover, at the end)."""
    (pfaults if pkg == "port" else jfaults).configure(_spec(point, block))
    lg = _ledger(pkg, d, async_commit, state)
    v = _validator(pkg, lg, net, chain[1])
    with pytest.raises(Exception) as ei:
        _commit_chain(pkg, lg, v, chain[0])
        lg.drain_state()
    assert "injected fault" in repr(ei.value) or "injected fault" in repr(ei.value.__cause__)
    if pkg == "port":
        v.close()
        lg.abort()
    else:
        _die(lg)
    (pfaults if pkg == "port" else jfaults).reset()
    lg = _ledger(pkg, d, state=state)
    sp = lg.state.savepoint()
    opened = {"height": lg.height, "savepoint": tuple(sp) if sp else None,
              "commit_hash": lg.commit_hash}
    v = _validator(pkg, lg, net, chain[1])
    replayer = (validating_replayer(v, lg.blocks) if pkg == "port"
                else _jreplayer(v, lg.blocks))
    replayed = lg.recover(replayer)
    recovered = {"replayed": replayed, "height": lg.height, "digest": lg.state_digest(),
                 "commit_hash": lg.commit_hash}
    v = _validator(pkg, lg, net, chain[1])
    _commit_chain(pkg, lg, v, chain[0][lg.height:])
    end = _summary(lg)
    lg.close()
    return opened, recovered, end


@pytest.mark.parametrize("point,block,async_commit,state", CRASHES,
                         ids=[f"{p.split('.', 1)[1]}@{b}" for p, b, _, _ in CRASHES])
def test_crash_and_recover(net, chain, ref_serial, tmp_path, point, block, async_commit,
                           state):
    opened, recovered, end = _crash_run("port", tmp_path / "port", net, chain, point, block,
                                        async_commit, state)
    jopened, jrecovered, jend = _crash_run("ref", tmp_path / "ref", net, chain, point, block,
                                           async_commit, state)
    # the block the fault fired at is in the files; what follows it
    # depends on the committer's timing, the savepoint does not
    assert opened["height"] >= block + 1 and jopened["height"] >= block + 1
    if "apply" in point:
        want_sp = (block - 1, 0) if point.endswith("before") else (block, 0)
        assert opened["savepoint"] == jopened["savepoint"] == want_sp
        assert recovered["replayed"] == opened["height"] - block - point.endswith("after")
    else:  # the in-memory state is replayed whole
        assert opened["savepoint"] is None and recovered["replayed"] == opened["height"]
    if opened["height"] == jopened["height"]:
        assert opened["commit_hash"] == jopened["commit_hash"]
        assert recovered == jrecovered
    for key in ("height", "commit_hash", "digest", "blocks", "segments"):
        assert end[key] == ref_serial[key] == jend[key], key
    assert end["history"] == jend["history"]


def _dup_block(raws) -> bytes:
    """Block ``N_BLOCKS``: the envelopes of blocks 1.. again (their tx
    ids committed), chained to the last block."""
    last = common_pb2.Block.FromString(raws[-1])
    blk = pu.new_block(N_BLOCKS, pu.block_header_hash(last.header))
    for raw in raws[1:]:
        for env in common_pb2.Block.FromString(raw).data.data:
            if len(env) > 20:
                blk.data.data.append(env)
    return pu.finalize_block(blk).SerializeToString()


@pytest.mark.parametrize("crash", [False, True], ids=["nothing_to_recover", "after_crash"])
def test_validator_reused_after_recover(net, chain, tmp_path, crash):
    """The validator ``recover`` validated with goes on to validate the
    rest of the chain and a block that repeats committed tx ids: its
    duplicate check sees the whole block store again (also after a
    recover of no block), and the ledger ends as the reference's that
    commits the same blocks with one validator."""
    raws = chain[0] + [_dup_block(chain[0])]
    ref = _run("ref", tmp_path / "ref", net, chain, raws=raws)
    want = _summary(ref)
    ref.close()
    d = tmp_path / "port"
    if crash:
        pfaults.configure(_spec("ledger.apply.before", 7))
        lg = _ledger("port", d, async_commit=True)
        v = _validator("port", lg, net, chain[1])
        with pytest.raises(Exception):
            _commit_chain("port", lg, v, chain[0])
            lg.drain_state()
        v.close()
        lg.abort()
        pfaults.reset()
    else:
        _run("port", d, net, chain).close()
    lg = _ledger("port", d)
    v = _validator("port", lg, net, chain[1])
    replayed = lg.recover(validating_replayer(v, lg.blocks))
    assert (replayed > 0) == crash and v.blocks is lg.blocks
    _commit_chain("port", lg, v, raws[lg.height:])
    got = _summary(lg)
    flt = bytes(lg.blocks.get_block(N_BLOCKS).metadata.metadata[2])
    lg.close()
    assert flt.count(int(C.DUPLICATE_TXID)) == len(flt) > 0
    for key in ("height", "commit_hash", "digest", "blocks", "history"):
        assert got[key] == want[key], key


def test_savepoint_ahead_is_reconciled(net, chain, ref_serial, tmp_path):
    """A durable state whose block tail was cut away: both packages
    open it, the port flags it, and the redelivered blocks overwrite the
    savepoint back into step."""
    out = {}
    for pkg in ("port", "ref"):
        d = tmp_path / pkg
        lg = _run(pkg, d, net, chain)
        lg.close()
        seg = os.path.join(d, "chains", "blocks_000000.bin")
        cut = len(chain[0][-1]) + len(chain[0][-2])  # about two blocks' bytes
        with open(seg, "r+b") as f:
            f.truncate(os.path.getsize(seg) - cut)
        lg = _ledger(pkg, d)
        assert lg.height < N_BLOCKS and lg.state.savepoint() == (N_BLOCKS - 1, 0)
        if pkg == "port":
            assert lg.savepoint_ahead
        height = lg.height
        v = _validator(pkg, lg, net, chain[1])
        _commit_chain(pkg, lg, v, chain[0][height:])
        out[pkg] = (height, _summary(lg))
        lg.close()
    assert out["port"] == out["ref"]
    assert out["port"][1]["commit_hash"] == ref_serial["commit_hash"]
    assert out["port"][1]["blocks"] == ref_serial["blocks"]


# ---------------------------------------------------------------------------
# The block store alone


def test_torn_tail_and_group_commit(net, chain, tmp_path):
    """Group commit counts its fsyncs by trigger, and a record cut in
    half is truncated on open, as the reference truncates it."""
    from fabric_tpu.ledger.blockstore import BlockStore as JBlockStore
    from fabric_tpu_torch.ledger.blockstore import BlockStore

    sizes = {}
    for pkg, Store in (("port", BlockStore), ("ref", JBlockStore)):
        d = str(tmp_path / pkg)
        st = Store(d, group_commit=GROUP, group_max_lag_s=1e9)
        for raw in chain[0]:
            st.add_block(_block(pkg, raw))
        if pkg == "port":
            assert st.stats()["fsyncs"] == {"group": 2, "lag": 0, "forced": 0, "apply": 0}
            assert st.unsynced == N_BLOCKS - 2 * GROUP and st.synced_height == 2 * GROUP
        st.close()
        seg = os.path.join(d, "blocks_000000.bin")
        with open(seg, "r+b") as f:
            f.truncate(os.path.getsize(seg) - 7)
        st = Store(d)
        sizes[pkg] = (st.height, os.path.getsize(seg),
                      [_serialize(b) for b in st.iter_blocks()],
                      sorted(st.iter_txid_codes()))
        st.close()
    assert sizes["port"] == sizes["ref"] and sizes["port"][0] == N_BLOCKS - 1


def test_add_block_refuses_what_does_not_extend(chain, tmp_path):
    from fabric_tpu_torch.ledger.blockstore import BlockStore

    st = BlockStore(str(tmp_path))
    first = M.Block.parse(chain[0][0])
    with pytest.raises(ValueError, match="height"):
        st.add_block(M.Block.parse(chain[0][1]))
    st.add_block(first)
    bad = M.Block.parse(chain[0][1])
    bad.header.previous_hash = b"\x00" * 32
    with pytest.raises(ValueError, match="previous_hash"):
        st.add_block(bad)
    st.close()


# ---------------------------------------------------------------------------
# SqliteVersionedDB


def _state_rows():
    """Namespace "a" holds JSON values only, "b" some that are not JSON."""
    rng = random.Random(7)
    rows = []
    for ns in ("a", "b", "a$c#hashed"):
        for i in range(60):
            v = rng.random()
            value = (b'{"owner": "o%d", "size": %d}' % (i % 4, i % 7) if v < 0.6
                     else b"[1, 2]" if v < 0.7 else b'"s"' if ns != "b" or v < 0.8
                     else b"not json %d" % i)
            md = b"\x0a\x01m" if i % 17 == 0 else None
            rows.append((ns, f"key{i:03d}", value, (i // 10, i % 10), md))
    return rows


def _fill(db, Batch, rows):
    db.open()
    b = Batch()
    for ns, key, value, ver, md in rows:
        b.put(ns, key, value, ver, md)
    db.apply_updates(b, (5, 0))
    d = Batch()
    for ns, key, _, ver, _ in rows[::9]:
        d.delete(ns, key, (6, 0))
    db.apply_updates(d, (6, 0))
    return db


QUERIES = [
    ("range", ("a", "", "", 0)), ("range", ("a", "key010", "key020", 0)),
    ("range", ("b", "key05", "", 4)), ("range", ("a$c#hashed", "key000", "key001", 0)),
    ("range", ("zz", "", "", 0)),
    ("query", ("a", {"owner": "o1"}, 0)), ("query", ("a", {"owner": "o2", "size": 3}, 0)),
    ("query", ("a", {"size": 5}, 2)), ("query", ("a", {}, 0)),
    ("query", ("a$c#hashed", {"owner": "o3"}, 0)),
    ("versions", None),
]


def _view(db, kind, args):
    if kind == "range":
        return [(k, vv.value, tuple(vv.version), vv.metadata)
                for k, vv in db.get_state_range(*args)]
    if kind == "query":
        ns, sel, limit = args
        return [(k, vv.value, tuple(vv.version), vv.metadata)
                for k, vv in db.execute_query(ns, {"selector": sel}, limit)]
    keys = [(ns, f"key{i:03d}") for ns in ("a", "b", "q") for i in range(0, 64, 3)]
    present, vers = db.get_versions_cols(keys)
    return (sorted(db.get_versions_bulk(keys).items()), present.tolist(),
            vers.tolist(), db.meta_count, db.savepoint(),
            [((ns, k), vv.value, tuple(vv.version), vv.metadata)
             for (ns, k), vv in db.iter_all()])


@pytest.mark.parametrize("kind,args", QUERIES, ids=[f"{k}{i}" for i, (k, _) in
                                                    enumerate(QUERIES)])
def test_sqlite_versioned_db_matches_reference(tmp_path, kind, args):
    rows = _state_rows()
    port = _fill(SqliteVersionedDB(str(tmp_path / "p.db")), UpdateBatch, rows)
    ref = _fill(JSqliteDB(str(tmp_path / "r.db")), JUpdateBatch, rows)
    got, want = _view(port, kind, args), _view(ref, kind, args)
    assert got == want
    assert got or args[0] == "zz"
    port.close()
    ref.close()
    # each opens the other's file
    p2, r2 = JSqliteDB(str(tmp_path / "p.db")), SqliteVersionedDB(str(tmp_path / "r.db"))
    p2.open()
    r2.open()
    assert _view(p2, kind, args) == _view(r2, kind, args) == want
    p2.close()
    r2.close()


def test_rich_query_skips_values_that_are_not_json(tmp_path):
    """Where the reference's sqlite query raises on a value that is not
    JSON, the port's matches the JSON values as the in-memory backend
    does."""
    rows = _state_rows()
    port = _fill(SqliteVersionedDB(str(tmp_path / "p.db")), UpdateBatch, rows)
    ref = _fill(JSqliteDB(str(tmp_path / "r.db")), JUpdateBatch, rows)
    mem = _fill(MemVersionedDB(), UpdateBatch, rows)
    sel = {"selector": {"owner": "o2"}}
    with pytest.raises(sqlite3.OperationalError, match="JSON"):
        list(ref.execute_query("b", sel))
    got = [(k, vv.value) for k, vv in port.execute_query("b", sel)]
    assert got == [(k, vv.value) for k, vv in mem.execute_query("b", sel)] and got
    port.close()
    ref.close()


def test_mem_versioned_db_matches_sqlite(tmp_path):
    rows = _state_rows()
    mem = _fill(MemVersionedDB(), UpdateBatch, rows)
    sq = _fill(SqliteVersionedDB(str(tmp_path / "s.db")), UpdateBatch, rows)
    for ns, start, end, limit in (("a", "", "", 0), ("b", "key02", "key09", 3)):
        assert ([(k, vv) for k, vv in mem.get_state_range(ns, start, end, limit)]
                == [(k, vv) for k, vv in sq.get_state_range(ns, start, end, limit)])
    assert [(k, vv.value) for k, vv in mem.execute_query("a", {"selector": {"owner": "o3"}})] \
        == [(k, vv.value) for k, vv in sq.execute_query("a", {"selector": {"owner": "o3"}})]
    assert list(mem.iter_all()) == list(sq.iter_all())
    assert mem.savepoint() == sq.savepoint() == (6, 0) and mem.meta_count == sq.meta_count
    keys = [("a", f"key{i:03d}") for i in range(70)]
    pm, vm = mem.get_versions_cols(keys)
    ps, vs = sq.get_versions_cols(keys)
    assert np.array_equal(pm, ps) and np.array_equal(vm, vs)
    sq.close()


# ---------------------------------------------------------------------------
# The fault plan


@pytest.mark.parametrize("spec", [
    "ledger.apply.before:raise:after=2:n=1",
    "ledger.fsync.before:latency:ms=1;ledger.fsync.after:raise:p=0.5:n=3",
    "x:raise:p=0.3",
])
def test_fault_plan_matches_reference(spec):
    """The same seeded spec fires at the same arrivals in both."""
    got = {}
    for name, mod in (("port", pfaults), ("ref", jfaults)):
        plan = mod.FaultPlan(spec, seed=11)
        fired = []
        for i in range(40):
            for point in plan.points:
                try:
                    plan.fire(point)
                except RuntimeError:
                    fired.append((i, point))
        got[name] = (plan.points, fired, plan.stats(), plan.fired())
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("bad", ["nokind", "p:explode", "p:raise:q=1", "p:raise:p=2",
                                 "p:latency", "p:raise:n=x"])
def test_fault_spec_errors(bad):
    with pytest.raises(pfaults.FaultSpecError):
        pfaults.FaultPlan(bad)
    with pytest.raises(jfaults.FaultSpecError):
        jfaults.FaultPlan(bad)


def test_block_store_index_serves_threads_at_once(tmp_path):
    """Three threads read the index (tx ids, blocks) while a fourth
    appends 300 blocks of 50 tx ids, each fsynced: one sqlite3 connection used from two threads at
    once raises ``InterfaceError``, so the store runs one statement at a
    time; every block and tx id reads back."""
    import threading

    from fabric_tpu_torch.ledger.blockstore import BlockStore

    bs = BlockStore(str(tmp_path / "bs"), group_commit=1)
    errors, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            try:
                for i in range(50):
                    bs.get_tx_loc(f"tx{i}_0")
                    bs.get_block(i)
            except Exception as e:  # the failure under test, reported below
                errors.append(repr(e))
                return

    readers = [threading.Thread(target=reader) for _ in range(3)]
    for t in readers:
        t.start()
    prev = b""
    try:
        for n in range(300):
            blk = ptu.new_block(n, prev)
            blk.data.data.extend([b"env-%d-%d" % (n, i) for i in range(50)])
            blk = ptu.finalize_block(blk)
            bs.add_block(blk, txids=[(f"tx{n}_{i}", i) for i in range(50)])
            prev = ptu.block_header_hash(blk.header)
    finally:
        stop.set()
        for t in readers:
            t.join(10)
    assert not any(t.is_alive() for t in readers) and errors == []
    assert bs.get_tx_loc("tx299_49")[:2] == (299, 49)
    assert [bs.get_block(n).header.number for n in (0, 299)] == [0, 299]
    bs.close()
