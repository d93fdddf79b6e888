"""The port's replay driver (``fabric_tpu_torch/peer/replay.py``) against
the JAX package's, on the CPU, exact equality throughout.

The source is a ledger the reference wrote (``tests/test_torch_ledger.py``'s
chain through the reference's validator and ``KVLedger``).  Each package
replays its block store into a fresh ledger of its own with its own
validator (``replay_into``):

* the port's replay gives the reference's replay digest, commit hash
  and height, and the source's, at depths 1, 2 and 4;
* a replay stopped at block k (the ledger's commit raises there)
  leaves the destination at height k and a checkpoint reading
  ``{"height": k}``; a new ``replay_into`` resumes from the
  destination's height and every block commits once;
* a coalesced replay (``coalesce_blocks`` 2 and 4) equals the single
  one;
* the reader's error surfaces, and ``autopilot=`` takes only None.

Every test writes only under pytest's ``tmp_path``."""

import json
import os

import pytest
from test_torch_ledger import (  # noqa: F401 — chain, net and the autouse fixtures
    N_BLOCKS,
    _commit_chain,
    _jverify,
    _ledger,
    _no_faults,
    _one_torch_thread,
    _summary,
    _validator,
    chain,
    net,
    pverify,
)

from fabric_tpu.ledger.blockstore import BlockStore as JBlockStore
from fabric_tpu.peer.replay import replay_into as jreplay_into
from fabric_tpu_torch.ledger.blockstore import BlockStore
from fabric_tpu_torch.peer.replay import ReplayCheckpoint, ReplayDriver, replay_into

KEYS = ("height", "commit_hash", "digest", "savepoint", "history", "blocks")


@pytest.fixture(scope="module")
def source(net, chain, tmp_path_factory):
    """The reference's ledger of the chain → (its directory, summary)."""
    d = tmp_path_factory.mktemp("source")
    lg = _ledger("ref", d)
    _commit_chain("ref", lg, _validator("ref", lg, net, chain[1]), chain[0])
    want = _summary(lg)
    lg.close()
    return str(d), want


def _replay(pkg, d, net, chain, source_dir, **kw):
    lg = _ledger(pkg, d, kw.pop("async_commit", False))
    v = _validator(pkg, lg, net, chain[1])
    Store = BlockStore if pkg == "port" else JBlockStore
    src = Store(os.path.join(source_dir, "chains"))
    try:
        stats = (replay_into if pkg == "port" else jreplay_into)(lg, v, src, **kw)
    finally:
        src.close()
    return lg, stats


@pytest.fixture(scope="module")
def ref_replay(net, chain, source, tmp_path_factory):
    lg, stats = _replay("ref", tmp_path_factory.mktemp("ref_replay"), net, chain, source[0],
                        depth=2)
    out = {k: v for k, v in _summary(lg).items() if k in KEYS}
    lg.close()
    assert stats["blocks"] == N_BLOCKS
    return out


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_replay_matches_reference(net, chain, source, ref_replay, tmp_path, depth):
    lg, stats = _replay("port", tmp_path, net, chain, source[0], depth=depth,
                        async_commit=depth == 4)
    got = {k: v for k, v in _summary(lg).items() if k in KEYS}
    lg.close()
    assert got == ref_replay
    assert got == {k: v for k, v in source[1].items() if k in KEYS}
    assert stats["blocks"] == stats["submitted"] == N_BLOCKS and stats["resumed_from"] == 0
    assert stats["height"] == N_BLOCKS and stats["txs_valid"] > 0
    assert stats["first_commit_s"] <= stats["seconds"]


@pytest.mark.parametrize("stop_at", [3, 6])
def test_replay_stopped_resumes_from_destination(net, chain, source, ref_replay, tmp_path,
                                                 stop_at):
    lg = _ledger("port", tmp_path / "dst")
    ckpt = str(tmp_path / "replay.ckpt")
    committed = []
    real = lg.commit_block

    def commit_block(block, *a, **kw):
        if block.header.number == stop_at and not committed.count(-1):
            committed.append(-1)
            raise RuntimeError("commit stopped")
        real(block, *a, **kw)
        committed.append(block.header.number)

    lg.commit_block = commit_block
    src = BlockStore(os.path.join(source[0], "chains"))
    v = _validator("port", lg, net, chain[1])
    with pytest.raises(RuntimeError, match="commit stopped"):
        replay_into(lg, v, src, depth=2, checkpoint=ckpt, checkpoint_every=2)
    assert lg.height == stop_at
    with open(ckpt) as f:
        assert json.load(f) == {"height": stop_at}
    assert ReplayCheckpoint(ckpt).load() == stop_at
    v = _validator("port", lg, net, chain[1])
    stats = replay_into(lg, v, src, depth=2, checkpoint=ckpt)
    src.close()
    assert stats["resumed_from"] == stop_at and stats["blocks"] == N_BLOCKS - stop_at
    assert [n for n in committed if n >= 0] == list(range(N_BLOCKS))
    assert ReplayCheckpoint(ckpt).load() == N_BLOCKS
    got = {k: v for k, v in _summary(lg).items() if k in KEYS}
    lg.close()
    assert got == ref_replay


@pytest.mark.parametrize("k", [2, 4])
def test_coalesced_replay_equals_single(net, chain, source, ref_replay, tmp_path, k):
    lg, stats = _replay("port", tmp_path, net, chain, source[0], depth=2, coalesce_blocks=k,
                        prefetch=N_BLOCKS)
    got = {k: v for k, v in _summary(lg).items() if k in KEYS}
    lg.close()
    assert got == ref_replay and stats["blocks"] == N_BLOCKS


def test_reader_error_surfaces_and_autopilot_is_refused(net, chain, tmp_path):
    """The run holds the traffic autopilot in throughput mode (its shed
    and re-weight rules off) and releases the hold when the run fails."""
    from fabric_tpu_torch.control import Autopilot
    from fabric_tpu_torch.observe import Tracer
    from fabric_tpu_torch.ops_metrics import Registry

    ap = Autopilot(None, registry=Registry(), tracer=Tracer())
    held = []
    lg = _ledger("port", tmp_path)
    v = _validator("port", lg, net, chain[1])

    def blocks():
        from fabric_tpu_torch.protos import messages as M

        yield M.Block.parse(chain[0][0])
        raise OSError("source read failed")

    def commit(res):
        held.append(ap.throughput_mode)
        lg.commit_block(res.pend.wire, res.tx_filter, res.batch, res.history, None,
                        res.txids, res.pend.hd_bytes)

    with pytest.raises(OSError, match="source read failed"):
        ReplayDriver(v, commit, depth=2, autopilot=ap).run(blocks())
    assert lg.height == 1 and held == [True]
    assert not ap.throughput_mode
    lg.close()
