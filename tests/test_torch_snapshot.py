"""The port's snapshots (``fabric_tpu_torch/ledger/snapshot.py``) against
the JAX package's, on the CPU, exact equality throughout.

Both packages commit ``tests/test_torch_ledger.py``'s chain up to height
``H`` with their own validators, and the reference commits all of it
(the replay source):

* ``generate_snapshot`` at height H writes the reference's files, byte
  for byte, and the same signable metadata, under the serial and the
  async engine;
* ``verify_snapshot`` of either package refuses a tampered state or
  tx-id file;
* ``create_from_snapshot``, then a replay of H..end, equals a replay
  from genesis and the reference's join (height, commit hash, digest,
  blocks), and a snapshot of a joined ledger before its first block
  equals the reference's;
* ``warm_resident`` admits every key of the snapshot into a validator's
  resident table, and that validator's replay of the suffix (its stage
  2 on the resident path) gives the host path's filters.

Every test writes only under pytest's ``tmp_path``."""

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

from fabric_tpu import protoutil as pu
from fabric_tpu.ledger import snapshot as jsnap
from fabric_tpu.ledger.blockstore import BlockStore as JBlockStore
from fabric_tpu.peer.replay import replay_into as jreplay_into
from fabric_tpu_torch.ledger import snapshot as snap
from fabric_tpu_torch.ledger.blockstore import BlockStore
from fabric_tpu_torch.peer.replay import replay_into

H = 6
KEYS = ("height", "commit_hash", "digest", "blocks")


@pytest.fixture(scope="module")
def source(net, chain, tmp_path_factory):
    """The reference's ledger of the whole chain → its directory."""
    d = tmp_path_factory.mktemp("source")
    lg = _ledger("ref", d)
    _commit_chain("ref", lg, _validator("ref", lg, net, chain[1]), chain[0])
    want = _summary(lg)
    lg.close()
    return str(d), want


def _at_h(pkg, d, net, chain, async_commit=False):
    lg = _ledger(pkg, d, async_commit)
    _commit_chain(pkg, lg, _validator(pkg, lg, net, chain[1]), chain[0][:H])
    return lg


def _files(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def ref_snapshot(net, chain, tmp_path_factory):
    base = tmp_path_factory.mktemp("ref_snap")
    lg = _at_h("ref", base / "ledger", net, chain)
    meta = jsnap.generate_snapshot(lg, str(base / "snap"), channel_id="ledgerchan",
                                   config_bytes=b"cfg")
    lg.close()
    return str(base / "snap"), meta, _files(base / "snap")


@pytest.mark.parametrize("async_commit", [False, True], ids=["serial", "async"])
def test_generate_snapshot_matches_reference(net, chain, ref_snapshot, tmp_path,
                                             async_commit):
    lg = _at_h("port", tmp_path / "ledger", net, chain, async_commit)
    meta = snap.generate_snapshot(lg, str(tmp_path / "snap"), channel_id="ledgerchan",
                                  config_bytes=b"cfg")
    lg.close()
    assert meta == ref_snapshot[1] and meta["height"] == H
    assert _files(tmp_path / "snap") == ref_snapshot[2]
    assert snap.verify_snapshot(str(tmp_path / "snap")) == meta


@pytest.mark.parametrize("target", [snap.STATE_FILE, snap.TXIDS_FILE])
def test_verify_snapshot_refuses_a_tampered_file(ref_snapshot, tmp_path, target):
    d = tmp_path / "snap"
    d.mkdir()
    for name, data in ref_snapshot[2].items():
        if name == target:
            data = data[:-1] + bytes([data[-1] ^ 1])
        (d / name).write_bytes(data)
    with pytest.raises(ValueError, match="hash mismatch"):
        snap.verify_snapshot(str(d))
    with pytest.raises(ValueError, match="hash mismatch"):
        jsnap.verify_snapshot(str(d))
    with pytest.raises(ValueError, match="hash mismatch"):
        snap.create_from_snapshot(str(d), str(tmp_path / "joined"))


def _join(pkg, d, net, chain, snap_dir, source_dir, async_commit=False, **vkw):
    """Create a ledger from the snapshot and replay the source's suffix."""
    mod = snap if pkg == "port" else jsnap
    lg, meta = mod.create_from_snapshot(snap_dir, str(d), async_commit=async_commit)
    lg.blocks.group_commit = 4
    joined = {"height": lg.height, "commit_hash": lg.commit_hash, "digest": lg.state_digest()}
    v = _validator(pkg, lg, net, chain[1], **vkw)
    Store = BlockStore if pkg == "port" else JBlockStore
    src = Store(os.path.join(source_dir, "chains"))
    try:
        stats = (replay_into if pkg == "port" else jreplay_into)(lg, v, src, depth=2)
    finally:
        src.close()
    return lg, v, meta, joined, stats


@pytest.fixture(scope="module")
def ref_join(net, chain, source, ref_snapshot, tmp_path_factory):
    lg, _, _, joined, stats = _join("ref", tmp_path_factory.mktemp("ref_join"), net, chain,
                                    ref_snapshot[0], source[0])
    out = {k: v for k, v in _summary(lg).items() if k in KEYS}
    lg.close()
    assert stats["resumed_from"] == H
    return joined, out


@pytest.mark.parametrize("async_commit", [False, True], ids=["serial", "async"])
def test_join_then_replay_equals_genesis_replay(net, chain, source, ref_snapshot, ref_join,
                                                tmp_path, async_commit):
    lg, _, meta, joined, stats = _join("port", tmp_path / "joined", net, chain,
                                       ref_snapshot[0], source[0], async_commit)
    got = {k: v for k, v in _summary(lg).items() if k in KEYS}
    lg.close()
    assert meta["height"] == H and joined["height"] == H
    assert joined == ref_join[0]
    assert stats["resumed_from"] == H and stats["blocks"] == N_BLOCKS - H
    # a joined ledger holds only the blocks after the snapshot
    want = {k: v for k, v in source[1].items() if k in KEYS}
    assert got["blocks"] == want["blocks"][H:]
    assert {k: got[k] for k in ("height", "commit_hash", "digest")} == \
        {k: want[k] for k in ("height", "commit_hash", "digest")}
    assert got == ref_join[1]


def test_snapshot_of_a_joined_ledger(ref_snapshot, tmp_path):
    """Exported again before any block: the bootstrap anchors stand in
    for the last block, in both packages."""
    metas, files = [], []
    for name, mod in (("port", snap), ("ref", jsnap)):
        lg, _ = mod.create_from_snapshot(ref_snapshot[0], str(tmp_path / name / "l"))
        metas.append(mod.generate_snapshot(lg, str(tmp_path / name / "s")))
        files.append(_files(tmp_path / name / "s"))
        lg.close()
    assert metas[0] == metas[1] and files[0] == files[1]
    assert metas[0]["files"] == ref_snapshot[1]["files"]


def test_warm_resident_then_resident_replay(net, chain, source, ref_snapshot, ref_join,
                                            tmp_path):
    records = list(snap.iter_state_records(ref_snapshot[0]))
    assert records == [(ns, key, value, ver, md) for ns, key, value, ver, md in
                       jsnap.iter_state_records(ref_snapshot[0])]
    lg, meta = snap.create_from_snapshot(ref_snapshot[0], str(tmp_path / "joined"))
    v = _validator("port", lg, net, chain[1], state_resident=True, state_resident_mb=1)
    assert snap.warm_resident(v.resident, ref_snapshot[0]) == len(records) > 20
    assert snap.warm_resident(None, ref_snapshot[0]) == 0
    st = v.resident.stats()
    assert st["resident_keys"] == len(records) and st["evictions_total"] == 0
    flts = []

    def commit(res):
        flts.append(bytes(res.tx_filter))
        lg.commit_block(res.pend.wire, res.tx_filter, res.batch, res.history, None,
                        res.txids, res.pend.hd_bytes)

    from fabric_tpu_torch.peer.replay import ReplayDriver

    src = BlockStore(os.path.join(source[0], "chains"))
    ReplayDriver(v, commit, depth=2).run(src.iter_blocks(H))
    src.close()
    assert v.resident.stats()["hits_total"] > 0
    want = [bytes(pu.get_tx_filter(b)) for b in
            (jb for jb in _ref_blocks(source[0]))][H:]
    assert flts == want
    got = {k: v for k, v in _summary(lg).items() if k in KEYS}
    lg.close()
    assert got == ref_join[1]


def _ref_blocks(source_dir):
    st = JBlockStore(os.path.join(source_dir, "chains"))
    try:
        return list(st.iter_blocks())
    finally:
        st.close()
