"""The port's ordering service (fabric_tpu_torch/ordering/) held against
the JAX package's on the CPU: the block cutter over drawn message sizes
and counts, the WAL's files byte for byte with its recovery, the blocks
committed batches become (header bytes and hash chain), and Raft on
localhost — a three-node cluster that elects, replicates and fails
over, and a restart that does not duplicate blocks."""

import asyncio
import json
import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_endorser import genesis, orgs, port_signer  # noqa: F401  (module fixtures)

from fabric_tpu import protoutil as jpu
from fabric_tpu.ordering import blockcutter as jbc
from fabric_tpu.ordering import chain as jchain
from fabric_tpu.ordering import raft as jraft
from fabric_tpu_torch import protoutil as ppu
from fabric_tpu_torch.ordering import blockcutter as pbc
from fabric_tpu_torch.ordering import chain as pchain
from fabric_tpu_torch.ordering import raft as praft
from fabric_tpu_torch.ordering.node import BroadcastClient, DeliverClient, OrdererNode
from fabric_tpu_torch.protos import messages as M

CHANNEL = "ordchan"
SEED = 20261020


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _until(cond, timeout=10.0):
    loop = asyncio.get_event_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if cond():
            return True
        await asyncio.sleep(0.02)
    return False


def _envs(n, seed, size=(40, 200)):
    rng = np.random.default_rng(seed)
    return [b"env-%d-" % i + rng.bytes(int(rng.integers(*size))) for i in range(n)]


# ---------------------------------------------------------------------------
# block cutter


@settings(max_examples=60, deadline=None)
@given(sizes=st.lists(st.integers(1, 600), max_size=60), count=st.integers(1, 8),
       preferred=st.integers(50, 1500), cut_every=st.integers(0, 7))
def test_block_cutter_matches_reference(sizes, count, preferred, cut_every):
    cfgs = [mod.BatchConfig(max_message_count=count, preferred_max_bytes=preferred)
            for mod in (jbc, pbc)]
    cutters = [jbc.BlockCutter(cfgs[0]), pbc.BlockCutter(cfgs[1])]
    for i, n in enumerate(sizes):
        env = bytes([i % 251]) * n
        got = [c.ordered(env) for c in cutters]
        assert got[0] == got[1]
        assert got[1][1] == cutters[1].pending
        if cut_every and i % cut_every == 0:
            assert cutters[0].cut() == cutters[1].cut()
    assert cutters[0].cut() == cutters[1].cut()
    assert not cutters[1].pending


def test_batch_config_defaults_are_the_reference_sample():
    ref, port = jbc.BatchConfig(), pbc.BatchConfig()
    assert (port.max_message_count, port.preferred_max_bytes, port.absolute_max_bytes,
            port.batch_timeout_s) == (500, 2 * 1024 * 1024, 10 * 1024 * 1024, 2.0)
    assert vars(port) == vars(ref)


# ---------------------------------------------------------------------------
# the WAL


def _wal_script(mod, path):
    """One sequence of WAL operations → the entries it ends with."""
    w = mod.WAL(path)
    ents = [mod.Entry(1 + i // 4, i + 1, b"data-%d" % i * (i % 3 + 1)) for i in range(12)]
    w.save_meta(1, "o1")
    w.append(ents[:6])
    w.append(ents[6:9])
    w.save_meta(3, None)
    w.truncate_from(8)  # a conflict rewrite
    w.append([mod.Entry(3, 8, b"rewritten"), mod.Entry(3, 9, b"next")])
    w.compact_to(4)
    w.append([mod.Entry(3, 10, b"after compaction")])
    w.close()
    return [(e.term, e.index, e.data) for e in mod.WAL(path).entries]


def test_wal_files_match_reference_and_recover(tmp_path):
    got = {}
    for name, mod in (("ref", jraft), ("port", praft)):
        got[name] = _wal_script(mod, str(tmp_path / name))
    assert got["ref"] == got["port"]
    assert [i for _, i, _ in got["port"]] == [5, 6, 7, 8, 9, 10]
    for f in ("wal.bin", "meta.json"):
        assert (tmp_path / "ref" / f).read_bytes() == (tmp_path / "port" / f).read_bytes()
    # each package opens the other's files
    for writer, reader in (("ref", praft), ("port", jraft)):
        w = reader.WAL(str(tmp_path / writer))
        assert [(e.term, e.index, e.data) for e in w.entries] == got[writer]
        assert (w.term, w.voted_for, w.snap_index, w.snap_term) == (3, None, 4, 1)
        w.close()
    # a torn tail is truncated on open, in both
    wal = tmp_path / "port" / "wal.bin"
    good = wal.read_bytes()
    for mod in (jraft, praft):
        wal.write_bytes(good + b"\x00\x00\x00\x40" + b"\x00" * 19)
        w = mod.WAL(str(tmp_path / "port"))
        assert [(e.term, e.index, e.data) for e in w.entries] == got["port"]
        w.close()
        assert wal.read_bytes() == good


def test_election_timeouts_come_from_the_callers_rng(tmp_path):
    draws = []
    for _ in range(2):
        n = praft.RaftNode("a", ["a", "b"], praft.WAL(str(tmp_path / f"w{len(draws)}")),
                           apply_cb=None, send_cb=None, rng=random.Random(7))
        draws.append([n.rng.uniform(*n.election_timeout) for _ in range(5)])
        n.wal.close()
    assert draws[0] == draws[1]
    assert all(0.15 <= d <= 0.30 for d in draws[0])


# ---------------------------------------------------------------------------
# block assembly: the same committed batches, the same chain


def test_committed_batches_give_the_reference_blocks(tmp_path):
    batches = [_envs(k, SEED + k) for k in (3, 1, 5, 2)]
    jgen = jpu.finalize_block(jpu.new_block(0, b""))
    gens = {"ref": jgen, "port": M.Block.parse(jgen.SerializeToString())}
    chains = {}
    for name, mod in (("ref", jchain), ("port", pchain)):
        c = mod.OrderingChain(CHANNEL, "o0", ["o0"], str(tmp_path / name), send_cb=None,
                              genesis_block=gens[name])
        c._offset = c._derive_offset()
        assert c._offset == 1
        for i, batch in enumerate(batches):
            entry = json.dumps([b.hex() for b in batch]).encode()
            c._apply(mod.Entry(2, i + 1, entry))
            c._apply(mod.Entry(2, i + 1, entry))  # a replayed entry is skipped
        chains[name] = [c.blocks.get_block(n) for n in range(c.height)]
        c.stop()
    ref, port = chains["ref"], chains["port"]
    assert len(port) == len(batches) + 1
    for rb, pb in zip(ref, port):
        assert pb.serialize() == rb.SerializeToString()
        assert ppu.block_header_hash(pb.header) == jpu.block_header_hash(rb.header)
    for prev, blk in zip(port, port[1:]):
        assert blk.header.previous_hash == ppu.block_header_hash(prev.header)
        assert json.loads(blk.metadata.metadata[M.META_ORDERER]) == {"term": 2,
                                                                      "index": blk.header.number}


def test_block_signature_is_the_reference_layout(orgs):  # noqa: F811
    signer = port_signer(orgs, "Org1MSP", "peer")
    blk = pchain.assemble_block(3, b"\x01" * 32, _envs(2, SEED), 1, 3, signer)
    from fabric_tpu.protos import common_pb2
    from fabric_tpu_torch.crypto.msp import MSPManager, verify_signature

    (creator, data, sig), = ppu.block_signed_data(blk)
    jgot = jpu.block_signed_data(common_pb2.Block.FromString(blk.serialize()))
    assert jgot == [(creator, data, sig)]
    ident = MSPManager({"Org1MSP": orgs["Org1MSP"]["msp"]}).deserialize_identity(creator)
    assert creator == signer.serialized and verify_signature(ident, data, sig)
    assert data.endswith(ppu.block_header_hash(blk.header))


# ---------------------------------------------------------------------------
# Raft on localhost


async def _cluster(tmp_path, n, bc):
    cluster, nodes = {}, []
    for i in range(n):
        node = OrdererNode(f"o{i}", str(tmp_path / f"o{i}"), cluster, batch_config=bc,
                           rng=random.Random(SEED + i))
        await node.start()
        cluster[node.id] = ("127.0.0.1", node.port)
        nodes.append(node)
    for node in nodes:
        node.cluster.update(cluster)
        node.join_channel(CHANNEL)
    return nodes, cluster


def _leader(nodes):
    leaders = [n for n in nodes if n.chains[CHANNEL].raft.state == "leader"]
    return leaders[0] if len(leaders) == 1 else None


def _chain_bytes(node):
    c = node.chains[CHANNEL]
    return [c.blocks.get_block(i).serialize() for i in range(c.height)]


def test_three_node_raft_elects_replicates_and_fails_over(tmp_path):
    async def scenario():
        bc = pbc.BatchConfig(max_message_count=3, batch_timeout_s=0.2)
        nodes, cluster = await _cluster(tmp_path, 3, bc)
        cli = BroadcastClient(list(cluster.values()))
        try:
            assert await _until(lambda: _leader(nodes) is not None)
            first = _envs(6, SEED)
            for env in first:
                assert (await cli.broadcast(CHANNEL, env))["status"] == 200
            assert await _until(lambda: all(n.chains[CHANNEL].height == 2 for n in nodes))
            assert len({tuple(_chain_bytes(n)) for n in nodes}) == 1
            old = _leader(nodes)
            await old.stop()
            rest = [n for n in nodes if n is not old]
            assert await _until(lambda: _leader(rest) is not None, timeout=15)
            assert _leader(rest).chains[CHANNEL].raft.wal.term > old.chains[CHANNEL].raft.wal.term
            for env in _envs(4, SEED + 1):
                assert (await cli.broadcast(CHANNEL, env))["status"] == 200
            assert await _until(lambda: all(n.chains[CHANNEL].height == 4 for n in rest))
            chain = _chain_bytes(rest[0])
            assert chain == _chain_bytes(rest[1])
            blocks = [M.Block.parse(b) for b in chain]
            assert [list(b.data.data) for b in blocks] == [first[:3], first[3:]] + [
                list(b.data.data) for b in blocks[2:]]
            assert sum(len(b.data.data) for b in blocks) == 10
            for prev, blk in zip(blocks, blocks[1:]):
                assert blk.header.previous_hash == ppu.block_header_hash(prev.header)
            # deliver from a follower streams the same chain
            got = [b async for b in DeliverClient(*cluster[rest[0].id]).blocks(CHANNEL, 0, 3)]
            assert [b.serialize() for b in got] == chain
        finally:
            await cli.close()
            for n in nodes:
                await n.stop()

    run(scenario())


def test_restart_does_not_duplicate_blocks(tmp_path):
    async def scenario():
        bc = pbc.BatchConfig(max_message_count=3, batch_timeout_s=0.1)
        nodes, cluster = await _cluster(tmp_path, 1, bc)
        cli = BroadcastClient(list(cluster.values()))
        try:
            assert await _until(lambda: _leader(nodes) is not None)
            for env in _envs(7, SEED + 2):
                assert (await cli.broadcast(CHANNEL, env))["status"] == 200
            assert await _until(lambda: nodes[0].chains[CHANNEL].height == 3)
            before = _chain_bytes(nodes[0])
        finally:
            await cli.close()
            await nodes[0].stop()
        again = OrdererNode("o0", str(tmp_path / "o0"), {}, batch_config=bc)
        await again.start()
        again.cluster["o0"] = ("127.0.0.1", again.port)
        again.join_channel(CHANNEL)
        cli = BroadcastClient([again.cluster["o0"]])
        try:
            assert await _until(lambda: _leader([again]) is not None)
            await asyncio.sleep(0.3)  # the WAL replays; nothing may be re-cut
            assert _chain_bytes(again) == before
            for env in _envs(3, SEED + 3):
                assert (await cli.broadcast(CHANNEL, env))["status"] == 200
            assert await _until(lambda: again.chains[CHANNEL].height == 4)
            blocks = [M.Block.parse(b) for b in _chain_bytes(again)]
            assert [b.header.number for b in blocks] == [0, 1, 2, 3]
            assert _chain_bytes(again)[:3] == before
            assert blocks[3].header.previous_hash == ppu.block_header_hash(blocks[2].header)
        finally:
            await cli.close()
            await again.stop()

    run(scenario())


def test_writers_policy_gates_broadcast(orgs, genesis, tmp_path):  # noqa: F811
    from fabric_tpu_torch.peer import txassembly as ptxa

    async def scenario():
        node = OrdererNode("o0", str(tmp_path / "o0"), {},
                           batch_config=pbc.BatchConfig(max_message_count=1))
        await node.start()
        node.cluster["o0"] = ("127.0.0.1", node.port)
        chain = node.join_channel(CHANNEL, M.Block.parse(genesis["bytes"]))
        try:
            assert await _until(lambda: chain.raft.state == "leader")
            out = []
            for msp_id in ("Org1MSP", "Org2MSP"):
                client = port_signer(orgs, msp_id, "user")
                signed, _, prop = ptxa.create_signed_proposal(client, CHANNEL, "kv", [b"x"])
                resp = ptxa.create_proposal_response(prop, b"", port_signer(orgs, "Org1MSP",
                                                                            "peer"), "kv")
                env = ptxa.assemble_transaction(prop, [resp], client)
                out.append(await chain.broadcast(env.serialize()))
            assert out[0] == {"status": 200}
            assert out[1] == {"status": 400, "info": "Writers policy not satisfied"}
            assert chain.height == 2  # genesis + the admitted envelope
            assert (await chain.broadcast(b""))["status"] == 400
        finally:
            await node.stop()

    run(scenario())


def test_knobs_not_yet_ported_raise(tmp_path):
    """``tls`` and ``operations_port``, once refused, are ported: the
    profile's server context goes to the listener and the operations
    server answers /healthz with the ``consensus`` check."""
    import urllib.request

    class Profile:
        def server_ctx(self):
            return None

        def client_ctx(self):
            return None

    assert OrdererNode("o0", str(tmp_path / "b"), {}, tls=Profile()).tls is not None

    async def ops():
        node = await OrdererNode("o0", str(tmp_path / "d"), {}).start(operations_port=0)
        try:
            url = f"http://127.0.0.1:{node.operations.port}/healthz"
            raw = await asyncio.get_event_loop().run_in_executor(
                None, lambda: urllib.request.urlopen(url, timeout=10).read())
            return json.loads(raw)
        finally:
            await node.stop()

    assert run(ops()) == {"status": "OK", "failed_checks": []}


def test_bft_consensus_builds_a_node_and_a_chain(tmp_path):
    """``consensus="bft"`` (once refused by name) builds an orderer node
    whose chains run ``BFTNode``, and an ``OrderingChain`` over it."""
    from fabric_tpu_torch.ordering.bft import BFTNode

    async def scenario():
        node = OrdererNode("o0", str(tmp_path / "a"), {}, consensus="bft", view_timeout=30.0,
                           batch_config=pbc.BatchConfig(max_message_count=1))
        await node.start()
        try:
            node.cluster["o0"] = ("127.0.0.1", node.port)
            chain = node.join_channel(CHANNEL)
            assert isinstance(chain.raft, BFTNode) and chain.raft.view_timeout == 30.0
            assert chain.raft.state == "leader"  # a one-node cluster leads view 0
            assert (await chain.broadcast(b"env"))["status"] == 200
            meta = json.loads(bytes(chain.blocks.get_block(0).metadata.metadata[
                M.META_ORDERER]))
            assert chain.height == 1 and meta["index"] == 1
            assert [c["type"] for c in meta["bft_proof"]] == ["bft_commit"]
        finally:
            await node.stop()

    run(scenario())
    chain = pchain.OrderingChain(CHANNEL, "o0", ["o0"], str(tmp_path / "c"), send_cb=None,
                                 consensus="bft")
    assert isinstance(chain.raft, BFTNode) and chain.raft.quorum == 1
    chain.blocks.close()
