"""The port's BFT ordering service on localhost and a peer's quorum
attestation (fabric_tpu_torch/ordering/{bft,chain,node}.py,
peer/node.py::_verify_bft_attestation), held against the JAX package
on the CPU: the reference's ``tests/test_bft.py`` socket network,
``tests/test_bft_catchup.py`` and ``tests/test_block_attestation.py``
scenarios on the port — four orderers that survive their leader, a
replica that catches up after compaction by pulling attested blocks, a
fifth consenter added live, the peer's censorship monitor, and a peer
on a BFT channel that commits only blocks carrying 2f+1 consenter
COMMIT signatures over their own batch.  The attestation decisions of
both packages are compared on the same block bytes, forgeries
included.

Every BFT message is signed and checked with the port's host
``ec_ref``; the clusters take a ``view_timeout`` of 4 s, which a
normal block (about a second of one core) cannot reach, and a replica
looks for a gap after 2 sequences (the chain's default is 8) so that
the catch-up needs few blocks.  Identities are the reference
cryptogen's, carried into the port (``carry.from_cryptogen``)."""

import asyncio
import hashlib
import json

import pytest
import torch
from test_torch_endorser import carried

from fabric_tpu.crypto import cryptogen as jcryptogen
from fabric_tpu.peer.node import PeerChannel as JPeerChannel
from fabric_tpu.protos import common_pb2
from fabric_tpu.tools import configtxgen as jcg
from fabric_tpu_torch import protoutil as pu
from fabric_tpu_torch.comm.rpc import RpcServer
from fabric_tpu_torch.crypto import policy as ppol
from fabric_tpu_torch.crypto.msp import MSPManager
from fabric_tpu_torch.ordering import BatchConfig, BroadcastClient, OrdererNode
from fabric_tpu_torch.ordering.bft import _signable
from fabric_tpu_torch.peer import txassembly as txa
from fabric_tpu_torch.peer.chaincode import ChaincodeRuntime
from fabric_tpu_torch.peer.node import PeerChannel, PeerNode
from fabric_tpu_torch.peer.validator import NamespaceInfo, PolicyProvider
from fabric_tpu_torch.protos import messages as M

CHANNEL = "bftnet"
VIEW_TIMEOUT = 4.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _wait(cond, timeout=25.0):
    loop = asyncio.get_event_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if cond():
            return True
        await asyncio.sleep(0.03)
    return False


@pytest.fixture(scope="module")
def material():
    """An orderer org of 7 (o0..o3 the consenters), Org1 with a peer and
    a client: the reference's identities and the port's carry."""
    oorg = jcryptogen.generate_org("OrdererMSP", "ord.bftnet.example.com", peers=0,
                                   orderers=7, users=0, admin=False)
    org1 = jcryptogen.generate_org("Org1MSP", "org1.bftnet.example.com", peers=1, users=1)
    osigners, omsp = carried(oorg)
    psigners, pmsp = carried(org1)
    ids = [f"o{i}" for i in range(7)]
    port = {oid: osigners[f"orderer{i}.ord.bftnet.example.com"] for i, oid in enumerate(ids)}
    ref = {oid: jcryptogen.signing_identity(oorg, f"orderer{i}.ord.bftnet.example.com")
           for i, oid in enumerate(ids)}
    mgr = MSPManager({"OrdererMSP": omsp})
    return {
        "oorg": oorg, "org1": org1, "omsp": omsp, "msp1": pmsp, "ids": ids,
        "port": port, "ref": ref,
        "verifiers": {oid: mgr.deserialize_identity(s.serialized) for oid, s in port.items()},
        "peer": psigners["peer0.org1.bftnet.example.com"],
        "client": psigners["User1@org1.bftnet.example.com"],
        "ref_client": jcryptogen.signing_identity(org1, "User1@org1.bftnet.example.com"),
    }


def bft_genesis(material, consenters=4, addrs=None):
    """A reference configtxgen genesis block: Org1, the orderer org, BFT
    with ``consenters`` identities pinned → the block's bytes."""
    addrs = addrs or [("h", i + 1) for i in range(consenters)]
    prof = jcg.Profile(
        CHANNEL, application_orgs=[jcg.OrgProfile("Org1MSP", material["org1"].msp())],
        orderer_orgs=[jcg.OrgProfile("OrdererMSP", material["oorg"].msp())],
        consensus_type="bft",
        raft_consenters=[(h, p, material["ref"][f"o{i}"].serialized, f"o{i}")
                         for i, (h, p) in enumerate(addrs)])
    return jcg.genesis_block(prof).SerializeToString()


def _node(tmp_path, oid, material, cluster, **kw):
    return OrdererNode(oid, str(tmp_path / oid), cluster,
                       batch_config=BatchConfig(max_message_count=1, batch_timeout_s=0.1),
                       consensus="bft", signer=material["port"][oid],
                       verifiers=dict(kw.pop("verifiers", None) or {
                           k: v for k, v in material["verifiers"].items() if k < "o4"}),
                       view_timeout=VIEW_TIMEOUT, **kw)


async def _cluster(tmp_path, material, ids, genesis=None, retention=256, gap=8):
    cluster, nodes = {}, {}
    for oid in ids:
        n = _node(tmp_path, oid, material, cluster)
        await n.start()
        cluster[oid] = ("127.0.0.1", n.port)
        nodes[oid] = n
    for n in nodes.values():
        n.cluster.update(cluster)
        chain = n.join_channel(CHANNEL, M.Block.parse(genesis) if genesis else None)
        chain.wal_retention = retention
        chain.raft.catchup_gap = gap
    return nodes, cluster


def test_bft_orderer_network_survives_its_leader(material, tmp_path):
    """4 BFT orderers over sockets: batches replicate with a 2f+1 proof
    in every block; killing the leader does not lose the chain, and no
    view change happens before it."""
    async def scenario():
        nodes, cluster = await _cluster(tmp_path, material, material["ids"][:4])
        bc = BroadcastClient(list(cluster.values()))
        try:
            assert (await bc.broadcast(CHANNEL, b"envelope-payload-1"))["status"] == 200
            assert await _wait(lambda: all(n.chains[CHANNEL].height >= 1
                                           for n in nodes.values()))
            assert all(n.chains[CHANNEL].raft.view == 0 for n in nodes.values())
            victim = nodes.pop(nodes["o0"].chains[CHANNEL].raft.leader_id)
            await victim.stop()
            res = await bc.broadcast(CHANNEL, b"envelope-payload-2", retries=80)
            assert res["status"] == 200, res
            assert await _wait(lambda: all(n.chains[CHANNEL].height >= 2
                                           for n in nodes.values()))
            hd = [[(n.chains[CHANNEL].blocks.get_block(k).header.serialize(),
                    n.chains[CHANNEL].blocks.get_block(k).data.serialize()) for k in range(2)]
                  for n in nodes.values()]
            assert hd[0] == hd[1] == hd[2]
            for n in nodes.values():
                blk = n.chains[CHANNEL].blocks.get_block(1)
                assert len(pu.block_signed_data(blk)) == 1  # each node signs its own copy
                omd = json.loads(bytes(blk.metadata.metadata[M.META_ORDERER]))
                assert len({m["from"] for m in omd["bft_proof"]}) >= 3
                assert omd["term"] >= 1  # committed in the new view
            await bc.close()
        finally:
            for n in nodes.values():
                await n.stop()

    run(scenario())


def test_bft_replica_catchup_after_compaction(material, tmp_path):
    """A replica that slept through the cluster's compaction window
    recovers by pulling the missing blocks (each verified against its
    2f+1 commit proof), install_snapshot fast-forwards it, and it rejoins
    agreement with identical headers."""
    async def scenario():
        nodes, cluster = await _cluster(tmp_path, material, material["ids"][:4], retention=2,
                                        gap=2)
        bc = BroadcastClient(list(cluster.values()))
        try:
            assert (await bc.broadcast(CHANNEL, b"warm", retries=60))["status"] == 200
            await nodes["o3"].stop()
            for i in range(5):  # past retention and the gap
                assert (await bc.broadcast(CHANNEL, b"m%d" % i, retries=60))["status"] == 200
            live = [nodes[i] for i in ("o0", "o1", "o2")]
            assert await _wait(lambda: all(n.chains[CHANNEL].height >= 6 for n in live))
            wal0 = nodes["o0"].chains[CHANNEL].raft.wal
            assert await _wait(lambda: wal0.snap_index > 0, 10)

            o3 = _node(tmp_path, "o3", material, dict(cluster))
            await o3.start()
            cluster["o3"] = ("127.0.0.1", o3.port)
            for n in live:
                n.cluster["o3"] = cluster["o3"]
            o3.cluster.update(cluster)
            ch3 = o3.join_channel(CHANNEL)
            ch3.wal_retention, ch3.raft.catchup_gap = 2, 2
            nodes["o3"] = o3
            checked = []
            ok = ch3._catchup_block_ok
            ch3._catchup_block_ok = lambda blk: checked.append(blk.header.number) or ok(blk)
            for i in range(3):
                assert (await bc.broadcast(CHANNEL, b"post%d" % i, retries=60))["status"] == 200
            target = nodes["o0"].chains[CHANNEL].height
            assert await _wait(lambda: ch3.height >= target, 40)
            assert checked and ch3.raft.last_applied >= wal0.snap_index
            for k in range(target):
                assert (ch3.blocks.get_block(k).header.serialize()
                        == nodes["o0"].chains[CHANNEL].blocks.get_block(k).header.serialize())
            # a pulled block whose proof does not verify is refused
            blk = M.Block.parse(nodes["o0"].chains[CHANNEL].blocks.get_block(1).serialize())
            omd = json.loads(bytes(blk.metadata.metadata[M.META_ORDERER]))
            omd["bft_proof"] = omd["bft_proof"][:2]
            blk.metadata.metadata[M.META_ORDERER] = json.dumps(omd).encode()
            assert not ok(blk)
            await bc.close()
        finally:
            for n in nodes.values():
                await n.stop()

    run(scenario())


def _bft_config_env(consenters, identities):
    """A CONFIG envelope carrying a BFT consenter set with identities."""
    meta = M.RaftConfigMetadata(consenters=[
        M.RaftConsenter(host=h, port=p, id=i, identity=identities.get(i, b""))
        for h, p, i in consenters])
    ct = M.ConsensusType(type="bft", metadata=meta.serialize())
    root = M.ConfigGroup()
    root.groups["Orderer"] = M.ConfigGroup()
    root.groups["Orderer"].values["ConsensusType"] = M.ConfigValue(value=ct.serialize())
    cfg_env = M.ConfigEnvelope(config=M.Config(sequence=1, channel_group=root))
    ch = M.ChannelHeader(type=M.HEADER_CONFIG, channel_id=CHANNEL)
    payload = M.Payload(header=M.Header(channel_header=ch.serialize()), data=cfg_env.serialize())
    return M.Envelope(payload=payload.serialize())


def test_bft_add_fifth_consenter_live(material, tmp_path):
    """A committed config block carrying a fifth consenter's identity
    grows the membership to n=5 (f 1, quorum 3) and rotates every
    verifier registry; the newcomer catches up and replicates."""
    async def scenario():
        nodes, cluster = await _cluster(tmp_path, material, material["ids"][:4], gap=2)
        bc = BroadcastClient(list(cluster.values()))
        try:
            assert (await bc.broadcast(CHANNEL, b"pre0", retries=60))["status"] == 200
            o4 = _node(tmp_path, "o4", material, {}, verifiers=material["verifiers"])
            await o4.start()
            new_addr = ("127.0.0.1", o4.port)
            consenters = [(h, p, oid) for oid, (h, p) in cluster.items()] + [(*new_addr, "o4")]
            env = _bft_config_env(consenters, {"o4": material["port"]["o4"].serialized})
            assert (await bc.broadcast(CHANNEL, env.serialize(), retries=60))["status"] == 200
            assert await _wait(lambda: all(
                "o4" in n.chains[CHANNEL].raft.peers and n.chains[CHANNEL].raft.n == 5
                and n.chains[CHANNEL].raft.quorum == 3
                and "o4" in n.chains[CHANNEL].raft.verifiers for n in nodes.values()))
            o4.cluster.update({**cluster, "o4": new_addr})
            ch4 = o4.join_channel(CHANNEL)
            ch4.raft.catchup_gap = 2
            nodes["o4"] = o4
            for i in range(3):
                assert (await bc.broadcast(CHANNEL, b"post%d" % i, retries=60))["status"] == 200
            assert await _wait(lambda: ch4.height == nodes["o0"].chains[CHANNEL].height == 5,
                               40)
            await bc.close()
        finally:
            for n in nodes.values():
                await n.stop()

    run(scenario())


def test_peer_censorship_monitor_rotates_off_withholding_orderer(material, tmp_path):
    """An orderer that keeps the Deliver stream open while withholding
    blocks cannot stall the peer: the monitor cross-checks the other
    orderers' heights and rotates."""
    async def scenario():
        orderer = OrdererNode("o0", str(tmp_path / "o0"), {},
                              batch_config=BatchConfig(max_message_count=1, batch_timeout_s=0.1))
        await orderer.start()
        orderer.cluster["o0"] = ("127.0.0.1", orderer.port)
        orderer.join_channel("cns")
        bc = BroadcastClient([("127.0.0.1", orderer.port)])
        for i in range(3):
            assert (await bc.broadcast("cns", b"m%d" % i, retries=60))["status"] == 200
        await bc.close()
        censor = RpcServer("127.0.0.1", 0)

        async def black_hole(stream):
            await stream.__anext__()  # the seek request
            await asyncio.sleep(3600)

        censor.register("Deliver", black_hole)
        await censor.start()
        peer = PeerNode("p0", str(tmp_path / "p0"), MSPManager({"Org1MSP": material["msp1"]}),
                        material["peer"], ChaincodeRuntime(), device="cpu")
        await peer.start()
        ch = peer.join_channel("cns", PolicyProvider({"cc": NamespaceInfo(
            policy=ppol.from_dsl("OutOf(1, 'Org1MSP.peer')"))}))
        try:
            ch.start_deliver([("127.0.0.1", censor.port), ("127.0.0.1", orderer.port)],
                             censorship_check_s=0.5)
            assert await _wait(lambda: ch.height >= 3), ch.height
        finally:
            await peer.stop()
            await censor.stop()
            await orderer.stop()

    run(scenario())


# ---------------------------------------------------------------------------
# the peer's quorum attestation


def _attested(material, num, prev, seq, signers=("o0", "o1", "o2"), digest=None,
              with_proof=True, names=None, sign_pkg="port", data=None):
    """A block of one envelope with its ORDERER metadata's proof: one
    COMMIT a name in ``names`` (default: the signers' ids) signed by the
    matching signer, and the orderer signature of ``signers[0]``."""
    blk = pu.new_block(num, prev)
    blk.data.data.append(data or b"envelope-%d" % num)
    blk = pu.finalize_block(blk)
    d = digest or hashlib.sha256(
        json.dumps([bytes(e).hex() for e in blk.data.data]).encode()).hexdigest()
    meta = {"term": 0, "index": seq}
    if with_proof:
        proof = []
        for name, who in zip(names or signers, signers):
            s = material[sign_pkg][who] if who in material["ids"] else who
            msg = {"type": "bft_commit", "from": name, "view": 0, "seq": seq, "digest": d}
            msg["sig"] = s.sign(_signable(msg)).hex()
            msg["from_cert"] = s.serialized.hex()
            proof.append(msg)
        meta["bft_proof"] = proof
    blk.metadata.metadata[M.META_ORDERER] = json.dumps(meta).encode()
    pu.sign_block(blk, material["port"][signers[0] if signers[0] in material["ids"] else "o0"])
    return blk.serialize()


def _decide(channel, verify, raw, parse):
    try:
        verify(parse(raw))
        return "ok"
    except ValueError as e:
        return "refused: " + ("quorum" if "quorum" in str(e) else "advance" if "advance" in str(e)
                              else "proof" if "BFT" in str(e) else "signature")


def test_both_packages_decide_the_same_attestations(material, tmp_path):
    """The same block bytes through the reference's and the port's
    ``verify_block_signature`` on a BFT channel: the same blocks pass,
    the same forgeries are refused — no proof, 2 of a quorum of 3, a
    proof over another digest, valid orderer-org identities that are not
    consenters, one identity under three names, app-org votes, a seq
    that does not advance — whichever package signed the votes."""
    genesis = bft_genesis(material)
    jch = JPeerChannel(CHANNEL, str(tmp_path / "ref"),
                       genesis_block=common_pb2.Block.FromString(genesis))
    pch = PeerChannel(CHANNEL, str(tmp_path / "port"), genesis_block=M.Block.parse(genesis),
                      device="cpu", async_commit=False)
    try:
        prev = pu.block_header_hash(pch.ledger.blocks.get_block(0).header)
        client = material["client"]
        cases = [
            ("no proof", _attested(material, 1, prev, 1, with_proof=False)),
            ("two of three", _attested(material, 1, prev, 1, signers=("o0", "o1"))),
            ("other digest", _attested(material, 1, prev, 1, digest="ab" * 32)),
            ("not consenters", _attested(material, 1, prev, 1, signers=("o4", "o5", "o6"))),
            ("one identity", _attested(material, 1, prev, 1, signers=("o1", "o1", "o1"),
                                       names=("fake0", "fake1", "fake2"))),
            ("app votes", _attested(material, 1, prev, 1, signers=("o0", client, client),
                                    names=("o0", "app0", "app1"))),
            ("ref-signed quorum", _attested(material, 1, prev, 1, sign_pkg="ref")),
            ("stale seq", _attested(material, 2, b"\x00" * 32, 1)),
            ("next", _attested(material, 2, b"\x00" * 32, 2, signers=("o3", "o2", "o1"))),
        ]
        got = {"ref": [], "port": []}
        for _, raw in cases:
            got["ref"].append(_decide(jch, jch.verify_block_signature, raw,
                                      common_pb2.Block.FromString))
            got["port"].append(_decide(pch, pch.verify_block_signature, raw, M.Block.parse))
        assert got["ref"] == got["port"]
        assert got["port"] == ["refused: proof"] + ["refused: quorum"] * 5 + [
            "ok", "refused: advance", "ok"], list(zip([c for c, _ in cases], got["port"]))
    finally:
        pch.stop()


def test_peer_on_a_bft_channel_commits_only_attested_blocks(material, tmp_path):
    """Four port BFT orderers from a genesis block and a port peer joined
    from it: every delivered block passes the attestation before its
    launch and commits; a block with one COMMIT signature, or with the
    proof of another block, is refused and the channel goes on."""
    async def scenario():
        genesis = bft_genesis(material)
        nodes, cluster = await _cluster(tmp_path, material, material["ids"][:4], genesis)
        peer = PeerNode("p0", str(tmp_path / "p0"), None, material["peer"], ChaincodeRuntime(),
                        device="cpu")
        await peer.start()
        ch = peer.join_channel(CHANNEL, genesis_block=M.Block.parse(genesis))
        seen = []
        att = ch._verify_bft_attestation
        ch._verify_bft_attestation = lambda blk, b: seen.append(blk.header.number) or att(blk, b)
        # a window above a block's commit under load: the monitor would
        # take a slow commit for a withholding orderer
        ch.start_deliver(list(cluster.values()), censorship_check_s=30.0)
        bc = BroadcastClient(list(cluster.values()))
        client = material["client"]
        try:
            for i in range(2):
                _, _, prop = txa.create_signed_proposal(client, CHANNEL, "cc", [b"i%d" % i])
                env = txa.assemble_transaction(prop, [txa.create_proposal_response(
                    prop, b"", material["peer"], "cc")], client)
                assert (await bc.broadcast(CHANNEL, env.serialize(), retries=60))["status"] == 200
            assert await _wait(lambda: ch.height >= 3)
            assert sorted(set(seen)) == [1, 2]
            chain = nodes["o1"].chains[CHANNEL]
            for k in range(3):
                assert (ch.ledger.blocks.get_block(k).header.serialize()
                        == chain.blocks.get_block(k).header.serialize())
            # forgeries of the next block, from the stream's own material
            good = M.Block.parse(chain.blocks.get_block(2).serialize())
            one = M.Block.parse(_attested(material, 3, pu.block_header_hash(good.header), 3,
                                          signers=("o0",)))
            other = M.Block.parse(_attested(material, 3, pu.block_header_hash(good.header), 3))
            other.metadata.metadata[M.META_ORDERER] = good.metadata.metadata[M.META_ORDERER]
            for forged in (one, other):
                with pytest.raises(ValueError, match="quorum|advance"):
                    await ch.commit_block(forged)
            assert ch.height == 3
            # block 2 delivered again (a pipe restart) is held against
            # block 1, not refused as a replay of itself
            ch.verify_block_signature(good)
            _, _, prop = txa.create_signed_proposal(client, CHANNEL, "cc", [b"after"])
            env = txa.assemble_transaction(prop, [txa.create_proposal_response(
                prop, b"", material["peer"], "cc")], client)
            assert (await bc.broadcast(CHANNEL, env.serialize(), retries=60))["status"] == 200
            assert await _wait(lambda: ch.height >= 4)
            await bc.close()
        finally:
            await peer.stop()
            for n in nodes.values():
                await n.stop()

    run(scenario())
