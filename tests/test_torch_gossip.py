"""The port's gossip layer (fabric_tpu_torch/gossip.py) and its pvtdata
store's missing-data rows (ledger/pvtdata.py) held against the JAX
package on the CPU: the cleartext encoding, the ``PvtPush`` payload and
the ``PvtPull`` signed bytes equal to the reference's, the collection
access filter, ``missing_data`` / ``resolve_missing`` on the same calls,
each package's gossip client served by the other's handlers; then the
reference's ``tests/test_gossip_pvtdata.py`` scenarios on port peers
over localhost — distribution at endorsement and the pull at commit,
missing then reconciled, anti-entropy from a peer, a non-member that
never holds the cleartext, BTL expiry, a dead peer out of the election
— with the peers' filters and state equal to the JAX package's
validator on the orderer's blocks.  Identities are the reference
cryptogen's, carried into the port (``carry.from_cryptogen``)."""

import asyncio
import hashlib
import json

import pytest
import torch
from test_torch_endorser import carried
from test_torch_wire import _CachedVerify

from fabric_tpu import gossip as jgossip
from fabric_tpu.comm.rpc import RpcServer as JRpcServer
from fabric_tpu.crypto import cryptogen as jcryptogen
from fabric_tpu.crypto import policy as jpol
from fabric_tpu.crypto.msp import MSPManager as JMSPManager
from fabric_tpu.discovery import PeerInfo as JPeerInfo
from fabric_tpu.discovery import PeerRegistry as JPeerRegistry
from fabric_tpu.ledger import pvtdata as jpvt
from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.peer import transient as jtransient
from fabric_tpu.peer import validator as jvalidator
from fabric_tpu.protos import common_pb2
from fabric_tpu_torch import gossip as pgossip
from fabric_tpu_torch.comm.rpc import RpcClient, RpcServer
from fabric_tpu_torch.crypto import policy as ppol
from fabric_tpu_torch.crypto.msp import MSPManager
from fabric_tpu_torch.discovery import PeerInfo, PeerRegistry
from fabric_tpu_torch.ledger import pvtdata as ppvt
from fabric_tpu_torch.ops import p256v3
from fabric_tpu_torch.ordering import BatchConfig, BroadcastClient, OrdererNode
from fabric_tpu_torch.peer import transient as ptransient
from fabric_tpu_torch.peer import txassembly as txa
from fabric_tpu_torch.peer.chaincode import ChaincodeRuntime, KVContract
from fabric_tpu_torch.peer.node import PeerNode
from fabric_tpu_torch.peer.validator import NamespaceInfo, PolicyProvider
from fabric_tpu_torch.protos import messages as M

CHANNEL = "pvtchan"
CC = "pvtcc"
POLICY = "OutOf(1, 'Org1MSP.peer', 'Org2MSP.peer')"
COLLECTIONS = {
    # collA spans both orgs; collPriv is Org1-only; collPullOnly has
    # max_peer_count 0: no push at endorsement, reconciliation only
    "collA": {"member_orgs": ["Org1MSP", "Org2MSP"], "required_peer_count": 1,
              "max_peer_count": 2, "btl": 0},
    "collB": {"member_orgs": ["Org1MSP", "Org2MSP"], "required_peer_count": 0,
              "max_peer_count": 2, "btl": 0},
    "collPriv": {"member_orgs": ["Org1MSP"], "required_peer_count": 0, "max_peer_count": 2,
                 "btl": 0},
    "collPullOnly": {"member_orgs": ["Org1MSP", "Org2MSP"], "required_peer_count": 0,
                     "max_peer_count": 0, "btl": 0},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _wait(cond, timeout=20.0):
    loop = asyncio.get_event_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if cond():
            return True
        await asyncio.sleep(0.03)
    return False


@pytest.fixture(scope="module")
def orgs():
    out = {}
    for msp_id, domain in (("Org1MSP", "org1.gossip.example.com"),
                           ("Org2MSP", "org2.gossip.example.com")):
        org = jcryptogen.generate_org(msp_id, domain, peers=1, users=1)
        signers, msp = carried(org)
        out[msp_id] = {"ref": org, "msp": msp, "peer": signers[f"peer0.{domain}"],
                       "user": signers[f"User1@{domain}"],
                       "ref_peer": jcryptogen.signing_identity(org, f"peer0.{domain}")}
    return out


# ---------------------------------------------------------------------------
# formats and the access filter


CLEAR = {(CC, "collA"): {"k1": b"v1", "ké2": b"\x00\xff", "gone": None},
         ("other", "c"): {}}


def test_cleartext_encoding_equals_reference():
    assert pgossip._enc_cleartext(CLEAR) == jgossip._enc_cleartext(CLEAR)
    enc = json.loads(json.dumps(jgossip._enc_cleartext(CLEAR)))
    assert pgossip._dec_cleartext(enc) == jgossip._dec_cleartext(enc) == CLEAR
    kv = CLEAR[(CC, "collA")]
    assert ppvt.encode_kv(kv) == jpvt.encode_kv(kv)
    assert ppvt.decode_kv(jpvt.encode_kv(kv)) == kv


class _Chan:
    """The slice of a channel the gossip handlers read."""

    def __init__(self, cid, colls, transient=None, msp=None, pvtdata=None):
        self.id, self.colls, self.transient = cid, colls, transient
        self.height = 3
        self.validator = type("V", (), {"msp": msp})()
        self.ledger = type("L", (), {"pvtdata": pvtdata})()

    def collection_config(self, ns, coll):
        return self.colls.get(coll) if ns == CC else None


class _Node:
    def __init__(self, node_id, signer, chans, registry, server=None):
        self.id, self.signer, self.server = node_id, signer, server
        self.channels = {c.id: c for c in chans}
        self.registry = registry


@pytest.mark.parametrize("coll", ["collA", "collPriv", "collPullOnly", "undefined"])
@pytest.mark.parametrize("own", ["Org1MSP", "Org2MSP", None])
def test_access_filter_equals_reference(coll, own):
    ch = _Chan(CHANNEL, COLLECTIONS)
    assert (pgossip.GossipService._members(ch, CC, coll, own)
            == jgossip.GossipService._members(ch, CC, coll, own))
    assert pgossip.GossipService._members(None, CC, coll, own) == (
        jgossip.GossipService._members(None, CC, coll, own))


def test_push_payload_and_pull_bytes_equal_reference(orgs):
    """The PvtPush payloads and PvtPull requests each package's client
    sends for the same calls: the same bytes (the pull's signature
    apart: the reference signs with a random nonce), each request's
    signature valid under the other package's check."""
    async def capture(mod, registry_cls, info_cls, signer):
        sent = []

        class Cli:
            async def unary(self, method, payload, *a, **kw):
                sent.append((method, payload))
                return b'{"status": 404}'

        reg = registry_cls()
        for org, port in (("Org1MSP", 7001), ("Org2MSP", 7002), ("Org3MSP", 7003)):
            reg.add(info_cls(org, "127.0.0.1", port))
        svc = mod.GossipService(_Node("p0", signer, [_Chan(CHANNEL, COLLECTIONS)], reg))

        async def client(host, port):
            return Cli()

        svc._client = client
        await svc.push_pvt(CHANNEL, "tx1", {(CC, "collA"): {"a": b"1", "b": None},
                                            (CC, "collPriv"): {"c": b"3"},
                                            (CC, "collPullOnly"): {"d": b"4"},
                                            (CC, "undefined"): {"e": b"5"}}, 7)
        assert await svc.pull_pvt_for(CHANNEL)("tx1", 5, 2, CC, "collA") is None
        return sent

    ref = run(capture(jgossip, JPeerRegistry, JPeerInfo, orgs["Org1MSP"]["ref_peer"]))
    port = run(capture(pgossip, PeerRegistry, PeerInfo, orgs["Org1MSP"]["peer"]))
    pushes = [(m, p) for m, p in ref if m == "PvtPush"]
    assert pushes == [(m, p) for m, p in port if m == "PvtPush"]
    assert len(pushes) == 2 + 1 + 1  # collA to both orgs' peers, collPriv and undefined to Org1
    pulls = {name: [json.loads(p) for m, p in sent if m == "PvtPull"]
             for name, sent in (("ref", ref), ("port", port))}
    assert len(pulls["ref"]) == len(pulls["port"]) == 3  # one request, every peer asked
    jmgr = JMSPManager({"Org1MSP": orgs["Org1MSP"]["ref"].msp()})
    pmgr = MSPManager({"Org1MSP": orgs["Org1MSP"]["msp"]})
    from fabric_tpu_torch.crypto.msp import verify_signature

    for r, p in zip(pulls["ref"], pulls["port"]):
        assert {k: v for k, v in r.items() if k != "sig"} == {
            k: v for k, v in p.items() if k != "sig"}
        assert pgossip.GossipService._pull_signable(p) == jgossip.GossipService._pull_signable(r)
        signable = pgossip.GossipService._pull_signable(p)
        assert jmgr.deserialize_identity(bytes.fromhex(p["identity"])).verify(
            signable, bytes.fromhex(p["sig"]))
        assert verify_signature(pmgr.deserialize_identity(bytes.fromhex(r["identity"])),
                                signable, bytes.fromhex(r["sig"]))


def _store_script(mod, path):
    s = mod.PvtDataStore(str(path))
    s.commit_block(1, {(0, CC, "collA"): (b"rw0", 0)},
                   [(1, CC, "collA", True), (2, CC, "collPriv", False)])
    s.commit_block(2, {}, [(0, CC, "collB", True), (3, "x", "y", True)])
    s.commit_block(3, {(1, CC, "collA"): (b"rw1", 5)}, [(4, CC, "collA", True)])
    out = [s.missing_data(2), s.missing_data(2, eligible_only=False), s.missing_data(9)]
    s.resolve_missing(1, 1, CC, "collA", b"late")
    s.resolve_missing(2, 3, "x", "y", b"late2", expiry=4)
    out += [s.missing_data(9), s.missing_data(9, eligible_only=False),
            s.get_pvt_data(1), s.get_pvt_data(2), s.purge_expired(4), s.missing_data(0)]
    s.close()
    return out


def test_missing_data_and_resolve_equal_reference(tmp_path):
    assert _store_script(ppvt, tmp_path / "port.db") == _store_script(jpvt, tmp_path / "ref.db")
    # each package reads the other's file
    assert ppvt.PvtDataStore(str(tmp_path / "ref.db")).missing_data(9, False) == \
        jpvt.PvtDataStore(str(tmp_path / "port.db")).missing_data(9, False)


def test_each_packages_gossip_client_is_served_by_the_others(orgs, tmp_path):
    """A reference gossip service's push and signed pull reach the port's
    handlers, and the port's reach the reference's: an Org2 member
    receives the collA push and is refused the Org1-only collection; a
    member's pull is answered from the transient store, then the
    committed store; a non-member's pull is refused."""
    async def scenario():
        out = {}
        for server_pkg in ("port", "ref"):
            srv_mod, cli_mod = (pgossip, jgossip) if server_pkg == "port" else (jgossip, pgossip)
            rpc = RpcServer("127.0.0.1", 0) if server_pkg == "port" else JRpcServer("127.0.0.1", 0)
            tmod, pmod = (ptransient, ppvt) if server_pkg == "port" else (jtransient, jpvt)
            mgr = (MSPManager({k: o["msp"] for k, o in orgs.items()}) if server_pkg == "port"
                   else JMSPManager({k: o["ref"].msp() for k, o in orgs.items()}))
            store = pmod.PvtDataStore(str(tmp_path / f"{server_pkg}.db"))
            store.commit_block(4, {(2, CC, "collA"): (pmod.encode_kv({"old": b"o"}), 0)})
            chan = _Chan(CHANNEL, COLLECTIONS, tmod.TransientStore(
                str(tmp_path / f"{server_pkg}-t.db")), mgr, store)
            signer = orgs["Org2MSP"]["peer" if server_pkg == "port" else "ref_peer"]
            srv = srv_mod.GossipService(_Node("srv", signer, [chan], None, rpc)).register()
            await rpc.start()
            # the client is the other package's
            reg_cls, info_cls = ((JPeerRegistry, JPeerInfo) if server_pkg == "port"
                                 else (PeerRegistry, PeerInfo))
            got = []
            for who in ("Org1MSP", "Org2MSP"):
                reg = reg_cls()
                reg.add(info_cls("Org2MSP", "127.0.0.1", rpc.port))
                csigner = orgs[who]["ref_peer" if server_pkg == "port" else "peer"]
                cli = cli_mod.GossipService(_Node("cli", csigner, [_Chan(CHANNEL, COLLECTIONS)],
                                                  reg))
                await cli.push_pvt(CHANNEL, f"tx-{who}", {(CC, "collA"): {"k": b"v"},
                                                          (CC, "collPriv"): {"p": b"x"}}, 1)
                pull = cli.pull_pvt_for(CHANNEL)
                got.append((sorted(chan.transient.get(f"tx-{who}")),
                            await pull(f"tx-{who}", 9, 0, CC, "collA"),
                            await pull("", 4, 2, CC, "collA"),
                            await pull(f"tx-{who}", 9, 0, CC, "collPriv")))
                await cli.stop()
            await srv.stop()
            await rpc.stop()
            chan.transient.close()
            store.close()
            out[server_pkg] = got
        return out

    got = run(scenario())
    assert got["port"] == got["ref"]
    want = ([(CC, "collA")], {"k": b"v"}, {"old": b"o"}, None)
    assert got["port"] == [want, want]


# ---------------------------------------------------------------------------
# the reference's scenarios on port peers over localhost


async def _mknet(orgs, tmp_path, btl=0):
    """A port Raft orderer (1-message blocks) and two port peers on the
    CPU, Org1's p0 and Org2's p1, each knowing the other; the channel's
    static policy provider carries ``COLLECTIONS``."""
    orderer = OrdererNode("o0", str(tmp_path / "o0"), {},
                          batch_config=BatchConfig(max_message_count=1, batch_timeout_s=0.1))
    await orderer.start()
    orderer.cluster["o0"] = ("127.0.0.1", orderer.port)
    orderer.join_channel(CHANNEL)
    mgr = MSPManager({k: o["msp"] for k, o in orgs.items()})
    peers = []
    for i, org in enumerate(("Org1MSP", "Org2MSP")):
        rt = ChaincodeRuntime()
        rt.register(CC, KVContract())
        node = PeerNode(f"p{i}", str(tmp_path / f"p{i}"), mgr, orgs[org]["peer"], rt,
                        device="cpu")
        await node.start()
        colls = json.loads(json.dumps(COLLECTIONS))
        colls["collA"]["btl"] = btl
        node.join_channel(CHANNEL, PolicyProvider({CC: NamespaceInfo(
            policy=ppol.from_dsl(POLICY), collections=colls)}))
        peers.append(node)
    for i, node in enumerate(peers):
        other = peers[1 - i]
        node.registry.add(PeerInfo(("Org1MSP", "Org2MSP")[1 - i], "127.0.0.1", other.port))
    return orderer, peers


async def _endorse(peer, client, args, transient=None):
    signed, tx_id, prop = txa.create_signed_proposal(client, CHANNEL, CC, args,
                                                     transient=transient)
    cli = RpcClient("127.0.0.1", peer.port)
    await cli.connect()
    try:
        pr = M.ProposalResponse.parse(await cli.unary("Endorse", signed.serialize(), timeout=60))
    finally:
        await cli.close()
    assert pr.response.status == 200, pr.response.message
    return tx_id, txa.assemble_transaction(prop, [pr], client)


async def _submit(orderer, env):
    bc = BroadcastClient([("127.0.0.1", orderer.port)])
    try:
        assert (await bc.broadcast(CHANNEL, env.serialize()))["status"] == 200
    finally:
        await bc.close()


def _pvt(peer, coll, key):
    vv = peer.channels[CHANNEL].ledger.state.get_state(f"{CC}${coll}", key)
    return vv.value if vv is not None else None


def _reference_validation(orgs, blocks):
    """The JAX ``BlockValidator`` over the orderer's blocks, one at a
    time (its verify's verdicts from the port's plain verify) → (filters,
    public and hashed state rows)."""
    jmgr = JMSPManager({k: o["ref"].msp() for k, o in orgs.items()})
    prov = jvalidator.PolicyProvider({CC: jvalidator.NamespaceInfo(
        policy=jpol.from_dsl(POLICY), collections=COLLECTIONS)})
    parser = jvalidator.BlockValidator(jmgr, prov, JMemDB())
    jblocks = [common_pb2.Block.FromString(b) for b in blocks]
    todo = list(dict.fromkeys(it for b in jblocks for it in parser._parse(b)[1].tuples()))
    cache = _CachedVerify(jax=True)
    cache.bits.update(zip(todo, p256v3.verify_launch(todo, device="cpu").fetch()))

    class Store:
        txids = set()

        def tx_exists(self, txid):
            return txid in self.txids

    state, store, filters = JMemDB(), Store(), []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvalidator.p256, "verify_launch", cache)
        v = jvalidator.BlockValidator(jmgr, prov, state, block_store=store)
        for b in jblocks:
            flt, batch, _ = v.validate(b)
            state.apply_updates(batch, (b.header.number, 0))
            store.txids.update(p.txid for p in v.last_parsed if p.txid)
            filters.append(bytes(flt))
    return filters, sorted((k, vv.value, vv.version) for k, vv in state.iter_all())


def _public_rows(peer):
    lg = peer.channels[CHANNEL].ledger
    lg.drain_state()
    return sorted((k, vv.value, vv.version) for k, vv in lg.state.iter_all()
                  if "$" not in k[0] or k[0].endswith("#hashed"))


def test_pvt_distribution_and_pull(orgs, tmp_path):
    async def scenario():
        orderer, (p0, p1) = await _mknet(orgs, tmp_path)
        client = orgs["Org1MSP"]["user"]
        try:
            for p in (p0, p1):
                p.channels[CHANNEL].start_deliver([("127.0.0.1", orderer.port)])
            # endorse ONLY on p0: it pushes to p1's transient store
            tx_id, env = await _endorse(p0, client, [b"put_private", b"collA", b"secret-key"],
                                        {"value": b"secret-value"})
            assert await _wait(lambda: bool(p1.channels[CHANNEL].transient.get(tx_id)))
            assert p0.gossip_service.stats["acks"] == {"collA": 1}
            await _submit(orderer, env)
            assert await _wait(lambda: _pvt(p0, "collA", "secret-key") == b"secret-value"
                               and _pvt(p1, "collA", "secret-key") == b"secret-value")
            kh = hashlib.sha256(b"secret-key").digest().hex()
            for p in (p0, p1):
                hv = p.channels[CHANNEL].ledger.state.get_state(f"{CC}$collA#hashed", kh)
                assert hv.value == hashlib.sha256(b"secret-value").digest()
            # pull-only collection: no push; p1 pulls the cleartext at commit
            tx2, env2 = await _endorse(p0, client, [b"put_private", b"collPullOnly", b"po-key"],
                                       {"value": b"po-value"})
            await asyncio.sleep(0.5)  # the window an eager push would use
            assert not p1.channels[CHANNEL].transient.get(tx2)
            await _submit(orderer, env2)
            assert await _wait(lambda: _pvt(p1, "collPullOnly", "po-key") == b"po-value")
            assert p0.gossip_service.stats["pulls"] == 1
            assert p1.gossip_service.stats["pulled"] == 1
            # both peers' filters and public/hashed state equal the reference's
            blocks = [orderer.chains[CHANNEL].blocks.get_block(n).serialize() for n in range(2)]
            assert await _wait(lambda: all(p.channels[CHANNEL].height == 2 for p in (p0, p1)))
            want, rows = _reference_validation(orgs, blocks)
            for p in (p0, p1):
                lg = p.channels[CHANNEL].ledger
                got = [bytes(M.Block.parse(lg.blocks.get_block(n).serialize())
                             .metadata.metadata[M.META_TRANSACTIONS_FILTER]) for n in range(2)]
                assert got == want == [b"\x00", b"\x00"]
                assert _public_rows(p) == rows
                assert not lg.pvtdata.missing_data(9, eligible_only=False)
        finally:
            for p in (p0, p1):
                await p.stop()
            await orderer.stop()

    run(scenario())


def test_missing_then_reconcile(orgs, tmp_path):
    async def scenario():
        orderer, (p0, p1) = await _mknet(orgs, tmp_path)
        client = orgs["Org1MSP"]["user"]
        try:
            for p in (p0, p1):
                p.channels[CHANNEL].start_deliver([("127.0.0.1", orderer.port)])
            p0.registry.peers.clear()  # no distribution targets
            ch1 = p1.channels[CHANNEL]
            real_puller = ch1.pvt_puller

            async def no_pull(*a):
                return None

            ch1.pvt_puller = no_pull
            _, env = await _endorse(p0, client, [b"put_private", b"collB", b"k2"],
                                    {"value": b"v2"})
            await _submit(orderer, env)
            assert await _wait(lambda: ch1.height >= 1)
            assert await _wait(lambda: bool(ch1.ledger.pvtdata.missing_data(ch1.height)))
            assert ch1.ledger.state.get_state(f"{CC}$collB", "k2") is None
            ch1.pvt_puller = real_puller
            p1.gossip_service.start_reconciler(CHANNEL, interval=0.2)
            assert await _wait(lambda: not ch1.ledger.pvtdata.missing_data(ch1.height))
            assert _pvt(p1, "collB", "k2") == b"v2"
            assert p1.gossip_service.stats["reconciled"] == 1
            assert ch1.ledger.pvtdata.get_pvt_data(0) == {
                (0, CC, "collB"): ppvt.encode_kv({"k2": b"v2"})}
        finally:
            for p in (p0, p1):
                await p.stop()
            await orderer.stop()

    run(scenario())


def test_anti_entropy_catchup_and_election(orgs, tmp_path):
    async def scenario():
        orderer, (p0, p1) = await _mknet(orgs, tmp_path)
        client = orgs["Org1MSP"]["user"]
        try:
            # only p0 talks to the orderer; p1 relies on anti-entropy
            p0.channels[CHANNEL].start_deliver([("127.0.0.1", orderer.port)])
            for i in range(3):
                _, env = await _endorse(p0, client, [b"put", b"k%d" % i, b"v%d" % i])
                await _submit(orderer, env)
            assert await _wait(lambda: p0.channels[CHANNEL].height >= 3)
            c0, c1 = p0.channels[CHANNEL], p1.channels[CHANNEL]
            assert c1.height == 0
            p1.gossip_service.start_anti_entropy(CHANNEL, interval=0.2)
            assert await _wait(lambda: c1.height >= 3
                               and p1.gossip_service.stats["ae_blocks"] == 3)
            assert c1.pipeline_depth == 1
            for k in range(3):
                assert c0.ledger.blocks.get_block(k).serialize() == \
                    c1.ledger.blocks.get_block(k).serialize()
            assert c0.ledger.state_digest() == c1.ledger.state_digest()
            gs = p0.gossip_service
            me = ("127.0.0.1", p0.port)
            others = [PeerInfo("Org1MSP", "127.0.0.1", p1.port, height=3)]
            assert gs.elect_leader(others, me) == (me < ("127.0.0.1", p1.port))
        finally:
            for p in (p0, p1):
                await p.stop()
            await orderer.stop()

    run(scenario())


def test_non_member_org_never_holds_cleartext(orgs, tmp_path):
    """collPriv is Org1-only: the push skips Org2's peer, a push aimed
    at it is refused, its signed pull is refused, and it records the
    collection missing as ineligible (never pulled again)."""
    async def scenario():
        orderer, (p0, p1) = await _mknet(orgs, tmp_path)
        client = orgs["Org1MSP"]["user"]
        try:
            for p in (p0, p1):
                p.channels[CHANNEL].start_deliver([("127.0.0.1", orderer.port)])
            tx_id, env = await _endorse(p0, client, [b"put_private", b"collPriv", b"top-secret"],
                                        {"value": b"classified"})
            assert p0.channels[CHANNEL].transient.get(tx_id)
            await asyncio.sleep(0.3)
            assert not p1.channels[CHANNEL].transient.get(tx_id)
            push = json.dumps({"channel": CHANNEL, "txid": tx_id, "height": 0,
                               "data": {f"{CC}\x00collPriv": {"top-secret": b"x".hex()}}}).encode()
            cli = RpcClient("127.0.0.1", p1.port)
            await cli.connect()
            assert json.loads(await cli.unary("PvtPush", push))["status"] == 403
            await cli.close()
            assert not p1.channels[CHANNEL].transient.get(tx_id)
            await _submit(orderer, env)
            assert await _wait(lambda: all(p.channels[CHANNEL].height >= 1 for p in (p0, p1)))
            assert _pvt(p0, "collPriv", "top-secret") == b"classified"
            assert _pvt(p1, "collPriv", "top-secret") is None
            assert await p1.gossip_service.pull_pvt_for(CHANNEL)(tx_id, 0, 0, CC,
                                                                   "collPriv") is None
            lg1 = p1.channels[CHANNEL].ledger
            assert lg1.pvtdata.missing_data(9) == []
            assert lg1.pvtdata.missing_data(9, eligible_only=False) == [(0, 0, CC, "collPriv")]
            assert p1.gossip_service.stats["pulled"] == 0
            assert _public_rows(p0) == _public_rows(p1)
        finally:
            for p in (p0, p1):
                await p.stop()
            await orderer.stop()

    run(scenario())


def test_btl_expiry_purges_state_and_store(orgs, tmp_path):
    async def scenario():
        orderer, (p0, p1) = await _mknet(orgs, tmp_path, btl=1)
        client = orgs["Org1MSP"]["user"]
        try:
            ch0 = p0.channels[CHANNEL]
            ch0.start_deliver([("127.0.0.1", orderer.port)])
            _, env = await _endorse(p0, client, [b"put_private", b"collA", b"ttl-key"],
                                    {"value": b"ephemeral"})
            await _submit(orderer, env)
            assert await _wait(lambda: ch0.height >= 1)
            assert _pvt(p0, "collA", "ttl-key") == b"ephemeral"
            assert ch0.ledger.pvtdata.get_pvt_data(0)
            for i in range(2):  # data committed at block 0 with btl 1 expires at block 2
                _, env = await _endorse(p0, client, [b"put", b"pub%d" % i, b"v"])
                await _submit(orderer, env)
            assert await _wait(lambda: ch0.height >= 3)
            ch0.ledger.drain_state()
            assert not ch0.ledger.pvtdata.get_pvt_data(0)
            assert _pvt(p0, "collA", "ttl-key") is None
            kh = hashlib.sha256(b"ttl-key").digest().hex()
            assert ch0.ledger.state.get_state(f"{CC}$collA#hashed", kh) is None
        finally:
            for p in (p0, p1):
                await p.stop()
            await orderer.stop()

    run(scenario())


def test_dead_peer_excluded_from_election(orgs, tmp_path):
    async def scenario():
        orderer, (p0, p1) = await _mknet(orgs, tmp_path)
        try:
            gs = p0.gossip_service
            dead = PeerInfo("Org1MSP", "127.0.0.1", 1)
            p0.registry.add(dead)
            me = ("127.0.0.1", p0.port)
            org_peers = p0.registry.peers.get("Org1MSP", [])
            assert not gs.elect_leader(org_peers, me)  # never probed: counts
            res = await gs.probe_members()
            assert dead.alive is False and res[("127.0.0.1", 1)] is None
            assert res[("127.0.0.1", p1.port)]["heights"] == {CHANNEL: 0}
            assert gs.elect_leader(org_peers, me)
        finally:
            for p in (p0, p1):
                await p.stop()
            await orderer.stop()

    run(scenario())
