"""BASELINE config 1's network on the port, on localhost and on the CPU
(fabric_tpu_torch/ordering/node.py, peer/node.py, peer/gateway.py,
discovery.py): one Raft orderer and one peer whose endorser signs on
its sign lane.  The orderer's blocks go through the JAX package's
``BlockValidator`` serially, and the peer's filters and final state
must equal it; policy and MVCC rejections come out as in
``tests/test_e2e.py``; a ``configtxgen`` genesis carries a lifecycle
approve and commit and then an invoke; the gateway round trip; the
commit lock; and the JAX package's broadcast and deliver clients
against the port's orderer.  Identities are the reference cryptogen's,
carried into the port (``carry.from_cryptogen``)."""

import asyncio
import json
import random
import time

import pytest
import torch
from test_torch_endorser import carried, orgs, port_signer  # noqa: F401  (module fixture)
from test_torch_wire import _CachedVerify

from fabric_tpu.crypto import cryptogen as jcryptogen
from fabric_tpu.crypto import policy as jpol
from fabric_tpu.crypto.msp import MSPManager as JMSPManager
from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.ordering.node import BroadcastClient as JBroadcastClient
from fabric_tpu.ordering.node import DeliverClient as JDeliverClient
from fabric_tpu.peer import validator as jvalidator
from fabric_tpu.protos import common_pb2
from fabric_tpu_torch.comm.rpc import RpcClient
from fabric_tpu_torch.crypto import policy as ppol
from fabric_tpu_torch.crypto.msp import MSPManager, verify_signature
from fabric_tpu_torch.ops import p256v3
from fabric_tpu_torch.ordering import BatchConfig, BroadcastClient, OrdererNode
from fabric_tpu_torch.peer import txassembly as txa
from fabric_tpu_torch.peer.chaincode import ChaincodeRuntime, KVContract, MarblesContract
from fabric_tpu_torch.peer.endorser import Endorser, response_status
from fabric_tpu_torch.peer.gateway import GatewayClient, GatewayError
from fabric_tpu_torch.peer.lifecycle import LIFECYCLE_NS, ChaincodeDefinition, definition_key
from fabric_tpu_torch.peer.node import PeerNode
from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
from fabric_tpu_torch.peer.validator import NamespaceInfo, PolicyProvider
from fabric_tpu_torch.protos import messages as M
from fabric_tpu_torch.tools import configtxgen as cg

CHANNEL = "netchan"
CC = "kvcc"
POLICY = "OutOf(1, 'Org1MSP.peer')"
SEED = 20261021


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _until(cond, timeout=15.0):
    loop = asyncio.get_event_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if cond():
            return True
        await asyncio.sleep(0.02)
    return False


@pytest.fixture(scope="module")
def orderer_org():
    org = jcryptogen.generate_org("OrdererMSP", "ord.net.example.com", peers=0, orderers=1,
                                  users=0, admin=False)
    signers, msp = carried(org)
    return {"ref": org, "signer": signers["orderer0.ord.net.example.com"], "msp": msp}


class Net:
    """One Raft orderer and one Org1 peer (``device="cpu"``, the sign
    lane on), one channel, KV and marbles chaincodes."""

    def __init__(self, orgs, tmp, genesis=None, orderer_signer=None, **peer_kw):  # noqa: F811
        self.orgs, self.tmp, self.genesis = orgs, tmp, genesis
        self.orderer_signer = orderer_signer
        self.peer_kw = peer_kw
        self.client = port_signer(orgs, "Org1MSP", "user")

    async def up(self):
        o = OrdererNode("o0", str(self.tmp / "o0"), {}, signer=self.orderer_signer,
                        batch_config=BatchConfig(max_message_count=3, batch_timeout_s=0.2),
                        rng=random.Random(SEED))
        await o.start()
        o.cluster["o0"] = ("127.0.0.1", o.port)
        self.orderer = o
        self.chain = o.join_channel(CHANNEL, self.genesis)
        rt = ChaincodeRuntime()
        rt.register(CC, KVContract())
        rt.register("marbles", MarblesContract())
        mgr = MSPManager({"Org1MSP": self.orgs["Org1MSP"]["msp"]})
        self.peer = PeerNode("p0", str(self.tmp / "p0"), mgr,
                             port_signer(self.orgs, "Org1MSP", "peer"), rt, device="cpu",
                             sign_device=True, **self.peer_kw)
        await self.peer.start()
        if self.genesis is None:
            prov = PolicyProvider({CC: NamespaceInfo(policy=ppol.from_dsl(POLICY)),
                                   "marbles": NamespaceInfo(policy=ppol.from_dsl(POLICY))})
            self.ch = self.peer.join_channel(CHANNEL, prov)
        else:
            self.ch = self.peer.join_channel(CHANNEL, genesis_block=self.genesis)
        self.ch.start_deliver([o.cluster["o0"]])
        self.bcast = BroadcastClient([o.cluster["o0"]])
        assert await _until(lambda: self.chain.raft.state == "leader")
        return self

    async def down(self):
        await self.bcast.close()
        await self.peer.stop()
        await self.orderer.stop()

    async def endorse(self, args, signer=None, cc=CC):
        signed, tx_id, prop = txa.create_signed_proposal(signer or self.client, CHANNEL, cc, args)
        cli = RpcClient("127.0.0.1", self.peer.port)
        await cli.connect()
        try:
            pr = M.ProposalResponse.parse(await cli.unary("Endorse", signed.serialize(), timeout=60))
        finally:
            await cli.close()
        return prop, pr, tx_id

    async def submit(self, prop, responses, signer=None):
        env = txa.assemble_transaction(prop, responses, signer or self.client)
        res = await self.bcast.broadcast(CHANNEL, env.serialize())
        assert res["status"] == 200, res

    async def query(self, key, ns=CC):
        cli = RpcClient("127.0.0.1", self.peer.port)
        await cli.connect()
        try:
            return json.loads(await cli.unary("Query", json.dumps(
                {"channel": CHANNEL, "ns": ns, "key": key}).encode()))
        finally:
            await cli.close()

    def filters(self):
        return [bytes(M.Block.parse(self.ch.ledger.blocks.get_block(n).serialize())
                      .metadata.metadata[M.META_TRANSACTIONS_FILTER])
                for n in range(self.ch.height)]

    def orderer_blocks(self):
        return [self.chain.blocks.get_block(n).serialize() for n in range(self.chain.height)]


def _reference_validation(orgs, blocks):  # noqa: F811
    """The JAX ``BlockValidator`` over the orderer's blocks, one at a
    time (its verify's verdicts from the port's plain verify) → (filters,
    state)."""
    jmgr = JMSPManager({"Org1MSP": orgs["Org1MSP"]["ref"].msp()})
    prov = jvalidator.PolicyProvider({cc: jvalidator.NamespaceInfo(policy=jpol.from_dsl(POLICY))
                                      for cc in (CC, "marbles")})
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
    return filters, state


def test_network_commits_what_the_reference_validates(orgs, tmp_path):  # noqa: F811
    async def scenario():
        net = await Net(orgs, tmp_path).up()
        try:
            for key, value in ((b"bal", b"100"), (b"k1", b"v1"), (b"k2", b"v2")):
                prop, pr, _ = await net.endorse([b"put", key, value])
                await net.submit(prop, [pr])
            assert await _until(lambda: net.ch.height >= 1)
            assert (await net.query("bal"))["value"] == b"100".hex()
            # under-endorsed: a client's signature is no peer endorsement
            prop, _, _ = await net.endorse([b"put", b"bal", b"999"])
            rogue = Endorser(net.peer.msp, net.client, net.ch.ledger.state, net.peer.runtime)
            signed = M.SignedProposal(proposal_bytes=prop.serialize(),
                                      signature=net.client.sign(prop.serialize()))
            await net.submit(prop, [rogue.process_proposal(signed).response])
            # double spend: two transfers endorsed against one version
            pa, ra, _ = await net.endorse([b"transfer", b"bal", b"x", b"60"])
            pb, rb, _ = await net.endorse([b"transfer", b"bal", b"y", b"70"])
            await net.submit(pa, [ra])
            await net.submit(pb, [rb])
            pm, rm, _ = await net.endorse([b"create", b"m1", b"red", b"3", b"tom"], cc="marbles")
            await net.submit(pm, [rm])
            n_tx = 7
            assert await _until(lambda: sum(len(f) for f in net.filters()) == n_tx)
            assert await _until(lambda: net.ch.height == net.chain.height)
            got = net.filters()
            flat = b"".join(got)
            assert flat.count(bytes([C.ENDORSEMENT_POLICY_FAILURE])) == 1
            assert flat.count(bytes([C.MVCC_READ_CONFLICT])) == 1
            assert flat.count(bytes([C.VALID])) == n_tx - 2
            want, jstate = _reference_validation(orgs, net.orderer_blocks())
            assert got == want
            net.ch.ledger.drain_state()
            rows = sorted((k, vv.value, vv.version) for k, vv in jstate.iter_all())
            assert rows == sorted((k, vv.value, vv.version) for k, vv in net.ch.ledger.state.iter_all())
            x, y, bal = [(await net.query(k))["value"] for k in ("x", "y", "bal")]
            assert (x, y, bal) in ((b"60".hex(), None, b"40".hex()), (None, b"70".hex(), b"30".hex()))
        finally:
            await net.down()

    run(scenario())


def test_genesis_lifecycle_then_invoke_through_the_gateway(orgs, orderer_org, tmp_path):  # noqa: F811
    prof = cg.Profile(CHANNEL, application_orgs=[cg.OrgProfile("Org1MSP", orgs["Org1MSP"]["msp"])],
                      orderer_orgs=[cg.OrgProfile("OrdererMSP", orderer_org["msp"])])
    genesis = cg.genesis_block(prof)

    async def scenario():
        net = await Net(orgs, tmp_path, genesis=genesis, orderer_signer=orderer_org["signer"]).up()
        admin = port_signer(orgs, "Org1MSP", "admin")
        gw = GatewayClient("127.0.0.1", net.peer.port, admin)
        try:
            assert net.ch.height == 1 and net.ch.acl is not None
            with pytest.raises(GatewayError) as e:  # no definition yet
                await gw.submit_transaction(CHANNEL, CC, [b"put", b"a", b"1"])
            assert e.value.status == 404
            for fn in (b"approve", b"commit"):
                _, st = await gw.submit_transaction(CHANNEL, LIFECYCLE_NS, [fn, CC.encode(), b"1"])
                assert st["code"] == C.VALID, st
            vv = net.ch.ledger.state.get_state(LIFECYCLE_NS, definition_key(CC))
            assert ChaincodeDefinition.from_bytes(vv.value).sequence == 1
            gw_user = GatewayClient("127.0.0.1", net.peer.port, net.client)
            tx_id, st = await gw_user.submit_transaction(CHANNEL, CC, [b"put", b"a", b"42"])
            assert (st["tx_id"], st["code_name"]) == (tx_id, "VALID")
            assert st["durable_height"] > st["block"]  # acknowledged after the fsync
            resp = await gw_user.evaluate(CHANNEL, CC, [b"get", b"a"])
            assert (resp.status, resp.payload) == (200, b"42")
            # every delivered block carried the orderer's signature
            for n in range(1, net.ch.height):
                blk = net.ch.ledger.blocks.get_block(n)
                net.ch.verify_block_signature(blk)
            await gw_user.close()
        finally:
            await gw.close()
            await net.down()

    run(scenario())


def test_gateway_round_trip_events_and_discovery(orgs, tmp_path):  # noqa: F811
    async def scenario():
        net = await Net(orgs, tmp_path).up()
        gw = GatewayClient("127.0.0.1", net.peer.port, net.client)
        try:
            results = await asyncio.gather(*[gw.submit_transaction(
                CHANNEL, "marbles", [b"create", b"m%d" % i, b"red", b"3", b"tom"])
                for i in range(3)])
            assert all(st["code_name"] == "VALID" for _, st in results)
            _, st = await gw.submit_transaction(CHANNEL, CC, [b"put", b"k", b"v"])
            assert st["code"] == C.VALID and st["durable_height"] >= st["block"] + 1
            resp = await gw.evaluate(CHANNEL, CC, [b"get", b"absent"])
            assert resp.status == 404
            with pytest.raises(GatewayError) as e:
                await gw.submit_transaction(CHANNEL, CC, [b"transfer", b"a", b"a", b"1"])
            assert e.value.status == 400
            cli = RpcClient("127.0.0.1", net.peer.port)
            await cli.connect()
            st = await cli.open_stream("GwChaincodeEvents")
            await st.send(json.dumps({"channel": CHANNEL, "chaincode": "marbles"}).encode())
            events = [json.loads(await st.__anext__()) for _ in range(3)]
            st.dispose()
            assert sorted(bytes.fromhex(e["payload"]) for e in events) == [b"m0", b"m1", b"m2"]
            assert {e["tx_id"] for e in events} == {t for t, _ in results}
            desc = json.loads(await cli.unary("Discover", json.dumps(
                {"channel": CHANNEL, "query": "endorsers", "chaincode": CC}).encode()))
            assert desc["descriptor"]["layouts"] == [{"Org1MSP": 1}]
            info = json.loads(await cli.unary("Info", json.dumps({"channel": CHANNEL}).encode()))
            assert info == {"status": 200, "height": net.ch.height}
            snap = json.loads(await cli.unary("Snapshot", json.dumps(
                {"channel": CHANNEL, "out_dir": str(tmp_path / "snap")}).encode()))
            assert snap["status"] == 200
            assert snap["metadata"]["last_block_number"] == net.ch.height - 1
            await cli.close()
            # every endorsement came off the peer's sign lane and verifies
            assert net.peer.sign_batcher.stats()["signed_total"] >= 4
            for n in range(net.ch.height):
                for env in net.ch.ledger.blocks.get_block(n).data.data:
                    from fabric_tpu_torch import protoutil as ppu

                    _, _, cap, prp, _ = ppu.extract_action(M.Envelope.parse(env))
                    e0 = cap.action.endorsements[0]
                    ident = net.peer.msp.deserialize_identity(e0.endorser)
                    assert verify_signature(ident, cap.action.proposal_response_payload
                                            + e0.endorser, e0.signature)
        finally:
            await gw.close()
            await net.down()

    run(scenario())


def test_endorsements_proceed_while_a_commit_holds_the_lock(orgs, tmp_path):  # noqa: F811
    """Endorsements take the commit lock's shared side: concurrent
    proposals simulate at the same time, and a held writer (a commit)
    delays them."""
    spans = []

    class SlowKV(KVContract):
        def put(self, stub, key, value):
            t0 = time.perf_counter()
            time.sleep(0.8)  # a slow simulation (worker thread)
            spans.append((t0, time.perf_counter()))
            return super().put(stub, key, value)

    async def scenario():
        net = await Net(orgs, tmp_path).up()
        net.peer.runtime.register(CC, SlowKV())
        try:
            got = await asyncio.gather(*(net.endorse([b"put", b"k%d" % i, b"v"]) for i in range(6)))
            assert all(response_status(pr) == 200 for _, pr, _ in got)
            # the six simulations ran side by side, not one after another
            overlap = max(sum(a <= t < b for a, b in spans) for t, _ in spans)
            assert len(spans) == 6 and overlap >= 2, spans

            # a held WRITER (a commit in progress) delays endorsements
            async def hold_commit():
                async with net.ch.commit_lock.writer():
                    await asyncio.sleep(0.6)

            t0 = time.perf_counter()
            holder = asyncio.ensure_future(hold_commit())
            await asyncio.sleep(0.02)
            _, pr, _ = await net.endorse([b"put", b"k9", b"v"])
            assert response_status(pr) == 200 and time.perf_counter() - t0 >= 0.58
            await holder
        finally:
            await net.down()

    run(scenario())


def test_reference_clients_drive_the_port_orderer(tmp_path):
    async def scenario():
        o = OrdererNode("o0", str(tmp_path / "o0"), {},
                        batch_config=BatchConfig(max_message_count=2, batch_timeout_s=0.2))
        await o.start()
        o.cluster["o0"] = ("127.0.0.1", o.port)
        chain = o.join_channel(CHANNEL)
        cli = JBroadcastClient([o.cluster["o0"]])
        try:
            assert await _until(lambda: chain.raft.state == "leader")
            envs = [b"envelope-%d" % i for i in range(5)]
            for env in envs:
                assert (await cli.broadcast(CHANNEL, env))["status"] == 200
            assert (await cli.broadcast("nochan", b"x"))["status"] == 404
            assert await _until(lambda: chain.height == 3)
            got = [b async for b in JDeliverClient(*o.cluster["o0"]).blocks(CHANNEL, 0, 2)]
            assert [list(b.data.data) for b in got] == [envs[:2], envs[2:4], envs[4:]]
            assert [b.SerializeToString() for b in got] == \
                [chain.blocks.get_block(n).serialize() for n in range(3)]
        finally:
            await cli.close()
            await o.stop()

    run(scenario())


def test_peer_device_and_unported_knobs(orgs, tmp_path):  # noqa: F811
    mgr = MSPManager({"Org1MSP": orgs["Org1MSP"]["msp"]})
    signer = port_signer(orgs, "Org1MSP", "peer")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PeerNode("p", str(tmp_path / "a"), mgr, signer)
    for kw in ({"slos": "x"}, {"vitals_interval_s": 1.0}, {"blackbox_dir": "d"},
               {"autopilot": True}, {"mesh_devices": 2}, {"verify_chunk": 64},
               {"recode_device": True}, {"host_stage_mode": "process"},
               {"sidecar_listen": "127.0.0.1:1"}, {"verify_deadline_ms": 5.0}):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
            PeerNode("p", str(tmp_path / "b"), mgr, signer, device="cpu", **kw)

    class NoScalar:
        serialized, msp_id = signer.serialized, "Org1MSP"

        def sign(self, message):
            return signer.sign(message)

    async def starts():
        node = PeerNode("p", str(tmp_path / "c"), mgr, NoScalar(), device="cpu", sign_device=True)
        try:
            await node.start()
        finally:
            await node.stop()

    with pytest.raises(ValueError, match="P-256"):
        run(starts())

    async def install_refused():
        # the install RPC is ported: bytes that are no package are a 400
        node = await PeerNode("p", str(tmp_path / "d"), mgr, signer, device="cpu").start()
        cli = RpcClient("127.0.0.1", node.port)
        await cli.connect()
        try:
            res = json.loads(await cli.unary("InstallChaincode", b"pkg"))
            assert res["status"] == 400 and "malformed chaincode package" in res["message"]
        finally:
            await cli.close()
            await node.stop()

    run(install_refused())


def test_a_failed_launch_fails_the_pipe_closed_and_deliver_resumes(orgs, tmp_path):  # noqa: F811
    """A stage-2 dispatch that raises (an armed ``validator.stage2``
    fault, no guard) closes the peer's pipe: the block is not committed,
    the failure is counted and logged, and the deliver loop reconnects
    from the committed height and commits the block once the fault is
    spent."""
    from fabric_tpu_torch import faults
    from fabric_tpu_torch.ops_metrics import global_registry

    fails = global_registry().counter("commit_pipeline_stage_failures_total")
    reconnects = global_registry().counter("deliver_reconnects_total")

    async def scenario():
        net = await Net(orgs, tmp_path).up()
        f0 = fails.value(channel=CHANNEL, stage="launch")
        r0 = reconnects.value(channel=CHANNEL)
        faults.configure("validator.stage2:raise:n=1")
        try:
            prop, pr, tx_id = await net.endorse([b"put", b"k", b"v"])
            await net.submit(prop, [pr])
            assert await _until(lambda: net.ch.height == 1)
            assert net.filters() == [bytes([C.VALID])]
            assert faults.plan().fired("validator.stage2") == 1
            assert fails.value(channel=CHANNEL, stage="launch") == f0 + 1
            assert reconnects.value(channel=CHANNEL) == r0 + 1
        finally:
            faults.reset()
            await net.down()

    run(scenario())
