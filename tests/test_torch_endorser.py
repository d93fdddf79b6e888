"""The execute phase of the port (fabric_tpu_torch/peer/{chaincode,
simulator,endorser,lifecycle,acl,transient,coordinator}.py,
utils/locks.py and carry.py's ``from_cryptogen``) held against the JAX
package on the CPU.  The identities are the reference cryptogen's,
carried into the port; the same seeded state, the same contract calls
and the same ``SignedProposal`` bytes go through both packages, and the
read/write sets, proposal responses and endorsement signatures must be
byte-equal (both sign lanes sign with RFC 6979 nonces)."""

import asyncio
import hashlib
import time

import numpy as np
import pytest
import torch

from fabric_tpu import channelconfig as jcc
from fabric_tpu.crypto import cryptogen as jcryptogen
from fabric_tpu.crypto import policy as jpol
from fabric_tpu.crypto.msp import MSPManager as JMSPManager
from fabric_tpu.crypto.msp import policy_to_proto as jpolicy_to_proto
from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.ledger.statedb import UpdateBatch as JBatch
from fabric_tpu.peer import acl as jacl
from fabric_tpu.peer import chaincode as jcc_mod
from fabric_tpu.peer import coordinator as jcoord
from fabric_tpu.peer import endorser as jendorser
from fabric_tpu.peer import lifecycle as jlc
from fabric_tpu.peer import signlane as jsl
from fabric_tpu.peer import simulator as jsim
from fabric_tpu.peer import transient as jtransient
from fabric_tpu.peer import txassembly as jtxa
from fabric_tpu.tools import configtxgen as jcg
from fabric_tpu_torch import carry
from fabric_tpu_torch import channelconfig as pcc
from fabric_tpu_torch.crypto import policy as ppol
from fabric_tpu_torch.crypto.msp import MSPManager as PMSPManager
from fabric_tpu_torch.crypto.msp import policy_to_proto as ppolicy_to_proto
from fabric_tpu_torch.crypto.msp import verify_signature
from fabric_tpu_torch.ledger.statedb import MemVersionedDB as PMemDB
from fabric_tpu_torch.ledger.statedb import UpdateBatch as PBatch
from fabric_tpu_torch.peer import acl as pacl
from fabric_tpu_torch.peer import chaincode as pcc_mod
from fabric_tpu_torch.peer import coordinator as pcoord
from fabric_tpu_torch.peer import endorser as pendorser
from fabric_tpu_torch.peer import lifecycle as plc
from fabric_tpu_torch.peer import signlane as psl
from fabric_tpu_torch.peer import simulator as psim
from fabric_tpu_torch.peer import transient as ptransient
from fabric_tpu_torch.protos import messages as M
from fabric_tpu_torch.utils.locks import AsyncRWLock

CHANNEL = "endochan"
SEED = 20261019


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carried(org):
    """A reference cryptogen org → the port's signing identities and MSP
    (``carry.from_cryptogen``)."""
    from cryptography.hazmat.primitives.serialization import Encoding

    members = {name: (enr.cert.public_bytes(Encoding.DER), enr.key.private_numbers().private_value)
               for name, enr in {**org.nodes, **org.users}.items()}
    return carry.from_cryptogen(org.msp_id, org.ca.cert.public_bytes(Encoding.DER), members)


@pytest.fixture(scope="module")
def orgs():
    """Org1 (a channel member) and Org2 (known to the MSP manager, not
    on the channel): the reference's material and the port's carry."""
    out = {}
    for msp_id, domain in (("Org1MSP", "org1.endo.example.com"), ("Org2MSP", "org2.endo.example.com")):
        org = jcryptogen.generate_org(msp_id, domain, peers=1, users=1)
        signers, msp = carried(org)
        out[msp_id] = {"ref": org, "port": signers, "msp": msp,
                       "peer": f"peer0.{domain}", "user": f"User1@{domain}",
                       "admin": f"Admin@{domain}"}
    return out


def ref_signer(orgs, msp_id, who):
    o = orgs[msp_id]
    return jcryptogen.signing_identity(o["ref"], o[who])


def port_signer(orgs, msp_id, who):
    o = orgs[msp_id]
    return o["port"][o[who]]


@pytest.fixture(scope="module")
def genesis(orgs):
    """A channel genesis block of the reference's configtxgen (Org1
    only) and the port's bundle of the same bytes."""
    prof = jcg.Profile(CHANNEL, application_orgs=[jcg.OrgProfile("Org1MSP", orgs["Org1MSP"]["ref"].msp())])
    blk = jcg.genesis_block(prof)
    return {"ref": blk, "bytes": blk.SerializeToString(),
            "jbundle": jcc.bundle_from_genesis(CHANNEL, blk),
            "pbundle": pcc.bundle_from_genesis(CHANNEL, M.Block.parse(blk.SerializeToString()))}


# ---------------------------------------------------------------------------
# identities and genesis carried from the reference


def test_carried_identities_sign_and_verify_as_the_reference(orgs):
    jmgr = JMSPManager({k: o["ref"].msp() for k, o in orgs.items()})
    pmgr = PMSPManager({k: o["msp"] for k, o in orgs.items()})
    for msp_id in orgs:
        for who in ("peer", "user", "admin"):
            js, ps = ref_signer(orgs, msp_id, who), port_signer(orgs, msp_id, who)
            assert ps.serialized == js.serialized
            assert ps.d == jsl.private_scalar(js)
            msg = b"carried %s %s" % (msp_id.encode(), who.encode())
            jid, pid = jmgr.deserialize_identity(js.serialized), pmgr.deserialize_identity(ps.serialized)
            assert (pid.msp_id, pid.role, pid.is_valid) == (jid.msp_id, jid.role, jid.is_valid)
            assert pid.is_valid
            # each package verifies the other's signature, and rejects a
            # signature over another message
            assert jid.verify(msg, ps.sign(msg)) and verify_signature(pid, msg, js.sign(msg))
            assert not jid.verify(msg + b"!", ps.sign(msg))
            assert not verify_signature(pid, msg + b"!", js.sign(msg))


def test_channel_joined_from_carried_genesis_has_the_reference_bundle_hash(genesis, tmp_path):
    from fabric_tpu_torch.peer.node import PeerChannel

    ch = PeerChannel(CHANNEL, str(tmp_path / "p"), genesis_block=M.Block.parse(genesis["bytes"]),
                     device="cpu", async_commit=False)
    try:
        want = hashlib.sha256(genesis["jbundle"].config.SerializeToString(deterministic=True)).digest()
        assert ch.processor.bundle.hash() == genesis["pbundle"].hash() == want
        assert ch.height == 1
        assert ch.ledger.blocks.get_block(0).header.serialize() == \
            genesis["ref"].header.SerializeToString()
        assert sorted(ch.validator.msp.msps) == sorted(genesis["jbundle"].msp_manager.msps)
    finally:
        ch.stop()


# ---------------------------------------------------------------------------
# simulator and chaincode: rwset bytes


def _contracts(cc):
    """The scenario contracts over one package's chaincode module."""

    class Caller(cc.Contract):
        def relay(self, stub, key, value):
            stub.put_state("relayed", key)
            resp = stub.invoke_chaincode("kv", [b"put", key, value])
            return resp.payload

        def lock(self, stub, key, policy_hex):
            stub.set_state_validation_parameter(key.decode(), bytes.fromhex(policy_hex.decode()))
            stub.put_state(key.decode(), b"locked")
            return stub.get_state_validation_parameter("locked0") or b"none"

        def mixed(self, stub, key):
            v = stub.get_state(key.decode())
            stub.put_state(key.decode(), (v or b"") + b"+")
            stub.put_state(key.decode(), (v or b"") + b"++")  # read-your-own-write
            stub.del_state("k3")
            stub.get_state("k3")
            stub.set_state_metadata("k4", {"color": b"blue"})
            stub.put_private("coll", "sec", b"s1")
            return stub.get_private("coll", "sec") or b""

    rt = cc.ChaincodeRuntime()
    rt.register("kv", cc.KVContract())
    rt.register("marbles", cc.MarblesContract())
    rt.register("caller", Caller())
    return rt


SIM_CASES = {
    "kv_put": ("kv", [b"put", b"k9", b"v9"], None),
    "kv_get": ("kv", [b"get", b"k1"], None),
    "kv_delete": ("kv", [b"delete", b"k2"], None),
    "kv_transfer": ("kv", [b"transfer", b"acct-a", b"acct-b", b"30"], None),
    "kv_range": ("kv", [b"range_sum", b"acct-", b"acct-z"], None),
    "kv_range_open_end": ("kv", [b"range_sum", b"k", b""], None),
    "kv_private": ("kv", [b"put_private", b"coll", b"pk"], {"value": b"secret"}),
    "marbles_create": ("marbles", [b"create", b"m1", b"red", b"5", b"tom"], None),
    "marbles_transfer": ("marbles", [b"transfer", b"m0", b"jerry"], None),
    "cross_chaincode": ("caller", [b"relay", b"k7", b"v7"], None),
    "key_level_policy": ("caller", [b"lock", b"locked1", b"0a02"], None),
    "mixed": ("caller", [b"mixed", b"k1"], None),
    "failed": ("kv", [b"transfer", b"acct-a", b"acct-b", b"999"], None),
}


def _rows():
    rng = np.random.default_rng(SEED)
    rows = [("kv", f"k{i}", b"%d" % rng.integers(1 << 30), (1, i)) for i in range(6)]
    rows += [("kv", "acct-a", b"100", (2, 0)), ("kv", "acct-b", b"7", (2, 1)),
             ("kv", "acct-c", b"11", (3, 4)),
             ("marbles", "m0", b'{"color": "blue", "docType": "marble", "name": "m0", '
                               b'"owner": "tom", "size": 3}', (2, 2))]
    return rows


def _state(pkg_db, pkg_batch, rows):
    db, b = pkg_db(), pkg_batch()
    for ns, key, value, ver in rows:
        b.put(ns, key, value, ver)
    db.apply_updates(b, (3, 9))
    return db


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_simulation_rwset_bytes_match_reference(case):
    cc_name, args, transient = SIM_CASES[case]
    out = []
    for cc, sim_mod, db_cls, batch_cls in ((jcc_mod, jsim, JMemDB, JBatch),
                                          (pcc_mod, psim, PMemDB, PBatch)):
        rt = _contracts(cc)
        sim = sim_mod.TxSimulator(_state(db_cls, batch_cls, _rows()))
        resp = rt.execute(sim, cc_name, args, transient=transient, creator=b"c", channel=CHANNEL)
        rw, pvt = sim.done()
        out.append((resp.status, resp.payload, resp.message, list(resp.events), rw, pvt))
    assert out[0] == out[1]
    if case == "kv_private":
        assert out[1][5] == {("kv", "coll"): {"pk": b"secret"}} and b"secret" not in out[1][4]


def test_contract_dispatch_refuses_like_the_reference():
    for args in ([], [b"invoke"], [b"_private"], [b"nosuch"]):
        got = [rt.execute(sim.TxSimulator(db()), "kv", args) for rt, sim, db in
               ((_contracts(jcc_mod), jsim, JMemDB), (_contracts(pcc_mod), psim, PMemDB))]
        assert [(r.status, r.message) for r in got][0] == [(r.status, r.message) for r in got][1]
        assert got[1].status == 400
    for cc in (jcc_mod, pcc_mod):
        with pytest.raises(cc.ChaincodeError):
            cc.ChaincodeRuntime().execute(None, "absent", [b"x"])


# ---------------------------------------------------------------------------
# the endorser: the same SignedProposal bytes through both packages


@pytest.fixture(scope="module")
def endorsers(orgs, genesis):
    """Both packages' endorsers over equal state, the channel ACL of the
    genesis bundle, and the peer's key on each package's sign lane."""
    jpeer, ppeer = ref_signer(orgs, "Org1MSP", "peer"), port_signer(orgs, "Org1MSP", "peer")
    jlane = jsl.SignBatcher(jsl.cpu_sign_backend(jsl.private_scalar(jpeer))).start()
    plane = psl.SignBatcher(psl.device_sign_backend(ppeer.d, device="cpu")).start()
    jmgr = JMSPManager({k: o["ref"].msp() for k, o in orgs.items()})
    pmgr = PMSPManager({k: o["msp"] for k, o in orgs.items()})
    jaclp = jacl.ACLProvider(lambda: genesis["jbundle"])
    paclp = pacl.ACLProvider(lambda: genesis["pbundle"])
    rows = _rows()
    ref = jendorser.Endorser(jmgr, jsl.BatchedSigner(jpeer, jlane), _state(JMemDB, JBatch, rows),
                             _contracts(jcc_mod),
                             acl_check=lambda _c, cr, msg, sig: jaclp.check(jacl.PROPOSE, cr, msg, sig))
    port = pendorser.Endorser(pmgr, psl.BatchedSigner(ppeer, plane), _state(PMemDB, PBatch, rows),
                              _contracts(pcc_mod),
                              acl_check=lambda _c, cr, msg, sig: paclp.check(pacl.PROPOSE, cr, msg, sig))
    yield ref, port, ppeer
    jlane.stop()
    plane.stop()


def _proposal(orgs, case):
    client = ref_signer(orgs, "Org2MSP" if case == "denied_acl" else "Org1MSP", "user")
    cc_name, args, transient = {
        "valid": ("kv", [b"transfer", b"acct-a", b"acct-c", b"5"], None),
        "bad_signature": ("kv", [b"put", b"k1", b"x"], None),
        "failed_simulation": ("kv", [b"get", b"absent"], None),
        "unknown_chaincode": ("nosuch", [b"get", b"k1"], None),
        "denied_acl": ("kv", [b"put", b"k1", b"x"], None),
        "transient": ("kv", [b"put_private", b"coll", b"pk"], {"value": b"secret-value"}),
        "event": ("marbles", [b"create", b"m5", b"red", b"5", b"tom"], None),
        "tx_id_mismatch": ("kv", [b"put", b"k1", b"x"], None),
    }[case]
    signed, tx_id, prop = jtxa.create_signed_proposal(client, CHANNEL, cc_name, args,
                                                      transient=transient)
    if case == "bad_signature":
        signed.signature = client.sign(b"another message")
    if case == "tx_id_mismatch":
        from fabric_tpu.protos import common_pb2

        hdr = common_pb2.Header.FromString(prop.header)
        ch = common_pb2.ChannelHeader.FromString(hdr.channel_header)
        ch.tx_id = "0" * 64
        hdr.channel_header = ch.SerializeToString()
        prop.header = hdr.SerializeToString()
        signed.proposal_bytes = prop.SerializeToString()
        signed.signature = client.sign(signed.proposal_bytes)
    return signed.SerializeToString(), tx_id


ENDORSE_CASES = ("valid", "bad_signature", "failed_simulation", "unknown_chaincode", "denied_acl",
                 "transient", "event", "tx_id_mismatch")
WANT_STATUS = {"valid": 200, "bad_signature": 500, "failed_simulation": 404,
               "unknown_chaincode": 500, "denied_acl": 403, "transient": 200, "event": 200,
               "tx_id_mismatch": 500}


@pytest.mark.parametrize("case", ENDORSE_CASES)
def test_endorser_matches_reference(orgs, endorsers, case):
    from fabric_tpu.protos import proposal_pb2

    ref, port, ppeer = endorsers
    raw, tx_id = _proposal(orgs, case)
    jres = ref.process_proposal(proposal_pb2.SignedProposal.FromString(raw))
    pres = port.process_proposal(M.SignedProposal.parse(raw))
    assert pres.response.serialize() == jres.response.SerializeToString()
    assert pendorser.response_status(pres.response) == WANT_STATUS[case]
    assert (pres.tx_id, pres.pvt_cleartext) == (jres.tx_id, jres.pvt_cleartext)
    if WANT_STATUS[case] == 200:
        assert pres.tx_id == tx_id
        pr = pres.response
        # the ESCC signature verifies under the peer's key
        ident = port.msp.deserialize_identity(pr.endorsement.endorser)
        assert verify_signature(ident, pr.payload + pr.endorsement.endorser, pr.endorsement.signature)
        assert pr.endorsement.endorser == ppeer.serialized
    if case == "transient":
        assert pres.pvt_cleartext == {("kv", "coll"): {"pk": b"secret-value"}}
        assert b"secret-value" not in pres.response.serialize()


def test_endorser_answers_429_when_the_sign_lane_is_full(orgs):
    class Busy:
        serialized = b"peer"

        def sign(self, message):
            raise psl.SignBusy(9, 8)

    client = port_signer(orgs, "Org1MSP", "user")
    e = pendorser.Endorser(PMSPManager({"Org1MSP": orgs["Org1MSP"]["msp"]}), Busy(),
                           _state(PMemDB, PBatch, _rows()), _contracts(pcc_mod))
    from fabric_tpu_torch.peer import txassembly as ptxa

    signed, _, _ = ptxa.create_signed_proposal(client, CHANNEL, "kv", [b"put", b"k", b"v"])
    res = e.process_proposal(signed)
    assert pendorser.response_status(res.response) == 429 and not res.response.payload


# ---------------------------------------------------------------------------
# lifecycle, ACL, transient store, coordinator, the commit lock


def test_lifecycle_approve_commit_matches_reference(orgs):
    spec = b'{"policy": {"sig": "%s"}, "package_id": "pkg-%s"}'
    rule_dsl = "OutOf(1, 'Org1MSP.peer', 'Org2MSP.peer')"
    sig_hex = jpolicy_to_proto(jpol.from_dsl(rule_dsl)).SerializeToString().hex().encode()
    assert sig_hex == ppolicy_to_proto(ppol.from_dsl(rule_dsl)).serialize().hex().encode()
    states = {"ref": JMemDB(), "port": PMemDB()}
    steps = [("Org1MSP", b"approve"), ("Org2MSP", b"approve"), ("Org1MSP", b"checkcommitreadiness"),
             ("Org1MSP", b"commit"), ("Org1MSP", b"querydef"), ("Org2MSP", b"commit")]
    for n, (msp_id, fn) in enumerate(steps):
        got = []
        for key, sim_mod, lc, batch_cls in (("ref", jsim, jlc, JBatch), ("port", psim, plc, PBatch)):
            creator = (ref_signer if key == "ref" else port_signer)(orgs, msp_id, "admin").serialized
            rt = (jcc_mod if key == "ref" else pcc_mod).LayeredRuntime(
                (jcc_mod if key == "ref" else pcc_mod).ChaincodeRuntime(),
                {lc.LIFECYCLE_NS: lc.LifecycleContract(org_lister=lambda: ["Org1MSP", "Org2MSP"])})
            sim = sim_mod.TxSimulator(states[key])
            args = ([fn, b"kvcc"] if fn == b"querydef"
                    else [fn, b"kvcc", b"1", spec % (sig_hex, msp_id.encode())])
            resp = rt.execute(sim, lc.LIFECYCLE_NS, args, creator=creator)
            status = resp.status
            rw, _ = sim.done()
            got.append((status, resp.payload, resp.message, rw))
            if status == 200:
                batch = batch_cls()
                for k, v in sim.rwset.ns_rwset(lc.LIFECYCLE_NS).writes.items():
                    batch.put(lc.LIFECYCLE_NS, k, v, (5, n))
                states[key].apply_updates(batch, (5, n))
        assert got[0] == got[1], (msp_id, fn)
    assert got[1][0] == 500 and "next committable is 2" in got[1][2]  # sequence 1 again
    jprov = jlc.LifecyclePolicyProvider(states["ref"])
    pprov = plc.LifecyclePolicyProvider(states["port"])
    jinfo, pinfo = jprov.info("kvcc"), pprov.info("kvcc")
    assert ppolicy_to_proto(pinfo.policy).serialize() == \
        jpolicy_to_proto(jinfo.policy).SerializeToString()
    assert pinfo.plugin == jinfo.plugin == "default"
    assert pprov.info("absent") is None and jprov.info("absent") is None
    assert plc.ChaincodeDefinition(name="kvcc", sequence=1).to_bytes() == \
        jlc.ChaincodeDefinition(name="kvcc", sequence=1).to_bytes()


def test_acl_matches_reference(orgs, genesis):
    jp = jacl.ACLProvider(lambda: genesis["jbundle"])
    pp = pacl.ACLProvider(lambda: genesis["pbundle"])
    msg = b"the proposal bytes"
    for msp_id, who in (("Org1MSP", "user"), ("Org1MSP", "peer"), ("Org2MSP", "user")):
        s = port_signer(orgs, msp_id, who)
        for sig in (s.sign(msg), s.sign(b"other")):
            for res in (jacl.PROPOSE, jacl.DELIVER, jacl.SNAPSHOT, "unmapped/resource"):
                assert pp.check(res, s.serialized, msg, sig) == jp.check(res, s.serialized, msg, sig)
    assert pacl.ACLProvider(lambda: None).check(pacl.PROPOSE, b"", msg, b"") is False


def test_transient_store_and_coordinator_match_reference(tmp_path):
    clear = {("cc", "coll"): {"a": b"1", "b": None}, ("cc", "c2"): {"x": b"9"}}
    for writer, reader in ((ptransient, jtransient), (jtransient, ptransient)):
        path = str(tmp_path / f"{writer.__name__.rsplit('.', 2)[0]}.db")
        w = writer.TransientStore(path)
        w.persist("tx1", clear, 5)
        w.persist("tx2", {("cc", "coll"): {"z": b"0"}}, 9)
        r = reader.TransientStore(path)
        assert r.get("tx1") == w.get("tx1") == clear
        assert r.purge_below(6) == 3 and w.get("tx1") == {}
        assert ptransient.encode_kv({"a": b"1", "b": None}) == jtransient.encode_kv({"a": b"1", "b": None})
        w.close()
        r.close()

    class Tx:
        def __init__(self, idx, txid, rwset):
            self.idx, self.txid, self.rwset = idx, txid, rwset

    def rwsets(rw_mod):
        out = []
        for i, key in enumerate(("a", "b", "q")):
            tx = rw_mod.TxRWSet()
            kh = hashlib.sha256(key.encode()).digest()
            vh = hashlib.sha256(b"1").digest()
            tx.ns_rwset("cc").hashed["coll"] = {"reads": {}, "writes": {kh: (vh, i == 1)}}
            out.append(Tx(i, f"tx{i}", tx))
        return out

    from fabric_tpu.ledger import rwset as jrw
    from fabric_tpu_torch.ledger import rwset as prw

    got = []
    for coord, rw_mod in ((jcoord, jrw), (pcoord, prw)):
        class Store:
            def get(self, txid):
                return {"tx0": {("cc", "coll"): {"a": b"1"}}, "tx1": {("cc", "coll"): {"b": None}},
                        "tx2": {("cc", "coll"): {"q": b"tampered"}}}[txid]

        res = asyncio.run(coord.PvtDataCoordinator(Store()).gather(4, rwsets(rw_mod), bytes([0, 0, 0])))
        got.append((res.updates, res.store_data, res.missing))
    assert got[0] == got[1]
    assert got[1][2] == [(2, "tx2", "cc", "coll")]


def test_commit_lock_readers_overlap_and_a_writer_excludes():
    async def scenario():
        lock = AsyncRWLock()
        events = []

        async def reader(name, hold):
            async with lock.reader():
                events.append(("r+", name))
                await asyncio.sleep(hold)
                events.append(("r-", name))

        async def writer(name, hold):
            async with lock.writer():
                events.append(("w+", name))
                await asyncio.sleep(hold)
                events.append(("w-", name))

        t0 = time.perf_counter()
        await asyncio.gather(reader("a", 0.1), reader("b", 0.1), reader("c", 0.1))
        assert time.perf_counter() - t0 < 0.25  # parallel, not 0.3 serial
        events.clear()
        r1 = asyncio.ensure_future(reader("r1", 0.15))
        await asyncio.sleep(0.02)
        w = asyncio.ensure_future(writer("w", 0.05))
        await asyncio.sleep(0.02)
        r2 = asyncio.ensure_future(reader("r2", 0.01))
        await asyncio.gather(r1, w, r2)
        # r1 finished before w started; r2 queued BEHIND the writer
        assert events.index(("r-", "r1")) < events.index(("w+", "w"))
        assert events.index(("w-", "w")) < events.index(("r+", "r2"))

    asyncio.run(scenario())
