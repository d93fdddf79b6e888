"""The port's BFT consenter (fabric_tpu_torch/ordering/bft.py) held
against the JAX package's on the CPU: the digest and signed bytes of a
message, the WAL and the commit-proof files byte for byte, each
package reading the other's proofs and accepting the other's signed
messages; then the reference's ``tests/test_bft.py`` scenarios on the
port — the normal case, forged messages dropped, a view change after
the leader's crash, a NEW_VIEW refused without its justification, a
byzantine new leader that may neither drop nor substitute a certified
entry, and a chain restarted from its WAL.

Every message is signed and checked with the port's host ``ec_ref``
(about 15 ms a signature and 30 ms a check on this kind of CPU, where
the reference uses OpenSSL), so a four-node block costs about a second
of one core.  The clusters here take a ``view_timeout`` of 4 s, which a
normal block cannot reach (the reference's tests take 0.4-0.8 s).
Identities are the reference cryptogen's, carried into the port
(``carry.from_cryptogen``)."""

import asyncio
import json
import os

import pytest
from test_torch_endorser import carried

from fabric_tpu.crypto import cryptogen as jcryptogen
from fabric_tpu.crypto.msp import MSPManager as JMSPManager
from fabric_tpu.ordering import bft as jbft
from fabric_tpu.ordering import raft as jraft
from fabric_tpu_torch.crypto.msp import MSPManager
from fabric_tpu_torch.ordering import bft as pbft
from fabric_tpu_torch.ordering import raft as praft

VIEW_TIMEOUT = 4.0  # beyond a normal block's ~1 s of ec_ref work


def run(coro, timeout=90):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _wait(cond, timeout=20.0):
    loop = asyncio.get_event_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if cond():
            return True
        await asyncio.sleep(0.02)
    return False


@pytest.fixture(scope="module")
def material():
    """Four orderers of one orderer org: the reference's identities and
    the port's carry, with each package's verifier registry."""
    org = jcryptogen.generate_org("OrdererMSP", "orderer.bft.example.com", peers=0,
                                  orderers=4, users=0, admin=False)
    psigners, msp = carried(org)
    ids = [f"o{i}" for i in range(4)]
    names = [f"orderer{i}.orderer.bft.example.com" for i in range(4)]
    jsigners = {oid: jcryptogen.signing_identity(org, n) for oid, n in zip(ids, names)}
    jmgr, pmgr = JMSPManager({"OrdererMSP": org.msp()}), MSPManager({"OrdererMSP": msp})
    return {
        "ids": ids,
        "ref": (jsigners, {o: jmgr.deserialize_identity(s.serialized) for o, s in jsigners.items()}),
        "port": ({oid: psigners[n] for oid, n in zip(ids, names)},
                 {oid: pmgr.deserialize_identity(psigners[n].serialized)
                  for oid, n in zip(ids, names)}),
    }


def mk_cluster(tmp_path, mod, raft_mod, ids, signers=None, verifiers=None,
               view_timeout=VIEW_TIMEOUT):
    """``len(ids)`` BFTNodes of package ``mod`` on one loop, messages
    delivered by ``call_soon`` through a JSON round trip (a real
    transport's copy); ``down`` drops a node's traffic both ways."""
    nodes, applied, down = {}, {oid: [] for oid in ids}, set()

    def send_cb_for(src):
        def send(dst, msg):
            if dst in down or src in down:
                return
            node = nodes.get(dst)
            if node is not None:
                asyncio.get_event_loop().call_soon(node.handle, json.loads(json.dumps(msg)))
        return send

    for oid in ids:
        nodes[oid] = mod.BFTNode(
            oid, ids, raft_mod.WAL(str(tmp_path / oid)),
            apply_cb=(lambda o: (lambda e: applied[o].append(e)))(oid),
            send_cb=send_cb_for(oid), signer=(signers or {}).get(oid),
            verifiers=verifiers, view_timeout=view_timeout)
    return nodes, applied, down


def _files(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


# ---------------------------------------------------------------------------
# formats


@pytest.mark.parametrize("msg", [
    {"type": "bft_prepare", "from": "o1", "view": 0, "seq": 7, "digest": "ab" * 32},
    {"type": "bft_commit", "from": "o2", "view": 3, "seq": 1, "digest": "00" * 32,
     "sig": "3045", "from_cert": "0a0b"},
    {"type": "bft_view_change", "from": "o0", "new_view": 2, "last_applied": 5,
     "prepared": {"6": {"payload": "ff", "view": 1, "cert": [{"type": "bft_prepare"}]}}},
    {"type": "bft_pre_prepare", "from": "oé", "view": 0, "seq": 1, "payload": ""},
])
def test_digest_and_signable_bytes_equal_reference(msg):
    assert pbft._signable(msg) == jbft._signable(msg)
    payload = json.dumps(msg).encode()
    assert pbft._digest(payload) == jbft._digest(payload)
    assert (pbft.PRE_PREPARE, pbft.PREPARE, pbft.COMMIT, pbft.VIEW_CHANGE, pbft.NEW_VIEW) == (
        jbft.PRE_PREPARE, jbft.PREPARE, jbft.COMMIT, jbft.VIEW_CHANGE, jbft.NEW_VIEW)


def test_wal_and_proof_files_equal_reference(tmp_path):
    """The same batches through an unsigned four-node cluster of each
    package leave the same WAL and proof files, byte for byte, on every
    node; each package's node restarted over the other's files replays
    the same entries and serves the same commit proofs."""
    ids = ["o0", "o1", "o2", "o3"]
    payloads = [b"batch-%d" % i * (i + 1) for i in range(4)]

    async def drive(mod, raft_mod, root):
        nodes, applied, _ = mk_cluster(root, mod, raft_mod, ids)
        for n in nodes.values():
            n.start()
        for p in payloads:
            nodes["o0"].propose(p)
        assert await _wait(lambda: all(len(a) == len(payloads) for a in applied.values()))
        for n in nodes.values():
            n.stop()
            n.wal.close()

    run(drive(jbft, jraft, tmp_path / "ref"))
    run(drive(pbft, praft, tmp_path / "port"))
    for oid in ids:
        ref, port = _files(tmp_path / "ref" / oid), _files(tmp_path / "port" / oid)
        assert sorted(port) == ["proofs/1.json", "proofs/2.json", "proofs/3.json",
                                "proofs/4.json", "wal.bin"]
        assert port == ref
    # each package over the other's files
    for writer, mod, raft_mod in (("ref", pbft, praft), ("port", jbft, jraft)):
        got = []
        node = mod.BFTNode("o1", ids, raft_mod.WAL(str(tmp_path / writer / "o1")),
                           apply_cb=got.append, send_cb=lambda *a: None)

        async def replay(node=node):
            node.start()
            node.stop()

        run(replay())
        assert [(e.term, e.index, e.data) for e in got] == [
            (0, i + 1, p) for i, p in enumerate(payloads)]
        want = json.loads((tmp_path / writer / "o1" / "proofs" / "2.json").read_text())
        assert node.commit_proof(2) == want and len(want) >= 3
        node.wal.close()


def test_each_package_accepts_the_others_signed_messages(material):
    """A PREPARE signed by either package's identity is accepted by the
    other package's node, and the same forgeries (wrong signer, no
    signature, a tampered field) are dropped by both."""
    ids = material["ids"]
    jsigners, jver = material["ref"]
    psigners, pver = material["port"]

    async def scenario():
        out = {}
        for name, mod, ver in (("ref", jbft, jver), ("port", pbft, pver)):
            node = mod.BFTNode("o0", ids, _MemWAL(), apply_cb=lambda e: None,
                               send_cb=lambda *a: None, verifiers=ver)
            node._stopped = False
            verdicts = []
            for signer_pkg, signers in (("ref", jsigners), ("port", psigners)):
                for seq, (claimed, by) in enumerate((("o1", "o1"), ("o1", "o3"), ("o2", None)),
                                                    start=1):
                    msg = {"type": "bft_prepare", "from": claimed, "view": 0, "seq": seq,
                           "digest": "%02x" % seq * 32}
                    if by is not None:
                        msg["sig"] = signers[by].sign(mod._signable(msg)).hex()
                    node.handle(json.loads(json.dumps(msg)))
                    verdicts.append(claimed in node._slot(seq).prepares)
                    node.slots.clear()
                good = {"type": "bft_prepare", "from": "o2", "view": 0, "seq": 9,
                        "digest": "09" * 32}
                good["sig"] = signers["o2"].sign(mod._signable(good)).hex()
                good["seq"] = 10  # tampered after signing
                node.handle(good)
                verdicts.append("o2" in node._slot(10).prepares)
            out[name] = verdicts
        return out

    got = run(scenario())
    assert got["ref"] == got["port"] == [True, False, False, False] * 2


class _MemWAL:
    """The slice of ``raft.WAL`` a BFTNode reads before it applies."""

    snap_index = 0
    entries = ()
    dir = os.devnull


# ---------------------------------------------------------------------------
# the reference's scenarios (tests/test_bft.py) on the port


def test_bft_normal_case_and_order(material, tmp_path):
    async def scenario():
        signers, verifiers = material["port"]
        nodes, applied, _ = mk_cluster(tmp_path, pbft, praft, material["ids"], signers, verifiers)
        for n in nodes.values():
            n.start()
        leader = nodes["o0"]
        assert leader.state == "leader"
        for i in range(3):
            assert leader.propose(b"batch-%d" % i) == i + 1
        assert await _wait(lambda: all(len(applied[o]) == 3 for o in nodes))
        for o, entries in applied.items():
            assert [e.data for e in entries] == [b"batch-%d" % i for i in range(3)]
            assert [e.index for e in entries] == [1, 2, 3]
        # every node's proof: 2f+1 distinct signed COMMITs over the digest
        for n in nodes.values():
            proof = n.commit_proof(2)
            assert len({m["from"] for m in proof}) >= n.quorum == 3
            assert {m["digest"] for m in proof} == {pbft._digest(b"batch-1")}
            assert all(m["from_cert"] == signers[m["from"]].serialized.hex() for m in proof)
        for n in nodes.values():
            n.stop()

    run(scenario())


def test_bft_rejects_forged_messages(material, tmp_path):
    async def scenario():
        signers, verifiers = material["port"]
        nodes, _, _ = mk_cluster(tmp_path, pbft, praft, material["ids"], signers, verifiers)
        n0 = nodes["o0"]
        n0.start()
        # a message claiming to be from o1 but signed by o3 (byzantine)
        forged = {"type": pbft.PREPARE, "from": "o1", "view": 0, "seq": 1, "digest": "00" * 32}
        forged["sig"] = signers["o3"].sign(pbft._signable(forged)).hex()
        n0.handle(forged)
        assert "o1" not in n0._slot(1).prepares
        # unsigned message: dropped too
        n0.handle({"type": pbft.PREPARE, "from": "o2", "view": 0, "seq": 1,
                   "digest": "00" * 32})
        assert "o2" not in n0._slot(1).prepares
        # a message "from" this very node, signed by another: dropped
        fake_self = {"type": pbft.PREPARE, "from": "o0", "view": 0, "seq": 1,
                     "digest": "22" * 32}
        fake_self["sig"] = signers["o1"].sign(pbft._signable(fake_self)).hex()
        n0.handle(fake_self)
        assert "o0" not in n0._slot(1).prepares
        # properly signed message: accepted
        good = {"type": pbft.PREPARE, "from": "o1", "view": 0, "seq": 1, "digest": "11" * 32}
        good["sig"] = signers["o1"].sign(pbft._signable(good)).hex()
        n0.handle(good)
        assert n0._slot(1).prepares.get("o1") == "11" * 32
        # a malformed field from a byzantine sender is dropped, not raised
        bad = {"type": pbft.COMMIT, "from": "o1", "view": "0", "seq": 1, "digest": "11" * 32}
        bad["sig"] = signers["o1"].sign(pbft._signable(bad)).hex()
        n0.handle(bad)
        assert "o1" not in n0._slot(1).commits
        n0.stop()

    run(scenario())


def test_bft_view_change_on_leader_crash(material, tmp_path):
    async def scenario():
        signers, verifiers = material["port"]
        nodes, applied, down = mk_cluster(tmp_path, pbft, praft, material["ids"], signers,
                                          verifiers)
        for n in nodes.values():
            n.start()
        nodes["o0"].propose(b"committed-before-crash")
        assert await _wait(lambda: all(len(applied[o]) == 1 for o in nodes))
        # no view change while the leader is up
        assert all(n.view == 0 for n in nodes.values())

        # leader dies; a client demand at a follower starts the clock
        down.add("o0")
        nodes["o0"].stop()
        for oid in ("o1", "o2", "o3"):
            nodes[oid].note_client_request()
        assert await _wait(lambda: nodes["o1"].view == 1 and nodes["o1"].state == "leader",
                           4 * VIEW_TIMEOUT)
        # the new leader makes progress
        assert nodes["o1"].propose(b"after-view-change") is not None
        assert await _wait(lambda: all(len(applied[o]) == 2 for o in ("o1", "o2", "o3")))
        for o in ("o1", "o2", "o3"):
            assert applied[o][1].data == b"after-view-change"
            assert applied[o][1].term == 1
        for n in nodes.values():
            n.stop()

    run(scenario())


def test_bft_chain_restart_recovers_blocks(tmp_path):
    """An OrderingChain on the BFT consenter restarted mid-stream must
    not lose or duplicate blocks: the WAL replay re-fires apply_cb and
    the chain skips batches already materialized."""
    from fabric_tpu_torch.ordering.blockcutter import BatchConfig
    from fabric_tpu_torch.ordering.chain import OrderingChain

    async def scenario():
        def mk():
            return OrderingChain("bftrestart", "solo", ["solo"], data_dir=str(tmp_path / "chain"),
                                 send_cb=lambda *a: None,
                                 config=BatchConfig(max_message_count=1, batch_timeout_s=0.05),
                                 consensus="bft")

        chain = mk()
        chain.start()
        for i in range(3):
            res = await chain.broadcast(b"env-%d" % i)
            assert res["status"] == 200, res
        assert chain.height == 3
        before = [chain.blocks.get_block(k).serialize() for k in range(3)]
        meta = json.loads(bytes(chain.blocks.get_block(2).metadata.metadata[3]))
        assert meta["index"] == 3 and len(meta["bft_proof"]) == 1
        chain.stop()

        chain2 = mk()
        chain2.start()
        assert chain2.height == 3
        assert [chain2.blocks.get_block(k).serialize() for k in range(3)] == before
        res = await chain2.broadcast(b"env-3")
        assert res["status"] == 200
        assert chain2.height == 4
        assert chain2.blocks.get_block(3).data.data[0] == b"env-3"
        chain2.stop()

    run(scenario())


def test_bft_new_view_requires_justification(material, tmp_path):
    """A NEW_VIEW without a 2f+1 signed VIEW-CHANGE justification must
    not install a view."""
    async def scenario():
        signers, verifiers = material["port"]
        nodes, _, down = mk_cluster(tmp_path, pbft, praft, material["ids"], signers, verifiers)
        for n in nodes.values():
            n.start()
        try:
            o0, o1 = nodes["o0"], nodes["o1"]
            forged = o1._sign({"type": "bft_new_view", "from": "o1", "view": 1, "vcs": {}})
            o0.handle(json.loads(json.dumps(forged)))
            await asyncio.sleep(0.1)
            assert o0.view == 0  # refused
            down.add("o1")
            for oid in ("o0", "o2", "o3"):
                nodes[oid].request_view_change()
            assert await _wait(lambda: len(o0.view_changes.get(1, {})) >= 3)
            vcs = {k: json.loads(json.dumps(v)) for k, v in o0.view_changes[1].items()}
            nv = o1._sign({"type": "bft_new_view", "from": "o1", "view": 1, "vcs": vcs})
            o0.handle(json.loads(json.dumps(nv)))
            await asyncio.sleep(0.05)
            assert o0.view == 1  # installed with proof
        finally:
            for n in nodes.values():
                n.stop()

    run(scenario())


def test_bft_byzantine_new_leader_cannot_drop_or_substitute(material, tmp_path):
    """A justified new leader must still re-propose the certified
    prepared entries verbatim."""
    async def scenario():
        signers, verifiers = material["port"]
        nodes, applied, down = mk_cluster(tmp_path, pbft, praft, material["ids"], signers,
                                          verifiers)
        suppress = {"on": True}
        for node in nodes.values():
            def wrap(orig):
                def send(dst, msg):
                    if suppress["on"] and msg.get("type") == "bft_commit":
                        return
                    orig(dst, msg)
                return send
            node.send_cb = wrap(node.send_cb)
        for n in nodes.values():
            n.start()
        try:
            o0, o1 = nodes["o0"], nodes["o1"]
            payload_a = b"batch-A"
            o0.propose(payload_a)
            assert await _wait(lambda: all(
                nodes[o].slots.get(1) is not None and len(nodes[o].slots[1].prepares) >= 3
                for o in ("o0", "o2", "o3")))
            assert all(nodes[o].last_applied == 0 for o in nodes)
            down.add("o1")
            for oid in ("o0", "o2", "o3"):
                nodes[oid].request_view_change()
            assert await _wait(lambda: len(o0.view_changes.get(1, {})) >= 3)
            vcs = {k: json.loads(json.dumps(v)) for k, v in o0.view_changes[1].items()}
            nv = o1._sign({"type": "bft_new_view", "from": "o1", "view": 1, "vcs": vcs})
            for oid in ("o0", "o2", "o3"):
                nodes[oid].handle(json.loads(json.dumps(nv)))
            await asyncio.sleep(0.05)
            assert o0.view == 1 and o0._expected_repro
            for evil in (b"batch-EVIL", b"batch-C"):  # substitute, then drop
                sub = o1._sign({"type": "bft_pre_prepare", "from": "o1", "view": 1, "seq": 1,
                                "payload": evil.hex()})
                for oid in ("o0", "o2", "o3"):
                    nodes[oid].handle(json.loads(json.dumps(sub)))
                await asyncio.sleep(0.05)
                for oid in ("o0", "o2", "o3"):
                    s = nodes[oid].slots.get(1)
                    assert s is None or s.payload is None
                    assert nodes[oid]._expected_repro
            suppress["on"] = False
            ok = o1._sign({"type": "bft_pre_prepare", "from": "o1", "view": 1, "seq": 1,
                           "payload": payload_a.hex()})
            for oid in ("o0", "o2", "o3"):
                nodes[oid].handle(json.loads(json.dumps(ok)))
            assert await _wait(lambda: all(nodes[o].last_applied == 1
                                           for o in ("o0", "o2", "o3")))
            for o in ("o0", "o2", "o3"):
                assert applied[o][0].data == payload_a
        finally:
            for n in nodes.values():
                n.stop()

    run(scenario())
