"""The port's protobuf wire codec and read/write-set wire form against
``google.protobuf`` (upb) on the CPU, and the port's front end plus
validation against the JAX ``BlockValidator`` on a seeded mutation
corpus.

* Every message type the reference's builder emits: the port decodes
  the ``SerializeToString()`` bytes to the same fields and encodes them
  back to the same bytes; the port's ``TxRWSet.to_bytes`` is the
  reference's ``to_proto().SerializeToString()``.
* A seeded fuzz of mutated encodings (bit flips, truncations, splices,
  random chunks, inserted groups and bad tags): the port accepts exactly
  what upb accepts, with the same fields, and re-encodes what upb
  re-encodes (``deterministic=True``).
* The merge of a repeated singular sub-message (two ``action``
  occurrences concatenate their endorsements), with the construction of
  ``tests/test_native_fuzz.py::test_duplicate_action_submessage_agrees``.
* 500 blocks of 4 envelopes (a valid pair, a stale read and one
  endorsement short of the policy), 1-2 of them mutated with
  ``tests/test_native_fuzz.py::_mutate``: the port's ``decode_block``
  and validation give the reference's TRANSACTIONS_FILTER, update batch
  and history for every block.  Each package's signature verdicts come
  from its own verifier, run once over the corpus's distinct signatures
  (the reference's jax verify has a large fixed cost per call on the
  CPU, whatever the batch).

Exact equality throughout."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from google.protobuf.message import DecodeError as PbDecodeError
from test_native_fuzz import _mutate

from fabric_tpu import protoutil as pu
from fabric_tpu.crypto import cryptogen
from fabric_tpu.crypto import policy as jpol
from fabric_tpu.crypto.msp import MSPManager as JMSPManager
from fabric_tpu.ledger.rwset import TxRWSet as JTxRWSet
from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.ledger.statedb import UpdateBatch as JUpdateBatch
from fabric_tpu.ops import p256v3 as jp256v3
from fabric_tpu.peer import validator as jvalidator
from fabric_tpu.peer import txassembly as txa
from fabric_tpu.peer.validator import BlockValidator as JBlockValidator
from fabric_tpu.peer.validator import NamespaceInfo as JNamespaceInfo
from fabric_tpu.peer.validator import PolicyProvider as JPolicyProvider
from fabric_tpu.protos import common_pb2, proposal_pb2, rwset_pb2, transaction_pb2
from fabric_tpu_torch import carry
from fabric_tpu_torch.crypto import msp as pmsp
from fabric_tpu_torch.ledger.rwset import TxRWSet
from fabric_tpu_torch.ops import p256v3
from fabric_tpu_torch.peer import validator as pv
from fabric_tpu_torch.protos import messages as M
from fabric_tpu_torch.protos import wire

CHANNEL, CC = "wirechan", "wirecc"
POLICY = "OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer')"
CORPUS_BLOCKS = 500
CORPUS_TXS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same(port, pb) -> bool:
    """The port's message holds the protobuf message's fields."""
    for f in port.FIELDS:
        v, w = getattr(port, f.name), getattr(pb, f.name)
        if f.kind == wire.MAP:
            if dict(w) != v:
                return False
        elif f.kind == wire.MESSAGE and f.repeated:
            if len(v) != len(w) or not all(same(a, b) for a, b in zip(v, w)):
                return False
        elif f.kind == wire.MESSAGE:
            if (v is not None) != pb.HasField(f.name) or (v is not None and not same(v, w)):
                return False
        elif (list(w) if f.repeated else w) != v:
            return False
    return True


@pytest.fixture(scope="module")
def net():
    org1 = cryptogen.generate_org("Org1MSP", "org1.wire.example.com", peers=1, users=1)
    org2 = cryptogen.generate_org("Org2MSP", "org2.wire.example.com", peers=1)
    orgs = [org1, org2]
    client = cryptogen.signing_identity(org1, "User1@org1.wire.example.com")
    peers = [cryptogen.signing_identity(org1, "peer0.org1.wire.example.com"),
             cryptogen.signing_identity(org2, "peer0.org2.wire.example.com")]
    return {
        "mgr": JMSPManager({o.msp_id: o.msp() for o in orgs}),
        "pmgr": pmsp.MSPManager({o.msp_id: pmsp.MSP(o.msp_id, [o.ca.cert_pem])
                                 for o in orgs}),
        "client": client, "peers": peers,
    }


def _rich_rwset() -> JTxRWSet:
    tx = JTxRWSet()
    n = tx.ns_rwset(CC)
    n.reads.update({"a": (1, 2), "b": None, "ü": (0, 0)})
    n.writes.update({"w": b"v", "gone": None, "empty": b""})
    n.range_queries.append(("k0", "k9", [("k1", (3, 4)), ("k2", None)]))
    n.range_queries.append(("z", "", []))
    n.metadata_writes["m"] = {"VALIDATION_PARAMETER": b"p", "x": b""}
    n.hashed["coll"] = {"reads": {b"\x01h": (5, 6), b"\x02": None},
                        "writes": {b"\x03": (b"vh", False), b"\x04": (b"", True)},
                        "pvt_hash": b"ph"}
    tx.ns_rwset("other").writes["k"] = b"x"
    return tx


def _reference_messages(net):
    """(port class, pb2 message) for every message the reference's
    builder emits, nested ones included."""
    rw = _rich_rwset().to_proto()
    signed, _, prop = txa.create_signed_proposal(net["client"], CHANNEL, CC,
                                                 [b"invoke", b"", b"x" * 300],
                                                 transient={"secret": b"s"})
    resp = txa.create_proposal_response(prop, rw.SerializeToString(), net["peers"][0], CC,
                                        response_payload=b"rp", events=b"ev")
    env = txa.assemble_transaction(prop, [resp, txa.create_proposal_response(
        prop, rw.SerializeToString(), net["peers"][1], CC, response_payload=b"rp",
        events=b"ev")], net["client"])
    payload = pu.unmarshal(common_pb2.Payload, env.payload)
    hdr = payload.header
    ch = pu.unmarshal(common_pb2.ChannelHeader, hdr.channel_header)
    sh = pu.unmarshal(common_pb2.SignatureHeader, hdr.signature_header)
    tx = pu.unmarshal(transaction_pb2.Transaction, payload.data)
    cap = pu.unmarshal(transaction_pb2.ChaincodeActionPayload, tx.actions[0].payload)
    prp = pu.unmarshal(proposal_pb2.ProposalResponsePayload,
                       cap.action.proposal_response_payload)
    cca = pu.unmarshal(proposal_pb2.ChaincodeAction, prp.extension)
    cpp = pu.unmarshal(proposal_pb2.ChaincodeProposalPayload, prop.payload)
    spec = pu.unmarshal(proposal_pb2.ChaincodeInvocationSpec, cpp.input)
    ns = next(n for n in rw.ns_rwset if n.namespace == CC)
    kv = pu.unmarshal(rwset_pb2.KVRWSet, ns.rwset)
    hashed = pu.unmarshal(rwset_pb2.HashedRWSet, ns.collection_hashed_rwset[0].hashed_rwset)
    blk = pu.new_block(7, b"prev")
    blk.data.data.append(env.SerializeToString())
    blk = pu.finalize_block(blk)
    pu.set_tx_filter(blk, b"\x00")
    return [
        (M.SignedProposal, signed), (M.Proposal, prop), (M.Header, hdr),
        (M.ChannelHeader, ch), (M.SignatureHeader, sh),
        (M.SerializedIdentity, pu.unmarshal(common_pb2.SerializedIdentity, sh.creator)),
        (M.ChaincodeHeaderExtension,
         pu.unmarshal(proposal_pb2.ChaincodeHeaderExtension, ch.extension)),
        (M.ChaincodeProposalPayload, cpp), (M.ChaincodeInvocationSpec, spec),
        (M.ProposalResponse, resp), (M.ProposalResponsePayload, prp),
        (M.ChaincodeAction, cca), (M.Envelope, env), (M.Payload, payload),
        (M.Transaction, tx), (M.ChaincodeActionPayload, cap), (M.Block, blk),
        (M.TxReadWriteSet, rw), (M.KVRWSet, kv), (M.HashedRWSet, hashed),
        (M.Timestamp, ch.timestamp), (M.Endorsement, cap.action.endorsements[0]),
    ]


def test_reference_messages_decode_and_encode_identically(net):
    for cls, pb in _reference_messages(net):
        raw = pb.SerializeToString()
        got = cls.parse(raw)
        assert same(got, pb), cls.__name__
        assert got.serialize() == raw, cls.__name__


def test_rwset_wire_form_matches_reference():
    ref = _rich_rwset()
    raw = ref.to_proto().SerializeToString()
    port = TxRWSet.from_bytes(raw)
    assert port.to_bytes() == raw
    back = JTxRWSet.from_bytes(port.to_bytes())
    for name, n in ref.ns.items():
        m = port.ns[name]
        assert (m.reads, m.writes, m.range_queries, m.metadata_writes, m.hashed) == (
            n.reads, n.writes, n.range_queries, n.metadata_writes, n.hashed)
        assert back.ns[name].range_queries == n.range_queries
    assert sorted(port.ns) == sorted(ref.ns)
    with pytest.raises(wire.DecodeError):
        TxRWSet.from_bytes(b"\x12\x03\x0a\x01\xff")  # namespace of invalid UTF-8


def _fuzz_mutation(rng: random.Random, raw: bytes) -> bytes:
    b = bytearray(raw)
    op = rng.randrange(7)
    if not b or op == 6:  # an inserted field: a group, a stray end-group, a bad tag
        k = rng.randrange(len(b) + 1)
        ins = rng.choice([b"\x0b\x08\x01\x0c", b"\x0b\x08\x01\x14", b"\x0c", b"\x0b",
                          b"\x00\x01", b"\x0e\x00", b"\x80\x80\x80\x80\x80\x01\x00",
                          b"\xfa\xff\xff\xff\x0f\x00", b"\x13\x1b\x1c\x14",
                          b"\x2d\x01\x02\x03\x04", b"\x29" + bytes(8)])
        return bytes(b[:k] + ins + b[k:])
    if op == 0:
        for _ in range(rng.randrange(1, 4)):
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
    elif op == 1:
        b = b[:rng.randrange(len(b))]
    elif op == 2:
        i, j = sorted(rng.randrange(len(b)) for _ in range(2))
        k = rng.randrange(len(b))
        b = b[:k] + b[i:j] + b[k:]
    elif op == 3:
        k = rng.randrange(len(b))
        b[k:k + 4] = bytes(rng.getrandbits(8) for _ in range(4))
    elif op == 4:
        b += bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 6)))
    else:
        b = b + b
    return bytes(b)


@pytest.mark.parametrize("index", range(22))
def test_codec_accepts_what_upb_accepts(net, index):
    cls, pb = _reference_messages(net)[index]
    raw = pb.SerializeToString()
    rng = random.Random(1000 + index)
    parsed = 0
    for _ in range(400):
        data = _fuzz_mutation(rng, raw)
        if rng.random() < 0.3:
            data = _fuzz_mutation(rng, data)
        try:
            ref = type(pb)()
            ref.ParseFromString(data)
        except PbDecodeError:
            ref = None
        try:
            got = cls.parse(data)
        except wire.DecodeError:
            got = None
        assert (ref is None) == (got is None), (cls.__name__, data.hex())
        if ref is not None:
            parsed += 1
            assert same(got, ref), (cls.__name__, data.hex())
            assert got.serialize() == ref.SerializeToString(deterministic=True), data.hex()
    assert parsed > 0


def test_duplicate_action_submessage_merges(net, jverify):
    """Two ``action`` occurrences: upb merges them, so the endorsements
    concatenate; the port's codec does the same, and the block validates
    as in the reference."""
    _, _, prop = txa.create_signed_proposal(net["client"], CHANNEL, CC, [b"i"])
    tx = JTxRWSet()
    tx.ns_rwset(CC).writes["k"] = b"v"
    rw = tx.to_proto().SerializeToString()
    env = txa.assemble_transaction(
        prop, [txa.create_proposal_response(prop, rw, p, CC) for p in net["peers"]],
        net["client"])
    payload = pu.unmarshal(common_pb2.Payload, env.payload)
    t = pu.unmarshal(transaction_pb2.Transaction, payload.data)
    cap = pu.unmarshal(transaction_pb2.ChaincodeActionPayload, t.actions[0].payload)
    cea1 = transaction_pb2.ChaincodeEndorsedAction()
    cea1.endorsements.add().CopyFrom(cap.action.endorsements[0])
    cea2 = transaction_pb2.ChaincodeEndorsedAction()
    cea2.proposal_response_payload = cap.action.proposal_response_payload
    cea2.endorsements.add().CopyFrom(cap.action.endorsements[1])
    b1, b2 = cea1.SerializeToString(), cea2.SerializeToString()
    v = wire.varint
    wire_bytes = (b"\x0a" + v(len(cap.chaincode_proposal_payload))
                  + cap.chaincode_proposal_payload
                  + b"\x12" + v(len(b1)) + b1 + b"\x12" + v(len(b2)) + b2)
    merged = transaction_pb2.ChaincodeActionPayload()
    merged.ParseFromString(wire_bytes)
    port = M.ChaincodeActionPayload.parse(wire_bytes)
    assert len(port.action.endorsements) == 2 and same(port, merged)
    assert port.serialize() == merged.SerializeToString()
    t.actions[0].payload = wire_bytes
    payload.data = t.SerializeToString()
    env2 = pu.sign_envelope(payload, net["client"])
    blk = pu.finalize_block(_block([env2.SerializeToString()], 2))
    jflt, _, _ = JBlockValidator(net["mgr"], _jprov(), _jstate()).validate(blk)
    v = pv.BlockValidator(_prov(), _state(), device="cpu", msp=net["pmgr"])
    flt, _, _ = v.validate(M.Block.parse(blk.SerializeToString()))
    assert bytes(flt) == bytes(jflt) == b"\x00"


# ---------------------------------------------------------------------------
# The mutation corpus


def _block(envs, num):
    blk = pu.new_block(num, b"prev")
    for e in envs:
        blk.data.data.append(e)
    return blk


def _seed_rows():
    return [(CC, f"seed{i}", b"v", (1, i)) for i in range(CORPUS_TXS)]


def _jstate():
    db = JMemDB()
    b = JUpdateBatch()
    for ns, key, val, ver in _seed_rows():
        b.put(ns, key, val, ver)
    db.apply_updates(b, (1, 0))
    return db


def _jprov():
    return JPolicyProvider({CC: JNamespaceInfo(policy=jpol.from_dsl(POLICY))})


def _state():
    return carry.from_reference(_seed_rows(), {CC: POLICY}, [])[0]


def _prov():
    return carry.from_reference([], {CC: POLICY}, [])[1]


def _rows(batch):
    return sorted((k, vv.value, vv.version) for k, vv in batch.updates.items())


class _CachedVerify:
    """A verify launch whose verdicts come from batched runs of the
    package's own verifier over the distinct signatures it has not seen:
    the port's plain ``p256v3.verify_launch``, or the reference's
    ``fabric_tpu.ops.p256v3.verify_launch`` (``jax=True``), whose handle
    carries a jax array, as the reference's stage 2 consumes it.  The
    reference's runs are ``JAX_CHUNK`` lanes each (the last padded with
    a repeat), so jax traces its verify program for one shape only."""

    JAX_CHUNK = 64

    def __init__(self, jax: bool = False):
        self.bits = {}
        self.jax = jax
        self.real = jp256v3.verify_launch if jax else p256v3.verify_launch

    def fill(self, items):
        todo = list(dict.fromkeys(it for it in items if it not in self.bits))
        if todo and not self.jax:
            self.bits.update(zip(todo, self.real(todo, device="cpu").fetch()))
        for k in range(0, len(todo) if self.jax else 0, self.JAX_CHUNK):
            part = todo[k:k + self.JAX_CHUNK]
            got = self.real(part + [part[0]] * (self.JAX_CHUNK - len(part))).fetch()
            self.bits.update(zip(part, got))

    def __call__(self, items, device="cuda", **_):
        items = items.tuples() if hasattr(items, "tuples") else list(items)
        self.fill(items)
        n = len(items)
        bits = [self.bits[it] for it in items]
        if self.jax:
            bits += [False] * (jp256v3._bucket(n) - n if n else 0)
            return jp256v3.VerifyHandle(jnp.asarray(np.asarray(bits, bool)), n)
        bits += [False] * (p256v3._bucket(n) - n if n else 0)
        return p256v3.VerifyHandle(torch.tensor(bits, dtype=torch.bool), n)


@pytest.fixture(scope="module")
def jverify():
    """The reference validator's verify launch, cached for the module."""
    cache = _CachedVerify(jax=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvalidator.p256, "verify_launch", cache)
        yield cache


def test_mutation_corpus_matches_reference(net, jverify, monkeypatch):
    base = []
    for i in range(CORPUS_TXS):
        _, _, prop = txa.create_signed_proposal(net["client"], CHANNEL, CC, [b"i", b"%d" % i])
        tx = JTxRWSet()
        n = tx.ns_rwset(CC)
        n.reads[f"seed{i}"] = (9, 9) if i == 2 else (1, i)  # tx 2: a stale read
        n.writes[f"w{i}"] = b"value-%d" % i
        rw = tx.to_proto().SerializeToString()
        endorsers = net["peers"][:1] if i == 3 else net["peers"]  # tx 3: one org short
        resps = [txa.create_proposal_response(prop, rw, p, CC) for p in endorsers]
        base.append(txa.assemble_transaction(prop, resps, net["client"]).SerializeToString())
    rng = random.Random(0xF00D)
    blocks = []
    for it in range(CORPUS_BLOCKS):
        envs = list(base)
        for _ in range(rng.randrange(1, 3)):
            i = rng.randrange(len(envs))
            envs[i] = _mutate(rng, envs[i])
        blocks.append(pu.finalize_block(_block(envs, 2 + it)))

    jv = JBlockValidator(net["mgr"], _jprov(), _jstate())
    jitems = []
    for b in blocks:
        jitems += jv._parse(b)[1].tuples()
    jverify.fill(jitems)
    want = [jv.validate(b) for b in blocks]

    cache = _CachedVerify()
    monkeypatch.setattr(p256v3, "verify_launch", cache)  # the facade's v3 launch
    v = pv.BlockValidator(_prov(), _state(), device="cpu", msp=net["pmgr"])
    wire_blocks = [M.Block.parse(b.SerializeToString()) for b in blocks]
    items = []
    for wb in wire_blocks:
        items += v._parse(v.decode(wb))[1]
    cache.fill(items)
    codes = set()
    for wb, (jflt, jbatch, jhist) in zip(wire_blocks, want):
        flt, batch, hist = v.validate(wb)
        assert bytes(flt) == bytes(jflt), wb.header.number
        assert _rows(batch) == _rows(jbatch) and hist == jhist, wb.header.number
        codes.update(flt)
    assert {0, 1, 2, 4, 8, 10, 11} <= codes, sorted(codes)
