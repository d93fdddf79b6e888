"""The port's front end (``peer/frontend.py``) and its wire-block entry
on the CPU, against the reference.

* ``decode_block`` over wire blocks equals the reference's own parser
  as ``tests/test_torch_slice.py``'s ``_decode`` helper carries it into
  the port's ``DecodedBlock`` form, on that file's randomized
  adversarial blocks.
* Those blocks, as wire ``Block``s through the port's ``BlockValidator``
  (``msp=``) and ``CommitPipeline`` at depths 1-3, give the JAX
  ``BlockValidator``'s TRANSACTIONS_FILTER, update batch and history.
  Each package's verify runs once per distinct signature in the module
  (``test_torch_wire._CachedVerify``).
* Blocks the port builds (its cryptogen, ``build_envelopes``) parse with
  ``common_pb2``, round-trip byte for byte, and get the codes they were
  built to get from both validators: bad creator signature, stale read,
  nil envelope, truncated payload, unbound and duplicate tx ids, an
  expired creator, a creator from an unknown CA, an endorser outside the
  policy orgs.
* Endorsements deduplicate by their serialized bytes, as the
  reference's do: one identity under two encodings counts twice.

Exact equality throughout."""

import random
import types

import numpy as np
import pytest
import torch
from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec, rsa
from cryptography.x509.oid import NameOID
from test_torch_wire import _CachedVerify
from test_torch_slice import (  # noqa: F401 — net is a fixture
    POLICIES,
    _blocks,
    _decode,
    _rand_tx,
    _reference,
    _rows,
    _seed_batch,
    _Store,
    net,
)

from fabric_tpu import protoutil as pu
from fabric_tpu.crypto import policy as jpol
from fabric_tpu.crypto import idemix as jidx
from fabric_tpu.crypto.msp import MSP as JMSP
from fabric_tpu.crypto.msp import MSPManager as JMSPManager
from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.ledger.statedb import UpdateBatch as JUpdateBatch
from fabric_tpu.peer import validator as jvalidator
from fabric_tpu.peer.validator import BlockValidator as JBlockValidator
from fabric_tpu.peer.validator import NamespaceInfo as JNamespaceInfo
from fabric_tpu.peer.validator import PolicyProvider as JPolicyProvider
from fabric_tpu.protos import common_pb2, transaction_pb2
from fabric_tpu_torch import carry
from fabric_tpu_torch import protoutil as ppu
from fabric_tpu_torch.crypto import cryptogen as pcryptogen
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.crypto import idemix as pidx
from fabric_tpu_torch.crypto import msp as pmsp
from fabric_tpu_torch.ledger.rwset import TxRWSet
from fabric_tpu_torch.ops import p256, p256v3
from fabric_tpu_torch.peer import frontend
from fabric_tpu_torch.peer import txassembly as ptxa
from fabric_tpu_torch.peer import validator as pv
from fabric_tpu_torch.peer.pipeline import CommitPipeline
from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
from fabric_tpu_torch.protos import messages as M

N_BLOCKS = 8
SEED = 20261017


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jverify():
    """The reference validators verify through one cached, fixed-shape
    run of their own kernel (one jax trace for the module)."""
    with pytest.MonkeyPatch.context() as mp:
        cache = _CachedVerify(jax=True)
        mp.setattr(jvalidator.p256, "verify_launch", cache)
        yield cache


def _port_msp(jmgr) -> pmsp.MSPManager:
    """The port's MSPs over the reference MSPs' root certificates."""
    return pmsp.MSPManager({
        mid: pmsp.MSP(mid, [c.public_bytes(serialization.Encoding.PEM) for c in m.roots])
        for mid, m in jmgr.msps.items()})


@pytest.fixture(scope="module")
def stream(net, _jverify):
    blocks = _blocks(net, seed=SEED, n_blocks=N_BLOCKS)
    parser = JBlockValidator(net["mgr"], net["prov"], JMemDB())
    _jverify.fill([it for b in blocks for it in parser._parse(b)[1].tuples()])
    want = _reference(net, blocks)
    seed = JMemDB()
    seed.apply_updates(_seed_batch(), (1, 0))
    rows = [(ns, key, vv.value, vv.version) for (ns, key), vv in seed.iter_all()]
    return blocks, want, rows, _port_msp(net["mgr"])


def _wire(blk) -> M.Block:
    return M.Block.parse(blk.SerializeToString())


def test_decode_block_matches_reference_parser(net, stream):
    blocks, _, _, pmgr = stream
    parser = JBlockValidator(net["mgr"], net["prov"], JMemDB())
    kinds = set()
    for blk in blocks:
        want = _decode(blk, parser, net["mgr"], {})
        got = frontend.decode_block(_wire(blk), pmgr)
        assert got.number == want.number
        for g, w in zip(got.txs, want.txs, strict=True):
            assert g == w
            kinds.add(g.code)
    assert {int(C.NOT_VALIDATED), int(C.NIL_ENVELOPE), int(C.BAD_PAYLOAD)} <= kinds


@pytest.fixture(scope="module")
def pverify():
    """The port's plain verify, run once per distinct signature across
    the pipeline depths."""
    return _CachedVerify()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_wire_blocks_through_pipeline_match_reference(stream, pverify, monkeypatch, depth):
    monkeypatch.setattr(p256v3, "verify_launch", pverify)  # the facade's v3 launch
    blocks, want, rows, pmgr = stream
    state, prov, _ = carry.from_reference(rows, POLICIES, [])
    store = _Store()

    def commit(res):
        state.apply_updates(res.batch)
        store.txids.update(t for t, _ in res.txids)

    v = pv.BlockValidator(prov, state, block_store=store, device="cpu", msp=pmgr)
    got = []
    with CommitPipeline(v, commit, depth=depth) as pipe:
        for blk in blocks:
            res = pipe.submit(_wire(blk))
            if res is not None:
                got.append(res)
        res = pipe.flush()
        if res is not None:
            got.append(res)
    assert len(got) == len(blocks)
    for res, (flt, batch_rows, hist) in zip(got, want):
        assert res.tx_filter == flt, res.block.number
        assert _rows(res.batch) == batch_rows, res.block.number
        assert res.history == hist, res.block.number


def _run(v, blocks) -> list:
    """``blocks`` through ``CommitPipeline(depth=2)`` over ``v``."""
    store, got = _Store(), []
    v.blocks = store

    def commit(res):
        v.state.apply_updates(res.batch)
        store.txids.update(t for t, _ in res.txids)

    with CommitPipeline(v, commit, depth=2) as pipe:
        for blk in blocks:
            res = pipe.submit(blk)
            if res is not None:
                got.append(res)
        res = pipe.flush()
        if res is not None:
            got.append(res)
    return got


def _both_entries(blocks, rows, pmgr, kernel="v3"):
    """(wire entry results, DecodedBlock entry results) of ``blocks``."""
    def validator():
        state, prov, _ = carry.from_reference(rows, POLICIES, [])
        return pv.BlockValidator(prov, state, device="cpu", msp=pmgr, kernel=kernel)

    return (_run(validator(), [_wire(b) for b in blocks]),
            _run(validator(), [frontend.decode_block(_wire(b), pmgr) for b in blocks]))


def _agree(wire, decoded, want):
    for a, b, (flt, batch_rows, hist) in zip(wire, decoded, want, strict=True):
        assert a.tx_filter == b.tx_filter == flt, a.block.number
        assert _rows(a.batch) == _rows(b.batch) == batch_rows, a.block.number
        assert a.history == b.history == hist, a.block.number


@pytest.mark.parametrize("kernel", ["v3", "v1"])
def test_wire_entry_matches_decoded_entry(net, stream, pverify, monkeypatch, kernel):
    """The columnar wire entry and the ``DecodedBlock`` entry over the
    same blocks give the reference's filter, update batch and history
    under the same kernel: v3 (stage 2 and its consumption-unsafe host
    redo) and v1 (the host path, where a ledger duplicate is found before
    an unknown namespace, validator.py:1798).  Range queries take status
    1 (their sets parsed in Python); the host path reads the other sets
    parsed at first use."""
    monkeypatch.setattr(p256, "verify_launch", pverify)
    host = []
    orig = pv.BlockValidator._validate_host
    monkeypatch.setattr(pv.BlockValidator, "_validate_host",
                        lambda self, p: host.append(p) or orig(self, p))
    blocks, want, rows, pmgr = stream
    if kernel != "v3":
        monkeypatch.setattr(jvalidator.p256, "_KERNEL", kernel)
        want = _reference(net, blocks)
    wire, decoded = _both_entries(blocks, rows, pmgr, kernel)
    _agree(wire, decoded, want)
    assert sum(r.pend.block.n_rwset_parsed for r in wire) > 0
    wire_host = [p for p in host if isinstance(p.block, pv.WireBlock)]
    assert wire_host and len(wire_host) == (len(blocks) if kernel == "v1" else len(wire_host))
    lazy = [ptx for p in wire_host for ptx in p.txs
            if ptx.rwset_bytes is not None and ptx._rwset is not None]
    assert lazy


def _odd_endorsement(raw: bytes, client) -> bytes:
    """The envelope with one more endorsement whose signature is not DER,
    re-signed by its creator: the C walk leaves it to the front end,
    which drops that endorsement."""
    env = common_pb2.Envelope.FromString(raw)
    payload = common_pb2.Payload.FromString(env.payload)
    tx = transaction_pb2.Transaction.FromString(payload.data)
    cap = transaction_pb2.ChaincodeActionPayload.FromString(tx.actions[0].payload)
    end = cap.action.endorsements.add()
    end.endorser, end.signature = cap.action.endorsements[0].endorser, b"\x30\x00"
    tx.actions[0].payload = cap.SerializeToString()
    payload.data = tx.SerializeToString()
    env.payload = payload.SerializeToString()
    env.signature = client.sign(env.payload)
    return env.SerializeToString()


def test_block_of_front_end_envelopes(net, stream, pverify, monkeypatch):
    """A block none of whose envelopes the C walk carries (``ok == 0``):
    transactions with an odd endorsement, one repeated, a nil envelope and
    garbage bytes.  Every one takes the front end, in block order, and
    the wire entry, the ``DecodedBlock`` entry and the reference agree."""
    import random

    monkeypatch.setattr(p256, "verify_launch", pverify)
    _, _, rows, pmgr = stream
    rng = random.Random(41)
    envs = [_odd_endorsement(_rand_tx(net, rng, ranges=False), net["client"])
            for _ in range(8)]
    envs += [envs[2], b"", b"\x13garbage-bytes"]
    blk = pu.new_block(2, b"prev")
    for e in envs:
        blk.data.data.append(e)
    blk = pu.finalize_block(blk)
    wire, decoded = _both_entries([blk], rows, pmgr)
    _agree(wire, decoded, _reference(net, [blk]))
    assert wire[0].pend.block.n_front_end == len(envs)
    assert {C.VALID, C.DUPLICATE_TXID, C.NIL_ENVELOPE, C.BAD_PAYLOAD} <= set(wire[0].tx_filter)


def test_reference_block_bytes_round_trip(stream):
    for blk in stream[0]:
        raw = blk.SerializeToString()
        port = M.Block.parse(raw)
        assert port.serialize() == raw
        assert port.data.data == list(blk.data.data)
        assert ppu.block_header_hash(port.header) == pu.block_header_hash(blk.header)
        assert ppu.block_data_hash(port.data) == pu.block_data_hash(blk.data)


# ---------------------------------------------------------------------------
# Blocks the port builds

CC = "portcc"
POLICY = "OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')"
KINDS = ("valid", "bad_creator_sig", "stale_read", "nil_envelope", "truncated_payload",
         "unbound_txid", "duplicate_txid", "expired_creator", "unknown_ca_creator",
         "outside_endorser")
WANT = {"valid": C.VALID, "bad_creator_sig": C.BAD_CREATOR_SIGNATURE,
        "stale_read": C.MVCC_READ_CONFLICT, "nil_envelope": C.NIL_ENVELOPE,
        "truncated_payload": C.BAD_PAYLOAD, "unbound_txid": C.BAD_PROPOSAL_TXID,
        "duplicate_txid": C.DUPLICATE_TXID, "expired_creator": C.BAD_CREATOR_SIGNATURE,
        "unknown_ca_creator": C.BAD_CREATOR_SIGNATURE,
        "outside_endorser": C.ENDORSEMENT_POLICY_FAILURE}


@pytest.fixture(scope="module")
def port_net():
    rng = np.random.default_rng(41)
    now = 1_790_000_000
    orgs = [pcryptogen.generate_org(f"Org{i}MSP", f"org{i}.port.example.com", rng, now=now)
            for i in (1, 2, 3, 4)]
    rogue = pcryptogen.generate_org("Org1MSP", "rogue.port.example.com", rng, now=now)
    d, pem = orgs[0].ca.issue("old@org1", "client", not_before=now - 20 * 86400,
                              not_after=now - 86400)
    return {
        "orgs": orgs,
        "pmgr": pmsp.MSPManager({o.msp_id: o.msp() for o in orgs}),
        "jmgr": JMSPManager({o.msp_id: JMSP(o.msp_id, [o.ca.cert_pem]) for o in orgs}),
        "client": orgs[0].users["User1@org1.port.example.com"],
        "peers": [o.nodes[f"peer0.org{i}.port.example.com"]
                  for i, o in zip((1, 2, 3, 4), orgs)],
        "expired": pcryptogen.SigningIdentity("Org1MSP", d, pem),
        "rogue": rogue.users["User1@rogue.port.example.com"],
    }


def unbind_txid(raw: bytes) -> bytes:
    """The envelope with its ChannelHeader's tx id replaced by one that
    is not sha256(nonce ‖ creator) (the creator signature no longer
    matches either; the binding check comes first)."""
    env = M.Envelope.parse(raw)
    payload = M.Payload.parse(env.payload)
    ch = M.ChannelHeader.parse(payload.header.channel_header)
    ch.tx_id = "0" * 64
    payload.header.channel_header = ch.serialize()
    env.payload = payload.serialize()
    return env.serialize()


def _port_block(pn, n=20):
    """n transactions cycling through KINDS → (Block, expected codes)."""
    specs, kinds = [], []
    for i in range(n):
        kind = KINDS[i % len(KINDS)]
        rw = TxRWSet()
        ns = rw.ns_rwset(CC)
        ns.reads[f"seed{i}"] = (9, 9) if kind == "stale_read" else (1, 0)
        ns.writes[f"w{i}"] = b"value-%d" % i
        creator = {"expired_creator": pn["expired"],
                   "unknown_ca_creator": pn["rogue"]}.get(kind, pn["client"])
        peers = pn["peers"]
        ends = ([peers[0], peers[3]] if kind == "outside_endorser"
                else [peers[i % 3], peers[(i + 1) % 3]])
        specs.append(ptxa.TxSpec(creator, ends, rw.to_bytes(), CC))
        kinds.append(kind)
    envs = ptxa.build_envelopes(specs)
    for i, kind in enumerate(kinds):
        if kind == "unbound_txid":
            envs[i] = unbind_txid(envs[i])
        elif kind == "bad_creator_sig":
            env = M.Envelope.parse(envs[i])
            env.signature = pn["client"].sign(b"other bytes")
            envs[i] = env.serialize()
        elif kind == "nil_envelope":
            envs[i] = b""
        elif kind == "truncated_payload":
            envs[i] = envs[i][:len(envs[i]) // 2]
        elif kind == "duplicate_txid":
            envs[i] = envs[0]
    return ptxa.build_block(3, b"prev", envs), bytes(int(WANT[k]) for k in kinds), n


def test_port_built_block_matches_reference_and_construction(port_net):
    blk, want, n = _port_block(port_net)
    raw = blk.serialize()
    jblk = common_pb2.Block()
    jblk.ParseFromString(raw)
    assert jblk.SerializeToString() == raw and M.Block.parse(raw) == blk
    assert jblk.header.data_hash == pu.block_data_hash(jblk.data)

    rows = [(CC, f"seed{i}", b"v", (1, 0)) for i in range(n)]
    jstate = JMemDB()
    seed = JUpdateBatch()
    for ns, key, val, ver in rows:
        seed.put(ns, key, val, ver)
    jstate.apply_updates(seed, (1, 0))
    jv = JBlockValidator(port_net["jmgr"], JPolicyProvider(
        {CC: JNamespaceInfo(policy=jpol.from_dsl(POLICY))}), jstate)
    jflt, jbatch, jhist = jv.validate(jblk)
    state, prov, _ = carry.from_reference(rows, {CC: POLICY}, [])
    v = pv.BlockValidator(prov, state, device="cpu", msp=port_net["pmgr"])
    flt, batch, hist = v.validate(M.Block.parse(raw))
    assert bytes(flt) == bytes(jflt) == want
    assert _rows(batch) == _rows(jbatch) and hist == jhist


def test_endorsers_deduplicate_by_serialized_bytes(port_net):
    """One peer under two encodings of its SerializedIdentity (the
    second with an unknown field appended) counts twice in the
    reference; so it does in the port."""
    peer = port_net["peers"][0]
    twin = pcryptogen.SigningIdentity(peer.msp_id, peer.d, peer.cert_pem)
    twin.__dict__["serialized"] = peer.serialized + b"\x18\x01"
    rw = TxRWSet()
    rw.ns_rwset(CC).writes["k"] = b"v"
    envs = ptxa.build_envelopes([
        ptxa.TxSpec(port_net["client"], [peer, twin], rw.to_bytes(), CC),
        ptxa.TxSpec(port_net["client"], [peer, peer], rw.to_bytes(), CC)])
    raw = ptxa.build_block(3, b"prev", envs).serialize()
    policy = "OutOf(2, 'Org1MSP.peer', 'Org1MSP.peer')"
    jblk = common_pb2.Block()
    jblk.ParseFromString(raw)
    jflt, _, _ = JBlockValidator(port_net["jmgr"], JPolicyProvider(
        {CC: JNamespaceInfo(policy=jpol.from_dsl(policy))}), JMemDB()).validate(jblk)
    _, prov, _ = carry.from_reference([], {CC: policy}, [])
    v = pv.BlockValidator(prov, carry.from_reference([], {}, [])[0], device="cpu",
                          msp=port_net["pmgr"])
    flt, _, _ = v.validate(M.Block.parse(raw))
    assert bytes(flt) == bytes(jflt) == bytes([C.VALID, C.ENDORSEMENT_POLICY_FAILURE])


def test_wire_entry_refusals(port_net):
    v = pv.BlockValidator(pv.PolicyProvider({}), carry.from_reference([], {}, [])[0],
                          device="cpu")
    blk = ptxa.build_block(3, b"prev", [b""])
    with pytest.raises(ValueError, match="msp"):
        v.validate(blk)
    with pytest.raises(TypeError):
        v.validate(blk.serialize())
    cfg = M.Envelope(payload=M.Payload(header=M.Header(
        channel_header=M.ChannelHeader(type=M.HEADER_CONFIG, tx_id="t").serialize())).serialize())
    # a config envelope is validated now: the reference's verdict (an
    # unsigned, creatorless config update is BAD_CREATOR_SIGNATURE)
    jflt, flt = _validate_both(port_net, [cfg.serialize()])
    assert flt == jflt == bytes([C.BAD_CREATOR_SIGNATURE])


def test_single_and_batched_assembly_agree(port_net, monkeypatch):
    """``create_signed_proposal`` → ``create_proposal_response`` →
    ``assemble_transaction`` gives the bytes ``build_envelopes`` gives
    for the same nonce and time (RFC 6979 signatures are a function of
    key and message)."""
    monkeypatch.setattr(ppu, "random_nonce", lambda: b"n" * 24)
    monkeypatch.setattr(ptxa, "time", types.SimpleNamespace(time=lambda: 1_790_000_000.5))
    rw = TxRWSet()
    rw.ns_rwset(CC).writes["k"] = b"v"
    client, peers = port_net["client"], port_net["peers"][:2]
    signed, tx_id, prop = ptxa.create_signed_proposal(client, "channel", CC, [b"invoke"])
    assert tx_id == ppu.compute_tx_id(b"n" * 24, client.serialized)
    r, s = ec_ref.der_decode_sig(signed.signature)
    assert ec_ref.verify_digest(client.public, ec_ref.digest_int(signed.proposal_bytes), r, s)
    resps = [ptxa.create_proposal_response(prop, rw.to_bytes(), p, CC) for p in peers]
    env = ptxa.assemble_transaction(prop, resps, client)
    assert env.serialize() == ptxa.build_envelopes([ptxa.TxSpec(client, peers, rw.to_bytes(),
                                                                CC)])[0]
    with pytest.raises(ValueError):
        ptxa.prepare_transaction(prop, [])


def _validate_both(pn, envs, policy=POLICY, jmgr=None, pmgr=None):
    """(reference filter, port filter) of one port-built block."""
    raw = ptxa.build_block(3, b"prev", envs).serialize()
    jblk = common_pb2.Block()
    jblk.ParseFromString(raw)
    jflt, _, _ = JBlockValidator(jmgr or pn["jmgr"], JPolicyProvider(
        {CC: JNamespaceInfo(policy=jpol.from_dsl(policy))}), JMemDB()).validate(jblk)
    _, prov, _ = carry.from_reference([], {CC: policy}, [])
    v = pv.BlockValidator(prov, carry.from_reference([], {}, [])[0], device="cpu",
                          msp=pmgr or pn["pmgr"])
    flt, _, _ = v.validate(M.Block.parse(raw))
    return bytes(jflt), bytes(flt)


def test_x509_creator_without_ec_key_is_bad_creator_signature(port_net):
    """A valid X.509 creator whose key is RSA: the reference's batch lane
    has no key for it and it is not idemix, so BAD_CREATOR_SIGNATURE; the
    port gives the same."""
    ca = port_net["orgs"][0].ca
    ca_cert = x509.load_pem_x509_certificate(ca.cert_pem)
    name = x509.Name([x509.NameAttribute(NameOID.ORGANIZATION_NAME, "org1.port.example.com"),
                      x509.NameAttribute(NameOID.ORGANIZATIONAL_UNIT_NAME, "client"),
                      x509.NameAttribute(NameOID.COMMON_NAME, "rsa@org1")])
    leaf = (x509.CertificateBuilder().subject_name(name).issuer_name(ca_cert.subject)
            .public_key(rsa.generate_private_key(public_exponent=65537, key_size=1024)
                        .public_key())
            .serial_number(77).not_valid_before(ca_cert.not_valid_before_utc)
            .not_valid_after(ca_cert.not_valid_after_utc)
            .sign(ec.derive_private_key(ca.d, ec.SECP256R1()), hashes.SHA256()))
    creator = pcryptogen.SigningIdentity("Org1MSP", port_net["client"].d,
                                         leaf.public_bytes(serialization.Encoding.PEM))
    ident = port_net["pmgr"].deserialize_identity(creator.serialized)
    assert ident.is_valid and not ident.has_ec_key and not ident.idemix
    rw = TxRWSet()
    rw.ns_rwset(CC).writes["k"] = b"v"
    peers = port_net["peers"][:2]
    envs = ptxa.build_envelopes([ptxa.TxSpec(port_net["client"], peers, rw.to_bytes(), CC),
                                 ptxa.TxSpec(creator, peers, rw.to_bytes(), CC)])
    assert _validate_both(port_net, envs) == (bytes([C.VALID, C.BAD_CREATOR_SIGNATURE]),) * 2


def test_idemix_creator_raises_and_idemix_endorser_is_dropped(port_net):
    """Identities of the channel's idemix MSP (the same issuer key and
    epoch record in both packages' managers): as a creator its
    presentation is verified on the host and the transaction validates,
    a tampered proof or an ECDSA signature under idemix id bytes is
    BAD_CREATOR_SIGNATURE; as an endorser it contributes nothing.  The
    port's verdicts equal the reference's, on the wire entry and through
    the front end."""
    rng = random.Random(7)
    iss = pidx.IdemixIssuer("IdemixMSP", bits=1024, rng=rng)
    holder = pidx.IdemixHolder(iss.ipk, rng)
    U, proof = holder.commitment()
    cred = holder.assemble(*iss.issue(U, proof, ou="org1", role="client"), ou="org1",
                           role="client")
    anon = pidx.IdemixSigningIdentity("IdemixMSP", iss.ipk, cred, rng)
    ecdsa_anon = pcryptogen.SigningIdentity(
        "IdemixMSP", port_net["client"].d,
        b'{"type": "idemix", "ou": "org1", "role": "member"}')
    orgs = port_net["orgs"]
    pmgr = pmsp.MSPManager({o.msp_id: o.msp() for o in orgs})
    pmgr.add(pidx.IdemixMSP("IdemixMSP", iss.ipk, iss.epoch_record))
    jmgr = JMSPManager({o.msp_id: JMSP(o.msp_id, [o.ca.cert_pem]) for o in orgs})
    jmgr.add(jidx.IdemixMSP("IdemixMSP", jidx.IssuerPublicKey.from_json(iss.ipk.to_json()),
                            jidx.EpochRecord.from_json(iss.epoch_record.to_json())))
    ident = pmgr.deserialize_identity(anon.serialized)
    assert ident.idemix and not ident.has_ec_key and ident.is_valid
    assert pmgr.deserialize_identity(ecdsa_anon.serialized).is_valid  # the shape is idemix
    rw = TxRWSet()
    rw.ns_rwset(CC).writes["k"] = b"v"
    peers = port_net["peers"]
    envs = ptxa.build_envelopes([
        ptxa.TxSpec(port_net["client"], [peers[0], ecdsa_anon], rw.to_bytes(), CC),
        ptxa.TxSpec(port_net["client"], peers[:2], rw.to_bytes(), CC),
        ptxa.TxSpec(port_net["client"], [peers[1], anon], rw.to_bytes(), CC),
        ptxa.TxSpec(anon, peers[:2], rw.to_bytes(), CC),
        ptxa.TxSpec(anon, peers[:2], rw.to_bytes(), CC),
        ptxa.TxSpec(ecdsa_anon, peers[:2], rw.to_bytes(), CC)])
    env = M.Envelope.parse(envs[4])
    env.signature = env.signature[:-6] + bytes(6)
    envs[4] = env.serialize()
    want = bytes([C.ENDORSEMENT_POLICY_FAILURE, C.VALID, C.ENDORSEMENT_POLICY_FAILURE,
                  C.VALID, C.BAD_CREATOR_SIGNATURE, C.BAD_CREATOR_SIGNATURE])
    assert _validate_both(port_net, envs, jmgr=jmgr, pmgr=pmgr) == (want, want)
    v = pv.BlockValidator(carry.from_reference([], {CC: POLICY}, [])[1],
                          carry.from_reference([], {}, [])[0], device="cpu", msp=pmgr)
    blk = ptxa.build_block(3, b"prev", envs)
    flt, _, _ = v.validate(v.decode(M.Block.parse(blk.serialize())))
    assert bytes(flt) == want
    assert [p.host_creator_ok for p in v.last_parsed] == [False] * 3 + [True] + [False] * 2
