"""The port's block-commit slice as a whole, on the CPU: randomized
adversarial blocks (bad creator and endorsement signatures, repeated
endorsers, in-block and cross-block duplicate txids, a
consumption-unsafe policy, stale and absent reads, deletes, committed
and in-block range phantoms, unknown namespaces, nil and garbage
envelopes) are built and signed with the JAX package's cryptogen and
tx assembly, validated by its ``BlockValidator`` block after block, and
decoded — by the reference's own parser, envelope by envelope — into
the port's ``DecodedBlock`` form.  The port's ``CommitPipeline`` at
depths 1, 2 and 3 must give the same TRANSACTIONS_FILTER, update batch
(values and versions) and history for every block."""

import hashlib
import random

import pytest
import torch

from fabric_tpu import protoutil as pu
from fabric_tpu.crypto import cryptogen
from fabric_tpu.crypto import policy as jpol
from fabric_tpu.crypto.identity import sig_to_ints
from fabric_tpu.crypto.msp import MSPManager
from fabric_tpu.ledger.rwset import TxRWSet as JTxRWSet
from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.ledger.statedb import UpdateBatch as JUpdateBatch
from fabric_tpu.peer import txassembly as txa
from fabric_tpu.peer.validator import BlockValidator as JBlockValidator
from fabric_tpu.peer.validator import NamespaceInfo as JNamespaceInfo
from fabric_tpu.peer.validator import PolicyProvider as JPolicyProvider
from fabric_tpu.protos import common_pb2
from fabric_tpu_torch import carry
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.crypto.identity import Identity
from fabric_tpu_torch.ledger.rwset import TxRWSet
from fabric_tpu_torch.ledger.statedb import MemVersionedDB
from fabric_tpu_torch.peer import validator as pv
from fabric_tpu_torch.peer.pipeline import CommitPipeline
from fabric_tpu_torch.peer.txcodes import TxValidationCode as C

CHANNEL = "slicechan"
CC, CC_UNSAFE = "slicecc", "sliceun"
POLICIES = {
    CC: "OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')",
    # one Org1 peer matches both principals: consumption-unsafe rows
    CC_UNSAFE: "OutOf(1, 'Org1MSP.peer', 'Org1MSP.member')",
}
N_BLOCKS = 14
TXS_PER_BLOCK = 8  # the reference's compiled shapes stay few


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and the pipeline tests run torch ops on two threads at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net():
    orgs = [cryptogen.generate_org(f"Org{i}MSP", f"org{i}.slice.example.com",
                                   peers=1, users=1) for i in (1, 2, 3)]
    rogue = cryptogen.generate_org("RogueMSP", "rogue.slice.example.com", peers=1)
    return {
        "mgr": MSPManager({o.msp_id: o.msp() for o in orgs}),
        "peers": [cryptogen.signing_identity(o, f"peer0.org{i}.slice.example.com")
                  for i, o in zip((1, 2, 3), orgs)],
        "client": cryptogen.signing_identity(orgs[0], "User1@org1.slice.example.com"),
        "rogue": cryptogen.signing_identity(rogue, "peer0.rogue.slice.example.com"),
        "prov": JPolicyProvider({ns: JNamespaceInfo(policy=jpol.from_dsl(d))
                                 for ns, d in POLICIES.items()}),
    }


def _seed_batch():
    seed = JUpdateBatch()
    for i in range(8):
        seed.put(CC, f"s{i}", b"v", (1, i))
        seed.put(CC_UNSAFE, f"u{i}", b"v", (1, i))
    return seed


def _rand_tx(net, rng):
    r = rng.random()
    namespaces = ([CC_UNSAFE] if r < 0.15 else ["nosuchcc"] if r < 0.2
                  else [CC, CC_UNSAFE] if r < 0.25 else [CC])
    tx = JTxRWSet()
    for ns in namespaces:
        n = tx.ns_rwset(ns)
        pre = "u" if ns == CC_UNSAFE else "s"
        for _ in range(rng.randrange(0, 3)):
            i = rng.randrange(8)
            kind = rng.random()
            if kind < 0.6:
                n.reads[f"{pre}{i}"] = (1, i)        # fresh (unless rewritten)
            elif kind < 0.8:
                n.reads[f"{pre}{i}"] = (0, 99)       # stale
            else:
                n.reads[f"absent{i}"] = None         # absent
        for _ in range(rng.randrange(0, 3)):
            n.writes[f"w{rng.randrange(10)}"] = b"x%d" % rng.randrange(100)
        if rng.random() < 0.1:
            n.writes[f"{pre}{rng.randrange(8)}"] = None  # delete
        if rng.random() < 0.15:
            # committed range; sometimes a result is missing (phantom)
            results = [(f"{pre}{i}", (1, i)) for i in range(4)
                       if not (i == 2 and rng.random() < 0.4)]
            n.range_queries.append((f"{pre}0", f"{pre}4", results))
        if rng.random() < 0.1:
            n.range_queries.append(("w0", "w5", []))  # in-block writers phantom it
    rw = tx.to_proto().SerializeToString()
    c = rng.random()
    peers = net["peers"]
    if c < 0.55:
        endorsers = rng.sample(peers, 2)
    elif c < 0.68:
        endorsers = [rng.choice(peers)]
    elif c < 0.78:
        p = rng.choice(peers)
        endorsers = [p, p]                           # repeated endorser
    elif c < 0.88:
        endorsers = [rng.choice(peers), net["rogue"]]
    else:
        endorsers = list(peers)
    _, _, prop = txa.create_signed_proposal(net["client"], CHANNEL, namespaces[0], [b"i"])
    resps = [txa.create_proposal_response(prop, rw, e, namespaces[0]) for e in endorsers]
    if rng.random() < 0.08:
        # an endorsement signature over other bytes
        resps[0].endorsement.signature = endorsers[0].sign(b"something else")
    env = txa.assemble_transaction(prop, resps, net["client"])
    if rng.random() < 0.08:
        env.signature = env.signature[:-4] + bytes(4)  # bad creator signature
    return env.SerializeToString()


def _blocks(net):
    rng = random.Random(20261017)
    blocks, pool = [], []
    for b in range(N_BLOCKS):
        envs = []
        for _ in range(TXS_PER_BLOCK):
            r = rng.random()
            if r < 0.03:
                envs.append(b"")                     # nil envelope
            elif r < 0.06:
                envs.append(b"\x13garbage-bytes")    # undecodable
            elif r < 0.11 and envs:
                envs.append(rng.choice(envs))        # in-block duplicate
            elif r < 0.15 and pool:
                envs.append(rng.choice(pool))        # cross-block duplicate
            else:
                envs.append(_rand_tx(net, rng))
        pool.extend(e for e in envs if len(e) > 20)
        blk = pu.new_block(2 + b, b"prev-%d" % b)
        for e in envs:
            blk.data.data.append(e)
        blocks.append(pu.finalize_block(blk))
    return blocks


class _Store:
    def __init__(self):
        self.txids = set()

    def tx_exists(self, txid):
        return txid in self.txids


def _rows(batch):
    return sorted((k, vv.value, vv.version) for k, vv in batch.updates.items())


def _reference(net, blocks):
    state = JMemDB()
    state.apply_updates(_seed_batch(), (1, 0))
    store = _Store()
    v = JBlockValidator(net["mgr"], net["prov"], state, block_store=store)
    out = []
    for blk in blocks:
        flt, batch, hist = v.validate(blk)
        state.apply_updates(batch, (blk.header.number, 0))
        store.txids.update(p.txid for p in v.last_parsed if p.txid)
        out.append((bytes(flt), _rows(batch), list(hist)))
    return out


def _port_rwset(rw):
    out = TxRWSet()
    for ns, n in rw.ns.items():
        m = out.ns_rwset(ns)
        m.reads, m.writes = dict(n.reads), dict(n.writes)
        m.range_queries = [(s, e, list(r)) for s, e, r in n.range_queries]
        m.metadata_writes, m.hashed = dict(n.metadata_writes), dict(n.hashed)
    return out


def _decode(blk, parser, mgr, known):
    """Reference-decoded envelopes → the port's DecodedBlock.  Each
    envelope is parsed alone, so the port does its own duplicate
    detection; endorsements come raw (repeats included)."""
    def ident(j):
        qx, qy = j.public_numbers
        return known.get((j.msp_id, j.role, qx, qy)) or Identity(
            j.msp_id, j.role, qx, qy, bool(j.is_valid))

    txs = []
    for raw in blk.data.data:
        one = common_pb2.Block()
        one.header.CopyFrom(blk.header)
        one.data.data.append(raw)
        ptxs, items, _, _ = parser._parse(one)
        ptx = ptxs[0]
        bound = bool(ptx.txid) and not ptx.is_config and ptx.code not in (
            C.NIL_ENVELOPE, C.UNKNOWN_TX_TYPE, C.BAD_PROPOSAL_TXID)
        dtx = pv.DecodedTx(txid=ptx.txid, code=int(ptx.code), txid_bound=bound,
                           rwset=_port_rwset(ptx.rwset) if ptx.rwset is not None else None,
                           is_config=ptx.is_config)
        tuples = items.tuples()
        if ptx.creator_item_idx >= 0:
            e, r, s, _, _ = tuples[ptx.creator_item_idx]
            dtx.creator = ident(mgr.deserialize_identity(ptx.creator))
            dtx.creator_sig = (e, r, s)
        if ptx.code == C.NOT_VALIDATED:
            env = pu.unmarshal(common_pb2.Envelope, raw)
            _, _, cap, _, _ = pu.extract_action(env)
            prp = cap.action.proposal_response_payload
            for end in cap.action.endorsements:
                try:
                    j = mgr.deserialize_identity(end.endorser)
                    r, s = sig_to_ints(end.signature)
                    j.public_numbers
                except Exception:
                    continue
                digest = int.from_bytes(hashlib.sha256(prp + end.endorser).digest(), "big")
                dtx.endorsements.append(pv.DecodedEndorsement(ident(j), digest, r, s))
        txs.append(dtx)
    return pv.DecodedBlock(number=blk.header.number, txs=txs)


@pytest.fixture(scope="module")
def streams(net):
    blocks = _blocks(net)
    want = _reference(net, blocks)
    seed = JMemDB()
    seed.apply_updates(_seed_batch(), (1, 0))
    rows = [(ns, key, vv.value, vv.version) for (ns, key), vv in seed.iter_all()]
    people = [net["client"], *net["peers"]]
    idents = [(p.msp_id, p.identity.role, *p.identity.public_numbers) for p in people]
    _, _, carried = carry.from_reference(rows, POLICIES, idents)
    known = {(i.msp_id, i.role, i.qx, i.qy): i for i in carried}
    parser = JBlockValidator(net["mgr"], net["prov"], JMemDB())
    decoded = [_decode(b, parser, net["mgr"], known) for b in blocks]
    return decoded, want, rows


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_matches_reference(streams, depth, monkeypatch):
    decoded, want, rows = streams
    state, prov, _ = carry.from_reference(rows, POLICIES, [])
    store = _Store()
    host_redos = []
    orig = pv.BlockValidator._validate_host
    monkeypatch.setattr(pv.BlockValidator, "_validate_host",
                        lambda self, p: host_redos.append(p.block.number) or orig(self, p))

    def commit(res):
        state.apply_updates(res.batch)
        store.txids.update(t for t, _ in res.txids)

    v = pv.BlockValidator(prov, state, block_store=store, device="cpu")
    got = []
    with CommitPipeline(v, commit, depth=depth) as pipe:
        for blk in decoded:
            res = pipe.submit(blk)
            if res is not None:
                got.append(res)
        res = pipe.flush()
        if res is not None:
            got.append(res)
    assert len(got) == len(decoded)
    for res, (flt, batch_rows, hist) in zip(got, want):
        assert res.tx_filter == flt, res.block.number
        assert _rows(res.batch) == batch_rows, res.block.number
        assert res.history == hist, res.block.number
    codes = {c for flt, _, _ in want for c in flt}
    assert codes >= {C.VALID, C.BAD_CREATOR_SIGNATURE, C.ENDORSEMENT_POLICY_FAILURE,
                     C.MVCC_READ_CONFLICT, C.PHANTOM_READ_CONFLICT, C.DUPLICATE_TXID,
                     C.INVALID_CHAINCODE, C.BAD_PAYLOAD}, codes
    assert host_redos, "no block took the consumption-unsafe host redo"


def _unsupported_blocks():
    ident = Identity("Org1MSP", "client", 1, 2)

    def tx(**kw):
        rw = TxRWSet()
        rw.ns_rwset(CC).writes["k"] = b"v"
        base = dict(txid="t", creator=ident, creator_sig=(1, 1, 1), rwset=rw)
        base.update(kw)
        return pv.DecodedTx(**base)

    meta, hashed = TxRWSet(), TxRWSet()
    meta.ns_rwset(CC).metadata_writes["k"] = {"VALIDATION_PARAMETER": b"p"}
    hashed.ns_rwset(CC).hashed["coll"] = {"reads": {}, "writes": {}}
    plug = TxRWSet()
    plug.ns_rwset("plugged").writes["k"] = b"v"
    return {
        "config": tx(is_config=True),
        "idemix": tx(creator=Identity("IdemixMSP", "client", None, None)),
        "sbe": tx(rwset=meta),
        "pvtdata": tx(rwset=hashed),
        "plugin": tx(rwset=plug),
    }


@pytest.mark.parametrize("kind", ["config", "idemix", "sbe", "pvtdata", "plugin"])
def test_unsupported_block_content_raises(kind):
    prov = pv.PolicyProvider({
        CC: pv.NamespaceInfo(policy=pol.from_dsl(POLICIES[CC])),
        "plugged": pv.NamespaceInfo(policy=pol.from_dsl(POLICIES[CC]), plugin="vscc2"),
    })
    v = pv.BlockValidator(prov, MemVersionedDB(), device="cpu")
    block = pv.DecodedBlock(number=3, txs=[_unsupported_blocks()[kind]])
    with pytest.raises(NotImplementedError, match="later slice"):
        v.validate(block)
