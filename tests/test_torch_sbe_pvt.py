"""Config transactions, key-level endorsement (SBE), private-collection
(hashed) read/write sets and custom validation plugins through the
port on the CPU, against the JAX package.

* A differential corpus in the shape of ``tests/test_differential.py``:
  a genesis block from the reference's ``configtxgen``, then seeded
  blocks with committed and in-block key-level policies (set, rotate,
  clear), hashed reads and writes, a namespace with a custom plugin and
  one whose plugin is not registered, stale and absent reads, range
  queries, bad creator signatures, repeated endorsers, nil and garbage
  envelopes, duplicate tx ids, config updates (an authorized rotation of
  Org3's MSP, an unauthorized and a stale update, one with a bad
  creator signature) and a ``_lifecycle`` write.  The JAX
  ``BlockValidator`` (its ``ConfigTxProcessor``, a plugin, committed
  configs applied as the peer does) gives each block's filter, update
  batch (values, metadata, versions) and history; the port's
  ``CommitPipeline`` gives the same at depths 1-3, under ``submit_many``
  with 2-4 blocks a group, on its host path alone, and under
  ``state_resident=True``.
* The seven scenarios of ``tests/test_sbe.py`` on both packages.
* The barrier: at depth 3 the block after a config block or a
  ``_lifecycle`` write was staged early, and is preprocessed again; a
  launch with an overlay that writes ``_lifecycle`` raises.

Exact equality throughout."""

import hashlib
import random

import pytest
import torch
from test_torch_coalesce import _RowVerify
from test_torch_config import _pinned_config_order  # noqa: F401 — an autouse fixture
from test_torch_wire import _CachedVerify

from fabric_tpu import channelconfig as jcc
from fabric_tpu import protoutil as pu
from fabric_tpu.crypto import cryptogen
from fabric_tpu.crypto import policy as jpol
from fabric_tpu.crypto.msp import policy_to_proto
from fabric_tpu.ledger.rwset import VALIDATION_PARAMETER, encode_metadata
from fabric_tpu.ledger.rwset import TxRWSet as JTxRWSet
from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.ledger.statedb import UpdateBatch as JUpdateBatch
from fabric_tpu.peer import txassembly as txa
from fabric_tpu.peer import validator as jvalidator
from fabric_tpu.peer.validator import BlockValidator as JBlockValidator
from fabric_tpu.peer.validator import NamespaceInfo as JNamespaceInfo
from fabric_tpu.peer.validator import PolicyProvider as JPolicyProvider
from fabric_tpu.protos import common_pb2, configtx_pb2
from fabric_tpu.tools import configtxgen as jcg
from fabric_tpu_torch import carry
from fabric_tpu_torch import channelconfig as cc
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.ledger.statedb import UpdateBatch
from fabric_tpu_torch.ops import p256v3
from fabric_tpu_torch.peer import validator as pv
from fabric_tpu_torch.peer.pipeline import CommitPipeline
from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
from fabric_tpu_torch.protos import messages as M

CHANNEL = "sbepvtchan"
CC_SAFE, CC_UNSAFE, PLUG, NOPLUG, LIFECYCLE = "diffcc", "diffun", "plugcc", "noplug", "_lifecycle"
SAFE = "OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')"
POLICIES = {CC_SAFE: (SAFE, "default"),
            CC_UNSAFE: ("OutOf(1, 'Org1MSP.peer', 'Org1MSP.member')", "default"),
            PLUG: ("OutOf(1, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')", "twoorgs"),
            NOPLUG: (SAFE, "vscc9"),
            LIFECYCLE: (SAFE, "default")}
N_BLOCKS = 15  # after the genesis block
TXS_PER_BLOCK = 8
CONFIG_AT = {3: "rotate", 6: "unauthorized", 9: "stale", 12: "bad_sig"}
LIFECYCLE_AT = 11


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jverify():
    """The reference validators verify through one cached, fixed-shape
    run of their own kernel."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvalidator.p256, "verify_launch", _CachedVerify(jax=True))
        yield


# ---------------------------------------------------------------------------
# The custom plugin, in each package's ParsedTx form: at least two orgs
# among the transaction's sig-valid, valid endorsers


class JTwoOrgs(jvalidator.ValidationPlugin):
    def validate_batch_group(self, ctx, group):
        return [len({ident.msp_id for (_, ident), i in zip(p.endorsements, p.endo_item_idx)
                     if ctx.sig_valid[i] and ident.is_valid}) >= 2 for p, _ in group]


class PTwoOrgs(pv.ValidationPlugin):
    def validate_batch(self, ctx):
        return [len({ident.msp_id for ident, i in zip(p.endorsers, p.endo_item_idx)
                     if ctx.sig_valid[i] and ident.is_valid}) >= 2 for p in ctx.txs]


def _jprov():
    return JPolicyProvider({ns: JNamespaceInfo(policy=jpol.from_dsl(d), plugin=p)
                            for ns, (d, p) in POLICIES.items()})


def _pprov():
    return pv.PolicyProvider({ns: pv.NamespaceInfo(policy=pol.from_dsl(d), plugin=p)
                              for ns, (d, p) in POLICIES.items()})


# ---------------------------------------------------------------------------
# The network and the corpus


@pytest.fixture(scope="module")
def net():
    orgs = [cryptogen.generate_org(f"Org{i}MSP", f"org{i}.sbe.example.com", peers=1, users=1)
            for i in (1, 2, 3)]
    org3b = cryptogen.generate_org("Org3MSP", "org3b.sbe.example.com", peers=1)
    org3c = cryptogen.generate_org("Org3MSP", "org3c.sbe.example.com", peers=1)
    rogue = cryptogen.generate_org("RogueMSP", "rogue.sbe.example.com", peers=1)
    sid = cryptogen.signing_identity
    return {
        "orgs": orgs, "org3b": org3b, "org3c": org3c,
        "peers": [sid(o, f"peer0.org{i}.sbe.example.com") for i, o in zip((1, 2, 3), orgs)],
        "peer3b": sid(org3b, "peer0.org3b.sbe.example.com"),
        "admins": [sid(o, f"Admin@{o.domain}") for o in orgs],
        "client": sid(orgs[0], "User1@org1.sbe.example.com"),
        "rogue": sid(rogue, "peer0.rogue.sbe.example.com"),
    }


def _sbe_policy(msp_id: str) -> bytes:
    return policy_to_proto(jpol.from_dsl(f"OutOf(1, '{msp_id}.peer')")).SerializeToString()


def _kh(i) -> bytes:
    return hashlib.sha256(b"pk%d" % i).digest()


def _seed_batch():
    seed = JUpdateBatch()
    for i in range(8):
        seed.put(CC_SAFE, f"s{i}", b"v", (1, i))
        seed.put(CC_UNSAFE, f"u{i}", b"v", (1, i))
        seed.put(PLUG, f"p{i}", b"v", (1, i))
    for i in range(4):  # committed key-level policies (Org2 / Org3 only)
        seed.put(CC_SAFE, f"sbe{i}", b"locked", (1, 20 + i), metadata=encode_metadata(
            {VALIDATION_PARAMETER: _sbe_policy("Org2MSP" if i % 2 else "Org3MSP")}))
    seed.put(CC_SAFE, "meta_only", b"m", (1, 40), metadata=encode_metadata({"other": b"x"}))
    for i in range(4):
        seed.put(f"{CC_SAFE}$collA#hashed", _kh(i).hex(), hashlib.sha256(b"pv%d" % i).digest(),
                 (1, 30 + i))
    return seed


def _seed_rows():
    db = JMemDB()
    db.apply_updates(_seed_batch(), (1, 0))
    return [(ns, key, vv.value, vv.version, vv.metadata) for (ns, key), vv in db.iter_all()]


def _endorse(net, ns, rw: bytes, endorsers, salt=b"i") -> bytes:
    _, _, prop = txa.create_signed_proposal(net["client"], CHANNEL, ns, [salt])
    resps = [txa.create_proposal_response(prop, rw, e, ns) for e in endorsers]
    return txa.assemble_transaction(prop, resps, net["client"]).SerializeToString()


def _rand_tx(net, rng, rotated: bool, plain: bool) -> bytes:
    """One signed envelope; ``plain``: no key-level policy write or
    locked key, no plugin namespace (a block of such takes the fused
    path)."""
    r = rng.random()
    ns = (CC_UNSAFE if r < 0.12 else CC_SAFE if plain else PLUG if r < 0.24
          else NOPLUG if r < 0.28 else CC_SAFE)
    tx = JTxRWSet()
    n = tx.ns_rwset(ns)
    pre = {CC_UNSAFE: "u", PLUG: "p"}.get(ns, "s")
    for _ in range(rng.randrange(0, 3)):
        i = rng.randrange(8)
        kind = rng.random()
        if kind < 0.6:
            n.reads[f"{pre}{i}"] = (1, i)
        elif kind < 0.8:
            n.reads[f"{pre}{i}"] = (0, 99)
        else:
            n.reads[f"absent{i}"] = None
    for _ in range(rng.randrange(0, 3)):
        n.writes[f"w{rng.randrange(12)}"] = b"x%d" % rng.randrange(50)
    if ns == CC_SAFE:
        sb = 1.0 if plain else rng.random()
        if sb < 0.14:
            n.writes[f"sbe{rng.randrange(4)}"] = b"y"          # a locked key
        elif sb < 0.18:
            n.writes["meta_only"] = None if rng.random() < 0.3 else b"z"
        elif sb < 0.28:
            key = rng.choice([f"sbe{rng.randrange(4)}", f"s{rng.randrange(8)}", "ghost"])
            n.metadata_writes[key] = ({} if rng.random() < 0.3 else {
                VALIDATION_PARAMETER: _sbe_policy(rng.choice(["Org1MSP", "Org2MSP", "Org3MSP"])),
                **({"other": b"o"} if rng.random() < 0.3 else {})})
            if rng.random() < 0.4:
                n.writes[key] = b"mv"
        if rng.random() < 0.25:
            coll = n.hashed.setdefault("collA", {"reads": {}, "writes": {}})
            i = rng.randrange(6)
            c = rng.random()
            if c < 0.45:
                coll["reads"][_kh(i)] = (1, 30 + i) if i < 4 and rng.random() < 0.7 else (
                    None if i >= 4 else (0, 9))
            elif c < 0.9:
                coll["writes"][_kh(i)] = (hashlib.sha256(b"nv").digest(), False)
            else:
                coll["writes"][_kh(i)] = (b"", True)
        if rng.random() < 0.08:
            results = [(f"s{i}", (1, i)) for i in range(4) if not (i == 2 and rng.random() < 0.4)]
            n.range_queries.append(("s0", "s4", results))
    rw = tx.to_proto().SerializeToString()
    peers = list(net["peers"])
    if rotated:
        peers[2] = net["peer3b"]  # Org3's peer under the rotated CA
    c = rng.random()
    if c < 0.5:
        endorsers = rng.sample(peers, 2)
    elif c < 0.62:
        endorsers = [rng.choice(peers)]
    elif c < 0.7:
        endorsers = [peers[0], peers[0]]
    elif c < 0.78:
        endorsers = [rng.choice(peers), net["rogue"]]
    elif c < 0.86:
        endorsers = [net["peers"][2], peers[1]]  # Org3's old peer
    else:
        endorsers = peers
    raw = _endorse(net, ns, rw, endorsers, b"%d" % rng.randrange(10**9))
    if rng.random() < 0.06:
        env = common_pb2.Envelope.FromString(raw)
        env.signature = env.signature[:-4] + bytes(4)
        raw = env.SerializeToString()
    return raw


def _config_tx(net, kind: str, bundles: dict) -> bytes:
    """A config update envelope of ``kind`` against the configs in
    ``bundles`` ({"genesis": Bundle, "current": Bundle})."""
    admins = net["admins"]
    if kind in ("rotate", "stale"):
        base = bundles["genesis"] if kind == "stale" else bundles["current"]
        org = net["org3b"] if kind == "rotate" else net["org3c"]
        new = configtx_pb2.Config()
        new.CopyFrom(base.config)
        new.channel_group.groups["Application"].groups["Org3MSP"].values["MSP"].value = \
            org.msp().to_proto().SerializeToString()
        signers = [admins[2]]
    else:
        base = bundles["current"]
        new = configtx_pb2.Config()
        new.CopyFrom(base.config)
        new.channel_group.groups["Application"].groups["Org1MSP"].policies[
            "Endorsement"].CopyFrom(jcc.config_policy(
                jpol.SignedBy(jpol.Principal("Org1MSP", jpol.ROLE_ADMIN))))
        signers = [admins[1]] if kind == "unauthorized" else [admins[0]]
    upd_env = jcg.sign_update(jcg.compute_update(CHANNEL, base.config, new), signers)
    try:
        proposed = jcc.authorize_update(base, upd_env)
    except jcc.ConfigUpdateError:
        proposed = new
    env = jcg.config_tx(CHANNEL, proposed, upd_env, signer=signers[0])
    if kind == "rotate":
        bundles["current"] = jcc.Bundle(CHANNEL, proposed)
    if kind == "bad_sig":
        env.signature = env.signature[:-4] + bytes(4)
    return env.SerializeToString()


def _lifecycle_tx(net) -> bytes:
    tx = JTxRWSet()
    tx.ns_rwset(LIFECYCLE).writes["namespaces/fields/plugcc/Definition"] = b"def"
    return _endorse(net, LIFECYCLE, tx.to_proto().SerializeToString(),
                    [net["peers"][0], net["peers"][1]], b"lc")


def _blocks(net, seed=20261018):
    rng = random.Random(seed)
    jp = jcg.Profile(CHANNEL, application_orgs=[jcg.OrgProfile(o.msp_id, o.msp())
                                                for o in net["orgs"]])
    genesis = jcg.genesis_block(jp)
    bundles = {"genesis": jcc.bundle_from_genesis(CHANNEL, genesis)}
    bundles["current"] = bundles["genesis"]
    blocks, pool = [genesis], []
    for b in range(1, N_BLOCKS + 1):
        envs = []
        for _ in range(TXS_PER_BLOCK):
            r = rng.random()
            if r < 0.03:
                envs.append(b"")
            elif r < 0.06:
                envs.append(b"\x13garbage-bytes")
            elif r < 0.1 and envs:
                envs.append(rng.choice(envs))
            elif r < 0.13 and pool:
                envs.append(rng.choice(pool))
            else:
                envs.append(_rand_tx(net, rng, rotated=b > 3, plain=b % 3 == 1))
        if b in CONFIG_AT:
            envs.insert(rng.randrange(len(envs) + 1), _config_tx(net, CONFIG_AT[b], bundles))
        if b == LIFECYCLE_AT:
            envs.insert(2, _lifecycle_tx(net))
        pool.extend(e for e in envs if len(e) > 20)
        blk = pu.new_block(b, b"prev-%d" % b)
        for e in envs:
            blk.data.data.append(e)
        blocks.append(pu.finalize_block(blk))
    return blocks


class _Store:
    def __init__(self):
        self.txids = set()

    def tx_exists(self, txid):
        return txid in self.txids


def _meta_rows(batch):
    return sorted((k, vv.value, vv.metadata, vv.version) for k, vv in batch.updates.items())


def _reference(blocks):
    """The JAX validator block after block, each batch applied and each
    committed config installed as the peer installs it."""
    state = JMemDB()
    state.apply_updates(_seed_batch(), (1, 0))
    store = _Store()
    proc = jcc.ConfigTxProcessor(jcc.bundle_from_genesis(CHANNEL, blocks[0]))
    v = JBlockValidator(proc.bundle.msp_manager, _jprov(), state, block_store=store,
                        plugins={"twoorgs": JTwoOrgs()}, config_processor=proc)
    out = []
    for blk in blocks:
        flt, batch, hist = v.validate(blk)
        state.apply_updates(batch, (blk.header.number, 0))
        store.txids.update(p.txid for p in v.last_parsed if p.txid)
        for p in v.last_parsed:
            if p.is_config and flt[p.idx] == C.VALID:
                env = pu.unmarshal(common_pb2.Envelope, blk.data.data[p.idx])
                cfg_env = pu.unmarshal(configtx_pb2.ConfigEnvelope,
                                       pu.unmarshal(common_pb2.Payload, env.payload).data)
                v.msp = proc.apply(cfg_env).msp_manager
        out.append((bytes(flt), _meta_rows(batch), list(hist)))
    return out


@pytest.fixture(scope="module")
def corpus(net):
    blocks = _blocks(net)
    want = _reference(blocks)
    wire = [M.Block.parse(b.SerializeToString()) for b in blocks]
    return wire, want


@pytest.fixture(scope="module")
def rowverify():
    return _RowVerify()


@pytest.fixture
def pverify(monkeypatch, rowverify):
    monkeypatch.setattr(p256v3, "verify_batch_packed", rowverify)
    return rowverify


def _validator(wire, **kw):
    state, _, _ = carry.from_reference(_seed_rows(), {}, [])
    proc = cc.ConfigTxProcessor(cc.bundle_from_genesis(CHANNEL, wire[0]))
    return pv.BlockValidator(_pprov(), state, block_store=_Store(), device="cpu",
                             msp=proc.bundle.msp_manager, plugins={"twoorgs": PTwoOrgs()},
                             config_processor=proc, **kw)


def _commit(v):
    def commit(res):
        v.state.apply_updates(res.batch)
        v.blocks.txids.update(t for t, _ in res.txids)
        cc.apply_committed_config(res, v)
    return commit


def _run(v, wire, depth=2, k=0):
    got = []
    try:
        pipe = CommitPipeline(v, _commit(v), depth=depth, coalesce_blocks=k)
        with pipe:
            if k:
                got += pipe.submit_many(wire)
            else:
                got += [r for r in (pipe.submit(b) for b in wire) if r is not None]
            tail = pipe.flush()
            if tail is not None:
                got.append(tail)
    finally:
        v.close()
    return [(bytes(r.tx_filter), _meta_rows(r.batch), list(r.history)) for r in got], pipe


def _check(got, want):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], (b, list(g[0]), list(w[0]))
        assert g[1] == w[1], b
        assert g[2] == w[2], b


def test_corpus_covers_every_case(corpus):
    _, want = corpus
    codes = {c for flt, _, _ in want for c in flt}
    assert codes >= {C.VALID, C.BAD_CREATOR_SIGNATURE, C.ENDORSEMENT_POLICY_FAILURE,
                     C.MVCC_READ_CONFLICT, C.PHANTOM_READ_CONFLICT, C.DUPLICATE_TXID,
                     C.INVALID_OTHER_REASON, C.NIL_ENVELOPE, C.BAD_PAYLOAD}, codes
    metas = [r for _, rows, _ in want for r in rows if r[2] is not None]
    hashed = [r for _, rows, _ in want for r in rows if r[0][0].endswith("#hashed")]
    assert metas and hashed


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_matches_reference(corpus, pverify, depth):
    wire, want = corpus
    got, pipe = _run(_validator(wire), wire, depth=depth)
    _check(got, want)
    if depth > 1:
        # the genesis block, the rotation and the lifecycle write are
        # barriers (a config tx that fails is one too)
        assert pipe.barriers == 1 + len(CONFIG_AT) + 1
        assert pipe.stale_prefetches == pipe.barriers


@pytest.mark.parametrize("k", [2, 3, 4])
def test_submit_many_matches_reference(corpus, pverify, k):
    wire, want = corpus
    got, pipe = _run(_validator(wire), wire, k=k)
    _check(got, want)
    assert pipe.stale_prefetches >= pipe.barriers


def test_host_path_and_fused_path_match_reference(corpus, pverify, monkeypatch):
    """The same stream with every block forced onto ``_validate_host``,
    and with the routes left to the validator: both equal the
    reference, and the free run took both routes."""
    wire, want = corpus
    v = _validator(wire)
    v.validate_finish = v._validate_host
    got, _ = _run(v, wire)
    _check(got, want)
    routes = {"fused": 0, "host": 0}
    orig = pv.BlockValidator._validate_host

    def host(self, pending):
        routes["host"] += 1
        return orig(self, pending)

    monkeypatch.setattr(pv.BlockValidator, "_validate_host", host)
    orig_dev = pv.BlockValidator._finish_device

    def dev(self, pending):
        out = orig_dev(self, pending)
        routes["fused"] += out is not None
        return out

    monkeypatch.setattr(pv.BlockValidator, "_finish_device", dev)
    got, _ = _run(_validator(wire), wire)
    _check(got, want)
    assert routes["fused"] >= 2 and routes["host"] >= 2, routes


def test_resident_state_matches_reference(corpus, pverify):
    wire, want = corpus
    v = _validator(wire, state_resident=True, state_resident_mb=1)
    got, _ = _run(v, wire)
    _check(got, want)
    assert v.resident.stats()["host_path_hashed_total"] >= 1


def test_lifecycle_overlay_launch_raises(corpus, pverify):
    wire, _ = corpus
    v = _validator(wire)
    overlay = UpdateBatch()
    overlay.put(LIFECYCLE, "k", b"v", (5, 0))
    with pytest.raises(ValueError, match="lifecycle"):
        v.validate_launch(wire[1], overlay=overlay)
    v.close()


# ---------------------------------------------------------------------------
# tests/test_sbe.py's scenarios on both packages


SBE_CC = "sbecc"
SBE_NS = "OutOf(1, 'Org1MSP.peer', 'Org2MSP.peer')"


def _sbe_tx(net, endorsers, reads=(), writes=(), meta=None) -> bytes:
    tx = JTxRWSet()
    n = tx.ns_rwset(SBE_CC)
    n.reads.update(dict(reads))
    n.writes.update(dict(writes))
    for k, entries in (meta or {}).items():
        n.metadata_writes[k] = dict(entries)
    return _endorse(net, SBE_CC, tx.to_proto().SerializeToString(),
                    [net["peers"][i] for i in endorsers], b"%d" % random.random())


def _meta(msp_id: str) -> dict:
    return {VALIDATION_PARAMETER: _sbe_policy(msp_id)}


class _Both:
    """The reference and the port over one state each: ``run(envs,
    num)`` validates one block on both, checks they agree, and commits
    the batch to both states when ``commit``."""

    def __init__(self, net, seed=()):
        jstate = JMemDB()
        b = JUpdateBatch()
        for key, value, md in seed:
            b.put(SBE_CC, key, value, (1, 0), metadata=md)
        jstate.apply_updates(b, (1, 0))
        self.jstate = jstate
        mgr = jcc.Bundle(CHANNEL, jcg.genesis_config(jcg.Profile(CHANNEL, application_orgs=[
            jcg.OrgProfile(o.msp_id, o.msp()) for o in net["orgs"]]))).msp_manager
        self.jv = JBlockValidator(mgr, JPolicyProvider(
            {SBE_CC: JNamespaceInfo(policy=jpol.from_dsl(SBE_NS))}), jstate)
        rows = [(ns, k, vv.value, vv.version, vv.metadata) for (ns, k), vv in jstate.iter_all()]
        pstate, _, _ = carry.from_reference(rows, {}, [])
        pcfg = cc.bundle_from_genesis(CHANNEL, M.Block.parse(jcg.genesis_block(jcg.Profile(
            CHANNEL, application_orgs=[jcg.OrgProfile(o.msp_id, o.msp())
                                       for o in net["orgs"]])).SerializeToString()))
        self.pv = pv.BlockValidator(pv.PolicyProvider(
            {SBE_CC: pv.NamespaceInfo(policy=pol.from_dsl(SBE_NS))}), pstate, device="cpu",
            msp=pcfg.msp_manager)

    def run(self, envs, num, commit=True):
        blk = pu.new_block(num, b"prev")
        for e in envs:
            blk.data.data.append(e)
        blk = pu.finalize_block(blk)
        jflt, jbatch, jhist = self.jv.validate(blk)
        flt, batch, hist = self.pv.validate(M.Block.parse(blk.SerializeToString()))
        assert bytes(flt) == bytes(jflt)
        assert _meta_rows(batch) == _meta_rows(jbatch) and list(hist) == list(jhist)
        assert self.pv.state.meta_count == self.jstate.meta_count
        if commit:
            self.jstate.apply_updates(jbatch, (num, 0))
            self.pv.state.apply_updates(batch)
        return list(jflt), jbatch


def test_sbe_key_policy_enforced_cross_block(net, pverify):
    both = _Both(net)
    assert both.run([_sbe_tx(net, [0], writes=[("k", b"v0")], meta={"k": _meta("Org2MSP")})],
                    2)[0] == [C.VALID]
    assert both.run([_sbe_tx(net, [0], writes=[("k", b"v1")])], 3, commit=False)[0] == \
        [C.ENDORSEMENT_POLICY_FAILURE]
    assert both.run([_sbe_tx(net, [1], writes=[("k", b"v2")])], 3, commit=False)[0] == [C.VALID]
    assert both.run([_sbe_tx(net, [0], writes=[("unrelated", b"x")])], 3)[0] == [C.VALID]


def test_sbe_in_block_policy_takes_effect_for_later_txs(net, pverify):
    both = _Both(net)
    flt, batch = both.run([
        _sbe_tx(net, [0], writes=[("k", b"v")], meta={"k": _meta("Org2MSP")}),
        _sbe_tx(net, [0], writes=[("k", b"later")]),
        _sbe_tx(net, [1], writes=[("k", b"fine")])], 2)
    assert flt == [C.VALID, C.ENDORSEMENT_POLICY_FAILURE, C.VALID]
    assert batch.updates[(SBE_CC, "k")].value == b"fine"


def test_sbe_policy_change_requires_current_policy(net, pverify):
    both = _Both(net, seed=[("k", b"v", None)])
    assert both.run([_sbe_tx(net, [0], meta={"k": _meta("Org2MSP")})], 2)[0] == [C.VALID]
    assert both.run([_sbe_tx(net, [0], meta={"k": _meta("Org1MSP")})], 3, commit=False)[0] == \
        [C.ENDORSEMENT_POLICY_FAILURE]
    assert both.run([_sbe_tx(net, [1], meta={"k": _meta("Org1MSP")})], 3)[0] == [C.VALID]
    assert both.run([_sbe_tx(net, [0], writes=[("k", b"w")])], 4, commit=False)[0] == [C.VALID]
    assert both.run([_sbe_tx(net, [1], writes=[("k", b"w")])], 4, commit=False)[0] == \
        [C.ENDORSEMENT_POLICY_FAILURE]


def test_sbe_policy_delete_falls_back_to_namespace(net, pverify):
    both = _Both(net, seed=[("k", b"v", None)])
    both.run([_sbe_tx(net, [0], meta={"k": _meta("Org2MSP")})], 2)
    assert both.pv.state.meta_count == 1
    assert both.run([_sbe_tx(net, [1], meta={"k": {}})], 3)[0] == [C.VALID]
    assert both.pv.state.meta_count == 0
    assert both.pv.state.get_state(SBE_CC, "k").metadata is None
    assert both.run([_sbe_tx(net, [0], writes=[("k", b"w")])], 4)[0] == [C.VALID]


def test_sbe_metadata_write_on_absent_key_is_noop(net, pverify):
    both = _Both(net)
    flt, batch = both.run([_sbe_tx(net, [0], meta={"ghost": _meta("Org2MSP")}),
                           _sbe_tx(net, [0], reads=[("ghost", None)], writes=[("out", b"x")])], 2)
    assert flt == [C.VALID, C.VALID] and (SBE_CC, "ghost") not in batch.updates
    assert both.pv.state.get_state(SBE_CC, "ghost") is None


def test_sbe_metadata_write_bumps_version_for_mvcc(net, pverify):
    both = _Both(net, seed=[("k", b"v", None)])
    flt, batch = both.run([_sbe_tx(net, [0], meta={"k": _meta("Org1MSP")}),
                           _sbe_tx(net, [0], reads=[("k", (1, 0))], writes=[("out", b"x")])], 2)
    assert flt == [C.VALID, C.MVCC_READ_CONFLICT]
    assert (batch.updates[(SBE_CC, "k")].value, batch.updates[(SBE_CC, "k")].version) == \
        (b"v", (2, 0))
    assert both.run([_sbe_tx(net, [0], reads=[("k", (1, 0))], writes=[("o2", b"y")])], 3)[0] == \
        [C.MVCC_READ_CONFLICT]


def test_sbe_via_chaincode_stub(net, pverify):
    """The reference's shim surface writes the set (SetStateValidation-
    Parameter through its simulator); both packages validate it, and the
    committed policy reads back from the port's state."""
    from fabric_tpu.peer.chaincode import ChaincodeRuntime, Contract, Response
    from fabric_tpu.peer.simulator import TxSimulator

    class EPContract(Contract):
        def lock(self, stub, key, msp):
            stub.put_state(key.decode(), b"locked")
            stub.set_state_validation_parameter(key.decode(), _sbe_policy(msp.decode()))
            return Response(200)

    both = _Both(net)
    rt = ChaincodeRuntime()
    rt.register(SBE_CC, EPContract())
    sim = TxSimulator(both.jstate)
    assert rt.execute(sim, SBE_CC, [b"lock", b"asset1", b"Org2MSP"]).status == 200
    rw, _ = sim.done()
    env = _endorse(net, SBE_CC, rw, [net["peers"][0]], b"stub")
    assert both.run([env], 2)[0] == [C.VALID]
    from fabric_tpu_torch.ledger.rwset import decode_metadata
    md = both.pv.state.get_state(SBE_CC, "asset1").metadata
    assert decode_metadata(md)[VALIDATION_PARAMETER] == _sbe_policy("Org2MSP")
    assert both.run([_sbe_tx(net, [0], writes=[("asset1", b"x")])], 3, commit=False)[0] == \
        [C.ENDORSEMENT_POLICY_FAILURE]
