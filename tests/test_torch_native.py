"""The port's host C++ (``fabric_tpu_torch/native``, built here with
g++) on the CPU.

* ``blockparse.parse_envelopes`` gives the reference's native arrays
  (``fabric_tpu.native.blockparse``), field by field, on blocks of
  endorser transactions (repeated and many endorsers, deletes, range
  queries), config and idemix-creator envelopes, nil, truncated and
  garbage bytes, and seeded mutations of them
  (``tests/test_native_fuzz.py::_mutate``).  Where the port's DER rule
  (``crypto/ec_ref.py::der_decode_sig``) differs from the reference's
  C, the port follows ``der_decode_sig``.  A block that outgrows the
  first capacity grows it and parses in full.
* Its SHA-256, through the SHA-NI dispatch and the scalar path alone,
  equals ``hashlib`` at every length from 0 to 300 bytes.
* ``ops/p256v3.stage_frame`` (one ``ecprep`` call) is byte-equal to
  ``stage_frame_ref`` on random items, on each edge of admission, and on
  a batch with no admitted row, from int tuples and from ``SigColumns``.
* ``mvccprep.prep`` gives the reference's ``mvcc_prep`` arrays; a
  version given twice takes status 1 in the port.
* ``ops/mvcc.prepare_block_from_flat`` is byte-equal to
  ``prepare_block_static`` (``packed_static``, ``packed_read_pv``, read
  keys, unique pairs, host version check) in both forms.
* On the corpus as wire blocks (config envelopes included), the
  validator's columnar policy groups (``_device_pre_columnar``) equal
  its entry-by-entry groups (``_device_preprocess``) where a block
  allows them, and the plain stage 2 gives the same verdicts over
  either; each config envelope of the corpus, alone in a block, gets the
  JAX ``BlockValidator``'s code.

Exact equality throughout."""

import hashlib
import random
import types

import numpy as np
import pytest
import torch
from test_native_fuzz import _mutate

from fabric_tpu import protoutil as pu
from fabric_tpu.crypto import cryptogen
from fabric_tpu.crypto.msp import MSPManager as JMSPManager
from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.ledger.rwset import TxRWSet as JTxRWSet
from fabric_tpu.native import blockparse as jbp
from fabric_tpu.native import mvccprep_py as jmv
from fabric_tpu.peer import txassembly as txa
from fabric_tpu.peer.validator import BlockValidator as JBlockValidator
from fabric_tpu.peer.validator import PolicyProvider as JPolicyProvider
from fabric_tpu.protos import common_pb2
from fabric_tpu_torch import carry
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.crypto import msp as pmsp
from fabric_tpu_torch.ledger.rwset import TxRWSet
from fabric_tpu_torch.native import blockparse, mvccprep
from fabric_tpu_torch.ops import mvcc, p256v3
from fabric_tpu_torch.peer import device_block
from fabric_tpu_torch.peer import validator as pv
from fabric_tpu_torch.protos import messages as M

CHANNEL, CC = "nativechan", "nativecc"
N_BLOCKS = 8
MUTATED = 160

N_FIELDS = ("ok", "ch_type", "txid_span", "channel_span", "creator_span", "nonce_span",
            "results_span", "events_span", "payload_digest", "txid_digest", "creator_sig_ok",
            "creator_r", "creator_s", "endo_start", "endo_count", "creator_uid")
M_FIELDS = ("e_endorser_span", "e_digest", "e_r", "e_s", "e_ok", "e_uid", "e_dup")


@pytest.fixture(scope="module")
def net():
    org1 = cryptogen.generate_org("Org1MSP", "org1.native.example.com", peers=2, users=1)
    org2 = cryptogen.generate_org("Org2MSP", "org2.native.example.com", peers=1)
    return {
        "pmgr": pmsp.MSPManager({o.msp_id: pmsp.MSP(o.msp_id, [o.ca.cert_pem])
                                 for o in (org1, org2)}),
        "jmgr": JMSPManager({o.msp_id: o.msp() for o in (org1, org2)}),
        "client": cryptogen.signing_identity(org1, "User1@org1.native.example.com"),
        "peers": [cryptogen.signing_identity(org1, "peer0.org1.native.example.com"),
                  cryptogen.signing_identity(org1, "peer1.org1.native.example.com"),
                  cryptogen.signing_identity(org2, "peer0.org2.native.example.com")],
    }


def _rwset(rng) -> JTxRWSet:
    tx = JTxRWSet()
    for ns in rng.sample([CC, "other", "ü-ns"], rng.randrange(1, 3)):
        n = tx.ns_rwset(ns)
        for _ in range(rng.randrange(0, 4)):
            n.reads[f"k{rng.randrange(12)}"] = rng.choice([None, (1, rng.randrange(5))])
        for _ in range(rng.randrange(0, 4)):
            n.writes[f"k{rng.randrange(12)}"] = rng.choice([None, b"", b"v%d" % rng.random()])
        if rng.random() < 0.1:
            n.range_queries.append(("k0", "k5", [("k1", (1, 1))]))
    return tx


def _envelope(net, rng, endorsers=None) -> bytes:
    rw = _rwset(rng).to_proto().SerializeToString()
    _, _, prop = txa.create_signed_proposal(net["client"], CHANNEL, CC, [b"i", b"%d" % rng.random()])
    if endorsers is None:
        k = rng.random()
        endorsers = (rng.sample(net["peers"], 2) if k < 0.6 else
                     [net["peers"][0]] * 2 if k < 0.8 else list(net["peers"]))
    resps = [txa.create_proposal_response(prop, rw, p, CC) for p in endorsers]
    return txa.assemble_transaction(prop, resps, net["client"]).SerializeToString()


def _with_header(raw: bytes, **ch_fields) -> bytes:
    env = common_pb2.Envelope.FromString(raw)
    payload = common_pb2.Payload.FromString(env.payload)
    ch = common_pb2.ChannelHeader.FromString(payload.header.channel_header)
    for k, v in ch_fields.items():
        setattr(ch, k, v)
    payload.header.channel_header = ch.SerializeToString()
    env.payload = payload.SerializeToString()
    return env.SerializeToString()


def _idemix_creator(raw: bytes) -> bytes:
    env = common_pb2.Envelope.FromString(raw)
    payload = common_pb2.Payload.FromString(env.payload)
    sh = common_pb2.SignatureHeader.FromString(payload.header.signature_header)
    sh.creator = common_pb2.SerializedIdentity(mspid="IdemixMSP",
                                               id_bytes=b"\x01nym").SerializeToString()
    payload.header.signature_header = sh.SerializeToString()
    env.payload = payload.SerializeToString()
    return env.SerializeToString()


def _with_signature(raw: bytes, sig: bytes) -> bytes:
    env = common_pb2.Envelope.FromString(raw)
    env.signature = sig
    return env.SerializeToString()


@pytest.fixture(scope="module")
def corpus(net):
    """N_BLOCKS blocks of envelopes: endorser transactions, a config
    envelope, an idemix creator, nil/garbage/truncated bytes, and
    MUTATED seeded mutations spread over them."""
    rng = random.Random(0xB10C)
    base = [_envelope(net, rng) for _ in range(24)]
    special = [_with_header(base[0], type=1), _idemix_creator(base[1]), b"", b"\x13garbage",
               base[2][:len(base[2]) // 2]]
    envs = base + special + [_mutate(rng, rng.choice(base)) for _ in range(MUTATED)]
    rng.shuffle(envs)
    k = -(-len(envs) // N_BLOCKS)
    return [envs[i:i + k] for i in range(0, len(envs), k)]


# ---------------------------------------------------------------------------
# Columnar policy groups on the corpus

CORPUS_POLICIES = {CC: "OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer')",
                   "other": "OutOf(1, 'Org1MSP.member', 'Org2MSP.peer')"}  # "ü-ns": unknown


@pytest.fixture(scope="module")
def corpus_blocks(net, corpus):
    """The corpus as wire blocks: the port refuses none of its envelopes
    now, and the config envelope (with any mutation that became one) is
    kept — each is parsed alone first."""
    v = _corpus_validator(net)
    out, refused, configs = [], 0, []
    for b, envs in enumerate(corpus):
        keep = []
        for e in envs:
            blk = M.Block(header=M.BlockHeader(number=2 + b), data=M.BlockData(data=[e]))
            try:
                _, txs, _ = v._parse_wire(blk)
            except NotImplementedError:
                refused += 1
                continue
            if txs[0].is_config:
                configs.append(e)
            keep.append(e)
        out.append(M.Block(header=M.BlockHeader(number=2 + b), data=M.BlockData(data=keep)))
    assert refused == 0 and 1 <= len(configs) <= 4
    net["configs"] = configs
    return out


def test_corpus_config_envelopes_match_reference(net, corpus_blocks):
    """Each config envelope the corpus keeps, alone in block 3: the
    port's code is the JAX ``BlockValidator``'s (no config processor
    on either side: the creator check, then the ConfigEnvelope parse)."""
    for e in net["configs"]:
        raw = M.Block(header=M.BlockHeader(number=3), data=M.BlockData(data=[e]))
        jblk = common_pb2.Block.FromString(raw.serialize())
        jflt, _, _ = JBlockValidator(net["jmgr"], JPolicyProvider({}), JMemDB()).validate(jblk)
        flt, _, _ = _corpus_validator(net).validate(raw)
        assert bytes(flt) == bytes(jflt)


def _corpus_validator(net, state=None):
    db, prov, _ = carry.from_reference([], CORPUS_POLICIES, [])
    return pv.BlockValidator(prov, state or db, device="cpu", msp=net["pmgr"])


def _stage2_verdicts(dpre, txs, n_items: int, seed: int) -> torch.Tensor:
    """The plain stage 2 over ``dpre`` with seeded signature bits and
    version checks: the packed verdicts (valid, conflict, phantom,
    creator, policy, the safe bits)."""
    rng = np.random.default_rng(seed)
    sig = torch.from_numpy(rng.random(p256v3._bucket(max(n_items, 1))) < 0.85)
    T = dpre.static_t.shape[0]
    lv = np.zeros((T, 3), np.int32)
    lv[:, 0] = -1
    for t in txs:
        if t.undetermined:
            lv[t.idx] = (t.creator_item_idx, 1, rng.random() < 0.9)
    return device_block.stage2_ref(sig, torch.from_numpy(lv), dpre.groups, dpre.static_t,
                                   dpre.static.dims)


@pytest.mark.parametrize("block", range(N_BLOCKS))
def test_columnar_groups_match_entry_groups_on_corpus(net, corpus_blocks, block):
    """``_device_pre_columnar`` gives ``_device_preprocess``'s codes,
    gp arrays (the match row of every (tx, endorser) pair), static
    arrays and stage-2 verdicts, or returns None exactly when a live
    transaction is not a flat column row."""
    blk = corpus_blocks[block]
    v = _corpus_validator(net)
    wb, txs, items = v._parse_wire(blk)
    wb2, txs2, _ = v._parse_wire(blk)
    live = np.array([t.undetermined and not t.is_config for t in txs2])
    col = v._device_pre_columnar(txs, wb)
    gen = v._device_preprocess(txs2, wb2)
    assert (col is None) == bool((live & ~wb2.flat).any())
    if col is not None:
        assert [t.code for t in txs] == [t.code for t in txs2]
        assert [(p.principals, E, S) for p, _, E, S in col.groups] == \
            [(p.principals, E, S) for p, _, E, S in gen.groups]
        assert [g.numpy().tobytes() for _, g, _, _ in col.groups] == \
            [g.numpy().tobytes() for _, g, _, _ in gen.groups]
        assert col.static.packed_static().tobytes() == gen.static.packed_static().tobytes()
        assert torch.equal(_stage2_verdicts(col, txs, len(items), block),
                           _stage2_verdicts(gen, txs2, len(items), block))


@pytest.mark.parametrize("block", range(N_BLOCKS))
def test_columnar_groups_on_corpus_column_rows(net, corpus_blocks, block):
    """The block's envelopes that the C walk carries and whose sets it
    flattens (mutations included; random nonces make the rest of the
    corpus take either path): the columnar groups are taken and
    equal the entry-by-entry groups."""
    envs = list(corpus_blocks[block].data.data)
    pb = blockparse.parse_envelopes(envs)
    ok = pb.ok.astype(bool)
    flat = ok & (mvccprep.prep(pb, ok).status == 0)
    blk = M.Block(header=M.BlockHeader(number=2 + block),
                  data=M.BlockData(data=[e for e, f in zip(envs, flat) if f]))
    v = _corpus_validator(net)
    (wb, txs, items), (wb2, txs2, _) = v._parse_wire(blk), v._parse_wire(blk)
    col, gen = v._device_pre_columnar(txs, wb), v._device_preprocess(txs2, wb2)
    assert col is not None and flat.sum() >= 2
    assert [t.code for t in txs] == [t.code for t in txs2]
    assert [g.numpy().tobytes() for _, g, _, _ in col.groups] == \
        [g.numpy().tobytes() for _, g, _, _ in gen.groups]
    assert col.static.packed_static().tobytes() == gen.static.packed_static().tobytes()
    assert torch.equal(_stage2_verdicts(col, txs, len(items), block),
                       _stage2_verdicts(gen, txs2, len(items), block))


def _same_parse(port, ref):
    for f in N_FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)
    m = port.n_endorsements
    assert m == int(ref.endo_count.sum())
    for f in M_FIELDS:
        np.testing.assert_array_equal(getattr(port, f)[:m], getattr(ref, f)[:m], err_msg=f)
    assert port.n_ids == ref.n_ids
    np.testing.assert_array_equal(port.ident_span[:port.n_ids], ref.ident_span[:ref.n_ids])
    assert port.blob == ref.blob


@pytest.mark.parametrize("block", range(N_BLOCKS))
def test_parse_envelopes_matches_reference(corpus, block):
    envs = corpus[block]
    port, ref = blockparse.parse_envelopes(envs), jbp.parse_envelopes(envs)
    _same_parse(port, ref)
    assert port.ok.any() and not port.ok.all()


def test_parse_envelopes_grows_its_capacity(net):
    """One envelope of 12 endorsements: past the first capacity (8), so
    the arrays grow; every endorsement's digest is hashlib's."""
    rng = random.Random(7)
    env = _envelope(net, rng, endorsers=[net["peers"][j % 3] for j in range(12)])
    pb = blockparse.parse_envelopes([env])
    assert pb.ok.tolist() == [1] and pb.endo_count.tolist() == [12]
    assert pb.e_dup[:12].tolist() == [0, 0, 0] + [1] * 9
    e = common_pb2.Envelope.FromString(env)
    _, _, cap, _, _ = pu.extract_action(e)
    prp = cap.action.proposal_response_payload
    for j, end in enumerate(cap.action.endorsements):
        assert pb.e_digest[j].tobytes() == hashlib.sha256(prp + end.endorser).digest()
    assert pb.payload_digest[0].tobytes() == hashlib.sha256(e.payload).digest()


def _der(r: bytes, s: bytes, long_outer: bool = False) -> bytes:
    body = b"\x02" + bytes([len(r)]) + r + b"\x02" + bytes([len(s)]) + s
    return b"\x30" + (b"\x81" if long_outer else b"") + bytes([len(body)]) + body


@pytest.mark.parametrize("kind", ["valid", "long_form_length", "oversize_integer",
                                  "negative", "not_minimal", "trailing"])
def test_creator_der_follows_the_ports_decoder(net, kind):
    """The creator signature's DER as the port's ``der_decode_sig``
    reads it: decoded (ok, r, s), refused (creator_sig_ok 0), or an
    INTEGER past 32 bytes (the front end decides: ok 0)."""
    env = _envelope(net, random.Random(3))
    r, s = b"\x01" * 32, b"\x02" * 32
    sig = {"valid": _der(r, s), "long_form_length": _der(r, s, long_outer=True),
           "oversize_integer": _der(b"\x01" * 33, s), "negative": _der(b"\x81" + r[1:], s),
           "not_minimal": _der(b"\x00\x01" + r[2:], s), "trailing": _der(r, s) + b"\x00"}[kind]
    pb = blockparse.parse_envelopes([_with_signature(env, sig)])
    try:
        want = ec_ref.der_decode_sig(sig)
    except ValueError:
        want = None
    if want is not None and max(want) >= 1 << 256:
        assert pb.ok.tolist() == [0]
        return
    assert pb.ok.tolist() == [1]
    assert pb.creator_sig_ok.tolist() == [want is not None]
    if want is not None:
        got = (int.from_bytes(pb.creator_r[0].tobytes(), "big"),
               int.from_bytes(pb.creator_s[0].tobytes(), "big"))
        assert got == want


@pytest.mark.parametrize("scalar", [False, True])
def test_sha256_matches_hashlib_at_every_length(scalar):
    rng = random.Random(11)
    for n in range(301):
        data = rng.randbytes(n)
        assert blockparse.sha256(data, scalar=scalar) == hashlib.sha256(data).digest(), n


# ---------------------------------------------------------------------------
# Signature staging

N, P, HALF_N = ec_ref.N, ec_ref.P, ec_ref.HALF_N


def _signed(rng, n):
    out = []
    for _ in range(n):
        k = ec_ref.SigningKey(rng.randrange(1, N))
        e = rng.getrandbits(256)
        out.append((e, *k.sign_digest(e), *k.public))
    return out


def _edges(rng):
    """One item on each edge of admission, from a signed base."""
    e, r, s, qx, qy = _signed(rng, 1)[0]
    return [(e, 0, s, qx, qy), (e, N, s, qx, qy), (e, r, HALF_N, qx, qy),
            (e, r, HALF_N + 1, qx, qy), (e, r, N, qx, qy), (e, r, 0, qx, qy),
            (e, r, s, P, qy), (e, r, s, qx, P + 1), (e, r, s, 0, 0), (e, P - N, s, qx, qy),
            (e, P - N - 1, s, qx, qy), (e, N - 1, s, qx, qy), ((1 << 300) + e, r, s, qx, qy),
            (-e, r, s, qx, qy), (e, -r, s, qx, qy), (e, r, s, 1 << 256, qy),
            (e, 1 << 256, s, qx, qy), (0, r, s, qx, qy)]


@pytest.mark.parametrize("case", ["random", "edges", "no_admitted_row", "empty"])
def test_stage_frame_matches_plain_version(case):
    rng = random.Random(case)
    items = {"random": lambda: _signed(rng, 40),
             "edges": lambda: _edges(rng) + _signed(rng, 6),
             "no_admitted_row": lambda: [it for it in _edges(rng)
                                         if not p256v3.admit(*it)],
             "empty": lambda: []}[case]()
    if case == "no_admitted_row":
        assert len(items) >= 10
    for pad in (None, 64):
        got, want = p256v3.stage_frame(items, pad), p256v3.stage_frame_ref(items, pad)
        assert got.dtype == want.dtype == np.int16 and got.tobytes() == want.tobytes()
    if case == "edges":
        assert 0 < int(got[:, p256v3._PRE_OK].sum()) < len(items)
    if items:  # a frame shorter than the batch is refused, not overrun
        with pytest.raises(ValueError):
            p256v3.stage_frame(items, len(items) - 1)


def test_stage_frame_of_sig_columns_matches_tuples():
    """``SigColumns`` (rows gathered per identity, tuples appended) and
    its tuples stage to one frame; iterating gives those tuples."""
    rng = random.Random(5)
    keys = [ec_ref.SigningKey(rng.randrange(1, N)) for _ in range(3)]
    idents = [types.SimpleNamespace(qx=k.public[0], qy=k.public[1]) for k in keys]
    idents.append(types.SimpleNamespace(qx=0, qy=0))  # Q = (0, 0): rejected
    rows, q_idx = [], []
    for j in range(20):
        u = j % 4
        e = rng.getrandbits(256)
        r, s = keys[u % 3].sign_digest(e)
        rows.append((e, r, s if j != 7 else N - s))
        q_idx.append(u)
    pack = lambda vals: p256v3.pack256(vals)[0]
    pool = np.concatenate([pack([i.qx for i in idents]), pack([i.qy for i in idents])], 1)
    cols = p256v3.SigColumns(pack([x[0] for x in rows]), pack([x[1] for x in rows]),
                             pack([x[2] for x in rows]), np.array(q_idx, np.int32), pool,
                             p256v3.q_admit(pool), idents)
    extra = _edges(rng)[:5]
    cols.extra = list(extra)
    tuples = list(cols)
    assert tuples[:20] == [(*x, idents[u].qx, idents[u].qy) for x, u in zip(rows, q_idx)]
    assert tuples[20:] == extra and len(cols) == 25
    assert p256v3.stage_frame(cols, 32).tobytes() == p256v3.stage_frame_ref(tuples, 32).tobytes()


# ---------------------------------------------------------------------------
# Read/write sets


def _rw_block(seed: int, n: int = 40):
    """n port read/write sets (some with range queries) as one blob with
    results spans, the form ``mvccprep.prep`` reads."""
    rng = random.Random(seed)
    sets = []
    for _ in range(n):
        tx = TxRWSet()
        for ns in rng.sample(["a", "b", "nsé", "zz"], rng.randrange(0, 3)):
            m = tx.ns_rwset(ns)
            for _ in range(rng.randrange(0, 5)):
                m.reads[f"k{rng.randrange(30)}"] = rng.choice([None, (1, rng.randrange(4)),
                                                               (2**31 + 5, 3)])
            for _ in range(rng.randrange(0, 4)):
                m.writes[f"k{rng.randrange(30)}"] = rng.choice([None, b"", b"x%d" % rng.random()])
            if rng.random() < 0.05:
                m.range_queries.append(("k1", "k3", []))
        sets.append(tx)
    raws = [tx.to_bytes() for tx in sets]
    raws[3] = b"\x12\x05trunc"  # does not parse: status 1
    offs = np.cumsum([0] + [len(r) for r in raws[:-1]])
    spans = np.array([[o, len(r)] for o, r in zip(offs, raws)], np.int64)
    spans[5] = (-1, 0)  # no results field: status 2
    return sets, types.SimpleNamespace(blob=b"".join(raws), results_span=spans)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_mvcc_prep_matches_reference(seed):
    _, pb = _rw_block(seed)
    use = np.random.default_rng(seed).random(len(pb.results_span)) < 0.9
    got, ref = mvccprep.prep(pb, use), jmv.prep(pb, use)
    for f in ("status", "tx_ns_start", "tx_ns_count", "r_start", "r_count", "w_start",
              "w_count"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert (got.n_ns, got.n_keys, got.n_reads, got.n_writes) == \
        (ref.n_ns, ref.n_keys, ref.n_reads, ref.n_writes)
    for f, k in (("r_uid", got.n_reads), ("r_has_ver", got.n_reads), ("r_ver", got.n_reads),
                 ("w_uid", got.n_writes), ("w_is_del", got.n_writes),
                 ("w_key_span", got.n_writes), ("w_val_span", got.n_writes),
                 ("ns_of_ukey", got.n_keys), ("ukey_span", got.n_keys),
                 ("ns_span", got.n_ns), ("ns_ids_flat", len(got.ns_ids_flat))):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f)[:k], err_msg=f)
    assert {0, 1, 2} <= set(got.status.tolist())
    assert got.ns_names() == ref.ns_names() and got.ukey_strs() == ref.ukey_strs()


def test_mvcc_prep_repeated_version_takes_status_1():
    """A KVRead with its version twice: the codec merges the two, so the
    port parses that set in Python (the reference's walk keeps the last)."""
    read = b"\x0a\x01k" + b"\x12\x04\x08\x03\x10\x04" + b"\x12\x02\x08\x07"
    kv = b"\x0a" + bytes([len(read)]) + read
    ns = b"\x0a\x02cc\x12" + bytes([len(kv)]) + kv
    raw = b"\x12" + bytes([len(ns)]) + ns
    rw = TxRWSet.from_bytes(raw)
    assert rw.ns["cc"].reads == {"k": (7, 4)}  # merged: block 7, tx 4
    pb = types.SimpleNamespace(blob=raw, results_span=np.array([[0, len(raw)]], np.int64))
    assert mvccprep.prep(pb, np.ones(1, bool)).status.tolist() == [1]
    assert jmv.prep(pb, np.ones(1, bool)).status.tolist() == [0]


@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_prepare_block_from_flat_matches_static(seed, unique):
    sets, pb = _rw_block(seed)
    rwp = mvccprep.prep(pb, np.ones(len(sets), bool))
    rng = np.random.default_rng(seed)
    include = (rwp.status == 0) & (rng.random(len(sets)) < 0.85)
    _, _, keys, rank = rwp.key_table()
    got = mvcc.prepare_block_from_flat(rwp, include, rank, keys, unique=unique)
    txs = []
    for tx, inc in zip(sets, include):
        reads, writes, rqs = tx.mvcc_form() if inc else ([], [], [])
        txs.append(mvcc.TxRWSet(reads=reads, writes=writes, range_reads=rqs))
    want = mvcc.prepare_block_static(txs, bucketed=True, unique=unique)
    assert got.packed_static().tobytes() == want.packed_static().tobytes()
    assert got.packed_read_pv().tobytes() == want.packed_read_pv().tobytes()
    assert got.dims == want.dims and got.read_key_set == want.read_key_set
    assert got.u_pairs == want.u_pairs and got.u_index == want.u_index
    committed = {k: rng.choice([(1, 0), (1, 1), (2, 0)])
                 for k in sorted(want.read_key_set) if rng.random() < 0.7}
    np.testing.assert_array_equal(got.host_ver_ok(committed), want.host_ver_ok(committed))
    assert include.sum() >= 25
