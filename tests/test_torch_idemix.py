"""Idemix creators through the port on the CPU, against the JAX package.

* The scheme: with the reference's ``secrets`` calls drawn from the
  seeded ``random.Random`` the port takes (``_seeded_reference``), both
  packages make the same issuer key, epoch records, credentials and
  presentations, byte for byte.  Presentations made by either package
  get the same verdict under both verifiers: honest ones, a wrong
  message, OU or role, tampered bytes, the no-credential and
  small-exponent forgeries, and epoch revocation (the reference's
  ``tests/test_idemix.py`` cases).
* Bytes: ``IssuerPublicKey.to_json``, ``EpochRecord`` and
  ``IdemixMSP.to_config`` equal the reference's; a genesis config with
  an idemix org equals the reference's ``configtxgen``'s; a forged epoch
  record is refused by both.
* Identities: deserialization and principal matching equal the
  reference MSP manager's.
* Whole blocks: a channel of three X.509 orgs and an idemix org, its
  genesis block from the reference's ``configtxgen``, then the
  reference's ``test_anonymous_creator_through_validator`` and
  ``..._native_parse_fallback`` blocks, a mixed block of 20
  transactions, an epoch-record rotation co-signed by the idemix org's
  admin, blocks under the new record (a revoked holder, re-issued
  holders) and config updates an idemix admin co-signs.  The JAX
  ``BlockValidator`` (its ``ConfigTxProcessor``, committed configs
  applied as the peer applies them) gives each block's filter, update
  batch and history; the port gives the same through ``CommitPipeline``
  at depths 1-3 (the stale re-preprocess after a rotation verifies the
  proofs again, under the new record), the ``DecodedBlock`` entry,
  ``submit_many`` with and without a staging pool, the forced host
  path, ``state_resident=True`` and ``SidecarValidator``.  A wire block
  with idemix creators stays on the columnar parse and group builder.

Issuer keys are 1024-bit, as the reference's tests use.  Exact equality
throughout."""

import contextlib
import json
import random
import types

import pytest
import torch
from test_torch_coalesce import _RowVerify
from test_torch_config import _pinned_config_order  # noqa: F401 — an autouse fixture
from test_torch_wire import _CachedVerify

from fabric_tpu import channelconfig as jcc
from fabric_tpu import protoutil as pu
from fabric_tpu.crypto import cryptogen
from fabric_tpu.crypto import ec_ref as jec_ref
from fabric_tpu.crypto import idemix as jidx
from fabric_tpu.crypto import policy as jpol
from fabric_tpu.crypto.msp import MSPManager as JMSPManager
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
from fabric_tpu_torch.crypto import ec_ref as pec_ref
from fabric_tpu_torch.crypto import idemix as pidx
from fabric_tpu_torch.crypto import msp as pmsp
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.ops import p256v3
from fabric_tpu_torch.peer import frontend
from fabric_tpu_torch.peer import validator as pv
from fabric_tpu_torch.peer.pipeline import CommitPipeline
from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
from fabric_tpu_torch.protos import messages as M
from fabric_tpu_torch.sidecar import SidecarServer
from fabric_tpu_torch.sidecar.validator import SidecarValidator
from fabric_tpu_torch.tools import configtxgen as cg

SEED = 20261018
IDX = "IdemixOrgMSP"
CHANNEL = "idxchan"
CC = "idxcc"
POLICY = "OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')"
ROLES = {"alice": "client", "bob": "client", "carol": "client", "admin": "admin"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Secrets:
    """The ``secrets`` calls of the reference's ``idemix`` and
    ``ec_ref``, drawn from a seeded ``random.Random`` as the port draws
    from its ``rng``."""

    def __init__(self, rng):
        self.rng = rng

    def randbits(self, k):
        return self.rng.getrandbits(k)

    def randbelow(self, n):
        return self.rng.randrange(n)

    def token_hex(self, n):
        return self.rng.getrandbits(8 * n).to_bytes(n, "big").hex()


@contextlib.contextmanager
def _seeded_reference(seed):
    with pytest.MonkeyPatch.context() as mp:
        shim = _Secrets(random.Random(seed))
        mp.setattr(jidx, "secrets", shim)
        mp.setattr(jec_ref, "secrets", shim)
        yield


def _enroll(pkg, issuer, role, handle=None, holder=None, rng=None):
    """(holder, credential) of ``role`` in the issuer's current epoch."""
    if holder is None:
        holder = pkg.IdemixHolder(issuer.ipk) if rng is None else \
            pkg.IdemixHolder(issuer.ipk, rng)
    U, proof = holder.commitment()
    A, e, v = issuer.issue(U, proof, ou="org1", role=role, handle=handle)
    return holder, holder.assemble(A, e, v, ou="org1", role=role, epoch=issuer.epoch)


@pytest.fixture(scope="module")
def both():
    """One seed through both packages: issuer, a holder, its credential."""
    with _seeded_reference(SEED):
        jiss = jidx.IdemixIssuer(IDX, bits=1024)
        jh, jcred = _enroll(jidx, jiss, "client")
    rng = random.Random(SEED)
    piss = pidx.IdemixIssuer(IDX, bits=1024, rng=rng)
    ph, pcred = _enroll(pidx, piss, "client", rng=rng)
    return {"j": (jiss, jcred), "p": (piss, pcred)}


def _cred_tuple(c):
    return (c.A, c.e, c.v, c.sk, c.ou, c.role, c.epoch)


def test_seeded_issuance_is_byte_equal(both):
    (jiss, jcred), (piss, pcred) = both["j"], both["p"]
    assert piss.ipk.to_json() == jiss.ipk.to_json()
    assert piss.ipk.key_digest() == jiss.ipk.key_digest()
    assert piss.epoch_record.to_json() == jiss.epoch_record.to_json()
    assert piss.epoch_record.digest(piss.ipk) == jiss.epoch_record.digest(jiss.ipk)
    assert _cred_tuple(pcred) == _cred_tuple(jcred)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_presentation_is_byte_equal(both, seed):
    (jiss, jcred), (piss, pcred) = both["j"], both["p"]
    msg = b"payload-%d" % seed
    with _seeded_reference(seed):
        jsig = jidx.sign(jiss.ipk, jcred, msg)
    assert pidx.sign(piss.ipk, pcred, msg, random.Random(seed)) == jsig


def test_prime_tests_and_challenge_match(both):
    rng = random.Random(5)
    xs = [rng.getrandbits(200) | 1 for _ in range(40)] + [2, 3, 4, 561, 7919, 2**127 - 1]
    for x in xs:
        with _seeded_reference(x):
            want = jidx._is_probable_prime(x, rounds=8)
        assert pidx._is_probable_prime(x, rounds=8, rng=random.Random(x)) == want
    parts = (both["p"][0].ipk.to_json(), 0, 2**300 + 7, "org1", "client", 3, "ab" * 16, b"m")
    assert pidx._fs_challenge(*parts) == jidx._fs_challenge(*parts)
    assert pidx._attr_int("org1") == jidx._attr_int("org1")


# ---------------------------------------------------------------------------
# Presentations: each package's under both verifiers


def _forge_small_exponent(pkg, ipk, signer_path: bool, rng):
    """The reference's small-exponent forgeries: e = 1 with no
    credential, as a hand-run Σ-protocol or through ``sign``."""
    n = ipk.n
    sk, v = rng.getrandbits(pkg.L_M), rng.getrandbits(n.bit_length())
    ou, role = "org1", "admin"
    z_d = (ipk.Z * pow(ipk.R_ou, -pkg._attr_int(ou), n)
           * pow(ipk.R_role, -pkg._attr_int(role), n)) % n
    A2 = (z_d * pow(ipk.S, -v, n) * pow(ipk.R_sk, -sk, n)) % n
    if signer_path:
        fake = pkg.Credential(A=A2, e=1, v=v, sk=sk, ou=ou, role=role)
        return pkg.sign(ipk, fake, b"msg", rng) if pkg is pidx else pkg.sign(ipk, fake, b"msg")
    r_e = rng.getrandbits(pkg.L_E_PRIME + pkg.L_C + pkg.L_STAT)
    r_v = rng.getrandbits(n.bit_length() + 2 * pkg.L_STAT + pkg.L_C + pkg.L_E)
    r_sk = rng.getrandbits(pkg.L_M + pkg.L_C + pkg.L_STAT)
    t = (pow(A2, r_e, n) * pow(ipk.S, r_v, n) * pow(ipk.R_sk, r_sk, n)) % n
    nonce = "%032x" % rng.getrandbits(128)
    c = pkg._fs_challenge(ipk.to_json(), A2, t, ou, role, nonce, b"msg")
    return json.dumps({"A2": hex(A2), "c": hex(c), "nonce": nonce, "s_e": hex(r_e + c),
                       "s_v": hex(r_v + c * v), "s_sk": hex(r_sk + c * sk)}).encode()


def _presentation(case, pkg, iss, cred, rng):
    """(sig, ou, role, msg, expected verdict) for ``case``, made by ``pkg``."""
    ipk = iss.ipk
    sign = (lambda c, m: pidx.sign(ipk, c, m, rng)) if pkg is pidx else \
        (lambda c, m: jidx.sign(ipk, c, m))
    if case == "honest":
        return sign(cred, b"hello world"), "org1", "client", b"hello world", True
    if case == "wrong_message":
        return sign(cred, b"hello world"), "org1", "client", b"other", False
    if case == "wrong_ou":
        return sign(cred, b"m"), "org2", "client", b"m", False
    if case == "wrong_role":
        return sign(cred, b"m"), "org1", "admin", b"m", False
    if case == "tampered":
        good = bytearray(sign(cred, b"msg"))
        good[20] ^= 1
        return bytes(good), "org1", "client", b"msg", False
    if case == "no_credential":
        fake = pkg.Credential(A=pow(3, 65537, ipk.n), e=pidx._gen_prime(pkg.L_E, rng),
                              v=rng.getrandbits(ipk.n.bit_length()),
                              sk=rng.getrandbits(pkg.L_M), ou="org1", role="client")
        return sign(fake, b"msg"), "org1", "client", b"msg", False
    if case in ("small_exponent", "small_exponent_sign"):
        sig = _forge_small_exponent(pkg, ipk, case == "small_exponent_sign", rng)
        return sig, "org1", "admin", b"msg", False
    raise ValueError(case)


CASES = ["honest", "wrong_message", "wrong_ou", "wrong_role", "tampered", "no_credential",
         "small_exponent", "small_exponent_sign"]


@pytest.mark.parametrize("maker", ["reference", "port"])
@pytest.mark.parametrize("case", CASES)
def test_presentation_verdicts_cross(both, case, maker):
    pkg = jidx if maker == "reference" else pidx
    iss, cred = both["j"] if maker == "reference" else both["p"]
    sig, ou, role, msg, want = _presentation(case, pkg, iss, cred, random.Random(CASES.index(case)))
    assert jidx.verify(both["j"][0].ipk, ou, role, msg, sig) is want
    assert pidx.verify(both["p"][0].ipk, ou, role, msg, sig) is want


def test_presentations_are_unlinkable():
    iss = pidx.IdemixIssuer("U", bits=1024, rng=random.Random(3))
    _, cred = _enroll(pidx, iss, "client", rng=random.Random(4))
    s1, s2 = (json.loads(pidx.sign(iss.ipk, cred, b"m")) for _ in range(2))
    assert s1["A2"] != s2["A2"] and s1["s_sk"] != s2["s_sk"] and s1["c"] != s2["c"]
    with pytest.raises(ValueError, match="bad commitment proof"):
        holder = pidx.IdemixHolder(iss.ipk)
        U, proof = holder.commitment()
        iss.issue(U, {**proof, "s_sk": proof["s_sk"] + 1}, ou="org1", role="client")


@pytest.fixture(scope="module")
def revocation():
    """The reference's ``test_epoch_revocation`` on both packages, from
    one seed: alice and bob enrolled, bob revoked, alice re-issued."""
    out = {}
    for name, pkg in (("j", jidx), ("p", pidx)):
        rng = random.Random(SEED + 1)
        ctx = _seeded_reference(SEED + 1) if pkg is jidx else contextlib.nullcontext()
        with ctx:
            kw = {} if pkg is jidx else {"rng": rng}
            iss = pkg.IdemixIssuer("RevMSP", bits=1024, **kw)
            alice_h, alice = _enroll(pkg, iss, "client", "alice", rng=kw.get("rng"))
            _, bob = _enroll(pkg, iss, "client", "bob", rng=kw.get("rng"))
            rec0 = iss.epoch_record
            iss.revoke("bob")
            rec1 = iss.epoch_record
            _, alice2 = _enroll(pkg, iss, "client", "alice", holder=alice_h)
        out[name] = types.SimpleNamespace(iss=iss, alice=alice, bob=bob, alice2=alice2,
                                          rec0=rec0, rec1=rec1)
    return out


def test_epoch_records_byte_equal(revocation):
    j, p = revocation["j"], revocation["p"]
    assert p.iss.ipk.to_json() == j.iss.ipk.to_json()
    assert (p.rec0.to_json(), p.rec1.to_json()) == (j.rec0.to_json(), j.rec1.to_json())
    assert (p.rec0.epoch, p.rec1.epoch) == (0, 1)
    assert _cred_tuple(p.alice2) == _cred_tuple(j.alice2)
    with pytest.raises(ValueError, match="revoked"):
        _enroll(pidx, p.iss, "client", "bob")
    with pytest.raises(ValueError, match="handle"):
        _enroll(pidx, p.iss, "client", None)


@pytest.mark.parametrize("case", ["epoch0_under_rec0", "bob_under_rec1", "bob_lies_epoch",
                                  "alice2_under_rec1", "alice_old_under_rec1"])
@pytest.mark.parametrize("maker", ["reference", "port"])
def test_epoch_revocation_cross(revocation, case, maker):
    mk = revocation["j"] if maker == "reference" else revocation["p"]
    sign = jidx.sign if maker == "reference" else pidx.sign
    cred, rec, want = {
        "epoch0_under_rec0": ("bob", "rec0", True), "bob_under_rec1": ("bob", "rec1", False),
        "bob_lies_epoch": ("bob", "rec1", False), "alice2_under_rec1": ("alice2", "rec1", True),
        "alice_old_under_rec1": ("alice", "rec1", False)}[case]
    sig = sign(mk.iss.ipk, getattr(mk, cred), b"m")
    if case == "bob_lies_epoch":
        d = json.loads(sig)
        d["epoch"] = 1
        sig = json.dumps(d).encode()
    j, p = revocation["j"], revocation["p"]
    assert jidx.verify(j.iss.ipk, "org1", "client", b"m", sig, getattr(j, rec)) is want
    assert pidx.verify(p.iss.ipk, "org1", "client", b"m", sig, getattr(p, rec)) is want


def test_msp_config_and_epoch_records(revocation):
    j, p = revocation["j"], revocation["p"]
    for rec in (None, "rec0", "rec1"):
        jm = jidx.IdemixMSP("RevMSP", j.iss.ipk, getattr(j, rec) if rec else None)
        pm = pidx.IdemixMSP("RevMSP", p.iss.ipk, getattr(p, rec) if rec else None)
        want = jm.to_config().SerializeToString(deterministic=True)
        assert pm.to_config().serialize() == want == pm.to_proto().serialize()
        back = pidx.IdemixMSP.from_config(M.MSPConfig.parse(want).config)
        assert back.to_config().serialize() == want
        carried = carry.idemix_msp("RevMSP", j.iss.ipk.to_json(),
                                   getattr(j, rec).to_json() if rec else None)
        assert carried.to_config().serialize() == want
    # monotonic adoption; a forged record raises on both
    pm = pidx.IdemixMSP("RevMSP", p.iss.ipk, p.rec0)
    pm.set_epoch_record(p.rec1)
    pm.set_epoch_record(p.rec0)
    assert pm.epoch_record.epoch == 1
    rogue = pec_ref.SigningKey(d=12345)
    fake = pidx.EpochRecord(99, 0, 0)
    fake.r, fake.s = rogue.sign_digest(fake.digest(p.iss.ipk))
    jfake = jidx.EpochRecord.from_json(fake.to_json())
    with pytest.raises(ValueError):
        pm.set_epoch_record(fake)
    forged = json.loads(pidx.IdemixMSP("RevMSP", p.iss.ipk, fake).to_config().config)
    raw = json.dumps(forged, sort_keys=True).encode()
    with pytest.raises(ValueError):
        pidx.IdemixMSP.from_config(raw)
    with pytest.raises(ValueError):
        jidx.IdemixMSP.from_config(raw)
    with pytest.raises(ValueError):
        jidx.IdemixMSP("RevMSP", j.iss.ipk).set_epoch_record(jfake)
    with pytest.raises(ValueError):
        carry.idemix_msp("RevMSP", p.iss.ipk.to_json(), fake.to_json())
    # the revoked holder's presentation fails through the MSP's identity
    ident = pm.deserialize_identity(pidx.IdemixSigningIdentity("RevMSP", p.iss.ipk,
                                                               p.bob).serialized)
    # (every client of OU org1 serializes to these bytes: one identity, many holders)
    assert ident.is_valid and not ident.verify(b"m", pidx.sign(p.iss.ipk, p.bob, b"m"))
    assert ident.verify(b"m", pidx.sign(p.iss.ipk, p.alice2, b"m"))


# ---------------------------------------------------------------------------
# Identities


def _sid(mspid: str, id_bytes: bytes) -> bytes:
    return common_pb2.SerializedIdentity(mspid=mspid, id_bytes=id_bytes).SerializeToString()


IDENTITIES = {
    "client": _sid(IDX, b'{"ou": "org1", "role": "client", "type": "idemix"}'),
    "admin": _sid(IDX, b'{"ou": "org2", "role": "admin", "type": "idemix"}'),
    "no_role": _sid(IDX, b'{"ou": "org1", "type": "idemix"}'),
    "wrong_type": _sid(IDX, b'{"ou": "org1", "role": "client", "type": "x509"}'),
    "not_json": _sid(IDX, b"-----BEGIN CERTIFICATE-----"),
    "json_list": _sid(IDX, b'[1, 2]'),
    "peer_role": _sid(IDX, b'{"ou": "", "role": "peer", "type": "idemix"}'),
}


@pytest.mark.parametrize("name", sorted(IDENTITIES))
def test_identity_and_principals_match_reference(both, name):
    ser = IDENTITIES[name]
    jmgr = JMSPManager()
    jmgr.add(jidx.IdemixMSP(IDX, both["j"][0].ipk))
    pmgr = pmsp.MSPManager()
    pmgr.add(pidx.IdemixMSP(IDX, both["p"][0].ipk))
    ji, pi = jmgr.deserialize_identity(ser), pmgr.deserialize_identity(ser)
    assert (pi.msp_id, pi.role, pi.ou, pi.is_valid) == (ji.msp_id, ji.role, ji.ou_value,
                                                        ji.is_valid)
    assert pi.idemix and not pi.has_ec_key and pmgr.deserialize_identity(ser) is pi
    for msp_id in (IDX, "Org1MSP"):
        for role in ("member", "client", "admin", "peer"):
            assert pol.Principal(msp_id, role).matched_by(pi) == \
                jpol.Principal(msp_id, role).matched_by(ji)


# ---------------------------------------------------------------------------
# The channel: three X.509 orgs and an idemix org


class _Discloses:
    """A holder's signer whose serialized identity discloses other
    attributes than its credential holds (its proofs must fail)."""

    def __init__(self, signer, drop=(), **attrs):
        self.signer = signer
        self.attrs = {"type": "idemix", "ou": signer.cred.ou, "role": signer.cred.role, **attrs}
        for k in drop:
            del self.attrs[k]

    @property
    def serialized(self) -> bytes:
        return _sid(self.signer.msp_id, json.dumps(self.attrs, sort_keys=True).encode())

    def sign(self, message: bytes) -> bytes:
        return self.signer.sign(message)


@pytest.fixture(scope="module")
def net():
    orgs = [cryptogen.generate_org(f"Org{i}MSP", f"org{i}.idx.example.com", peers=1, users=1)
            for i in (1, 2, 3)]
    sid = cryptogen.signing_identity
    with _seeded_reference(SEED + 2):
        iss = jidx.IdemixIssuer(IDX, bits=1024)
        holders = {k: _enroll(jidx, iss, role, k) for k, role in ROLES.items()}
        rec0 = iss.epoch_record
        iss.revoke("bob")
        rec1 = iss.epoch_record
        creds1 = {k: _enroll(jidx, iss, role, k, holder=holders[k][0])[1]
                  for k, role in ROLES.items() if k != "bob"}
    anon0 = {k: jidx.IdemixSigningIdentity(IDX, iss.ipk, c) for k, (_, c) in holders.items()}
    anon1 = {k: jidx.IdemixSigningIdentity(IDX, iss.ipk, c) for k, c in creds1.items()}
    return {
        "orgs": orgs, "iss": iss, "rec0": rec0, "rec1": rec1, "anon0": anon0, "anon1": anon1,
        "peers": [sid(o, f"peer0.org{i}.idx.example.com") for i, o in zip((1, 2, 3), orgs)],
        "admins": [sid(o, f"Admin@{o.domain}") for o in orgs],
        "client": sid(orgs[0], "User1@org1.idx.example.com"),
    }


def test_genesis_with_idemix_org_is_byte_equal(net):
    iss = net["iss"]
    jp = jcg.Profile(CHANNEL, application_orgs=[jcg.OrgProfile(o.msp_id, o.msp())
                                                for o in net["orgs"]]
                     + [jcg.OrgProfile(IDX, jidx.IdemixMSP(IDX, iss.ipk, net["rec0"]))])
    pidx_msp = carry.idemix_msp(IDX, iss.ipk.to_json(), net["rec0"].to_json())
    pp = cg.Profile(CHANNEL, application_orgs=[cg.OrgProfile(o.msp_id, pmsp.MSP(
        o.msp_id, [o.ca.cert_pem])) for o in net["orgs"]] + [cg.OrgProfile(IDX, pidx_msp)])
    assert cg.genesis_config(pp).serialize() == \
        jcg.genesis_config(jp).SerializeToString(deterministic=True)
    bundle = cc.Bundle(CHANNEL, cg.genesis_config(pp))
    got = bundle.msp_manager.msps[IDX]
    assert isinstance(got, pidx.IdemixMSP)
    assert got.to_config().serialize() == pidx_msp.to_config().serialize()


def _seed_batch():
    seed = JUpdateBatch()
    for i in range(10):
        seed.put(CC, f"k{i}", b"v", (1, i))
    return seed


def _seed_rows():
    db = JMemDB()
    db.apply_updates(_seed_batch(), (1, 0))
    return [(ns, key, vv.value, vv.version) for (ns, key), vv in db.iter_all()]


def _tx(net, creator, reads=(), writes=(), endorsers=None, salt=b"s") -> bytes:
    tx = JTxRWSet()
    n = tx.ns_rwset(CC)
    n.reads.update(dict(reads))
    n.writes.update(dict(writes))
    rw = tx.to_proto().SerializeToString()
    _, _, prop = txa.create_signed_proposal(creator, CHANNEL, CC, [salt])
    ends = net["peers"][:2] if endorsers is None else endorsers
    resps = [txa.create_proposal_response(prop, rw, e, CC) for e in ends]
    return txa.assemble_transaction(prop, resps, creator).SerializeToString()


def _tampered(raw: bytes) -> bytes:
    env = common_pb2.Envelope.FromString(raw)
    env.signature = env.signature[:-6] + b"\x00" * 6
    return env.SerializeToString()


def _config_tx(net, state: dict, signers, change: str) -> bytes:
    """A config update of ``change`` against ``state["current"]`` (a
    reference bundle), signed by ``signers``; the bundle advances when
    the reference authorizes it."""
    base = state["current"]
    new = configtx_pb2.Config()
    new.CopyFrom(base.config)
    app = new.channel_group.groups["Application"]
    if change == "rotate":
        app.groups[IDX].values["MSP"].value = jidx.IdemixMSP(
            IDX, net["iss"].ipk, net["rec1"]).to_proto().SerializeToString()
    else:
        app.policies[change].CopyFrom(jcc.config_policy(
            jcc.ImplicitMeta(rule=2, sub_policy=change)))  # MAJORITY
    upd_env = jcg.sign_update(jcg.compute_update(CHANNEL, base.config, new), signers)
    try:
        proposed = jcc.authorize_update(base, upd_env)
        state["current"] = jcc.Bundle(CHANNEL, proposed)
    except jcc.ConfigUpdateError:
        proposed = new
    return jcg.config_tx(CHANNEL, proposed, upd_env, signer=net["admins"][0]).SerializeToString()


def _blocks(net):
    a0, a1, peers, client = net["anon0"], net["anon1"], net["peers"], net["client"]
    admins = net["admins"]
    jp = jcg.Profile(CHANNEL, application_orgs=[jcg.OrgProfile(o.msp_id, o.msp())
                                                for o in net["orgs"]]
                     + [jcg.OrgProfile(IDX, jidx.IdemixMSP(IDX, net["iss"].ipk, net["rec0"]))])
    genesis = jcg.genesis_block(jp)
    state = {"current": jcc.bundle_from_genesis(CHANNEL, genesis)}
    b1 = [_tx(net, a0["alice"], writes=[("a", b"1")]),
          _tampered(_tx(net, a0["alice"], writes=[("b", b"2")]))]
    b2 = [_tx(net, a0["alice"] if i % 3 == 0 else client, writes=[(f"n{i}", b"v")],
              salt=b"%d" % i) for i in range(18)]
    b2[6] = _tampered(b2[6])
    dup = _tx(net, a0["bob"], writes=[("w1", b"x")])
    b3 = [
        _tx(net, a0["alice"], reads=[("k0", (1, 0))], writes=[("k0", b"a")]),
        dup,
        _tx(net, _Discloses(a0["carol"], role="admin"), writes=[("w2", b"x")]),
        _tx(net, client, reads=[("k2", (1, 2))], writes=[("k2", b"c")]),
        _tampered(_tx(net, a0["alice"], writes=[("w4", b"x")])),
        _tampered(_tx(net, client, writes=[("w5", b"x")])),
        _tx(net, client, writes=[("w6", b"x")], endorsers=[peers[0], a0["alice"]]),
        _tx(net, a0["alice"], writes=[("w7", b"x")], endorsers=[peers[1], a0["bob"]]),
        dup,
        _tx(net, _Discloses(a0["alice"], drop=("role",)), writes=[("w9", b"x")]),
        _tx(net, _Discloses(a0["alice"], ou="org9"), writes=[("w10", b"x")]),
        _tx(net, a0["carol"], reads=[("k0", (1, 0))], writes=[("w11", b"x")]),
        _tx(net, a0["bob"], reads=[("k3", (0, 9))], writes=[("w12", b"x")]),
        b"",
        b"\x13garbage-bytes",
        _tx(net, a0["admin"], reads=[("k4", (1, 4))], writes=[("k4", b"adm")]),
        _tx(net, client, writes=[("w16", b"x")]),
        _tx(net, a0["carol"], writes=[("w17", b"x")], endorsers=peers),
        _tx(net, a0["alice"], writes=[("w18", b"x")], endorsers=[peers[2], peers[0]]),
        _tx(net, a0["bob"], reads=[("absent", None)], writes=[("w19", b"x")]),
    ]
    b4 = [_config_tx(net, state, [admins[0], admins[1], a0["admin"]], "rotate")]
    b5 = [_tx(net, a1["alice"], writes=[("r0", b"x")]),
          _tx(net, a0["bob"], writes=[("r1", b"x")]),
          _tx(net, a0["alice"], writes=[("r2", b"x")]),
          _tx(net, a1["carol"], reads=[("k6", (1, 6))], writes=[("k6", b"c")]),
          _tx(net, a1["admin"], writes=[("r4", b"x")]),
          _tx(net, client, writes=[("r5", b"x")])]
    b6 = [_config_tx(net, state, [admins[0], a1["admin"]], "Readers")]
    b7 = [_config_tx(net, state, [admins[0], admins[1], a1["admin"]], "Readers")]
    b8 = [_config_tx(net, state, [admins[0], admins[1], a0["admin"]], "Writers")]
    b9 = [_tx(net, a1["carol"], writes=[("z0", b"x")]), _tx(net, a0["bob"], writes=[("z1", b"x")]),
          _tx(net, client, writes=[("z2", b"x")]), _tx(net, a1["alice"], writes=[("z3", b"x")])]
    blocks = [genesis]
    for num, envs in enumerate([b1, b2, b3, b4, b5, b6, b7, b8, b9], start=1):
        blk = pu.new_block(num, b"prev-%d" % num)
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


def _jprov():
    return JPolicyProvider({CC: JNamespaceInfo(policy=jpol.from_dsl(POLICY))})


def _pprov():
    return pv.PolicyProvider({CC: pv.NamespaceInfo(policy=pol.from_dsl(POLICY))})


@pytest.fixture(autouse=True, scope="module")
def _jverify():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvalidator.p256, "verify_launch", _CachedVerify(jax=True))
        yield


def _reference(blocks):
    state = JMemDB()
    state.apply_updates(_seed_batch(), (1, 0))
    store = _Store()
    proc = jcc.ConfigTxProcessor(jcc.bundle_from_genesis(CHANNEL, blocks[0]))
    v = JBlockValidator(proc.bundle.msp_manager, _jprov(), state, block_store=store,
                        config_processor=proc)
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
        out.append((bytes(flt), _rows(batch), list(hist)))
    return out


@pytest.fixture(scope="module")
def corpus(net):
    blocks = _blocks(net)
    want = _reference(blocks)
    return [M.Block.parse(b.SerializeToString()) for b in blocks], want


@pytest.fixture(scope="module")
def rowverify():
    return _RowVerify()


@pytest.fixture
def pverify(monkeypatch, rowverify):
    monkeypatch.setattr(p256v3, "verify_batch_packed", rowverify)
    return rowverify


def _validator(wire, cls=pv.BlockValidator, **kw):
    state, _, _ = carry.from_reference(_seed_rows(), {}, [])
    proc = cc.ConfigTxProcessor(cc.bundle_from_genesis(CHANNEL, wire[0]))
    v = cls(_pprov(), state, block_store=_Store(), device="cpu", msp=proc.bundle.msp_manager,
            **kw)
    v.config_processor = proc
    return v


def _commit(v):
    def commit(res):
        v.state.apply_updates(res.batch)
        v.blocks.txids.update(t for t, _ in res.txids)
        cc.apply_committed_config(res, v)
    return commit


def _run(v, wire, depth=2, k=0):
    got = []
    try:
        with CommitPipeline(v, _commit(v), depth=depth, coalesce_blocks=k) as pipe:
            if k:
                got += pipe.submit_many(wire)
            else:
                got += [r for r in (pipe.submit(b) for b in wire) if r is not None]
            tail = pipe.flush()
            if tail is not None:
                got.append(tail)
    finally:
        v.close()
    return [(bytes(r.tx_filter), _rows(r.batch), list(r.history)) for r in got], pipe


def _check(got, want):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], (b, list(g[0]), list(w[0]))
        assert g[1] == w[1], b
        assert g[2] == w[2], b


def test_corpus_has_the_intended_verdicts(corpus):
    _, want = corpus
    V, B, E, D, M_, I = (C.VALID, C.BAD_CREATOR_SIGNATURE, C.ENDORSEMENT_POLICY_FAILURE,
                         C.DUPLICATE_TXID, C.MVCC_READ_CONFLICT, C.INVALID_OTHER_REASON)
    flt = [list(f) for f, _, _ in want]
    assert flt[1] == [V, B]
    assert flt[2] == [B if i == 6 else V for i in range(18)]
    assert flt[3] == [V, V, B, V, B, B, E, E, D, B, B, M_, M_, C.NIL_ENVELOPE, C.BAD_PAYLOAD,
                      V, V, V, V, V]
    assert flt[4] == [V]            # the rotation, co-signed by the idemix admin
    assert flt[5] == [V, B, B, V, V, V]  # the revoked holder and an old credential fail
    assert flt[6:9] == [[I], [V], [I]]  # 2 of 4 admins; 3 of 4; a revoked-epoch admin
    assert flt[9] == [V, B, V, V]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_matches_reference(corpus, pverify, depth, monkeypatch):
    """The wire entry through ``CommitPipeline``; at depth > 1 each
    config block is a barrier and its successor, staged before it
    committed, is preprocessed again: after the rotation its proofs are
    verified again, under the new epoch record."""
    wire, want = corpus
    seen: dict = {}
    orig = pidx.IdemixMSP.verify

    def verify(self, ou, role, message, sig):
        ok = orig(self, ou, role, message, sig)
        seen.setdefault(sig, set()).add((self.epoch_record.epoch, ok))
        return ok

    monkeypatch.setattr(pidx.IdemixMSP, "verify", verify)
    got, pipe = _run(_validator(wire), wire, depth=depth)
    _check(got, want)
    if depth > 1:
        assert pipe.barriers == 1 + 4  # the genesis block and the four config blocks
        assert pipe.stale_prefetches == pipe.barriers
        # block 5's re-issued holder: failed under the old record, valid under the new
        assert any(v == {(0, False), (1, True)} for v in seen.values())


def test_decoded_entry_matches_reference(corpus, pverify):
    """Each wire block decoded by the front end with the validator's
    MSP manager of the moment, then through the ``DecodedBlock`` entry."""
    wire, want = corpus
    v = _validator(wire)
    commit = _commit(v)
    got = []
    for blk in wire:
        dblk = frontend.decode_block(blk, v.msp)
        pend = v.validate_launch(dblk)
        flt, batch, hist = v.validate_finish(pend)
        commit(types.SimpleNamespace(pend=pend, tx_filter=flt, batch=batch,
                                     txids=[(p.txid, None) for p in pend.txs if p.txid]))
        got.append((bytes(flt), _rows(batch), list(hist)))
        assert all(p.host_creator_ok == (p.creator_item_idx == -1 and not p.is_config)
                   for p in pend.txs if p.code == C.VALID)
    _check(got, want)


@pytest.mark.parametrize("k,workers", [(2, 0), (3, 0), (4, 0), (3, 2)])
def test_submit_many_matches_reference(corpus, pverify, k, workers):
    wire, want = corpus
    got, pipe = _run(_validator(wire, host_stage_workers=workers), wire, k=k)
    _check(got, want)
    assert pipe.stale_prefetches >= pipe.barriers


def test_host_path_matches_reference(corpus, pverify):
    wire, want = corpus
    v = _validator(wire)
    v.validate_finish = v._validate_host
    got, _ = _run(v, wire)
    _check(got, want)


def test_resident_state_matches_reference(corpus, pverify):
    wire, want = corpus
    got, _ = _run(_validator(wire, state_resident=True, state_resident_mb=1), wire)
    _check(got, want)


def test_sidecar_validator_matches_reference(corpus, pverify):
    wire, want = corpus
    srv = SidecarServer(device="cpu").start_background()
    try:
        v = _validator(wire, cls=SidecarValidator, sidecar_endpoint=f"127.0.0.1:{srv.port}",
                       tenant="idemix")
        got, _ = _run(v, wire)
    finally:
        srv.stop_background()
    _check(got, want)


@pytest.mark.parametrize("block", [2, 3])
def test_idemix_rows_stay_columnar(corpus, pverify, monkeypatch, block):
    """A wire block with idemix creators stays on the columnar parse: the
    host-verified rows take lane -2.  An envelope with an idemix endorser
    goes to the front end (the walk stops at its non-DER endorsement, as
    the reference's does), and its set and endorsers join the columnar
    arrays.  Either way the policy groups come from the columnar
    builder."""
    wire, _ = corpus
    v = _validator(wire)
    v.validate(wire[0])

    def refuse(*a, **kw):
        raise AssertionError("the entry-by-entry group builder ran")

    monkeypatch.setattr(v, "_device_preprocess", refuse)
    pre = v.preprocess(wire[block])
    assert pre.dpre is not None
    lanes = [p.creator_lane for p in pre.txs]
    if block == 2:  # 6 idemix rows, one tampered
        assert pre.block.n_front_end == 0 and int(pre.block.flat.sum()) == 17
        assert [i for i, lane in enumerate(lanes) if lane == -2] == [0, 3, 9, 12, 15]
    else:  # nil, garbage and the two idemix-endorser envelopes go to the front end
        assert pre.block.n_front_end == 4
        assert pre.block.flat[[6, 7]].all() and lanes[7] == -2 and lanes[6] >= 0
        assert pre.block.ecnt[[6, 7]].tolist() == [1, 1]
    v.close()


@pytest.mark.parametrize("signers,want", [
    ((0, 1, "admin"), True), (("admin",), False), ((0, "admin"), False),
    ((0, 1, "admin_tampered"), False), ((0, 1, "carol"), False), ((0, 1, 2), True)])
def test_config_update_cosigned_by_idemix_admin(net, signers, want):
    """A change to the Application group's Admins-governed policy (a
    MAJORITY of the four orgs' admins) with an idemix admin among the
    signers: the port's authorization equals the reference's."""
    iss = net["iss"]
    jp = jcg.Profile(CHANNEL, application_orgs=[jcg.OrgProfile(o.msp_id, o.msp())
                                                for o in net["orgs"]]
                     + [jcg.OrgProfile(IDX, jidx.IdemixMSP(IDX, iss.ipk, net["rec0"]))])
    jb = jcc.Bundle(CHANNEL, jcg.genesis_config(jp))
    pb = cc.Bundle(CHANNEL, M.Config.parse(jcg.genesis_config(jp).SerializeToString()))
    new = configtx_pb2.Config()
    new.CopyFrom(jb.config)
    new.channel_group.groups["Application"].policies["Readers"].CopyFrom(
        jcc.config_policy(jcc.ImplicitMeta(rule=2, sub_policy="Readers")))
    update = jcg.compute_update(CHANNEL, jb.config, new)

    class Tampered:
        serialized = net["anon0"]["admin"].serialized

        def sign(self, message):
            return net["anon0"]["admin"].sign(message)[:-6] + b"\x00" * 6

    who = {"admin": net["anon0"]["admin"], "carol": net["anon0"]["carol"],
           "admin_tampered": Tampered()}
    upd_env = jcg.sign_update(update, [who[s] if isinstance(s, str) else net["admins"][s]
                                       for s in signers])
    outcomes = []
    for authorize, bundle, env in ((jcc.authorize_update, jb, upd_env),
                                   (cc.authorize_update, pb, M.ConfigUpdateEnvelope.parse(
                                       upd_env.SerializeToString()))):
        try:
            authorize(bundle, env)
            outcomes.append(True)
        except (jcc.ConfigUpdateError, cc.ConfigUpdateError):
            outcomes.append(False)
    assert outcomes == [want, want]
