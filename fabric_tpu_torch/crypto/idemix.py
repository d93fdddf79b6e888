"""Idemix: the anonymous-credential MSP (counterpart:
``fabric_tpu/crypto/idemix.py``, which stands for msp/idemix.go over
IBM/idemix).

The scheme is the reference's: Camenisch–Lysyanskaya signatures over a
strong-RSA group (CL01), with its capability surface:

* an issuer certifies a credential over (master secret, OU, role,
  epoch) without learning the master secret (blind issuance with a
  Schnorr proof of the commitment);
* the holder signs a message by presenting a fresh zero-knowledge proof
  of possession (randomized A', Fiat–Shamir over the message), so two
  signatures of one holder are unlinkable, while the org (issuer key)
  and the disclosed OU and role stay verifiable;
* a verifier needs a few modular exponentiations on the host: idemix
  identities are client creators (peers and orderers stay X.509, and
  idemix identities cannot endorse), so their proofs ride the
  validator's host lane, not the card's signature batch.

Math.  Issuer key: modulus n = pq, random quadratic residues S, Z,
R_sk, R_ou, R_role, R_epoch.  Credential: (A, e, v) with

    A^e · S^v · R_sk^sk · R_ou^m_ou · R_role^m_role · R_epoch^epoch ≡ Z  (mod n)

where e is a prime in [2^(L_E-1), 2^(L_E-1) + 2^L_E_PRIME].
Presentation for message M: A' = A·S^r, v' = v − e·r, then a Σ-protocol
proof of (e − 2^(L_E-1), v', sk) made non-interactive with
c = H(ipk, A', t, OU, role, epoch, nonce, M).  Revocation is by epoch:
the revocation authority signs an ``EpochRecord`` (ECDSA-P256 through
``crypto/ec_ref.py``), a verifier holding it requires presentations to
disclose that epoch, and a revoked holder is refused re-issuance into
the next one.

Every byte that is hashed or serialized (``IssuerPublicKey.to_json``,
``EpochRecord.to_json`` and ``digest``, the Fiat–Shamir inputs, a
presentation's JSON, ``IdemixMSP.to_config``) is the reference's, so a
presentation made by either package verifies under the other.

Randomness is explicit: the issuer, the holder and ``sign`` take
``rng``, an object with ``getrandbits(k)`` and ``randrange(n)``
(``random.Random`` seeded for reproducible tests and builds); the
default, ``secrets.SystemRandom()``, keeps presentations unlinkable.
The reference draws from ``secrets`` directly.

``IdemixMSP`` is the MSP the channel config carries as a type-1
``MSPConfig``.  Its identities (``crypto/identity.py::IdemixIdentity``)
read the MSP's current epoch record when they verify, so an identity
cached before a record was adopted is not held to the old one.
"""

from __future__ import annotations

import hashlib
import json
import secrets

from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.crypto.identity import IdemixIdentity
from fabric_tpu_torch.protos import messages as m

# parameter lengths (bits); l_n is set per issuer.  The responses run
# over the offset e' = e − 2^(L_E-1) and the verifier bounds s_e, so
# |e'| < 2^(L_E_PRIME+L_C+L_STAT+2) ≪ 2^(L_E-2): e is provably huge
# (no e = 1 forgeries).
L_M = 256        # attribute size
L_E = 597        # total bit-length of the prime exponent e
L_E_PRIME = 120  # width of the interval e ranges over
L_STAT = 80      # statistical hiding slack
L_C = 256        # Fiat–Shamir challenge

_SYSTEM = secrets.SystemRandom()


def _rng(rng):
    return _SYSTEM if rng is None else rng


def _attr_int(value: str) -> int:
    return int.from_bytes(hashlib.sha256(value.encode()).digest(), "big") % (1 << L_M)


def _rand_bits(bits: int, rng=None) -> int:
    return _rng(rng).getrandbits(bits)


def _token_hex(nbytes: int, rng=None) -> str:
    return _rng(rng).getrandbits(8 * nbytes).to_bytes(nbytes, "big").hex()


def _is_probable_prime(x: int, rounds: int = 40, rng=None) -> bool:
    if x < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if x % p == 0:
            return x == p
    rng = _rng(rng)
    d, r = x - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = rng.randrange(x - 3) + 2
        y = pow(a, d, x)
        if y in (1, x - 1):
            continue
        for _ in range(r - 1):
            y = pow(y, 2, x)
            if y == x - 1:
                break
        else:
            return False
    return True


def _gen_prime(bits: int, rng=None) -> int:
    while True:
        x = _rand_bits(bits, rng) | (1 << (bits - 1)) | 1
        if _is_probable_prime(x, rng=rng):
            return x


def _gen_cred_exponent(rng=None) -> int:
    """A prime in [2^(L_E-1), 2^(L_E-1) + 2^L_E_PRIME], the window the
    presentation's range bound certifies."""
    base = 1 << (L_E - 1)
    while True:
        x = base + (_rand_bits(L_E_PRIME, rng) | 1)
        if _is_probable_prime(x, rng=rng):
            return x


def _fs_challenge(*parts) -> int:
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, int):
            p = p.to_bytes((p.bit_length() + 7) // 8 or 1, "big")
        elif isinstance(p, str):
            p = p.encode()
        h.update(len(p).to_bytes(4, "big"))
        h.update(p)
    return int.from_bytes(h.digest(), "big") % (1 << L_C)


class IssuerPublicKey:
    """(n, S, Z, R_sk, R_ou, R_role, R_epoch) and the revocation
    authority's P-256 public point: all a verifier needs."""

    __slots__ = ("n", "S", "Z", "R_sk", "R_ou", "R_role", "R_epoch", "ra_pub", "_json",
                 "_key_digest")

    def __init__(self, n, S, Z, R_sk, R_ou, R_role, R_epoch, ra_pub):
        self.n, self.S, self.Z = n, S, Z
        self.R_sk, self.R_ou, self.R_role = R_sk, R_ou, R_role
        self.R_epoch = R_epoch
        self.ra_pub = tuple(ra_pub)
        self._json = None
        self._key_digest = None

    def to_json(self) -> str:
        """Sorted keys, every field as ``hex()``, ``ra_pub`` a list;
        made once (every field is set once, in ``__init__``)."""
        if self._json is None:
            d = {k: hex(getattr(self, k))
                 for k in ("n", "S", "Z", "R_sk", "R_ou", "R_role", "R_epoch")}
            d["ra_pub"] = [hex(self.ra_pub[0]), hex(self.ra_pub[1])]
            self._json = json.dumps(d, sort_keys=True)
        return self._json

    def key_digest(self) -> bytes:
        """sha256 of the key's JSON, made once: the epoch record's
        verification is cached per key digest."""
        if self._key_digest is None:
            self._key_digest = hashlib.sha256(self.to_json().encode()).digest()
        return self._key_digest

    @classmethod
    def from_json(cls, raw: str) -> "IssuerPublicKey":
        """``R_epoch`` and ``ra_pub`` are required (a degenerate epoch
        generator would let every epoch claim pass)."""
        d = json.loads(raw)
        ra = d.pop("ra_pub")
        return cls(**{k: int(v, 16) for k, v in d.items()},
                   ra_pub=(int(ra[0], 16), int(ra[1], 16)))


class Credential:
    __slots__ = ("A", "e", "v", "sk", "ou", "role", "epoch")

    def __init__(self, A, e, v, sk, ou, role, epoch=0):
        self.A, self.e, self.v = A, e, v
        self.sk, self.ou, self.role = sk, ou, role
        self.epoch = epoch


class EpochRecord:
    """The revocation authority's signed epoch statement.  A verifier
    holding it requires presentations to disclose its epoch; revoking a
    holder advances the epoch and re-issues every other holder."""

    __slots__ = ("epoch", "r", "s", "_ok_for")

    def __init__(self, epoch: int, r: int, s: int):
        self.epoch, self.r, self.s = epoch, r, s
        self._ok_for = None  # the key digest the signature verified against

    def to_json(self) -> str:
        return json.dumps({"epoch": self.epoch, "r": hex(self.r), "s": hex(self.s)},
                          sort_keys=True)

    @classmethod
    def from_json(cls, raw: str) -> "EpochRecord":
        d = json.loads(raw)
        return cls(int(d["epoch"]), int(d["r"], 16), int(d["s"], 16))

    def digest(self, ipk: IssuerPublicKey) -> int:
        return int.from_bytes(hashlib.sha256(
            b"idemix-epoch|" + ipk.to_json().encode() + b"|%d" % self.epoch).digest(), "big")

    def verify(self, ipk: IssuerPublicKey) -> bool:
        """The authority's signature over (key, epoch), cached per key:
        the record is static between adoptions."""
        kd = ipk.key_digest()
        if self._ok_for == kd:
            return True
        try:
            ok = ec_ref.verify_digest(ipk.ra_pub, self.digest(ipk), self.r, self.s)
        except Exception:
            return False
        if ok:
            self._ok_for = kd
        return ok


class IdemixIssuer:
    """Key generation, blind issuance and epoch revocation.  ``bits``:
    the strong-RSA modulus size (2048 the production floor; tests pass
    1024 for speed)."""

    def __init__(self, msp_id: str, bits: int = 2048, rng=None):
        self.msp_id = msp_id
        self.bits = bits
        self._rng = rng
        p = _gen_prime(bits // 2, rng)
        q = _gen_prime(bits // 2, rng)
        while q == p:
            q = _gen_prime(bits // 2, rng)
        self.n = p * q
        self._phi = (p - 1) * (q - 1)

        def qr():
            return pow(_rng(rng).randrange(self.n - 2) + 2, 2, self.n)

        self._ra_key = ec_ref.SigningKey(d=_rng(rng).randrange(ec_ref.N - 1) + 1)
        S, Z, R_sk, R_ou, R_role, R_epoch = (qr() for _ in range(6))
        self.ipk = IssuerPublicKey(self.n, S, Z, R_sk, R_ou, R_role, R_epoch,
                                   ra_pub=self._ra_key.public)
        # a handle names a holder to the issuer only; it never appears in
        # a presentation
        self.epoch = 0
        self._revoked: set = set()
        self._epoch_record = self._sign_epoch()

    def _sign_epoch(self) -> EpochRecord:
        rec = EpochRecord(self.epoch, 0, 0)
        rec.r, rec.s = self._ra_key.sign_digest(rec.digest(self.ipk))
        return rec

    @property
    def epoch_record(self) -> EpochRecord:
        return self._epoch_record

    def revoke(self, handle) -> None:
        """Mark ``handle`` revoked and advance the epoch."""
        self._revoked.add(handle)
        self.epoch += 1
        self._epoch_record = self._sign_epoch()

    def is_revoked(self, handle) -> bool:
        return handle in self._revoked

    def issue(self, commitment: int, proof: dict, ou: str, role: str, handle=None):
        """Blind issuance over U = R_sk^sk · S^v_u and its proof →
        (A, e, v_issuer).  Refused for a revoked handle, and without a
        handle once any holder is revoked."""
        if self._revoked and handle is None:
            raise ValueError("revocation is active on this issuer: issuance requires "
                             "a holder handle")
        if handle is not None and handle in self._revoked:
            raise ValueError(f"holder {handle!r} is revoked")
        ipk = self.ipk
        c = _fs_challenge(ipk.to_json(), commitment, proof["t"], "issue")
        lhs = (pow(ipk.R_sk, proof["s_sk"], ipk.n) * pow(ipk.S, proof["s_v"], ipk.n)
               * pow(commitment, -c, ipk.n)) % ipk.n
        if lhs != proof["t"] % ipk.n:
            raise ValueError("bad commitment proof")
        e = _gen_cred_exponent(self._rng)
        v_i = _rand_bits(self.bits + L_STAT, self._rng)
        base = (commitment * pow(ipk.S, v_i, ipk.n) * pow(ipk.R_ou, _attr_int(ou), ipk.n)
                * pow(ipk.R_role, _attr_int(role), ipk.n)
                * pow(ipk.R_epoch, self.epoch, ipk.n)) % ipk.n
        A = pow((ipk.Z * pow(base, -1, ipk.n)) % ipk.n, pow(e, -1, self._phi), ipk.n)
        return A, e, v_i


class IdemixHolder:
    """A credential holder: the commitment, then the credential."""

    def __init__(self, ipk: IssuerPublicKey, rng=None):
        self.ipk = ipk
        self._rng = rng
        self.sk = _rand_bits(L_M, rng)
        self._v_u = None

    def commitment(self):
        ipk, rng = self.ipk, self._rng
        v_u = _rand_bits(ipk.n.bit_length() + L_STAT, rng)
        self._v_u = v_u
        U = (pow(ipk.R_sk, self.sk, ipk.n) * pow(ipk.S, v_u, ipk.n)) % ipk.n
        r_sk = _rand_bits(L_M + L_C + L_STAT, rng)
        r_v = _rand_bits(ipk.n.bit_length() + L_STAT + L_C + L_STAT, rng)
        t = (pow(ipk.R_sk, r_sk, ipk.n) * pow(ipk.S, r_v, ipk.n)) % ipk.n
        c = _fs_challenge(ipk.to_json(), U, t, "issue")
        return U, {"t": t, "s_sk": r_sk + c * self.sk, "s_v": r_v + c * v_u}

    def assemble(self, A: int, e: int, v_i: int, ou: str, role: str,
                 epoch: int = 0) -> Credential:
        cred = Credential(A, e, v_i + self._v_u, self.sk, ou, role, epoch=epoch)
        ipk = self.ipk
        lhs = (pow(A, e, ipk.n) * pow(ipk.S, cred.v, ipk.n) * pow(ipk.R_sk, self.sk, ipk.n)
               * pow(ipk.R_ou, _attr_int(ou), ipk.n) * pow(ipk.R_role, _attr_int(role), ipk.n)
               * pow(ipk.R_epoch, epoch, ipk.n)) % ipk.n
        if lhs != ipk.Z % ipk.n:
            raise ValueError("credential does not verify")
        return cred


def sign(ipk: IssuerPublicKey, cred: Credential, msg: bytes, rng=None) -> bytes:
    """A fresh presentation proof over ``msg``: the idemix signature
    (A' and every proof value randomized per call)."""
    n = ipk.n
    r = _rand_bits(n.bit_length() + L_STAT, rng)
    A2 = (cred.A * pow(ipk.S, r, n)) % n
    v2 = cred.v - cred.e * r  # may be negative
    e_off = cred.e - (1 << (L_E - 1))
    r_e = _rand_bits(L_E_PRIME + L_C + L_STAT, rng)
    r_v = _rand_bits(n.bit_length() + 2 * L_STAT + L_C + L_E, rng)
    r_sk = _rand_bits(L_M + L_C + L_STAT, rng)
    t = (pow(A2, r_e, n) * pow(ipk.S, r_v, n) * pow(ipk.R_sk, r_sk, n)) % n
    nonce = _token_hex(16, rng)
    c = _fs_challenge(ipk.to_json(), A2, t, cred.ou, cred.role, cred.epoch, nonce, msg)
    s_v = r_v + c * v2
    return json.dumps({
        "A2": hex(A2), "c": hex(c), "nonce": nonce, "epoch": cred.epoch,
        "s_e": hex(r_e + c * e_off),
        "s_v": hex(s_v) if s_v >= 0 else "-" + hex(-s_v),
        "s_sk": hex(r_sk + c * cred.sk),
    }).encode()


def _parse_signed(h: str) -> int:
    return -int(h[1:], 16) if h.startswith("-") else int(h, 16)


def verify(ipk: IssuerPublicKey, ou: str, role: str, msg: bytes, sig: bytes,
           epoch_record: EpochRecord | None = None) -> bool:
    """A presentation proof over ``msg`` disclosing ``ou`` and ``role``.
    With ``epoch_record`` the presentation must disclose that epoch (the
    revocation check; the epoch folds into the proof, so a lie fails
    it).  Any exception is a False verdict."""
    try:
        d = json.loads(sig)
        n = ipk.n
        A2, c = int(d["A2"], 16), int(d["c"], 16)
        s_e = int(d["s_e"], 16)
        s_v = _parse_signed(d["s_v"])
        s_sk = int(d["s_sk"], 16)
        nonce = d["nonce"]
        epoch = int(d.get("epoch", 0))
        if epoch_record is not None:
            if not epoch_record.verify(ipk) or epoch != epoch_record.epoch:
                return False
        if not (0 < A2 < n):
            return False
        # the range bound on s_e: e = 2^(L_E-1) + e' with e' small
        if not (0 <= s_e < 1 << (L_E_PRIME + L_C + L_STAT + 1)):
            return False
        z_d = (ipk.Z * pow(ipk.R_ou, -_attr_int(ou), n) * pow(ipk.R_role, -_attr_int(role), n)
               * pow(ipk.R_epoch, -epoch, n)) % n
        t_hat = (pow(A2, s_e + (c << (L_E - 1)), n) * pow(ipk.S, s_v, n)
                 * pow(ipk.R_sk, s_sk, n) * pow(z_d, -c, n)) % n
        return _fs_challenge(ipk.to_json(), A2, t_hat, ou, role, epoch, nonce, msg) == c
    except Exception:
        return False


# ---------------------------------------------------------------------------
# The MSP


def _id_bytes(ou: str, role: str) -> bytes:
    return json.dumps({"type": "idemix", "ou": ou, "role": role}, sort_keys=True).encode()


class IdemixSigningIdentity:
    """The holder's signer: ``serialized`` discloses the credential's
    OU and role; ``sign`` makes a fresh presentation."""

    def __init__(self, msp_id: str, ipk: IssuerPublicKey, cred: Credential, rng=None):
        self.msp_id = msp_id
        self.ipk = ipk
        self.cred = cred
        self._rng = rng

    @property
    def serialized(self) -> bytes:
        return m.SerializedIdentity(mspid=self.msp_id,
                                    id_bytes=_id_bytes(self.cred.ou, self.cred.role)).serialize()

    def sign(self, message: bytes) -> bytes:
        return sign(self.ipk, self.cred, message, self._rng)


class IdemixMSP:
    """An MSP backed by an issuer public key (msp/idemix.go).  A
    serialized idemix identity discloses only its OU and role;
    membership and attribute truth are proven by each signature's
    presentation, so deserializing checks the shape and the proof check
    rides ``IdemixIdentity.verify``.  ``epoch_record``: the newest
    authority-signed epoch statement this MSP holds (None: revocation not
    configured, any epoch accepted)."""

    def __init__(self, msp_id: str, ipk: IssuerPublicKey,
                 epoch_record: EpochRecord | None = None):
        self.msp_id = msp_id
        self.ipk = ipk
        self.epoch_record = epoch_record

    def set_epoch_record(self, rec: EpochRecord) -> None:
        """Adopt a newer epoch statement; an older one (a replay) is
        ignored, a forged one raises."""
        if not rec.verify(self.ipk):
            raise ValueError("epoch record does not verify")
        if self.epoch_record is None or rec.epoch > self.epoch_record.epoch:
            self.epoch_record = rec

    def verify(self, ou: str, role: str, message: bytes, sig: bytes) -> bool:
        """A presentation under this MSP's key and current epoch record."""
        return verify(self.ipk, ou, role, message, sig, epoch_record=self.epoch_record)

    def deserialize_identity(self, serialized: bytes) -> IdemixIdentity:
        """Valid only when ``id_bytes`` is the JSON object with ``type``
        "idemix", ``ou`` and ``role`` (the reference's :526-539); the role
        defaults to "client" and the OU to ""."""
        sid = m.SerializedIdentity.parse(serialized)
        try:
            d = json.loads(sid.id_bytes)
            ok = d.get("type") == "idemix" and "ou" in d and "role" in d
        except Exception:
            d, ok = {}, False
        return IdemixIdentity(sid.mspid, d.get("role", "client"), d.get("ou", ""), ok,
                              serialized, self)

    def to_proto(self) -> m.MSPConfig:
        """The channel config's ``MSPConfig`` (what ``configtxgen``'s
        ``_org_group`` calls)."""
        return self.to_config()

    def to_config(self) -> m.MSPConfig:
        """Type 1 (IDEMIX); the payload is the sorted JSON of the MSP id,
        the issuer key and the epoch record."""
        rec = self.epoch_record
        return m.MSPConfig(type=m.MSP_TYPE_IDEMIX, config=json.dumps({
            "msp_id": self.msp_id, "ipk": json.loads(self.ipk.to_json()),
            "epoch_record": json.loads(rec.to_json()) if rec is not None else None,
        }, sort_keys=True).encode())

    @classmethod
    def from_config(cls, cfg_bytes: bytes) -> "IdemixMSP":
        """A type-1 config's payload → MSP.  An epoch record that does
        not verify against the key raises (fail closed), as does a
        payload that does not parse."""
        d = json.loads(cfg_bytes)
        ipk = IssuerPublicKey.from_json(json.dumps(d["ipk"]))
        rec = None
        if d.get("epoch_record"):
            rec = EpochRecord.from_json(json.dumps(d["epoch_record"]))
            if not rec.verify(ipk):
                raise ValueError("idemix epoch record does not verify")
        return cls(d["msp_id"], ipk, epoch_record=rec)
