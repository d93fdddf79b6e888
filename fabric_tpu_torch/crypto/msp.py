"""Membership service providers: X.509 identities, chain validation and
roles (counterparts: ``fabric_tpu/crypto/msp.py:70-300`` and
``identity.py:52-100``).

``MSPManager.deserialize_identity`` turns a serialized
``SerializedIdentity`` into the port's ``Identity(msp_id, role, qx, qy,
is_valid)``, memoized by the serialized bytes as the reference's is
(4,096 entries, cleared when full; each MSP keeps its own cache too).
It raises where the reference raises: bytes that are no
SerializedIdentity, PEM or certificate the reference cannot load, an
unknown signature algorithm.  An unknown MSP id gives an invalid
identity with the default role ``client``.  An identity of an MSP the
manager was told is idemix (``idemix=``; the reference's
``crypto/idemix.py::IdemixMSP``) gives an ``Identity`` marked
``idemix``, without reading its credential.  Validation is the
reference's:

* the validity window and the revoked serials apply to every
  certificate of the chain;
* any one fully valid chain leaf → [intermediate] → root is enough;
* NodeOUs: exactly one role OU (client, peer, admin, orderer: the
  reference's defaults), else invalid;
  without NodeOUs a certificate in the admin list is ``admin``, any
  other ``client``; with them the admin list still makes ``admin``.

Certificate signatures are checked with ``ec_ref`` WITHOUT the low-S
rule (CAs do not normalize s; Fabric's rule is for transaction
signatures).  A P-256 ECDSA issuer is the one kind this slice checks:
an RSA issuer, or an EC issuer on another curve, raises
``NotImplementedError``.  A leaf whose key is not a P-256 point gets
``qx = qy = None`` ("no EC key").  The time is taken when an identity
is first seen, and the result is cached, as in the reference.
"""

from __future__ import annotations

import hashlib
import time

from fabric_tpu_torch.crypto import der, ec_ref
from fabric_tpu_torch.crypto.identity import (
    ROLE_ADMIN, ROLE_CLIENT, ROLE_ORDERER, ROLE_PEER, Identity,
)
from fabric_tpu_torch.protos.messages import SerializedIdentity

# NodeOUs: the role OU values (cryptogen's config.yaml), named as the roles
_ROLE_OUS = (ROLE_CLIENT, ROLE_PEER, ROLE_ADMIN, ROLE_ORDERER)


def load_pem_certificate(pem: bytes) -> der.Certificate:
    return der.parse_certificate(der.pem_certificate(pem))


def _digest(cert: der.Certificate) -> int:
    """The signed digest of ``cert`` as an integer, truncated to 256
    bits for the curve (ECDSA's bits2int)."""
    alg = der.SIG_ALGS.get(cert.sig_alg)
    if alg is None:
        raise der.DERError(f"unsupported signature algorithm {cert.sig_alg}")
    h = hashlib.new(alg[0], cert.tbs).digest()
    return int.from_bytes(h[:32], "big")


def verify_issued_by(cert: der.Certificate, issuer: der.Certificate) -> bool:
    """``issuer`` signed ``cert`` (names match, signature verifies)."""
    if cert.issuer != issuer.subject:
        return False
    if issuer.key_alg != der.OID_EC_PUBLIC_KEY:
        raise NotImplementedError(
            "certificates issued by a non-EC (e.g. RSA) CA: a later slice of the port")
    if not issuer.on_p256:
        raise NotImplementedError(
            "certificates issued by a CA key on a curve other than P-256: a later slice")
    pub = issuer.public_key
    if pub is None:
        raise der.DERError("the issuer's P-256 key is not a point of the curve")
    e = _digest(cert)
    try:
        r, s = der.decode_dss_signature(cert.signature)
    except ValueError:
        return False
    return ec_ref.verify_digest(pub, e, r, s, low_s=False)


class MSP:
    """One organization's membership provider; certificates as PEM."""

    def __init__(self, msp_id: str, root_certs, intermediate_certs=(), admins=(),
                 revoked_serials=None, node_ous: bool = True):
        self.msp_id = msp_id
        self.roots = [load_pem_certificate(c) for c in root_certs]
        self.intermediates = [load_pem_certificate(c) for c in intermediate_certs or ()]
        self.admin_pems = {bytes(a) for a in admins or ()}
        self.revoked_serials = set(revoked_serials or ())
        self.node_ous = node_ous
        self._cache: dict = {}

    def _cert_ok(self, cert: der.Certificate, now: float) -> bool:
        return cert.not_before <= now <= cert.not_after \
            and cert.serial not in self.revoked_serials

    def _chain_ok(self, cert: der.Certificate) -> bool:
        now = time.time()
        if not self._cert_ok(cert, now):
            return False

        def root_anchored(c):
            return any(verify_issued_by(c, root) and self._cert_ok(root, now)
                       for root in self.roots)

        for ca in self.intermediates:
            if verify_issued_by(cert, ca) and self._cert_ok(ca, now) and root_anchored(ca):
                return True
        return root_anchored(cert)

    def deserialize_identity(self, serialized: bytes) -> Identity:
        hit = self._cache.get(serialized)
        if hit is None:
            sid = SerializedIdentity.parse(serialized)
            hit = self._cache[serialized] = self._validate(
                sid, load_pem_certificate(sid.id_bytes))
        return hit

    def _validate(self, sid, cert: der.Certificate) -> Identity:
        key = cert.public_key or (None, None)
        role, valid = ROLE_CLIENT, self._chain_ok(cert)
        if valid:
            if self.node_ous:
                roles = [ou for ou in cert.ous() if ou in _ROLE_OUS]
                if len(roles) != 1:
                    valid = False
                else:
                    role = roles[0]
            if valid and bytes(sid.id_bytes) in self.admin_pems:
                role = ROLE_ADMIN
        return Identity(sid.mspid, role, key[0], key[1], valid)


class MSPManager:
    """Channel-wide registry: msp_id → MSP; ``idemix``: the ids of the
    channel's idemix MSPs."""

    CACHE_MAX = 4096

    def __init__(self, msps: dict | None = None, idemix=()):
        self.msps = dict(msps or {})
        self.idemix = frozenset(idemix)
        self._ident_cache: dict = {}

    def deserialize_identity(self, serialized: bytes) -> Identity:
        got = self._ident_cache.get(serialized)
        if got is not None:
            return got
        sid = SerializedIdentity.parse(serialized)
        msp = self.msps.get(sid.mspid)
        if sid.mspid in self.idemix:
            ident = Identity(sid.mspid, ROLE_CLIENT, None, None, False, idemix=True)
        elif msp is None:
            key = load_pem_certificate(sid.id_bytes).public_key or (None, None)
            ident = Identity(sid.mspid, ROLE_CLIENT, key[0], key[1], False)
        else:
            ident = msp.deserialize_identity(serialized)
        if len(self._ident_cache) >= self.CACHE_MAX:
            self._ident_cache.clear()
        self._ident_cache[serialized] = ident
        return ident
