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
identity with the default role ``client``.  An identity of an idemix
MSP (``crypto/idemix.py::IdemixMSP``, beside the X.509 ones in
``msps``) is its ``IdemixIdentity``: valid when its ``id_bytes`` is the
idemix JSON (type, OU, role), its proofs checked against the MSP's
current key and epoch record.  X.509 validation is the reference's:

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

The channel config carries each org's MSP as a ``MSPConfig``
(``MSP.from_proto`` / ``to_proto``, the reference's :95-132, NodeOU
names included; an idemix config, type 1, is ``IdemixMSP.from_config``).
``verify_signature`` is the reference's ``Identity.verify``
(identity.py:104-118): a DER ECDSA-SHA256 signature with Fabric's
low-S rule, checked on the host with ``ec_ref`` (config-update
signatures are few and rare), or an idemix identity's presentation
proof.  ``principal_from_proto``,
``policy_from_proto`` and ``policy_to_proto`` (:304-345) convert
between the ``SignaturePolicyEnvelope`` message (a channel policy, a
key's ``VALIDATION_PARAMETER``) and ``crypto/policy.py``'s AST.
"""

from __future__ import annotations

import hashlib
import time

from fabric_tpu_torch.crypto import der, ec_ref
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.crypto.idemix import IdemixMSP
from fabric_tpu_torch.crypto.identity import (
    ROLE_ADMIN, ROLE_CLIENT, ROLE_ORDERER, ROLE_PEER, Identity,
)
from fabric_tpu_torch.protos import messages as m
from fabric_tpu_torch.protos.messages import SerializedIdentity

# NodeOUs: the role OU values (cryptogen's config.yaml), named as the roles
_ROLE_OUS = (ROLE_CLIENT, ROLE_PEER, ROLE_ADMIN, ROLE_ORDERER)
_ROLE_BY_ENUM = {m.MSP_ROLE_MEMBER: pol.ROLE_MEMBER, m.MSP_ROLE_ADMIN: ROLE_ADMIN,
                 m.MSP_ROLE_CLIENT: ROLE_CLIENT, m.MSP_ROLE_PEER: ROLE_PEER,
                 m.MSP_ROLE_ORDERER: ROLE_ORDERER}
_ENUM_BY_ROLE = {v: k for k, v in _ROLE_BY_ENUM.items()}


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
    """One organization's membership provider; certificates as PEM.
    ``ou_identifiers``: role → the OU value that carries it under
    NodeOUs (default: the role's own name)."""

    def __init__(self, msp_id: str, root_certs, intermediate_certs=(), admins=(),
                 revoked_serials=None, node_ous: bool = True, ou_identifiers=None):
        self.msp_id = msp_id
        self.root_ders = [der.pem_certificate(c) for c in root_certs]
        self.intermediate_ders = [der.pem_certificate(c) for c in intermediate_certs or ()]
        self.roots = [der.parse_certificate(c) for c in self.root_ders]
        self.intermediates = [der.parse_certificate(c) for c in self.intermediate_ders]
        self.admin_pems = {bytes(a) for a in admins or ()}
        self.revoked_serials = set(revoked_serials or ())
        self.node_ous = node_ous
        self.ou_identifiers = dict(ou_identifiers or {r: r for r in _ROLE_OUS})
        self._role_of_ou = {ou: r for r, ou in self.ou_identifiers.items()}
        self._cache: dict = {}

    @classmethod
    def from_proto(cls, cfg: m.MSPConfig) -> "MSP":
        """An X.509 ``MSPConfig`` → MSP (the reference's ``from_proto``)."""
        fab = m.FabricMSPConfig.parse(cfg.config)
        nous = fab.fabric_node_ous or m.FabricNodeOUs()
        ous = None
        if nous.enable:
            ous = {role: (getattr(nous, f"{role}_ou_identifier") or m.FabricOUIdentifier())
                   .organizational_unit_identifier or role for role in _ROLE_OUS}
        return cls(fab.name, root_certs=list(fab.root_certs),
                   intermediate_certs=list(fab.intermediate_certs), admins=list(fab.admins),
                   node_ous=nous.enable, ou_identifiers=ous)

    def to_proto(self) -> m.MSPConfig:
        """This MSP as the channel config's ``MSPConfig`` (certificates
        re-encoded as PEM, admins sorted, the NodeOU names)."""
        fab = m.FabricMSPConfig(
            name=self.msp_id, root_certs=[der.pem_encode(c) for c in self.root_ders],
            intermediate_certs=[der.pem_encode(c) for c in self.intermediate_ders],
            admins=sorted(self.admin_pems),
            fabric_node_ous=m.FabricNodeOUs(enable=self.node_ous, **{
                f"{role}_ou_identifier": m.FabricOUIdentifier(
                    organizational_unit_identifier=self.ou_identifiers[role])
                for role in _ROLE_OUS}))
        return m.MSPConfig(type=m.MSP_TYPE_FABRIC, config=fab.serialize())

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
                roles = [self._role_of_ou[ou] for ou in cert.ous() if ou in self._role_of_ou]
                if len(roles) != 1:
                    valid = False
                else:
                    role = roles[0]
            if valid and bytes(sid.id_bytes) in self.admin_pems:
                role = ROLE_ADMIN
        return Identity(sid.mspid, role, key[0], key[1], valid)


class MSPManager:
    """Channel-wide registry: msp_id → MSP (X.509 ``MSP`` or
    ``IdemixMSP``)."""

    CACHE_MAX = 4096

    def __init__(self, msps: dict | None = None):
        self.msps = dict(msps or {})
        self._ident_cache: dict = {}

    def add(self, msp) -> None:
        self.msps[msp.msp_id] = msp
        self._ident_cache.clear()

    def add_config(self, cfg: m.MSPConfig) -> None:
        """One org's ``MSPConfig`` from the channel config: X.509
        (``MSP.from_proto``) or idemix (type 1, ``IdemixMSP.from_config``,
        which raises on a payload that does not parse or an epoch record
        that does not verify)."""
        if cfg.type == m.MSP_TYPE_IDEMIX:
            self.add(IdemixMSP.from_config(cfg.config))
        else:
            self.add(MSP.from_proto(cfg))

    def deserialize_identity(self, serialized: bytes):
        got = self._ident_cache.get(serialized)
        if got is not None:
            return got
        sid = SerializedIdentity.parse(serialized)
        msp = self.msps.get(sid.mspid)
        if msp is None:
            key = load_pem_certificate(sid.id_bytes).public_key or (None, None)
            ident = Identity(sid.mspid, ROLE_CLIENT, key[0], key[1], False)
        else:
            ident = msp.deserialize_identity(serialized)
        if len(self._ident_cache) >= self.CACHE_MAX:
            self._ident_cache.clear()
        self._ident_cache[serialized] = ident
        return ident


def verify_signature(ident, message: bytes, sig: bytes) -> bool:
    """``ident``'s signature of ``message`` (the reference's
    ``Identity.verify``): an idemix identity's presentation proof, else
    a DER ECDSA-SHA256 signature with Fabric's low-S rule; False for an
    X.509 identity without a P-256 key or bytes that are no DER
    signature."""
    if ident.idemix:
        return ident.verify(message, sig)
    if not ident.has_ec_key:
        return False
    try:
        r, s = ec_ref.der_decode_sig(sig)
    except ValueError:
        return False
    return ec_ref.verify_digest((ident.qx, ident.qy), ec_ref.digest_int(message), r, s)


def principal_from_proto(p: m.MSPPrincipal) -> pol.Principal:
    """A ROLE principal → the policy engine's ``Principal``; any other
    classification or an unknown role raises ``ValueError``."""
    if p.principal_classification != m.PRINCIPAL_ROLE:
        raise ValueError("only ROLE principals map to policy.Principal")
    role = m.MSPRole.parse(p.principal)
    if role.role not in _ROLE_BY_ENUM:
        raise ValueError(f"unknown MSP role {role.role}")
    return pol.Principal(role.msp_identifier, _ROLE_BY_ENUM[role.role])


def policy_from_proto(env: m.SignaturePolicyEnvelope):
    """``SignaturePolicyEnvelope`` → policy AST (a rule with neither
    member set is NOutOf(0) over nothing, as the reference reads it)."""

    def walk(rule):
        rule = rule or m.SignaturePolicy()
        if rule.signed_by is not None:
            return pol.SignedBy(principal_from_proto(env.identities[rule.signed_by]))
        n = rule.n_out_of or m.SignaturePolicyNOutOf()
        return pol.NOutOf(n.n, tuple(walk(r) for r in n.rules))

    return walk(env.rule)


def policy_to_proto(rule) -> m.SignaturePolicyEnvelope:
    """Policy AST → ``SignaturePolicyEnvelope``: each distinct principal
    once, ROLE-classified, numbered in first-use order."""
    env = m.SignaturePolicyEnvelope(version=0)
    pindex: dict = {}

    def principal_idx(principal: pol.Principal) -> int:
        if principal not in pindex:
            pindex[principal] = len(env.identities)
            role = m.MSPRole(msp_identifier=principal.msp_id,
                             role=_ENUM_BY_ROLE[principal.role])
            env.identities.append(m.MSPPrincipal(principal_classification=m.PRINCIPAL_ROLE,
                                                 principal=role.serialize()))
        return pindex[principal]

    def walk(node):
        if isinstance(node, pol.SignedBy):
            return m.SignaturePolicy(signed_by=principal_idx(node.principal))
        return m.SignaturePolicy(n_out_of=m.SignaturePolicyNOutOf(
            n=node.n, rules=[walk(r) for r in node.rules]))

    env.rule = walk(rule)
    return env
