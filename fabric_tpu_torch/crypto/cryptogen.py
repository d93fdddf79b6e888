"""Seeded crypto material for test networks (counterpart:
``fabric_tpu/crypto/cryptogen.py:50-200``, without TLS material).

Each org has a self-signed P-256 CA (BasicConstraints CA with path
length 1, KeyUsage digitalSignature | keyCertSign | cRLSign, both
critical) that issues peers, users and an admin with their NodeOU role
in the subject (C=US, O=<domain>, OU=<role>, CN=<name>), valid from a
day before ``now`` for ten years, as the reference's cryptogen writes
them.  Keys and serials come from the caller's seed, so the same seed
gives the same certificates.  Certificates are signed in batches by the
caller's ``sign_batch(digests, keys)``: ``ec_ref_signer`` on the CPU by
default, or ``ops/p256sign.sign_digests`` on the card, which gives the
same RFC 6979 (low-S) bytes; ``cryptography`` parses the certificates
and the reference MSP accepts them.  ``SigningIdentity.sign`` signs one
message with ``ec_ref``; the block builder (``peer/txassembly.py``)
signs whole batches with the caller's signer.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from fabric_tpu_torch.crypto import der, ec_ref
from fabric_tpu_torch.crypto.msp import MSP
from fabric_tpu_torch.protos.messages import SerializedIdentity

ONE_DAY = 86400
TEN_YEARS = 3650 * ONE_DAY


def _scalar(rng: np.random.Generator) -> int:
    return int.from_bytes(rng.bytes(32), "big") % (ec_ref.N - 1) + 1


def _serial(rng: np.random.Generator) -> int:
    return int.from_bytes(rng.bytes(19), "big") >> 1 | 1  # positive, < 2^159


@dataclass
class SigningIdentity:
    """A private scalar, its certificate and the MSP id."""

    msp_id: str
    d: int
    cert_pem: bytes

    @cached_property
    def serialized(self) -> bytes:
        return SerializedIdentity(mspid=self.msp_id, id_bytes=self.cert_pem).serialize()

    @cached_property
    def public(self):
        return ec_ref.pt_mul(self.d, ec_ref.G)

    def sign(self, message: bytes) -> bytes:
        """DER ECDSA-SHA256 signature (RFC 6979 nonce, low-S)."""
        return ec_ref.der_encode_sig(*ec_ref.SigningKey(self.d).sign_digest(
            ec_ref.digest_int(message)))


def ec_ref_signer(digests, keys) -> list:
    """The CPU signer: per digest ``ec_ref`` RFC 6979 signing with the
    matching private scalar.  A card signer with the same interface and
    the same bytes is ``functools.partial(ops.p256sign.sign_digests,
    device="cuda")``."""
    return [ec_ref.SigningKey(d).sign_digest(int(e)) for e, d in zip(digests, keys)]


def _subject(domain: str, cn: str, ou: str | None = None):
    attrs = [(der.OID_C, "US"), (der.OID_O, domain), (der.OID_CN, cn)]
    if ou:
        attrs.insert(2, (der.OID_OU, ou))
    return der.encode_name(attrs)


def _tbs(rng, subject: bytes, issuer: bytes, public, not_before, not_after, ca=False,
         serial=None) -> bytes:
    if ca:
        exts = [(der.OID_BASIC_CONSTRAINTS, True, der.basic_constraints(True, 1)),
                (der.OID_KEY_USAGE, True, der.key_usage(True, True, True))]
    else:
        exts = [(der.OID_BASIC_CONSTRAINTS, True, der.basic_constraints(False))]
    return der.encode_tbs(_serial(rng) if serial is None else serial, issuer, subject,
                          not_before, not_after, public, exts)


def _sign_certs(tbss, keys, sign_batch) -> list:
    """tbsCertificates signed in one batch → PEMs."""
    digests = [int.from_bytes(hashlib.sha256(t).digest(), "big") for t in tbss]
    return [der.pem_encode(der.encode_certificate(t, r, s))
            for t, (r, s) in zip(tbss, sign_batch(digests, keys))]


@dataclass
class CA:
    """A self-signed P-256 CA."""

    domain: str
    d: int
    name: bytes       # the encoded subject Name
    cert_pem: bytes
    rng: np.random.Generator
    now: int

    @classmethod
    def create(cls, domain: str, rng: np.random.Generator, now: int | None = None,
               sign_batch=ec_ref_signer) -> "CA":
        now = int(time.time()) if now is None else int(now)
        d = _scalar(rng)
        name = _subject(domain, f"ca.{domain}")
        tbs = _tbs(rng, name, name, ec_ref.pt_mul(d, ec_ref.G), now - ONE_DAY,
                   now + TEN_YEARS, ca=True)
        pem, = _sign_certs([tbs], [d], sign_batch)
        return cls(domain=domain, d=d, name=name, cert_pem=pem, rng=rng, now=now)

    def issue_many(self, requests, sign_batch=ec_ref_signer) -> list:
        """[(cn, ou)] or [(cn, ou, not_before, not_after, serial)] →
        [(private scalar, certificate PEM)], signed in one batch;
        None in the optional places takes the default."""
        ds, tbss = [], []
        for req in requests:
            cn, ou, nb, na, serial = (*req, None, None, None)[:5]
            d = _scalar(self.rng)
            ds.append(d)
            tbss.append(_tbs(self.rng, _subject(self.domain, cn, ou), self.name,
                             ec_ref.pt_mul(d, ec_ref.G),
                             self.now - ONE_DAY if nb is None else nb,
                             self.now + TEN_YEARS if na is None else na, serial=serial))
        return list(zip(ds, _sign_certs(tbss, [self.d] * len(tbss), sign_batch)))

    def issue(self, cn: str, ou: str | None = None, not_before: int | None = None,
              not_after: int | None = None, serial: int | None = None,
              sign_batch=ec_ref_signer):
        """One certificate → (private scalar, PEM)."""
        return self.issue_many([(cn, ou, not_before, not_after, serial)], sign_batch)[0]


@dataclass
class OrgMaterial:
    msp_id: str
    domain: str
    ca: CA
    nodes: dict = field(default_factory=dict)   # name -> SigningIdentity
    users: dict = field(default_factory=dict)

    def msp(self, **kw) -> MSP:
        return MSP(self.msp_id, root_certs=[self.ca.cert_pem], node_ous=True, **kw)


def generate_org(msp_id: str, domain: str, rng: np.random.Generator, peers: int = 1,
                 users: int = 1, now: int | None = None,
                 sign_batch=ec_ref_signer) -> OrgMaterial:
    """One org from ``rng``: its CA, ``peers`` peers, an admin and
    ``users`` clients, the members' certificates signed in one
    ``sign_batch`` call."""
    ca = CA.create(domain, rng, now, sign_batch=sign_batch)
    org = OrgMaterial(msp_id=msp_id, domain=domain, ca=ca)
    reqs = ([(f"peer{i}.{domain}", "peer", org.nodes) for i in range(peers)]
            + [(f"Admin@{domain}", "admin", org.users)]
            + [(f"User{i + 1}@{domain}", "client", org.users) for i in range(users)])
    made = ca.issue_many([(cn, ou) for cn, ou, _ in reqs], sign_batch)
    for (cn, _, into), (d, pem) in zip(reqs, made):
        into[cn] = SigningIdentity(msp_id, d, pem)
    return org
