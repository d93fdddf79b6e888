"""Seeded crypto material for networks and tests (counterpart:
``fabric_tpu/crypto/cryptogen.py``).

Each org has a self-signed P-256 CA (BasicConstraints CA with path
length 1, KeyUsage digitalSignature | keyCertSign | cRLSign, both
critical) that issues peers, orderers, users and an admin with their
NodeOU role in the subject (C=US, O=<domain>, OU=<role>, CN=<name>),
valid from a day before ``now`` for ten years, as the reference's
cryptogen writes them; and a TLS CA (``tlsca.<domain>``) that issues
each node a TLS certificate whose subjectAltName is the node's name,
``localhost`` and ``127.0.0.1``.  Keys and serials come from the
caller's generator (the CLI seeds one from ``secrets``), so the same
seed gives the same certificates.  Certificates are signed in batches
by the caller's ``sign_batch(digests, keys)``: ``ec_ref_signer`` on the
CPU by default, or ``ops/p256sign.sign_digests`` on the card, which
gives the same RFC 6979 (low-S) bytes; ``cryptography`` and OpenSSL
parse the certificates and the reference MSP accepts them.

``write_org`` lays an org out on disk as the reference does (``ca/``,
``msp/`` with ``config.json``, ``nodes|users/<name>/msp/{cacerts,
keystore,signcerts}``, ``tlsca/``, ``nodes/<name>/tls/{server,key,
ca}.pem``), keys as PKCS#8 ``PRIVATE KEY`` PEMs; ``load_org_msp``,
``load_signing_identity`` and ``load_tls_profile`` read either
package's layout back.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np

from fabric_tpu_torch.crypto import der, ec_ref
from fabric_tpu_torch.crypto.identity import SigningIdentity
from fabric_tpu_torch.crypto.msp import MSP

ONE_DAY = 86400
TEN_YEARS = 3650 * ONE_DAY


def _scalar(rng: np.random.Generator) -> int:
    return int.from_bytes(rng.bytes(32), "big") % (ec_ref.N - 1) + 1


def _serial(rng: np.random.Generator) -> int:
    return int.from_bytes(rng.bytes(19), "big") >> 1 | 1  # positive, < 2^159


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
         serial=None, sans=None) -> bytes:
    if ca:
        exts = [(der.OID_BASIC_CONSTRAINTS, True, der.basic_constraints(True, 1)),
                (der.OID_KEY_USAGE, True, der.key_usage(True, True, True))]
    else:
        exts = [(der.OID_BASIC_CONSTRAINTS, True, der.basic_constraints(False))]
    if sans:
        exts.append((der.OID_SUBJECT_ALT_NAME, False, der.subject_alt_name(sans)))
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
               sign_batch=ec_ref_signer, cn: str | None = None) -> "CA":
        now = int(time.time()) if now is None else int(now)
        d = _scalar(rng)
        name = _subject(domain, cn or f"ca.{domain}")
        tbs = _tbs(rng, name, name, ec_ref.pt_mul(d, ec_ref.G), now - ONE_DAY,
                   now + TEN_YEARS, ca=True)
        pem, = _sign_certs([tbs], [d], sign_batch)
        return cls(domain=domain, d=d, name=name, cert_pem=pem, rng=rng, now=now)

    @property
    def key_pem(self) -> bytes:
        return der.pem_private_key(self.d)

    def issue_many(self, requests, sign_batch=ec_ref_signer) -> list:
        """[(cn, ou)] or [(cn, ou, not_before, not_after, serial, sans)]
        → [(private scalar, certificate PEM)], signed in one batch;
        None in the optional places takes the default."""
        ds, tbss = [], []
        for req in requests:
            cn, ou, nb, na, serial, sans = (*req, None, None, None, None)[:6]
            d = _scalar(self.rng)
            ds.append(d)
            tbss.append(_tbs(self.rng, _subject(self.domain, cn, ou), self.name,
                             ec_ref.pt_mul(d, ec_ref.G),
                             self.now - ONE_DAY if nb is None else nb,
                             self.now + TEN_YEARS if na is None else na, serial=serial,
                             sans=sans))
        return list(zip(ds, _sign_certs(tbss, [self.d] * len(tbss), sign_batch)))

    def issue(self, cn: str, ou: str | None = None, not_before: int | None = None,
              not_after: int | None = None, serial: int | None = None,
              sign_batch=ec_ref_signer):
        """One certificate → (private scalar, PEM)."""
        return self.issue_many([(cn, ou, not_before, not_after, serial)], sign_batch)[0]


@dataclass
class OrgMaterial:
    """One org's material: signing CA, TLS CA, nodes, users and the
    nodes' TLS identities (``SigningIdentity`` each, TLS ones under the
    org's MSP id)."""

    msp_id: str
    domain: str
    ca: CA
    tls_ca: CA | None = None  # set by generate_org
    nodes: dict = field(default_factory=dict)   # name -> SigningIdentity
    tls: dict = field(default_factory=dict)     # name -> SigningIdentity (TLS)
    users: dict = field(default_factory=dict)

    def msp(self, **kw) -> MSP:
        return MSP(self.msp_id, root_certs=[self.ca.cert_pem], node_ous=True, **kw)


def generate_org(msp_id: str, domain: str, rng: np.random.Generator, peers: int = 1,
                 users: int = 1, now: int | None = None, sign_batch=ec_ref_signer,
                 orderers: int = 0) -> OrgMaterial:
    """One org from ``rng``: its CA, ``peers`` peers, ``orderers``
    orderers, an admin and ``users`` clients, the members' certificates
    signed in one ``sign_batch`` call; then the TLS CA and one TLS
    certificate a node, signed in a second."""
    ca = CA.create(domain, rng, now, sign_batch=sign_batch)
    org = OrgMaterial(msp_id=msp_id, domain=domain, ca=ca)
    node_names = ([f"peer{i}.{domain}" for i in range(peers)]
                  + [f"orderer{i}.{domain}" for i in range(orderers)])
    reqs = ([(f"peer{i}.{domain}", "peer", org.nodes) for i in range(peers)]
            + [(f"orderer{i}.{domain}", "orderer", org.nodes) for i in range(orderers)]
            + [(f"Admin@{domain}", "admin", org.users)]
            + [(f"User{i + 1}@{domain}", "client", org.users) for i in range(users)])
    made = ca.issue_many([(cn, ou) for cn, ou, _ in reqs], sign_batch)
    for (cn, _, into), (d, pem) in zip(reqs, made):
        into[cn] = SigningIdentity(msp_id, d, pem)
    org.tls_ca = CA.create(domain, rng, now, sign_batch=sign_batch, cn=f"tlsca.{domain}")
    made = org.tls_ca.issue_many(
        [(n, None, None, None, None, [n, "localhost", "127.0.0.1"]) for n in node_names],
        sign_batch)
    for n, (d, pem) in zip(node_names, made):
        org.tls[n] = SigningIdentity(msp_id, d, pem)
    return org


def signing_identity(org: OrgMaterial, name: str) -> SigningIdentity:
    """The signing identity of a node or user of the org."""
    ident = org.nodes.get(name) or org.users.get(name)
    if ident is None:
        raise KeyError(name)
    return ident


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def write_msp_dir(base: str, ident: SigningIdentity, ca_pem: bytes) -> None:
    """cryptogen's msp/ directory: cacerts/ca.pem, keystore/key.pem,
    signcerts/cert.pem."""
    for sub in ("cacerts", "keystore", "signcerts"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    _write(os.path.join(base, "cacerts", "ca.pem"), ca_pem)
    _write(os.path.join(base, "keystore", "key.pem"), der.pem_private_key(ident.d))
    _write(os.path.join(base, "signcerts", "cert.pem"), ident.cert_pem)


def write_org(org: OrgMaterial, base: str) -> str:
    """The reference's layout for one org under ``<base>/<domain>``
    (``ca/``, ``msp/cacerts/`` + ``msp/config.json``,
    ``nodes|users/<name>/msp/``, ``tlsca/``, ``nodes/<name>/tls/``);
    returns the org directory."""
    root = os.path.join(base, org.domain)
    os.makedirs(os.path.join(root, "ca"), exist_ok=True)
    _write(os.path.join(root, "ca", "ca-cert.pem"), org.ca.cert_pem)
    _write(os.path.join(root, "ca", "ca-key.pem"), org.ca.key_pem)
    os.makedirs(os.path.join(root, "msp", "cacerts"), exist_ok=True)
    _write(os.path.join(root, "msp", "cacerts", "ca.pem"), org.ca.cert_pem)
    with open(os.path.join(root, "msp", "config.json"), "w") as f:
        json.dump({"msp_id": org.msp_id, "node_ous": True}, f)
    for group, members in (("nodes", org.nodes), ("users", org.users)):
        for name, ident in members.items():
            write_msp_dir(os.path.join(root, group, name, "msp"), ident, org.ca.cert_pem)
    os.makedirs(os.path.join(root, "tlsca"), exist_ok=True)
    _write(os.path.join(root, "tlsca", "tlsca-cert.pem"), org.tls_ca.cert_pem)
    for name, ident in org.tls.items():
        tdir = os.path.join(root, "nodes", name, "tls")
        os.makedirs(tdir, exist_ok=True)
        _write(os.path.join(tdir, "server.pem"), ident.cert_pem)
        _write(os.path.join(tdir, "key.pem"), der.pem_private_key(ident.d))
        _write(os.path.join(tdir, "ca.pem"), org.tls_ca.cert_pem)
    return root


def load_tls_profile(org_dir: str, node_name: str, ca_bundle: bytes | None = None):
    """``comm.rpc.TlsProfile`` of one node of a ``write_org`` directory;
    ``ca_bundle``: the trusted TLS CAs (default: the org's own)."""
    from fabric_tpu_torch.comm.rpc import TlsProfile

    tdir = os.path.join(org_dir, "nodes", node_name, "tls")
    with open(os.path.join(tdir, "server.pem"), "rb") as f:
        cert = f.read()
    with open(os.path.join(tdir, "key.pem"), "rb") as f:
        key = f.read()
    if ca_bundle is None:
        with open(os.path.join(tdir, "ca.pem"), "rb") as f:
            ca_bundle = f.read()
    return TlsProfile(cert, key, ca_bundle)


def load_org_msp(org_dir: str) -> MSP:
    """The org's MSP from a ``write_org`` directory."""
    with open(os.path.join(org_dir, "msp", "config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(org_dir, "msp", "cacerts", "ca.pem"), "rb") as f:
        root_pem = f.read()
    return MSP(cfg["msp_id"], root_certs=[root_pem], node_ous=bool(cfg.get("node_ous", True)))


def load_signing_identity(msp_dir: str, msp_id: str) -> SigningIdentity:
    """A signing identity from an msp/ directory (keystore + signcerts)."""
    with open(os.path.join(msp_dir, "keystore", "key.pem"), "rb") as f:
        key_pem = f.read()
    with open(os.path.join(msp_dir, "signcerts", "cert.pem"), "rb") as f:
        cert_pem = f.read()
    return SigningIdentity.from_pem(msp_id, key_pem, cert_pem)
