"""Decoded identities (counterpart: ``fabric_tpu/crypto/identity.py``,
trimmed to what block validation reads, and the identity of
``fabric_tpu/crypto/idemix.py::IdemixIdentity``).

The reference keeps the parsed x509 certificate per identity; the
port's MSP (``crypto/msp.py``) keeps what block validation reads: the
MSP id, the role the MSP assigned, the P-256 public key and whether the
certificate chain validated.  An identity without a P-256 key has
``qx``/``qy`` None.

``IdemixIdentity`` is an identity of an idemix MSP
(``crypto/idemix.py``): the MSP id, the disclosed role and OU, whether
the serialized form has the idemix shape (``is_valid``), no EC key
(``has_ec_key`` False, ``idemix`` True), and ``verify(message, sig)``,
the presentation check under its MSP's current key and epoch record.
``crypto/policy.py::Principal.matched_by`` reads it like any other.

``SigningIdentity`` is the local signer: a P-256 scalar, its
certificate and the MSP id (``from_pem`` reads a cryptogen keystore's
PKCS#8 or SEC1 key and its certificate, as the reference's does).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

ROLE_CLIENT = "client"
ROLE_PEER = "peer"
ROLE_ADMIN = "admin"
ROLE_ORDERER = "orderer"


@dataclass(frozen=True)
class Identity:
    msp_id: str
    role: str
    qx: int | None
    qy: int | None
    is_valid: bool = True
    idemix = False  # class attribute, not a field

    @property
    def has_ec_key(self) -> bool:
        return self.qx is not None and self.qy is not None


class IdemixIdentity:
    """An idemix MSP's identity; ``msp``: the ``IdemixMSP`` it was
    deserialized by (its proofs verify there)."""

    __slots__ = ("msp_id", "role", "ou", "is_valid", "serialized", "msp")
    qx = qy = None
    idemix = True
    has_ec_key = False

    def __init__(self, msp_id: str, role: str, ou: str, is_valid: bool, serialized: bytes, msp):
        self.msp_id, self.role, self.ou = msp_id, role, ou
        self.is_valid, self.serialized, self.msp = is_valid, serialized, msp

    def verify(self, message: bytes, sig: bytes) -> bool:
        return self.msp.verify(self.ou, self.role, message, sig)


@dataclass
class SigningIdentity:
    """A private scalar, its certificate and the MSP id."""

    msp_id: str
    d: int
    cert_pem: bytes

    @classmethod
    def from_pem(cls, msp_id: str, key_pem: bytes, cert_pem: bytes) -> "SigningIdentity":
        """A ``PRIVATE KEY`` / ``EC PRIVATE KEY`` PEM and a certificate
        PEM; the certificate is re-armoured as the reference re-encodes
        it, so both packages serialize the same identity bytes."""
        from fabric_tpu_torch.crypto import der

        return cls(msp_id, der.read_pem_private_key(key_pem),
                   der.pem_encode(der.pem_certificate(cert_pem)))

    @cached_property
    def serialized(self) -> bytes:
        from fabric_tpu_torch.protos.messages import SerializedIdentity

        return SerializedIdentity(mspid=self.msp_id, id_bytes=self.cert_pem).serialize()

    @cached_property
    def public(self):
        from fabric_tpu_torch.crypto import ec_ref

        return ec_ref.pt_mul(self.d, ec_ref.G)

    def sign(self, message: bytes) -> bytes:
        """DER ECDSA-SHA256 signature (RFC 6979 nonce, low-S)."""
        from fabric_tpu_torch.crypto import ec_ref

        return ec_ref.der_encode_sig(*ec_ref.SigningKey(self.d).sign_digest(
            ec_ref.digest_int(message)))
