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
"""

from __future__ import annotations

from dataclasses import dataclass

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
