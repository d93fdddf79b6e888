"""Decoded identities (counterpart: ``fabric_tpu/crypto/identity.py``,
trimmed to what block validation reads).

The reference keeps the parsed x509 certificate per identity; the
port's MSP (``crypto/msp.py``) keeps what block validation reads: the
MSP id, the role the MSP assigned, the P-256 public key and whether the
certificate chain validated.  An identity without a P-256 key has
``qx``/``qy`` None.  ``idemix`` marks an identity of one of the
channel's idemix MSPs, whose credentials the port does not read yet:
it has no key and is not valid, and a creator of that kind is refused
(host-verified creators are a later slice of the port).
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
    idemix: bool = False

    @property
    def has_ec_key(self) -> bool:
        return self.qx is not None and self.qy is not None
