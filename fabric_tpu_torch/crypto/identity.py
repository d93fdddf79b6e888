"""Decoded identities (counterpart: ``fabric_tpu/crypto/identity.py``,
trimmed to what block validation reads).

The reference deserializes an x509 certificate per identity; the port
takes identities already decoded by its front end: the MSP id, the
role the MSP assigned, the P-256 public key and whether the
certificate chain validated.  An identity without an EC key (an idemix
credential) has ``qx``/``qy`` None.
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

    @property
    def has_ec_key(self) -> bool:
        return self.qx is not None and self.qy is not None
