"""The decoded block form the validator takes (the front end's output,
``peer/frontend.py``): per transaction the txid, the creator identity
and signature, the endorsements, and the read/write set.  Each
signature arrives as (digest, r, s), the digest being the SHA-256 the
reference hashes (the payload for the creator, the proposal response
payload plus the serialized endorser for an endorsement)."""

from __future__ import annotations

from dataclasses import dataclass, field

from fabric_tpu_torch.crypto.identity import Identity
from fabric_tpu_torch.ledger.rwset import TxRWSet
from fabric_tpu_torch.peer.txcodes import TxValidationCode as C


@dataclass
class DecodedEndorsement:
    endorser: Identity
    digest: int  # sha256(proposal_response_payload || serialized endorser)
    r: int
    s: int
    serialized: bytes  # the serialized endorser: the validator's deduplication key


@dataclass
class DecodedTx:
    """One envelope as the front end decoded it.  ``code`` stays
    NOT_VALIDATED unless the front end failed on the envelope (e.g.
    NIL_ENVELOPE, BAD_PAYLOAD, BAD_PROPOSAL_TXID, BAD_CREATOR_SIGNATURE
    for an undeserializable creator, BAD_RWSET).  ``txid_bound``: the
    header parsed as an endorser transaction whose tx_id equals
    sha256(nonce || creator) — such a transaction claims its txid for the
    in-block duplicate check even if a later decoding step failed.  A
    config envelope has ``is_config``, ``config_data``, and its creator
    and ``creator_sig`` when they decode (no signature for a creator
    that is invalid or has no P-256 key).  ``host_creator_ok``: the
    creator is an idemix identity whose presentation proof over the
    payload the front end verified on the host (the reference's
    ``ParsedTx.host_creator_ok``); such a transaction has no
    ``creator_sig``, and the validator gives it the always-true creator
    lane."""

    txid: str = ""
    code: int = int(C.NOT_VALIDATED)
    txid_bound: bool = True
    creator: Identity | None = None
    creator_sig: tuple | None = None  # (digest, r, s); digest = sha256(payload)
    host_creator_ok: bool = False
    endorsements: list = field(default_factory=list)  # [DecodedEndorsement]
    rwset: TxRWSet | None = None
    is_config: bool = False
    config_data: bytes = b""  # a config envelope's payload data (its ConfigEnvelope)


@dataclass
class DecodedBlock:
    number: int
    txs: list  # [DecodedTx]
