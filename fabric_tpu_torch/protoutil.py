"""Wire-format helpers over the port's messages (counterpart:
``fabric_tpu/protoutil.py``): the nonce and transaction id, the block
header and data hashes, block assembly and the orderer's block
signatures (``sign_block``, ``block_signed_data``), an envelope as the
policy engine's signed data, action extraction with its validation
codes, and the TRANSACTIONS_FILTER helpers."""

from __future__ import annotations

import hashlib
import os

from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
from fabric_tpu_torch.protos import messages as m
from fabric_tpu_torch.protos.wire import DecodeError

# ---------------------------------------------------------------------------
# Minimal DER (only what the header hash needs)


def _der_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def _der_int(x: int) -> bytes:
    if x == 0:
        body = b"\x00"
    else:
        body = x.to_bytes((x.bit_length() + 8) // 8, "big")  # leading 0 if MSB set
        if body[0] == 0 and len(body) > 1 and body[1] < 0x80:
            body = body[1:]
    return b"\x02" + _der_len(len(body)) + body


def _der_octets(b: bytes) -> bytes:
    return b"\x04" + _der_len(len(b)) + b


def block_header_bytes(header: m.BlockHeader) -> bytes:
    """ASN.1 DER of (number, previous_hash, data_hash)."""
    body = (_der_int(header.number) + _der_octets(header.previous_hash)
            + _der_octets(header.data_hash))
    return b"\x30" + _der_len(len(body)) + body


def block_header_hash(header: m.BlockHeader) -> bytes:
    return hashlib.sha256(block_header_bytes(header)).digest()


def block_data_hash(data: m.BlockData) -> bytes:
    """SHA-256 over the concatenated serialized envelopes."""
    return hashlib.sha256(b"".join(data.data)).digest()


# ---------------------------------------------------------------------------
# IDs and blocks


def random_nonce() -> bytes:
    return os.urandom(24)


def compute_tx_id(nonce: bytes, creator: bytes) -> str:
    return hashlib.sha256(nonce + creator).hexdigest()


def new_block(number: int, previous_hash: bytes) -> m.Block:
    """An empty block with the five metadata slots."""
    return m.Block(header=m.BlockHeader(number=number, previous_hash=previous_hash),
                   data=m.BlockData(),
                   metadata=m.BlockMetadata(metadata=[b""] * m.N_METADATA))


def finalize_block(blk: m.Block) -> m.Block:
    blk.header.data_hash = block_data_hash(blk.data)
    return blk


def sign_block(blk: m.Block, signer) -> None:
    """Append the orderer's signature to the SIGNATURES metadata (the
    reference's :224): signed bytes = metadata.value ‖ signature header
    ‖ header hash, binding the signature to this block's header."""
    md = m.Metadata()
    slots = blk.metadata.metadata
    if len(slots) > m.META_SIGNATURES and slots[m.META_SIGNATURES]:
        md = m.Metadata.parse(slots[m.META_SIGNATURES])
    sh = m.SignatureHeader(creator=signer.serialized, nonce=os.urandom(24)).serialize()
    sig = signer.sign(md.value + sh + block_header_hash(blk.header))
    md.signatures.append(m.MetadataSignature(signature_header=sh, signature=sig))
    while len(slots) <= m.META_SIGNATURES:
        slots.append(b"")
    slots[m.META_SIGNATURES] = md.serialize()


def block_signed_data(blk: m.Block) -> list:
    """SIGNATURES metadata → [(creator identity bytes, signed bytes,
    signature)] (the reference's :247); a signature whose header does
    not parse contributes nothing."""
    slots = blk.metadata.metadata if blk.metadata is not None else []
    if len(slots) <= m.META_SIGNATURES or not slots[m.META_SIGNATURES]:
        return []
    md = m.Metadata.parse(slots[m.META_SIGNATURES])
    hh = block_header_hash(blk.header)
    out = []
    for ms in md.signatures:
        try:
            sh = m.SignatureHeader.parse(ms.signature_header)
        except DecodeError:
            continue
        out.append((sh.creator, md.value + ms.signature_header + hh, ms.signature))
    return out


def envelope_as_signed_data(env: m.Envelope):
    """An envelope as the policy engine's ``SignedData`` (payload,
    creator, signature; the reference's :140)."""
    from fabric_tpu_torch.channelconfig import SignedData

    payload = m.Payload.parse(env.payload)
    sh = m.SignatureHeader.parse((payload.header or m.Header()).signature_header)
    return SignedData(identity=sh.creator, data=env.payload, signature=env.signature)


def channel_header(env_bytes: bytes) -> m.ChannelHeader:
    """The channel header of a serialized envelope (raises
    ``DecodeError`` on bytes that do not parse)."""
    payload = m.Payload.parse(m.Envelope.parse(env_bytes).payload)
    return m.ChannelHeader.parse((payload.header or m.Header()).channel_header)


# ---------------------------------------------------------------------------
# Transaction extraction


class TxParseError(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


def extract_action(env: m.Envelope, parsed=None):
    """Envelope → (channel header, signature header,
    ChaincodeActionPayload, ProposalResponsePayload, ChaincodeAction)
    of an endorser transaction.  ``parsed``: the already-decoded
    (payload, channel header, signature header).  Raises
    ``TxParseError`` with the reference's code on a malformed structure.
    An absent sub-message reads as an empty one, as in protobuf."""
    if not env.payload:
        raise TxParseError(C.NIL_ENVELOPE, "empty payload")
    try:
        if parsed is not None:
            payload, ch, sh = parsed
        else:
            payload = m.Payload.parse(env.payload)
            hdr = payload.header or m.Header()
            ch = m.ChannelHeader.parse(hdr.channel_header)
            sh = m.SignatureHeader.parse(hdr.signature_header)
    except DecodeError as e:
        raise TxParseError(C.BAD_PAYLOAD, f"bad payload: {e}") from e
    if ch.type != m.HEADER_ENDORSER_TRANSACTION:
        raise TxParseError(C.UNKNOWN_TX_TYPE, f"type {ch.type}")
    try:
        tx = m.Transaction.parse(payload.data)
        if not tx.actions:
            raise TxParseError(C.NIL_TXACTION, "no actions")
        cap = m.ChaincodeActionPayload.parse(tx.actions[0].payload)
        if cap.action is None:
            cap.action = m.ChaincodeEndorsedAction()
        prp = m.ProposalResponsePayload.parse(cap.action.proposal_response_payload)
        cca = m.ChaincodeAction.parse(prp.extension)
    except DecodeError as e:
        raise TxParseError(C.BAD_PAYLOAD, f"bad tx: {e}") from e
    return ch, sh, cap, prp, cca


# ---------------------------------------------------------------------------
# TRANSACTIONS_FILTER


def new_tx_filter(n: int) -> bytearray:
    return bytearray([C.NOT_VALIDATED] * n)


def set_tx_filter(block: m.Block, flags: bytes) -> None:
    if block.metadata is None:
        block.metadata = m.BlockMetadata()
    md = block.metadata.metadata
    while len(md) <= m.META_TRANSACTIONS_FILTER:
        md.append(b"")
    md[m.META_TRANSACTIONS_FILTER] = bytes(flags)


def get_tx_filter(block: m.Block) -> bytes:
    md = block.metadata.metadata if block.metadata is not None else []
    if len(md) > m.META_TRANSACTIONS_FILTER and md[m.META_TRANSACTIONS_FILTER]:
        return md[m.META_TRANSACTIONS_FILTER]
    n = len(block.data.data) if block.data is not None else 0
    return bytes(new_tx_filter(n))


def tx_flag_is_valid(flags: bytes, i: int) -> bool:
    return flags[i] == C.VALID


# ---------------------------------------------------------------------------
# The block's wire form without its metadata (the ledger commit)


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def block_header_data_bytes(block: m.Block) -> bytes:
    """The serialized header and data fields (1 and 2) of ``block``
    without its metadata (the reference's :82): built off the commit
    thread, so the committer only splices the final metadata on
    (``append_block_metadata``).  The envelopes are framed as they
    are, not re-encoded; an empty data field is left out."""
    h = (block.header or m.BlockHeader()).serialize()
    frames, n = [], 0
    for env in (block.data.data if block.data is not None else ()):
        tag = b"\x0a" + _pb_varint(len(env))
        frames += (tag, env)
        n += len(tag) + len(env)
    head = [b"\x0a", _pb_varint(len(h)), h]
    if n:
        head += (b"\x12", _pb_varint(n))
    return b"".join(head + frames)  # one copy of the envelopes


def append_block_metadata(hd_bytes: bytes, block: m.Block) -> bytes:
    """``block_header_data_bytes`` output and the block's current
    metadata (field 3) → bytes that parse as ``block`` does (the
    reference's :104)."""
    md = (block.metadata or m.BlockMetadata()).serialize()
    return hd_bytes + b"\x1a" + _pb_varint(len(md)) + md
