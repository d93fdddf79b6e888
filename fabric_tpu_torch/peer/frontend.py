"""The block front end: wire-format blocks → ``DecodedBlock``
(counterpart: ``fabric_tpu/peer/validator.py::_parse_one_py``
:980-1101, the reference's envelope parser, and the part of
``fabric_tpu/native/blockparse.cpp`` that hashes the signed messages).

``decode_block(block, msp)`` walks every envelope with the port's wire
codec and MSP, in the reference's check order and with its codes:

* an empty envelope → NIL_ENVELOPE;
* an envelope, payload, channel header or signature header that does
  not decode → BAD_PAYLOAD;
* a config envelope sets ``is_config`` and keeps its payload data (the
  ``ConfigEnvelope`` bytes, parsed when the validator judges it), its
  creator and the creator's signature (digest sha256(payload)) when
  they decode; the validator checks the creator unless the block is
  the genesis block (the reference's :1005-1023);
* a header type other than ENDORSER_TRANSACTION → UNKNOWN_TX_TYPE;
* a tx id that is empty or not sha256(nonce ‖ creator) →
  BAD_PROPOSAL_TXID; every later envelope is bound (``txid_bound``) and
  claims its tx id for the validator's duplicate check
  (DUPLICATE_TXID), whatever fails after;
* a creator that does not deserialize → BAD_CREATOR_SIGNATURE;
* an idemix creator (``crypto/idemix.py``): its presentation proof over
  the payload is verified here, on the host, as the reference's
  :1054-1069 does; an invalid identity or a proof that fails →
  BAD_CREATOR_SIGNATURE, else ``host_creator_ok`` and no signature item;
* an X.509 creator that is invalid, has no P-256 key, or whose
  signature is no DER ECDSA-Sig-Value → BAD_CREATOR_SIGNATURE, as in the
  reference; the digest is sha256(payload);
* the action: no actions → NIL_TXACTION, a transaction, action
  payload, proposal response payload or chaincode action that does not
  decode → BAD_PAYLOAD, a read/write set that does not decode →
  BAD_RWSET;
* endorsements: one that does not deserialize, has no P-256 key (an
  idemix endorser included) or no DER signature is dropped, as in the
  reference; the others keep their serialized endorser, by which the
  validator deduplicates (:1085-1095); the digest is
  sha256(proposal response payload ‖ endorser).

Digests are hashed on the host with ``hashlib``, as the reference's
``_sig_item`` (:2634) does.  ``BlockValidator`` decodes with
``decode_envelope`` the envelopes its C walk (``native/blockparse.cpp``)
leaves to it, in block order, as the reference's ``_parse_one_py``
lane; ``decode_block`` makes the ``DecodedBlock`` entry's form.
"""

from __future__ import annotations

import hashlib

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.ledger.rwset import TxRWSet
from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
from fabric_tpu_torch.peer.decoded import DecodedBlock, DecodedEndorsement, DecodedTx
from fabric_tpu_torch.protos import messages as m
from fabric_tpu_torch.protos.wire import DecodeError

_EMPTY_HEADER = m.Header()


def _digest(data: bytes) -> int:
    return int.from_bytes(hashlib.sha256(data).digest(), "big")


def decode_envelope(raw: bytes, msp) -> DecodedTx:
    """One serialized envelope → ``DecodedTx`` (its ``code`` stays
    NOT_VALIDATED unless the envelope failed a front-end check)."""
    dtx = DecodedTx()
    if not raw:
        dtx.code, dtx.txid_bound = int(C.NIL_ENVELOPE), False
        return dtx
    try:
        env = m.Envelope.parse(raw)
        payload = m.Payload.parse(env.payload)
        hdr = payload.header or _EMPTY_HEADER
        ch = m.ChannelHeader.parse(hdr.channel_header)
        sh = m.SignatureHeader.parse(hdr.signature_header)
    except DecodeError:
        dtx.code, dtx.txid_bound = int(C.BAD_PAYLOAD), False
        return dtx
    dtx.txid = ch.tx_id
    if ch.type == m.HEADER_CONFIG:
        dtx.is_config, dtx.txid_bound, dtx.config_data = True, False, payload.data
        try:
            creator = msp.deserialize_identity(sh.creator)
            r, s = ec_ref.der_decode_sig(env.signature)
        except ValueError:
            return dtx
        dtx.creator = creator
        if creator.is_valid and creator.has_ec_key:
            dtx.creator_sig = (_digest(env.payload), r, s)
        return dtx
    if ch.type != m.HEADER_ENDORSER_TRANSACTION:
        dtx.code, dtx.txid_bound = int(C.UNKNOWN_TX_TYPE), False
        return dtx
    if not ch.tx_id or ch.tx_id != protoutil.compute_tx_id(sh.nonce, sh.creator):
        dtx.code, dtx.txid_bound = int(C.BAD_PROPOSAL_TXID), False
        return dtx
    try:
        creator = msp.deserialize_identity(sh.creator)
    except ValueError:
        dtx.code = int(C.BAD_CREATOR_SIGNATURE)
        return dtx
    if creator.idemix:
        if not creator.is_valid or not creator.verify(env.payload, env.signature):
            dtx.code = int(C.BAD_CREATOR_SIGNATURE)
            return dtx
        dtx.creator, dtx.host_creator_ok = creator, True
    else:
        try:
            r, s = ec_ref.der_decode_sig(env.signature)
        except ValueError:
            dtx.code = int(C.BAD_CREATOR_SIGNATURE)
            return dtx
        if not creator.is_valid or not creator.has_ec_key:
            dtx.code = int(C.BAD_CREATOR_SIGNATURE)
            return dtx
        dtx.creator, dtx.creator_sig = creator, (_digest(env.payload), r, s)
    try:
        _, _, cap, _, cca = protoutil.extract_action(env, parsed=(payload, ch, sh))
        dtx.rwset = TxRWSet.from_bytes(cca.results)
    except protoutil.TxParseError as e:
        dtx.code = int(e.code)
        return dtx
    except DecodeError:
        dtx.code = int(C.BAD_RWSET)
        return dtx
    prp = cap.action.proposal_response_payload
    for e in cap.action.endorsements:
        try:
            ident = msp.deserialize_identity(e.endorser)
            r, s = ec_ref.der_decode_sig(e.signature)
        except ValueError:
            continue
        if ident.has_ec_key:
            dtx.endorsements.append(DecodedEndorsement(ident, _digest(prp + e.endorser), r, s,
                                                       serialized=e.endorser))
    return dtx


def decode_block(block: m.Block, msp) -> DecodedBlock:
    """A wire block → ``DecodedBlock`` (every envelope decoded; the
    in-block duplicate check is the validator's)."""
    envs = block.data.data if block.data is not None else []
    number = block.header.number if block.header is not None else 0
    return DecodedBlock(number=number, txs=[decode_envelope(raw, msp) for raw in envs])
