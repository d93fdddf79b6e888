"""Transaction assembly: proposal → endorsements → envelope → block
(counterpart: ``fabric_tpu/peer/txassembly.py:17-140``), over the
port's messages.

``create_signed_proposal``, ``create_proposal_response``,
``prepare_transaction`` and ``assemble_transaction`` build what the
reference's functions build, signing one message at a time with
``SigningIdentity.sign``.  ``build_envelopes`` builds many
transactions at once and signs in two batches: every endorsement in one
``sign_batch(digests, keys)`` call, then every creator signature in
another, so a signer on the card (``ops/p256sign.sign_digests``) signs a
whole block's worth per launch.  A signer without an ECDSA scalar (an
idemix holder, ``crypto/idemix.py::IdemixSigningIdentity``) signs its
own messages on the host, one presentation each.  As in the reference,
every proposal takes a fresh random nonce and the current time.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.crypto.cryptogen import ec_ref_signer
from fabric_tpu_torch.protos import messages as m


def _timestamp() -> m.Timestamp:
    now = time.time()
    return m.Timestamp(seconds=int(now), nanos=int((now % 1) * 1e9))


def _proposal(creator: bytes, channel_id: str, chaincode: str, args, transient=None):
    """→ (Proposal, tx_id)."""
    nonce = protoutil.random_nonce()
    tx_id = protoutil.compute_tx_id(nonce, creator)
    ext = m.ChaincodeHeaderExtension(chaincode_id=m.ChaincodeID(name=chaincode))
    ch = m.ChannelHeader(type=m.HEADER_ENDORSER_TRANSACTION, channel_id=channel_id,
                         tx_id=tx_id, extension=ext.serialize(),
                         timestamp=_timestamp()).serialize()
    sh = m.SignatureHeader(creator=creator, nonce=nonce).serialize()
    spec = m.ChaincodeInvocationSpec(chaincode_spec=m.ChaincodeSpec(
        type=m.CHAINCODE_EXTERNAL, chaincode_id=m.ChaincodeID(name=chaincode),
        input=m.ChaincodeInput(args=list(args))))
    cpp = m.ChaincodeProposalPayload(input=spec.serialize(), TransientMap=dict(transient or {}))
    prop = m.Proposal(header=m.Header(channel_header=ch, signature_header=sh).serialize(),
                      payload=cpp.serialize())
    return prop, tx_id


def create_signed_proposal(signer, channel_id: str, chaincode: str, args,
                           transient: dict | None = None):
    """→ (SignedProposal, tx_id, Proposal)."""
    prop, tx_id = _proposal(signer.serialized, channel_id, chaincode, args, transient)
    pbytes = prop.serialize()
    return m.SignedProposal(proposal_bytes=pbytes, signature=signer.sign(pbytes)), tx_id, prop


def proposal_hash(prop: m.Proposal) -> bytes:
    return hashlib.sha256(prop.serialize()).digest()


def _prp(prop, rwset_bytes, chaincode, response_payload=b"", events=b"", status=200) -> bytes:
    cca = m.ChaincodeAction(results=rwset_bytes, events=events,
                            response=m.Response(status=status, payload=response_payload),
                            chaincode_id=m.ChaincodeID(name=chaincode))
    return m.ProposalResponsePayload(proposal_hash=proposal_hash(prop),
                                     extension=cca.serialize()).serialize()


def create_proposal_response(prop: m.Proposal, rwset_bytes: bytes, endorser_signer,
                             chaincode: str, response_payload: bytes = b"",
                             events: bytes = b"", status: int = 200) -> m.ProposalResponse:
    """Endorse: the proposal response payload, signed over
    ``prp ‖ endorser`` (the bytes the validator verifies)."""
    prp = _prp(prop, rwset_bytes, chaincode, response_payload, events, status)
    endorser = endorser_signer.serialized
    return m.ProposalResponse(
        payload=prp, response=m.Response(status=status),
        endorsement=m.Endorsement(endorser=endorser,
                                  signature=endorser_signer.sign(prp + endorser)))


def _payload(prop: m.Proposal, prp: bytes, endorsements) -> bytes:
    header = m.Header.parse(prop.header)
    cap = m.ChaincodeActionPayload(
        chaincode_proposal_payload=prop.payload,
        action=m.ChaincodeEndorsedAction(proposal_response_payload=prp,
                                         endorsements=list(endorsements)))
    tx = m.Transaction(actions=[m.TransactionAction(header=header.signature_header,
                                                    payload=cap.serialize())])
    return m.Payload(header=header, data=tx.serialize()).serialize()


def prepare_transaction(prop: m.Proposal, responses) -> bytes:
    """The unsigned transaction payload (serialized ``Payload``) from
    matching proposal responses."""
    if not responses:
        raise ValueError("no proposal responses")
    if len({r.payload for r in responses}) != 1:
        raise ValueError("proposal responses disagree")
    ends = [m.Endorsement(endorser=r.endorsement.endorser, signature=r.endorsement.signature)
            for r in responses]
    return _payload(prop, responses[0].payload, ends)


def assemble_transaction(prop: m.Proposal, responses, creator_signer) -> m.Envelope:
    payload = prepare_transaction(prop, responses)
    return m.Envelope(payload=payload, signature=creator_signer.sign(payload))


# ---------------------------------------------------------------------------
# Batched building


@dataclass
class TxSpec:
    """One transaction to build: its creator and endorsers
    (``SigningIdentity``), the serialized read/write set, the chaincode."""

    creator: object
    endorsers: list
    rwset: bytes
    chaincode: str
    channel_id: str = "channel"
    args: tuple = (b"invoke",)


def _batched(signer) -> bool:
    return getattr(signer, "d", None) is not None


def _sign_all(messages, signers, sign_batch) -> list[bytes]:
    """Each message signed by its signer: the ECDSA ones in one
    ``sign_batch`` call (DER), the others by their own ``sign``."""
    rows = [k for k, s in enumerate(signers) if _batched(s)]
    out = [None] * len(messages)
    if rows:
        rs = sign_batch([ec_ref.digest_int(messages[k]) for k in rows],
                        [signers[k].d for k in rows])
        for k, sig in zip(rows, rs):
            out[k] = ec_ref.der_encode_sig(*sig)
    for k, s in enumerate(signers):
        if out[k] is None:
            out[k] = s.sign(messages[k])
    return out


def build_envelopes(specs, sign_batch=ec_ref_signer) -> list[bytes]:
    """Serialized envelopes for ``specs``, signed in two batches:
    ``sign_batch(digests, keys) → [(r, s)]`` is called once for all
    endorsements and once for all creator signatures (each call left out
    when it has nothing to sign); an idemix signer signs on the host."""
    props, prps, msgs, signers = [], [], [], []
    for sp in specs:
        prop, _ = _proposal(sp.creator.serialized, sp.channel_id, sp.chaincode, sp.args)
        prp = _prp(prop, sp.rwset, sp.chaincode)
        props.append(prop)
        prps.append(prp)
        for e in sp.endorsers:
            msgs.append(prp + e.serialized)
            signers.append(e)
    sigs = iter(_sign_all(msgs, signers, sign_batch))
    payloads = []
    for sp, prop, prp in zip(specs, props, prps):
        ends = [m.Endorsement(endorser=e.serialized, signature=next(sigs))
                for e in sp.endorsers]
        payloads.append(_payload(prop, prp, ends))
    csigs = _sign_all(payloads, [sp.creator for sp in specs], sign_batch)
    return [m.Envelope(payload=p, signature=sig).serialize() for p, sig in zip(payloads, csigs)]


def build_block(number: int, previous_hash: bytes, envelopes) -> m.Block:
    """A block of serialized envelopes with its data hash."""
    blk = protoutil.new_block(number, previous_hash)
    blk.data.data.extend(envelopes)
    return protoutil.finalize_block(blk)
