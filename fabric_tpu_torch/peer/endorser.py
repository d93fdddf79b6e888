"""Endorser: ProcessProposal — simulate a proposal and sign the result
(counterpart: ``fabric_tpu/peer/endorser.py``).

Analog of core/endorser/endorser.go:304-476: unpack + auth the signed
proposal, run the chaincode against a tx simulator, wrap the rwset in
a ProposalResponsePayload whose hash binds (proposal, results), and
sign prp‖endorser with the peer's signing identity (the default ESCC,
core/handlers/endorsement/builtin/default_endorsement.go:35).  The
signature bytes produced here are EXACTLY what ``p256_verify`` checks
at commit (``peer/txassembly.py::create_proposal_response``).

The proposal check (creator, signature, tx id, ACL) runs on the host,
as the reference's does: the signature through
``crypto/msp.py::verify_signature`` (``ec_ref``).  The ESCC signature
goes through the peer's signing provider: a ``SigningIdentity``, or a
``peer/signlane.py::BatchedSigner`` whose ``sign`` queues on the card's
sign lane (``p256_sign``); a full lane's ``SignBusy`` becomes a 429
response."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.crypto.msp import verify_signature
from fabric_tpu_torch.peer import txassembly as txa
from fabric_tpu_torch.peer.chaincode import ChaincodeError, ChaincodeRuntime
from fabric_tpu_torch.peer.signlane import SignBusy
from fabric_tpu_torch.peer.simulator import TxSimulator
from fabric_tpu_torch.protos import messages as m


@dataclass
class EndorseResult:
    response: m.ProposalResponse
    pvt_cleartext: dict = field(default_factory=dict)
    tx_id: str = ""


class Endorser:
    def __init__(self, msp_manager, signer, state_db,
                 runtime: ChaincodeRuntime, acl_check=None):
        """signer: the peer's ESCC signing PROVIDER — a
        SigningIdentity, or a signlane.BatchedSigner routing ``sign``
        through the card's sign lane (same ``sign`` + ``serialized``
        surface; a provider answering SignBusy maps to a 429 proposal
        response below).
        acl_check(channel, creator_bytes, message, signature) -> bool
        (the peer/Propose Writers-policy gate, aclmgmt)."""
        self.msp = msp_manager
        self.signer = signer
        self.state = state_db
        self.runtime = runtime
        self.acl_check = acl_check

    def process_proposal(self, signed: m.SignedProposal) -> EndorseResult:
        prop = m.Proposal.parse(signed.proposal_bytes)
        header = m.Header.parse(prop.header)
        ch = m.ChannelHeader.parse(header.channel_header)
        sh = m.SignatureHeader.parse(header.signature_header)

        # auth: creator identity valid + signature over proposal bytes
        # (endorser.go:315-339 preProcess → validateSignedProposal)
        ident = self.msp.deserialize_identity(sh.creator)
        if not ident.is_valid:
            return self._err(500, "invalid creator identity")
        if not verify_signature(ident, signed.proposal_bytes, signed.signature):
            return self._err(500, "invalid proposal signature")
        if ch.tx_id != protoutil.compute_tx_id(sh.nonce, sh.creator):
            return self._err(500, "tx_id mismatch")
        if self.acl_check is not None and not self.acl_check(
                ch.channel_id, sh.creator, signed.proposal_bytes, signed.signature):
            return self._err(403, "access denied")

        # what to run
        cpp = m.ChaincodeProposalPayload.parse(prop.payload)
        spec = m.ChaincodeInvocationSpec.parse(cpp.input).chaincode_spec or m.ChaincodeSpec()
        cc_name = (spec.chaincode_id or m.ChaincodeID()).name
        args = list((spec.input or m.ChaincodeInput()).args)
        transient = dict(cpp.TransientMap)

        # simulate (endorser.go:379-401 GetTxSimulator + simulateProposal)
        sim = TxSimulator(self.state)
        try:
            resp = self.runtime.execute(sim, cc_name, args, transient=transient,
                                        creator=sh.creator, channel=ch.channel_id)
        except ChaincodeError as e:
            return self._err(500, str(e))
        if resp.status >= 400:
            # failed simulation is NOT endorsed (no rwset leaves the peer)
            return self._err(resp.status, resp.message)
        rwset_bytes, pvt_clear = sim.done()

        events = b""
        ev_list = getattr(resp, "events", [])
        if ev_list:
            name, payload = ev_list[-1]  # one event per tx, like the shim
            events = m.ChaincodeEvent(chaincode_id=cc_name, tx_id=ch.tx_id,
                                      event_name=name, payload=payload).serialize()

        # assemble + ESCC-sign
        try:
            pr = txa.create_proposal_response(prop, rwset_bytes, self.signer, cc_name,
                                              response_payload=resp.payload, events=events,
                                              status=resp.status)
        except SignBusy as e:
            # typed overflow from a full sign batcher: the simulation
            # ran but no signature leaves — 429 tells the client (and
            # the gateway layout loop) to back off and retry
            return self._err(429, str(e))
        return EndorseResult(response=pr, pvt_cleartext=pvt_clear, tx_id=ch.tx_id)

    @staticmethod
    def _err(status: int, msg: str) -> EndorseResult:
        return EndorseResult(response=m.ProposalResponse(
            response=m.Response(status=status, message=msg)))


def proposal_digest(signed: m.SignedProposal) -> bytes:
    return hashlib.sha256(signed.proposal_bytes).digest()


def response_status(pr: m.ProposalResponse) -> int:
    """A proposal response's status (an absent response reads as 0, as
    protobuf's default sub-message does)."""
    return pr.response.status if pr.response is not None else 0
