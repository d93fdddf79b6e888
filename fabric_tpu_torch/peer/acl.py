"""ACLs: API-resource → channel-policy mapping, enforced with the
requester's SIGNATURE (not just its identity) (counterpart:
``fabric_tpu/peer/acl.py``).

Reference: core/aclmgmt — resources like "peer/Propose" map to policy
refs ("/Channel/Application/Writers"); the check evaluates the policy
against the request's signed data (aclmgmt/resourceprovider.go).  The
endorser wires this in front of simulation (endorser.go:315 auth
phase); deliver/query surfaces use Readers."""

from __future__ import annotations

from fabric_tpu_torch.channelconfig import SignedData

PROPOSE = "peer/Propose"
DELIVER = "event/Block"
QUERY = "qscc/GetChainInfo"
SNAPSHOT = "snapshot/submit"

DEFAULT_POLICY_REFS = {
    PROPOSE: "/Channel/Application/Writers",
    DELIVER: "/Channel/Application/Readers",
    QUERY: "/Channel/Application/Readers",
    SNAPSHOT: "/Channel/Application/Admins",
}


class ACLProvider:
    """Evaluates resource policies against a channel's live bundle."""

    def __init__(self, bundle_source, overrides: dict | None = None):
        """bundle_source: zero-arg callable → channelconfig.Bundle —
        the LIVE bundle (config updates rotate it)."""
        self._bundle = bundle_source
        self.refs = {**DEFAULT_POLICY_REFS, **(overrides or {})}

    def check(self, resource: str, identity_bytes: bytes, message: bytes,
              signature: bytes) -> bool:
        """True iff the signer satisfies the resource's policy — the
        signature is over ``message`` (e.g. the proposal bytes), so a
        stolen identity without the key cannot pass."""
        ref = self.refs.get(resource)
        bundle = self._bundle()
        if bundle is None:
            return False  # no policy source → fail CLOSED (aclmgmt)
        if ref is None:
            return True  # unmapped resources follow the open default
        sd = SignedData(identity=identity_bytes, data=message,
                        signature=signature)
        return bundle.policy_manager.evaluate(ref, [sd])
