"""Chaincode lifecycle: the ``_lifecycle`` namespace as a system
contract + state-backed validation info for the plugin dispatcher
(counterpart: ``fabric_tpu/peer/lifecycle.py``; the same keys and the
same definition bytes).

Reference: core/chaincode/lifecycle (ExternalFunctions, the
``_lifecycle`` SCC, the cache feeding GetInfoForValidate —
plugindispatcher/dispatcher.go:266).  A chaincode definition is
agreed by approve/commit transactions whose writes land in the
``_lifecycle`` namespace of the SAME ledger the definitions govern, so
changing a chaincode's endorsement policy is itself an ordered,
validated, replayable transaction — and validation info for namespace
N is always read from committed state, never from node-local config.

Definition encoding: JSON (one state key per definition) rather than
the reference's per-field proto keys — the wire contract that matters
(rwset bytes) is unchanged.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from fabric_tpu_torch.crypto.msp import policy_from_proto, policy_to_proto
from fabric_tpu_torch.peer.chaincode import ChaincodeError, Contract, Response
from fabric_tpu_torch.peer.validator import LIFECYCLE_NS, NamespaceInfo
from fabric_tpu_torch.protos import messages as m


def definition_key(name: str) -> str:
    return f"namespaces/fields/{name}/Definition"


def approval_key(name: str, sequence: int, msp_id: str) -> str:
    return f"namespaces/approvals/{name}/{sequence}/{msp_id}"


@dataclass
class ChaincodeDefinition:
    """One committed chaincode definition (the dispatcher's
    GetInfoForValidate payload)."""

    name: str
    sequence: int
    plugin: str = "default"
    # policy: {"sig": hex(SignaturePolicyEnvelope)} or
    #         {"ref": "<channel application policy name>"}
    policy: dict = field(default_factory=lambda: {"ref": "Endorsement"})
    init_required: bool = False
    # collections: {name: {"member_orgs": [msp_id...],
    #   "required_peer_count": int, "max_peer_count": int, "btl": int}}
    # — the StaticCollectionConfig surface (peer/collection.proto:
    # member_orgs_policy, required/maximum peer counts, block_to_live)
    collections: dict = field(default_factory=dict)

    def to_bytes(self) -> bytes:
        return json.dumps(
            {
                "name": self.name,
                "sequence": self.sequence,
                "plugin": self.plugin,
                "policy": self.policy,
                "init_required": self.init_required,
                "collections": self.collections,
            },
            sort_keys=True,
        ).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "ChaincodeDefinition":
        d = json.loads(raw)
        return cls(
            name=d["name"], sequence=int(d["sequence"]),
            plugin=d.get("plugin", "default"),
            policy=d.get("policy", {"ref": "Endorsement"}),
            init_required=bool(d.get("init_required", False)),
            collections=d.get("collections", {}),
        )


def policy_spec_from_ast(rule) -> dict:
    return {"sig": policy_to_proto(rule).serialize().hex()}


class LifecycleContract(Contract):
    """The ``_lifecycle`` system contract (approve / commit / query).

    ``org_lister`` returns the channel's application org MSP ids (from
    the channelconfig bundle) — commit requires approvals from a
    MAJORITY of them, the reference's default LifecycleEndorsement
    policy shape.
    """

    def __init__(self, org_lister=None):
        self.org_lister = org_lister or (lambda: [])

    @staticmethod
    def _creator_msp(stub) -> str:
        sid = m.SerializedIdentity.parse(stub.creator)
        if not sid.mspid:
            raise ChaincodeError("no creator identity")
        return sid.mspid

    def approve(self, stub, name: bytes, sequence: bytes, spec: bytes = b"{}"):
        """ApproveChaincodeDefinitionForMyOrg: record this org's vote
        for (name, sequence, definition-hash)."""
        msp_id = self._creator_msp(stub)
        seq = int(sequence)
        cur = stub.get_state(definition_key(name.decode()))
        cur_seq = ChaincodeDefinition.from_bytes(cur).sequence if cur else 0
        if seq != cur_seq + 1:
            raise ChaincodeError(
                f"requested sequence {seq}, next committable is {cur_seq + 1}"
            )
        stub.put_state(
            approval_key(name.decode(), seq, msp_id),
            json.dumps(json.loads(spec or b"{}"), sort_keys=True).encode(),
        )
        return b"ok"

    def checkcommitreadiness(self, stub, name: bytes, sequence: bytes,
                             spec: bytes = b"{}"):
        ready = self._approvals(stub, name.decode(), int(sequence), spec)
        return json.dumps(ready, sort_keys=True).encode()

    @staticmethod
    def _norm_spec(raw: bytes) -> bytes:
        """Approval-comparison form: the package id is an ORG-LOCAL
        binding (which build this org runs), not part of the agreed
        definition — the reference likewise excludes packageID from
        the definition hash, so orgs running different builds of the
        same contract still converge."""
        d = json.loads(raw or b"{}")
        if not isinstance(d, dict):
            # a non-object approval can never normalize-match a real
            # spec; canonicalize without crashing commit for everyone
            return json.dumps(d, sort_keys=True).encode()
        d.pop("package_id", None)
        return json.dumps(d, sort_keys=True).encode()

    def _approvals(self, stub, name: str, seq: int, spec: bytes) -> dict:
        want = self._norm_spec(spec)
        out = {}
        for org in self.org_lister():
            got = stub.get_state(approval_key(name, seq, org))
            out[org] = got is not None and self._norm_spec(got) == want
        return out

    def commit(self, stub, name: bytes, sequence: bytes, spec: bytes = b"{}"):
        """CommitChaincodeDefinition: majority of orgs must have
        approved the identical definition at this sequence."""
        nm, seq = name.decode(), int(sequence)
        cur = stub.get_state(definition_key(nm))
        cur_seq = ChaincodeDefinition.from_bytes(cur).sequence if cur else 0
        if seq != cur_seq + 1:
            raise ChaincodeError(
                f"requested sequence {seq}, next committable is {cur_seq + 1}"
            )
        ready = self._approvals(stub, nm, seq, spec)
        approved = sum(1 for ok in ready.values() if ok)
        if not ready or approved < len(ready) // 2 + 1:
            raise ChaincodeError(
                f"insufficient approvals: {approved}/{len(ready)}"
            )
        params = json.loads(spec or b"{}")
        policy = params.get("policy", {"ref": "Endorsement"})
        cd = ChaincodeDefinition(
            name=nm, sequence=seq, plugin=params.get("plugin", "default"),
            policy=policy, init_required=bool(params.get("init_required")),
            collections=params.get("collections", {}),
        )
        stub.put_state(definition_key(nm), cd.to_bytes())
        stub.set_event("CommitChaincodeDefinition", nm.encode())
        return b"ok"

    def querydef(self, stub, name: bytes):
        raw = stub.get_state(definition_key(name.decode()))
        if raw is None:
            return Response(404, message=f"namespace {name.decode()} not defined")
        return raw


class LifecyclePolicyProvider:
    """PolicyProvider reading validation info from committed
    ``_lifecycle`` state (GetInfoForValidate,
    plugindispatcher/dispatcher.go:244-263), with the cache the
    reference keeps in lifecycle.Cache — invalidated when a committed
    block writes the ``_lifecycle`` namespace.

    ``ref_resolver(name)`` resolves channel-config policy references
    ("Endorsement", "LifecycleEndorsement") to policy ASTs — backed by
    the live channelconfig Bundle.
    """

    def __init__(self, state_db, ref_resolver=None, lifecycle_policy=None,
                 static_infos: dict | None = None):
        self.state = state_db
        self.ref_resolver = ref_resolver
        self.lifecycle_policy = lifecycle_policy
        self.static = dict(static_infos or {})
        self._cache: dict[str, NamespaceInfo | None] = {}

    def info(self, namespace: str) -> NamespaceInfo | None:
        if namespace in self._cache:
            return self._cache[namespace]
        got = self._load(namespace)
        self._cache[namespace] = got
        return got

    def _load(self, namespace: str) -> NamespaceInfo | None:
        if namespace == LIFECYCLE_NS:
            pol_ast = self.lifecycle_policy
            if pol_ast is None and self.ref_resolver is not None:
                pol_ast = self.ref_resolver("LifecycleEndorsement")
            return NamespaceInfo(policy=pol_ast) if pol_ast is not None else None
        vv = self.state.get_state(LIFECYCLE_NS, definition_key(namespace))
        if vv is None:
            return self.static.get(namespace)
        cd = ChaincodeDefinition.from_bytes(vv.value)
        ast = self._resolve_policy(cd.policy)
        if ast is None:
            return None
        return NamespaceInfo(policy=ast, plugin=cd.plugin)

    def collection(self, namespace: str, coll: str) -> dict | None:
        """Collection config from the committed definition (the
        distributor/coordinator's eligibility + BTL source,
        gossip/privdata/distributor.go:180-235) or None if the
        namespace/collection is undefined."""
        vv = self.state.get_state(LIFECYCLE_NS, definition_key(namespace))
        if vv is None:
            return None
        try:
            return ChaincodeDefinition.from_bytes(vv.value).collections.get(coll)
        except Exception:
            return None

    def _resolve_policy(self, spec: dict):
        if "sig" in spec:
            env = m.SignaturePolicyEnvelope.parse(bytes.fromhex(spec["sig"]))
            return policy_from_proto(env)
        if "ref" in spec and self.ref_resolver is not None:
            return self.ref_resolver(spec["ref"])
        return None

    # -- commit hook -------------------------------------------------------

    def on_block_committed(self, batch) -> None:
        """Invalidate cached infos for namespaces whose definitions the
        block touched (batch: ledger.statedb.UpdateBatch)."""
        for (ns, _key), _vv in batch.items():
            if ns == LIFECYCLE_NS:
                self._cache.clear()
                return
