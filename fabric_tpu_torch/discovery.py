"""Discovery service logic: peer membership, config queries, and
endorsement descriptors (layouts) (counterpart:
``fabric_tpu/discovery.py``).

Reference: discovery/ — notably endorsement.go:84-217
``PeersForEndorsement``: given a chaincode's policy, compute the
*layouts* (minimal combinations of org-grouped endorsers that satisfy
the policy) a client can use to target endorsement requests.  The
gateway's endorse path consumes the same computation
(internal/pkg/gateway/endorse.go:170).

Here the policy AST is walked directly into org-quantity layouts; the
per-org peer lists come from the registry the node maintains (static
wiring or anchor-peer config — the gossip-membership analog)."""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import combinations

from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.protos import messages as m

MAX_LAYOUTS = 16


def layouts_for_policy(rule) -> list[dict[str, int]]:
    """→ list of {msp_id: required_count} minimal satisfying layouts.

    Walks the AST: a SignedBy leaf needs one signature from its org;
    NOutOf(n, rules) takes every n-subset of child layouts (capped at
    MAX_LAYOUTS, like the reference caps its layout enumeration)."""

    def merge(a: dict, b: dict) -> dict:
        out = dict(a)
        for k, v in b.items():
            out[k] = out.get(k, 0) + v
        return out

    def walk(node) -> list[dict]:
        if isinstance(node, pol.SignedBy):
            return [{node.principal.msp_id: 1}]
        assert isinstance(node, pol.NOutOf)
        child_layouts = [walk(r) for r in node.rules]
        out: list[dict] = []
        for subset in combinations(range(len(node.rules)), node.n):
            partial = [{}]
            for idx in subset:
                partial = [
                    merge(p, c) for p in partial for c in child_layouts[idx]
                ][:MAX_LAYOUTS]
            out.extend(partial)
            if len(out) >= MAX_LAYOUTS:
                break
        # dedupe
        seen, uniq = set(), []
        for layout in out:
            key = tuple(sorted(layout.items()))
            if key not in seen:
                seen.add(key)
                uniq.append(layout)
        return uniq[:MAX_LAYOUTS]

    return walk(rule)


@dataclass
class PeerInfo:
    msp_id: str
    host: str
    port: int
    height: int = 0              # max across channels (legacy/display)
    heights: dict = field(default_factory=dict)  # channel -> height
    # liveness (gossip/discovery alive/dead expiration analog): a peer
    # is a candidate for election/dissemination only while alive.
    # None = never probed — treated alive so static wirings (tests,
    # fresh registries) work before the first probe round.
    alive: bool | None = None
    last_seen: float = 0.0


@dataclass
class PeerRegistry:
    """Known endorsing peers by org (gossip-membership analog; fed by
    static wiring or by anchor peers from the channel config)."""

    peers: dict = field(default_factory=dict)  # msp_id -> [PeerInfo]

    def add(self, info: PeerInfo) -> None:
        self.peers.setdefault(info.msp_id, []).append(info)

    def for_org(self, msp_id: str) -> list[PeerInfo]:
        return list(self.peers.get(msp_id, []))

    def from_anchor_peers(self, bundle) -> None:
        """Seed from the channel config's AnchorPeers values."""
        app = bundle.config.channel_group.groups.get("Application")
        if app is None:
            return
        for org_name, grp in app.groups.items():
            if "AnchorPeers" not in grp.values:
                continue
            ap = m.AnchorPeers.parse(grp.values["AnchorPeers"].value)
            for a in ap.anchor_peers:
                self.add(PeerInfo(org_name, a.host, a.port))


class DiscoveryService:
    """Query surface (discovery/service.go analog): peers, config,
    endorsement descriptors."""

    def __init__(self, registry: PeerRegistry, bundle_for=None,
                 policy_for=None):
        """bundle_for(channel) -> channelconfig.Bundle | None;
        policy_for(channel, chaincode) -> policy AST | None."""
        self.registry = registry
        self.bundle_for = bundle_for or (lambda ch: None)
        self.policy_for = policy_for or (lambda ch, cc: None)

    def peers(self, channel: str) -> list[dict]:
        return [
            {"msp_id": p.msp_id, "host": p.host, "port": p.port,
             "height": p.height}
            for org in sorted(self.registry.peers)
            for p in self.registry.for_org(org)
        ]

    def config(self, channel: str) -> dict | None:
        bundle = self.bundle_for(channel)
        if bundle is None:
            return None
        return {
            "msps": sorted(bundle.msp_manager.msps),
            "orderers": [],
            "application_orgs": bundle.application_orgs(),
            "capabilities": sorted(bundle.application_capabilities()),
        }

    def endorsement_descriptor(self, channel: str, chaincode: str) -> dict | None:
        """The PeersForEndorsement analog: layouts + per-org peers."""
        rule = self.policy_for(channel, chaincode)
        if rule is None:
            return None
        layouts = layouts_for_policy(rule)
        orgs = sorted({org for lay in layouts for org in lay})
        return {
            "chaincode": chaincode,
            "layouts": layouts,
            "peers_by_org": {
                org: [
                    {"host": p.host, "port": p.port, "msp_id": org}
                    for p in self.registry.for_org(org)
                ]
                for org in orgs
            },
        }
