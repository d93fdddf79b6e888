"""Genesis config blocks and config-update envelopes from a profile
(counterpart: ``fabric_tpu/tools/configtxgen.py``).

``genesis_config(profile)`` builds the channel's config tree as the
reference's does (the root's capabilities, hashing values and
implicit-meta Readers / Writers / Admins; the Application group with
Endorsement and LifecycleEndorsement MAJORITY policies and one group a
org holding its MSP and its member, admin and peer policies; the
Orderer group with its consensus, batch and BlockValidation values);
its serialized bytes equal the reference's under
``SerializeToString(deterministic=True)``, an idemix org's included (its
``MSPConfig`` is ``IdemixMSP.to_proto``).  ``compute_update`` is the
minimal read/write-set delta between two configs (configtxlator's
compute-update), ``sign_update`` adds one ``ConfigSignature`` a signer
over signature_header ‖ config_update, and ``config_tx`` wraps the new
config and its update in the CONFIG envelope an orderer emits.
Signers are ``crypto.cryptogen.SigningIdentity``; nonces are random and
headers carry the current time, as in the reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.channelconfig import CAP_V2_0, ImplicitMeta, config_policy
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.protos import messages as m


@dataclass
class OrgProfile:
    msp_id: str
    msp: object  # crypto.msp.MSP, or crypto.idemix.IdemixMSP (a type-1 MSPConfig)
    anchor_peers: list = field(default_factory=list)  # (host, port)


@dataclass
class Profile:
    """One channel's genesis profile (a configtx.yaml profile)."""

    channel_id: str
    application_orgs: list = field(default_factory=list)  # [OrgProfile]
    orderer_orgs: list = field(default_factory=list)
    consensus_type: str = "raft"
    raft_consenters: list = field(default_factory=list)  # [(host, port[, identity[, id]])]
    max_message_count: int = 500
    preferred_max_bytes: int = 2 * 1024 * 1024
    absolute_max_bytes: int = 10 * 1024 * 1024
    batch_timeout_ms: int = 200
    capabilities: tuple = (CAP_V2_0,)


def _value(msg, mod_policy: str = "") -> m.ConfigValue:
    return m.ConfigValue(value=msg.serialize(), mod_policy=mod_policy)


def _implicit(rule: int, sub: str) -> m.ConfigPolicy:
    return config_policy(ImplicitMeta(rule=rule, sub_policy=sub))


def _org_group(org: OrgProfile) -> m.ConfigGroup:
    g = m.ConfigGroup(mod_policy="Admins")
    g.values["MSP"] = _value(org.msp.to_proto(), "Admins")
    mid = org.msp_id
    for name, role in (("Readers", pol.ROLE_MEMBER), ("Writers", pol.ROLE_MEMBER),
                       ("Admins", pol.ROLE_ADMIN), ("Endorsement", pol.ROLE_PEER)):
        g.policies[name] = config_policy(pol.SignedBy(pol.Principal(mid, role)))
    if org.anchor_peers:
        g.values["AnchorPeers"] = _value(m.AnchorPeers(anchor_peers=[
            m.AnchorPeer(host=h, port=p) for h, p in org.anchor_peers]), "Admins")
    return g


def genesis_config(profile: Profile) -> m.Config:
    caps = m.Capabilities(capabilities={c: m.Capability() for c in profile.capabilities})
    root = m.ConfigGroup(mod_policy="Admins")
    root.values["Capabilities"] = _value(caps, "Admins")
    root.values["HashingAlgorithm"] = _value(m.HashingAlgorithm(name="SHA256"))
    root.values["BlockDataHashingStructure"] = _value(
        m.BlockDataHashingStructure(width=0xFFFFFFFF))
    for name, rule, sub in (("Readers", m.IMPLICIT_ANY, "Readers"),
                            ("Writers", m.IMPLICIT_ANY, "Writers"),
                            ("Admins", m.IMPLICIT_MAJORITY, "Admins")):
        root.policies[name] = _implicit(rule, sub)

    app = root.groups["Application"] = m.ConfigGroup(mod_policy="Admins")
    app.values["Capabilities"] = _value(caps, "Admins")
    for name, rule, sub in (("Readers", m.IMPLICIT_ANY, "Readers"),
                            ("Writers", m.IMPLICIT_ANY, "Writers"),
                            ("Admins", m.IMPLICIT_MAJORITY, "Admins"),
                            ("Endorsement", m.IMPLICIT_MAJORITY, "Endorsement"),
                            ("LifecycleEndorsement", m.IMPLICIT_MAJORITY, "Endorsement")):
        app.policies[name] = _implicit(rule, sub)
    for org in profile.application_orgs:
        app.groups[org.msp_id] = _org_group(org)

    ordg = root.groups["Orderer"] = m.ConfigGroup(mod_policy="Admins")
    consenters = []
    for c in profile.raft_consenters:
        rc = m.RaftConsenter(host=c[0], port=c[1])
        if len(c) > 2 and c[2]:
            rc.identity = c[2]
        if len(c) > 3 and c[3]:
            rc.id = c[3]
        consenters.append(rc)
    ordg.values["ConsensusType"] = _value(m.ConsensusType(
        type=profile.consensus_type,
        metadata=m.RaftConfigMetadata(consenters=consenters).serialize()))
    ordg.values["BatchSize"] = _value(m.BatchSize(
        max_message_count=profile.max_message_count,
        preferred_max_bytes=profile.preferred_max_bytes,
        absolute_max_bytes=profile.absolute_max_bytes))
    ordg.values["BatchTimeout"] = _value(m.BatchTimeout(timeout=f"{profile.batch_timeout_ms}ms"))
    for name, rule, sub in (("Readers", m.IMPLICIT_ANY, "Readers"),
                            ("Writers", m.IMPLICIT_ANY, "Writers"),
                            ("Admins", m.IMPLICIT_MAJORITY, "Admins"),
                            ("BlockValidation", m.IMPLICIT_ANY, "Writers")):
        ordg.policies[name] = _implicit(rule, sub)
    for org in profile.orderer_orgs:
        ordg.groups[org.msp_id] = _org_group(org)
    return m.Config(sequence=0, channel_group=root)


def _timestamp() -> m.Timestamp:
    now = time.time()
    return m.Timestamp(seconds=int(now), nanos=int((now % 1) * 1e9))


def _payload(htype: int, channel_id: str, tx_id: str, creator: bytes, nonce: bytes,
             data: bytes) -> m.Payload:
    ch = m.ChannelHeader(type=htype, channel_id=channel_id, tx_id=tx_id,
                         timestamp=_timestamp())
    sh = m.SignatureHeader(creator=creator, nonce=nonce)
    return m.Payload(header=m.Header(channel_header=ch.serialize(),
                                     signature_header=sh.serialize()), data=data)


def genesis_block(profile: Profile) -> m.Block:
    """Block 0: one CONFIG envelope holding the genesis ConfigEnvelope."""
    cfg_env = m.ConfigEnvelope(config=genesis_config(profile))
    payload = _payload(m.HEADER_CONFIG, profile.channel_id, "", b"",
                       protoutil.random_nonce(), cfg_env.serialize())
    blk = protoutil.new_block(0, b"")
    blk.data.data.append(m.Envelope(payload=payload.serialize()).serialize())
    return protoutil.finalize_block(blk)


# ---------------------------------------------------------------------------
# Config updates


def compute_update(channel_id: str, current: m.Config, updated: m.Config) -> m.ConfigUpdate:
    """The minimal read/write-set delta: the read set names every group
    on the path to a change at its current version, the write set holds
    the changed elements with bumped versions (a group with a deleted
    child is bumped and lists its exact surviving membership)."""
    upd = m.ConfigUpdate(channel_id=channel_id, read_set=m.ConfigGroup(),
                         write_set=m.ConfigGroup())

    def diff(cur: m.ConfigGroup, new: m.ConfigGroup, rd: m.ConfigGroup,
             wr: m.ConfigGroup) -> bool:
        changed = False
        rd.version = cur.version
        wr.version = cur.version
        wr.mod_policy = new.mod_policy
        deleted = ((set(cur.groups) - set(new.groups)) | (set(cur.values) - set(new.values))
                   | (set(cur.policies) - set(new.policies)))
        if deleted:
            changed = True
            wr.version = cur.version + 1
            for ncoll, ccoll, wcoll in ((new.groups, cur.groups, wr.groups),
                                        (new.values, cur.values, wr.values),
                                        (new.policies, cur.policies, wr.policies)):
                for name, elem in ncoll.items():
                    if name in ccoll:
                        wcoll[name] = elem.copy()
                        wcoll[name].version = ccoll[name].version
        for name, ng in new.groups.items():
            if name in cur.groups:
                rd.groups[name] = m.ConfigGroup()
                if wr.groups.get(name) is None:
                    wr.groups[name] = m.ConfigGroup()
                sub_changed = diff(cur.groups[name], ng, rd.groups[name], wr.groups[name])
                if not sub_changed:
                    del rd.groups[name]
                    if not deleted:
                        del wr.groups[name]
                changed |= sub_changed
            else:
                wr.groups[name] = ng.copy()
                wr.groups[name].version = 0
                changed = True
        for name, nv in new.values.items():
            cv = cur.values.get(name)
            if cv is None:
                wr.values[name] = nv.copy()
                wr.values[name].version = 0
                changed = True
            elif cv.value != nv.value or cv.mod_policy != nv.mod_policy:
                wr.values[name] = nv.copy()
                wr.values[name].version = cv.version + 1
                changed = True
        for name, np_ in new.policies.items():
            cp = cur.policies.get(name)
            if cp is None:
                wr.policies[name] = np_.copy()
                wr.policies[name].version = 0
                changed = True
            elif cp.serialize() != np_.serialize():
                wr.policies[name] = np_.copy()
                wr.policies[name].version = cp.version + 1
                changed = True
        return changed

    diff(current.channel_group or m.ConfigGroup(), updated.channel_group or m.ConfigGroup(),
         upd.read_set, upd.write_set)
    return upd


def sign_update(update: m.ConfigUpdate, signers) -> m.ConfigUpdateEnvelope:
    """Each signer signs signature_header ‖ config_update."""
    env = m.ConfigUpdateEnvelope(config_update=update.serialize())
    for signer in signers:
        sh = m.SignatureHeader(creator=signer.serialized,
                               nonce=protoutil.random_nonce()).serialize()
        env.signatures.append(m.ConfigSignature(signature_header=sh,
                                                signature=signer.sign(sh + env.config_update)))
    return env


def config_tx(channel_id: str, new_config: m.Config, update_env: m.ConfigUpdateEnvelope,
              signer=None) -> m.Envelope:
    """A CONFIG envelope carrying ConfigEnvelope{config, last_update},
    signed by ``signer`` when given."""
    creator = signer.serialized if signer else b""
    upd_payload = _payload(m.HEADER_CONFIG_UPDATE, channel_id, "", creator,
                           protoutil.random_nonce(), update_env.serialize()).serialize()
    last_update = m.Envelope(payload=upd_payload,
                             signature=signer.sign(upd_payload) if signer else b"")
    cfg_env = m.ConfigEnvelope(config=new_config, last_update=last_update)
    nonce = protoutil.random_nonce()
    payload = _payload(m.HEADER_CONFIG, channel_id, protoutil.compute_tx_id(nonce, creator),
                       creator, nonce, cfg_env.serialize()).serialize()
    return m.Envelope(payload=payload, signature=signer.sign(payload) if signer else b"")
