"""The port's channel config on the CPU, against the reference
(``fabric_tpu/channelconfig.py``, ``tools/configtxgen.py``,
``crypto/msp.py``).

* Messages: the port's config, policy and orderer messages serialize as
  ``google.protobuf`` does with ``deterministic=True`` (every one of
  them as the reference builds it: the genesis config, a signed config
  update and its CONFIG envelope, MSP configs, policies), parse the
  reference's bytes in any map order, and ``google.protobuf`` parses
  the port's.  ``policy_to_proto`` is byte-equal and
  ``policy_from_proto`` reads the reference's bytes into the same AST.
* The reference's ``tests/test_channelconfig.py`` scenarios on both
  packages with the same inputs (the reference's signed update
  envelopes, parsed by the port): the bundle surface, implicit-meta
  majority, a bad signature, the update flow, version discipline, the
  config-tx processor and deletion give the same verdicts and the same
  resulting config bytes.
* The port's ``configtxgen`` output equals the reference's (genesis
  config, update deltas), and the reference accepts the port's signed
  updates and config envelopes.

The reference's config-transaction check compares the proposed config
with the envelope's under ``google.protobuf``'s default serialization,
whose map order follows a hash seeded anew in each process: in about
one process in sixteen it rejects a config equal to the one its update
authorizes.  ``_pinned_config_order`` (autouse here, and imported by
every test file that takes the reference's config verdicts) makes that
comparison in ``deterministic=True`` order, so the expected verdicts do
not depend on the process that computed them.

Exact equality throughout."""

import hashlib

import pytest

from fabric_tpu import channelconfig as jcc
from fabric_tpu import protoutil as jpu
from fabric_tpu.crypto import cryptogen
from fabric_tpu.crypto import msp as jmsp
from fabric_tpu.crypto import policy as jpol
from fabric_tpu.protos import common_pb2, configtx_pb2, policies_pb2, transaction_pb2
from fabric_tpu.tools import configtxgen as jcg
from fabric_tpu_torch import channelconfig as cc
from fabric_tpu_torch.crypto import msp as pmsp
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.protos import messages as m
from fabric_tpu_torch.tools import configtxgen as cg

JC = transaction_pb2.TxValidationCode
CHANNEL = "confchan"


def _pinned_validate_config_tx(self, ptx, cfg_env) -> int:
    """``fabric_tpu/channelconfig.py``'s ``validate_config_tx`` (:485)
    with both configs serialized in ``deterministic=True`` order."""
    try:
        proposed = self._authorized_config(cfg_env)
    except Exception:
        return JC.INVALID_OTHER_REASON
    if proposed.SerializeToString(deterministic=True) != \
            cfg_env.config.SerializeToString(deterministic=True):
        return JC.INVALID_OTHER_REASON
    return JC.VALID


@pytest.fixture(autouse=True, scope="module")
def _pinned_config_order():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcc.ConfigTxProcessor, "validate_config_tx", _pinned_validate_config_tx)
        yield


DSLS = [
    "OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')",
    "AND('Org1MSP.member', OR('Org2MSP.admin', 'Org3MSP.client'))",
    "OutOf(1, 'Org1MSP.peer', 'Org1MSP.member')",
    "OR('Org1MSP.orderer', AND('Org2MSP.peer', 'Org2MSP.peer'))",
]


@pytest.fixture(scope="module")
def orgs():
    return [cryptogen.generate_org(f"Org{i}MSP", f"org{i}.cfg.example.com", peers=1)
            for i in (1, 2, 3)]


def _port_msp(org):
    return pmsp.MSP(org.msp_id, [org.ca.cert_pem])


@pytest.fixture(scope="module")
def bundles(orgs):
    """(reference bundle, port bundle) of the same genesis profile."""
    jp = jcg.Profile(CHANNEL, application_orgs=[jcg.OrgProfile(o.msp_id, o.msp()) for o in orgs])
    pp = cg.Profile(CHANNEL, application_orgs=[cg.OrgProfile(o.msp_id, _port_msp(o))
                                               for o in orgs])
    return jcc.Bundle(CHANNEL, jcg.genesis_config(jp)), cc.Bundle(CHANNEL, cg.genesis_config(pp))


def _det(msg) -> bytes:
    return msg.SerializeToString(deterministic=True)


def _admin(org):
    return cryptogen.signing_identity(org, f"Admin@{org.domain}")


def _ast(node, unordered: bool = False):
    """A policy AST of either package as nested tuples (``unordered``:
    each NOutOf's rules sorted)."""
    if hasattr(node, "principal"):
        return ("signed_by", node.principal.msp_id, node.principal.role)
    rules = tuple(_ast(r, unordered) for r in node.rules)
    return ("n_out_of", node.n, tuple(sorted(rules)) if unordered else rules)


# ---------------------------------------------------------------------------
# Messages


def test_genesis_config_is_byte_equal(orgs):
    anchors = [("peer0.org1", 7051)]
    jp = jcg.Profile(CHANNEL, application_orgs=[
        jcg.OrgProfile(orgs[0].msp_id, orgs[0].msp(), anchor_peers=anchors),
        jcg.OrgProfile(orgs[1].msp_id, orgs[1].msp())],
        orderer_orgs=[jcg.OrgProfile(orgs[2].msp_id, orgs[2].msp())],
        raft_consenters=[("o0", 7050), ("o1", 7050, b"ident", "n1")], batch_timeout_ms=50)
    pp = cg.Profile(CHANNEL, application_orgs=[
        cg.OrgProfile(orgs[0].msp_id, _port_msp(orgs[0]), anchor_peers=anchors),
        cg.OrgProfile(orgs[1].msp_id, _port_msp(orgs[1]))],
        orderer_orgs=[cg.OrgProfile(orgs[2].msp_id, _port_msp(orgs[2]))],
        raft_consenters=[("o0", 7050), ("o1", 7050, b"ident", "n1")], batch_timeout_ms=50)
    jcfg, pcfg = jcg.genesis_config(jp), cg.genesis_config(pp)
    assert pcfg.serialize() == _det(jcfg)
    # the reference's bytes (upb's hash order) parse into the same tree
    assert m.Config.parse(jcfg.SerializeToString()) == pcfg
    assert configtx_pb2.Config.FromString(pcfg.serialize()) == jcfg
    # the genesis block: a CONFIG envelope whose ConfigEnvelope the
    # reference reads back as the same config
    blk = cg.genesis_block(pp)
    jblk = common_pb2.Block.FromString(blk.serialize())
    assert jblk.header.number == 0 and jblk.header.data_hash == blk.header.data_hash
    assert jcc.bundle_from_genesis(CHANNEL, jblk).config == jcfg
    assert cc.bundle_from_genesis(CHANNEL, blk).config == pcfg


def _reference_messages(orgs):
    """(port class, reference message) pairs: every config, policy and
    orderer message the port carries, as the reference builds them."""
    from fabric_tpu.protos import orderer_pb2

    jp = jcg.Profile(CHANNEL, application_orgs=[
        jcg.OrgProfile(o.msp_id, o.msp(), anchor_peers=[("h", 1)]) for o in orgs],
        raft_consenters=[("o0", 7050, b"id", "n0")])
    cfg = jcg.genesis_config(jp)
    bundle = jcc.Bundle(CHANNEL, cfg)
    upd = jcg.compute_update(CHANNEL, cfg, _updated(bundle))
    upd.isolated_data["k"] = b"v"
    upd_env = jcg.sign_update(upd, [_admin(orgs[0]), _admin(orgs[1])])
    tx = jcg.config_tx(CHANNEL, jcc.authorize_update(bundle, upd_env), upd_env,
                       signer=_admin(orgs[0]))
    fab = configtx_pb2.FabricMSPConfig.FromString(orgs[0].msp().to_proto().config)
    ou = policies_pb2.OrganizationUnit(msp_identifier="Org1MSP",
                                       organizational_unit_identifier="peer",
                                       certifiers_identifier=b"c")
    sig_env = jmsp.policy_to_proto(jpol.from_dsl(DSLS[1]))
    return [
        (m.Config, cfg), (m.ConfigUpdate, upd), (m.ConfigUpdateEnvelope, upd_env),
        (m.ConfigSignature, upd_env.signatures[0]), (m.Envelope, tx),
        (m.ConfigEnvelope, configtx_pb2.ConfigEnvelope.FromString(
            jpu.unmarshal(common_pb2.Payload, tx.payload).data)),
        (m.MSPConfig, orgs[0].msp().to_proto()), (m.FabricMSPConfig, fab),
        (m.Capabilities, configtx_pb2.Capabilities.FromString(
            cfg.channel_group.values["Capabilities"].value)),
        (m.AnchorPeers, configtx_pb2.AnchorPeers.FromString(
            cfg.channel_group.groups["Application"].groups["Org1MSP"].values[
                "AnchorPeers"].value)),
        (m.OrdererAddresses, configtx_pb2.OrdererAddresses(addresses=["a:1", "b:2"])),
        (m.HashingAlgorithm, configtx_pb2.HashingAlgorithm(name="SHA256")),
        (m.BlockDataHashingStructure, configtx_pb2.BlockDataHashingStructure(width=7)),
        (m.ConsensusType, orderer_pb2.ConsensusType.FromString(
            cfg.channel_group.groups["Orderer"].values["ConsensusType"].value)),
        (m.RaftConfigMetadata, orderer_pb2.RaftConfigMetadata(
            consenters=[orderer_pb2.RaftConsenter(host="o", port=1, identity=b"i", id="x")],
            options=orderer_pb2.RaftOptions(tick_interval_ms=5, snapshot_interval_size=9))),
        (m.BatchSize, orderer_pb2.BatchSize(max_message_count=3, absolute_max_bytes=4,
                                            preferred_max_bytes=5)),
        (m.BatchTimeout, orderer_pb2.BatchTimeout(timeout="2s")),
        (m.SignaturePolicyEnvelope, sig_env),
        (m.ImplicitMetaPolicy, policies_pb2.ImplicitMetaPolicy(sub_policy="A", rule=2)),
        (m.MSPRole, policies_pb2.MSPRole(msp_identifier="Org1MSP", role=3)),
        (m.OrganizationUnit, ou),
        (m.MSPPrincipal, policies_pb2.MSPPrincipal(principal_classification=1,
                                                   principal=ou.SerializeToString())),
        (m.ApplicationPolicy, policies_pb2.ApplicationPolicy(signature_policy=sig_env)),
        (m.ApplicationPolicy, policies_pb2.ApplicationPolicy(
            channel_config_policy_reference="")),
        (m.SignaturePolicy, policies_pb2.SignaturePolicy(signed_by=0)),
    ]


def test_config_messages_are_byte_equal(orgs):
    """Each message the reference builds: the port parses its bytes (in
    upb's map order) and serializes them as ``deterministic=True`` does;
    upb parses the port's bytes back into the same message."""
    for cls, jmsg in _reference_messages(orgs):
        got = cls.parse(jmsg.SerializeToString())
        assert got.serialize() == _det(jmsg), cls.__name__
        assert type(jmsg).FromString(got.serialize()) == jmsg, cls.__name__
        assert got.copy() == got


def test_msp_config_is_byte_equal(orgs):
    jm = orgs[0].msp()
    pm_ = _port_msp(orgs[0])
    assert pm_.to_proto().serialize() == jm.to_proto().SerializeToString()
    back = pmsp.MSP.from_proto(m.MSPConfig.parse(jm.to_proto().SerializeToString()))
    assert back.to_proto().serialize() == jm.to_proto().SerializeToString()
    admin = _admin(orgs[0])
    got = back.deserialize_identity(admin.serialized)
    want = jm.deserialize_identity(admin.serialized)
    assert (got.is_valid, got.role) == (want.is_valid, want.role) == (True, "admin")


@pytest.mark.parametrize("dsl", DSLS)
def test_policy_proto_round_trip(dsl):
    want = jmsp.policy_to_proto(jpol.from_dsl(dsl)).SerializeToString()
    env = pmsp.policy_to_proto(pol.from_dsl(dsl))
    assert env.serialize() == want
    back = pmsp.policy_from_proto(m.SignaturePolicyEnvelope.parse(want))
    assert _ast(back) == _ast(pol.from_dsl(dsl)) == _ast(jmsp.policy_from_proto(
        policies_pb2.SignaturePolicyEnvelope.FromString(want)))
    # a ConfigPolicy of either kind
    jcp = jcc.config_policy(jpol.from_dsl(dsl), mod_policy="X")
    assert cc.config_policy(pol.from_dsl(dsl), mod_policy="X").serialize() == _det(jcp)
    meta = cc.config_policy(cc.ImplicitMeta(m.IMPLICIT_MAJORITY, "Admins"))
    assert meta.serialize() == _det(jcc.config_policy(jcc.ImplicitMeta(2, "Admins")))


def test_policy_from_proto_edge_cases():
    """An empty rule is NOutOf(0) over nothing in both packages; a
    non-ROLE principal or an unknown role raises in both."""
    empty = policies_pb2.SignaturePolicyEnvelope()
    assert _ast(pmsp.policy_from_proto(m.SignaturePolicyEnvelope())) == \
        _ast(jmsp.policy_from_proto(empty)) == ("n_out_of", 0, ())
    bad = policies_pb2.SignaturePolicyEnvelope()
    bad.rule.signed_by = 0
    bad.identities.add(principal_classification=policies_pb2.MSPPrincipal.IDENTITY,
                       principal=b"x")
    with pytest.raises(ValueError):
        jmsp.policy_from_proto(bad)
    with pytest.raises(ValueError):
        pmsp.policy_from_proto(m.SignaturePolicyEnvelope.parse(bad.SerializeToString()))


# ---------------------------------------------------------------------------
# The reference's channel-config scenarios, on both packages


def test_bundle_surface(bundles, orgs):
    jb, pb = bundles
    assert pb.application_orgs() == jb.application_orgs() == ["Org1MSP", "Org2MSP", "Org3MSP"]
    assert pb.application_capabilities() == jb.application_capabilities() == {cc.CAP_V2_0}
    assert pb.channel_capabilities() == jb.channel_capabilities()
    assert pb.hash() == hashlib.sha256(_det(jb.config)).digest()
    je, pe = jb.application_policy("Endorsement"), pb.application_policy("Endorsement")
    assert (pe.rule, pe.sub_policy) == (je.rule, je.sub_policy)
    # the port flattens over the orgs in name order, the reference in
    # its map's order
    assert _ast(pb.application_policy_ast("Endorsement")) == \
        _ast(jb.application_policy_ast("Endorsement"), unordered=True)
    for o in orgs:
        a = _admin(o)
        got = pb.msp_manager.deserialize_identity(a.serialized)
        want = jb.msp_manager.deserialize_identity(a.serialized)
        assert (got.is_valid, got.role, got.msp_id) == (want.is_valid, want.role, want.msp_id)


def _signed_both(signer, msg):
    sig = signer.sign(msg)
    return (jcc.SignedData(signer.serialized, msg, sig),
            cc.SignedData(signer.serialized, msg, sig))


def _evaluate_both(bundles, path, pairs) -> tuple:
    jb, pb = bundles
    return (jb.policy_manager.evaluate(path, [j for j, _ in pairs]),
            pb.policy_manager.evaluate(path, [p for _, p in pairs]))


def test_implicit_meta_majority(bundles, orgs):
    msg = b"payload-to-sign"
    admins = [_signed_both(_admin(o), msg) for o in orgs]
    cases = {"/Channel/Application/Admins": [admins[:2], admins, admins[:1],
                                             [admins[0], admins[0]]],
             "/Channel/Application/Writers": [admins[:1]],
             "/Channel/Admins": [admins[:2], admins[:1]],
             "/Channel/Application/Nope": [admins]}
    got = {path: [_evaluate_both(bundles, path, c) for c in cs] for path, cs in cases.items()}
    assert all(j == p for vs in got.values() for j, p in vs), got
    assert [j for j, _ in got["/Channel/Application/Admins"]] == [True, True, False, False]


def test_implicit_meta_rejects_bad_signature(bundles, orgs):
    msg = b"payload"
    sig = _admin(orgs[0]).sign(msg)
    bad = sig[:-2] + b"\x00\x00"
    pair = (jcc.SignedData(_admin(orgs[0]).serialized, msg, bad),
            cc.SignedData(_admin(orgs[0]).serialized, msg, bad))
    assert _evaluate_both(bundles, "/Channel/Application/Writers", [pair]) == (False, False)


def _updated(jb, dsl="Org1MSP.admin", org="Org1MSP", name="Endorsement"):
    new = configtx_pb2.Config()
    new.CopyFrom(jb.config)
    p = jpol.SignedBy(jpol.Principal(*dsl.split("."))) if "(" not in dsl else jpol.from_dsl(dsl)
    new.channel_group.groups["Application"].groups[org].policies[name].CopyFrom(
        jcc.config_policy(p))
    return new


def _authorize_both(bundles, upd_env) -> tuple:
    """(reference outcome, port outcome): the new config's deterministic
    bytes, or the error class name."""
    jb, pb = bundles
    out = []
    for fn, b, env in ((jcc.authorize_update, jb, upd_env),
                       (cc.authorize_update, pb,
                        m.ConfigUpdateEnvelope.parse(upd_env.SerializeToString()))):
        try:
            got = fn(b, env)
            out.append(_det(got) if hasattr(got, "SerializeToString") else got.serialize())
        except (jcc.ConfigUpdateError, cc.ConfigUpdateError):
            out.append("ConfigUpdateError")
    return tuple(out)


def test_config_update_flow(bundles, orgs):
    jb, _ = bundles
    upd = jcg.compute_update(CHANNEL, jb.config, _updated(jb))
    ok = _authorize_both(bundles, jcg.sign_update(upd, [_admin(orgs[0])]))
    assert ok[0] == ok[1] and ok[0] != "ConfigUpdateError"
    after = cc.Bundle(CHANNEL, m.Config.parse(ok[1]))
    assert after.sequence == jb.sequence + 1
    assert isinstance(after.policy_manager.get("/Channel/Application/Org1MSP/Endorsement")[0],
                      pol.SignedBy)
    for signers in ([], [_admin(orgs[1])]):  # unsigned; the wrong org's admin
        assert _authorize_both(bundles, jcg.sign_update(upd, signers)) == \
            ("ConfigUpdateError",) * 2
    # an Application value: its group's Admins, a MAJORITY of the orgs'
    new = configtx_pb2.Config()
    new.CopyFrom(jb.config)
    new.channel_group.groups["Application"].values["Capabilities"].value = b"\x0a\x00"
    upd = jcg.compute_update(CHANNEL, jb.config, new)
    for signers, accepted in (([_admin(orgs[0])], False), ([_admin(o) for o in orgs[:2]], True)):
        got = _authorize_both(bundles, jcg.sign_update(upd, signers))
        assert got[0] == got[1] and (got[0] != "ConfigUpdateError") == accepted


def test_config_update_version_discipline(bundles, orgs):
    jb, _ = bundles
    upd = jcg.compute_update(CHANNEL, jb.config, _updated(jb))
    wr = upd.write_set.groups["Application"].groups["Org1MSP"]
    wr.policies["Endorsement"].version = 7
    assert _authorize_both(bundles, jcg.sign_update(upd, [_admin(orgs[0])])) == \
        ("ConfigUpdateError",) * 2
    # a read set at a stale version
    upd = jcg.compute_update(CHANNEL, jb.config, _updated(jb))
    upd.read_set.groups["Application"].version = 5
    assert _authorize_both(bundles, jcg.sign_update(upd, [_admin(orgs[0])])) == \
        ("ConfigUpdateError",) * 2
    # an element changed without a version bump
    upd = jcg.compute_update(CHANNEL, jb.config, _updated(jb))
    wr = upd.write_set.groups["Application"].groups["Org1MSP"]
    wr.policies["Endorsement"].version = 0
    assert _authorize_both(bundles, jcg.sign_update(upd, [_admin(orgs[0])])) == \
        ("ConfigUpdateError",) * 2


def test_config_tx_processor(bundles, orgs):
    jb, pb = bundles
    upd = jcg.compute_update(CHANNEL, jb.config, _updated(jb))
    upd_env = jcg.sign_update(upd, [_admin(orgs[0])])
    new_applied = jcc.authorize_update(jb, upd_env)
    env = jcg.config_tx(CHANNEL, new_applied, upd_env, signer=_admin(orgs[0]))
    jcfg_env = jpu.unmarshal(configtx_pb2.ConfigEnvelope,
                             jpu.unmarshal(common_pb2.Payload, env.payload).data)
    pcfg_env = m.ConfigEnvelope.parse(jcfg_env.SerializeToString())
    jproc, pproc = jcc.ConfigTxProcessor(jb), cc.ConfigTxProcessor(pb)
    assert pproc.validate_config_tx(None, pcfg_env) == \
        jproc.validate_config_tx(None, jcfg_env) == JC.VALID
    # a config that is not what its update authorizes; no last update
    forged = configtx_pb2.ConfigEnvelope()
    forged.CopyFrom(jcfg_env)
    forged.config.channel_group.values["Capabilities"].value = b"\x01"
    bare = configtx_pb2.ConfigEnvelope(config=jcfg_env.config)
    for e in (forged, bare):
        assert pproc.validate_config_tx(None, m.ConfigEnvelope.parse(e.SerializeToString())) \
            == jproc.validate_config_tx(None, e) == JC.INVALID_OTHER_REASON
    seen = []
    pproc.listeners.append(lambda b: seen.append(b.sequence))
    assert pproc.apply(pcfg_env).sequence == jproc.apply(jcfg_env).sequence == 1
    assert seen == [1] and pproc.bundle.config.serialize() == _det(jproc.bundle.config)


def test_config_update_deletion(bundles, orgs):
    jb, pb = bundles
    new = configtx_pb2.Config()
    new.CopyFrom(jb.config)
    del new.channel_group.groups["Application"].groups["Org3MSP"]
    upd = jcg.compute_update(CHANNEL, jb.config, new)
    admins = [_admin(o) for o in orgs]
    assert _authorize_both(bundles, jcg.sign_update(upd, admins[:1])) == \
        ("ConfigUpdateError",) * 2
    got = _authorize_both(bundles, jcg.sign_update(upd, admins[:2]))
    assert got[0] == got[1] != "ConfigUpdateError"
    after = cc.Bundle(CHANNEL, m.Config.parse(got[1]))
    assert after.application_orgs() == ["Org1MSP", "Org2MSP"]
    assert after.policy_manager.get("/Channel/Application/Org1MSP/Admins")


# ---------------------------------------------------------------------------
# The port's configtxgen against the reference


@pytest.mark.parametrize("change", ["policy", "delete", "add_value", "mod_policy"])
def test_compute_update_is_byte_equal(bundles, orgs, change):
    jb, pb = bundles
    new = configtx_pb2.Config()
    new.CopyFrom(jb.config)
    app = new.channel_group.groups["Application"]
    if change == "policy":
        new = _updated(jb, "OutOf(1, 'Org2MSP.peer', 'Org3MSP.peer')", "Org2MSP")
    elif change == "delete":
        del app.groups["Org2MSP"].policies["Readers"]
    elif change == "add_value":
        app.groups["Org3MSP"].values["AnchorPeers"].value = b"\x0a\x04\x0a\x02h1"
    else:
        app.values["Capabilities"].mod_policy = "Writers"
    want = jcg.compute_update(CHANNEL, jb.config, new)
    got = cg.compute_update(CHANNEL, pb.config, m.Config.parse(new.SerializeToString()))
    assert got.serialize() == _det(want)


def test_port_signed_update_and_config_tx_accepted_by_reference(bundles, orgs):
    """The port's ``sign_update`` and ``config_tx`` with the same
    signers: the reference authorizes the update and its processor finds
    the envelope VALID, and so does the port's."""
    jb, pb = bundles
    new = _updated(jb)
    upd = cg.compute_update(CHANNEL, pb.config, m.Config.parse(new.SerializeToString()))
    penv = cg.sign_update(upd, [_admin(orgs[0])])
    jenv = configtx_pb2.ConfigUpdateEnvelope.FromString(penv.serialize())
    assert _det(jcc.authorize_update(jb, jenv)) == cc.authorize_update(pb, penv).serialize()
    tx = cg.config_tx(CHANNEL, cc.authorize_update(pb, penv), penv, signer=_admin(orgs[0]))
    jtx = common_pb2.Envelope.FromString(tx.serialize())
    payload = jpu.unmarshal(common_pb2.Payload, jtx.payload)
    ch = jpu.unmarshal(common_pb2.ChannelHeader, payload.header.channel_header)
    sh = jpu.unmarshal(common_pb2.SignatureHeader, payload.header.signature_header)
    assert ch.type == common_pb2.HeaderType.CONFIG and ch.channel_id == CHANNEL
    assert ch.tx_id == jpu.compute_tx_id(sh.nonce, sh.creator)
    jcfg_env = jpu.unmarshal(configtx_pb2.ConfigEnvelope, payload.data)
    # the reference's processor authorizes exactly the envelope's config
    # (it compares upb's hash-ordered bytes, which the port's sorted maps
    # need not match, so the messages are compared here)
    assert jcc.ConfigTxProcessor(jb)._authorized_config(jcfg_env) == jcfg_env.config
    assert cc.ConfigTxProcessor(pb).validate_config_tx(
        None, m.ConfigEnvelope.parse(payload.data)) == JC.VALID
    ident = jb.msp_manager.deserialize_identity(sh.creator)
    assert ident.verify(jtx.payload, jtx.signature)
