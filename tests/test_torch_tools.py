"""The offline tools, the port's against the reference's:
``tools/configtxlator.py`` over the port's proto3 JSON codec
(``protos/jsonfmt.py``) gives ``json_format``'s text for every message
type of ``configtxlator._TYPES`` on the config blocks of both packages'
``configtxgen`` (``proto_encode`` the same message, in
``deterministic=True`` order; ``compute_update`` the same bytes), and
``tools/ledgerutil.py`` / ``tools/nodeops.py`` give the same JSON and
leave the same files on copies of one ledger directory."""

import json
import os
import shutil

import pytest

from fabric_tpu import protoutil as jpu
from fabric_tpu.crypto import cryptogen as jcgen
from fabric_tpu.crypto import msp as jmsp
from fabric_tpu.crypto import policy as jpol
from fabric_tpu.ledger.kvledger import KVLedger
from fabric_tpu.ledger.statedb import SqliteVersionedDB, UpdateBatch
from fabric_tpu.protos import common_pb2, configtx_pb2, orderer_pb2
from fabric_tpu.tools import configtxgen as jctg
from fabric_tpu.tools import configtxlator as jctl
from fabric_tpu.tools import ledgerutil as jlu
from fabric_tpu.tools import nodeops as jnodeops
from fabric_tpu_torch.crypto import msp as pmsp
from fabric_tpu_torch.protos import jsonfmt
from fabric_tpu_torch.tools import configtxgen as pctg
from fabric_tpu_torch.tools import configtxlator as pctl
from fabric_tpu_torch.tools import ledgerutil as plu
from fabric_tpu_torch.tools import nodeops as pnodeops

CHANNEL = "toolschan"


@pytest.fixture(scope="module")
def blocks():
    """Genesis blocks of the same orgs from each package's configtxgen
    (an orderer org with a Raft consenter, anchor peers)."""
    org1 = jcgen.generate_org("Org1MSP", "org1.tools.example.com")
    oorg = jcgen.generate_org("OrdererMSP", "ord.tools.example.com", peers=0, orderers=1)

    def profile(ctg, msp_of):
        return ctg.Profile(
            CHANNEL, application_orgs=[ctg.OrgProfile("Org1MSP", msp_of(org1),
                                                      [("peer0.org1", 7051)])],
            orderer_orgs=[ctg.OrgProfile("OrdererMSP", msp_of(oorg), [])],
            raft_consenters=[("127.0.0.1", 7050)], max_message_count=123)

    ref = jctg.genesis_block(profile(jctg, lambda o: o.msp()))
    port = pctg.genesis_block(profile(pctg, lambda o: pmsp.MSP(o.msp_id, [o.ca.cert_pem])))
    return {"ref": ref.SerializeToString(deterministic=True), "port": port.serialize()}


def _parts(block_bytes: bytes) -> dict:
    """{type name: serialized message} of every ``_TYPES`` entry one
    genesis block holds, plus a config update and its envelope."""
    blk = common_pb2.Block.FromString(block_bytes)
    env = common_pb2.Envelope.FromString(blk.data.data[0])
    payload = common_pb2.Payload.FromString(env.payload)
    cenv = configtx_pb2.ConfigEnvelope.FromString(payload.data)
    cfg = cenv.config
    ordg = cfg.channel_group.groups["Orderer"]
    ct = orderer_pb2.ConsensusType.FromString(ordg.values["ConsensusType"].value)
    new = configtx_pb2.Config()
    new.CopyFrom(cfg)
    bs = orderer_pb2.BatchSize.FromString(ordg.values["BatchSize"].value)
    bs.max_message_count = 999
    new.channel_group.groups["Orderer"].values["BatchSize"].value = bs.SerializeToString()
    upd = jctg.compute_update(CHANNEL, cfg, new)
    upd.isolated_data["note"] = b"\x00\xffbytes"
    uenv = configtx_pb2.ConfigUpdateEnvelope(config_update=upd.SerializeToString(
        deterministic=True), signatures=[configtx_pb2.ConfigSignature(
            signature_header=b"hdr", signature=b"sig")])
    det = lambda msg: msg.SerializeToString(deterministic=True)  # noqa: E731
    out = {"common.Block": det(blk), "common.Envelope": det(env),
           "common.Payload": det(payload), "common.ConfigEnvelope": det(cenv),
           "common.Config": det(cfg), "orderer.ConsensusType": det(ct),
           "orderer.RaftConfigMetadata": ct.metadata,
           "common.ConfigUpdate": det(upd), "common.ConfigUpdateEnvelope": det(uenv)}
    maint = orderer_pb2.ConsensusType()
    maint.CopyFrom(ct)
    maint.state = orderer_pb2.ConsensusType.STATE_MAINTENANCE
    out["orderer.ConsensusType/maintenance"] = det(maint)
    for i, dsl in enumerate(("OutOf(2, 'Org1MSP.peer', 'Org2MSP.admin', 'Org3MSP.member')",
                             "AND('Org1MSP.member', OR('Org2MSP.admin', 'Org1MSP.client'))",
                             "OR('Org1MSP.orderer')")):
        out[f"policies.SignaturePolicyEnvelope/{i}"] = det(
            jmsp.policy_to_proto(jpol.from_dsl(dsl)))
    return out


TYPES = ["common.Block", "common.Envelope", "common.Payload", "common.ConfigEnvelope",
         "common.Config", "orderer.ConsensusType", "orderer.ConsensusType/maintenance",
         "orderer.RaftConfigMetadata", "common.ConfigUpdate", "common.ConfigUpdateEnvelope",
         "policies.SignaturePolicyEnvelope/0", "policies.SignaturePolicyEnvelope/1",
         "policies.SignaturePolicyEnvelope/2"]


@pytest.mark.parametrize("source", ["ref", "port"])
@pytest.mark.parametrize("key", TYPES)
def test_proto_decode_is_json_formats_text(blocks, source, key):
    data = _parts(blocks[source])[key]
    name = key.split("/")[0]
    text = pctl.proto_decode(name, data)
    assert text == jctl.proto_decode(name, data)
    # and back: the same message, in deterministic order
    cls = type(jctl.message_type(name)())
    want = cls.FromString(jctl.proto_encode(name, text)).SerializeToString(deterministic=True)
    assert pctl.proto_encode(name, text) == want == data


@pytest.mark.parametrize("classification", [0, 1, 2, 4, 9])
def test_signed_by_zero_and_enums_by_name(blocks, classification):
    """A set oneof member at 0 is written; an enum by its name, a number
    no name has as the number, the default left out."""
    from fabric_tpu.protos import policies_pb2

    env = policies_pb2.SignaturePolicyEnvelope(
        rule=policies_pb2.SignaturePolicy(signed_by=0),
        identities=[policies_pb2.MSPPrincipal(principal_classification=classification,
                                                   principal=b"p")])
    data = env.SerializeToString(deterministic=True)
    text = pctl.proto_decode("policies.SignaturePolicyEnvelope", data)
    assert text == jctl.proto_decode("policies.SignaturePolicyEnvelope", data)
    obj = json.loads(text)
    assert obj["rule"] == {"signed_by": 0}
    names = {0: None, 1: "ORGANIZATION_UNIT", 2: "IDENTITY", 4: "COMBINED", 9: 9}
    assert obj["identities"][0].get("principal_classification") == names[classification]
    assert pctl.proto_encode("policies.SignaturePolicyEnvelope", text) == data
    maint = json.loads(pctl.proto_decode(
        "orderer.ConsensusType", _parts(blocks["port"])["orderer.ConsensusType/maintenance"]))
    assert maint["state"] == "STATE_MAINTENANCE"


@pytest.mark.parametrize("text", [
    '{"sequence": 7, "channelGroup": {"modPolicy": "Admins"}}',  # lowerCamel names
    '{"sequence": "18446744073709551615"}',
    '{"channel_group": {"values": {"x": {"value": "AP8"}}}}',  # unpadded base64
    '{"channel_group": {"values": {"x": {"value": "-_8="}}}}',  # URL-safe base64
    '{"sequence": null, "channel_group": {}}'])
def test_proto_encode_takes_what_parse_takes(text):
    want = configtx_pb2.Config.FromString(jctl.proto_encode("common.Config", text))
    assert pctl.proto_encode("common.Config", text) == want.SerializeToString(
        deterministic=True)


@pytest.mark.parametrize("text", ['{"nosuch": 1}', '{"sequence": "x"}', '"abc"',
                                  '{"sequence": -1}', '{"channel_group": 3}'])
def test_proto_encode_refuses_what_parse_refuses(text):
    with pytest.raises(Exception):
        jctl.proto_encode("common.Config", text)
    with pytest.raises(jsonfmt.JsonFormatError):
        pctl.proto_encode("common.Config", text)


def test_unknown_type_is_refused_alike():
    with pytest.raises(ValueError) as p:
        pctl.proto_decode("no.Such", b"")
    with pytest.raises(ValueError) as j:
        jctl.proto_decode("no.Such", b"")
    assert str(p.value) == str(j.value)


@pytest.mark.parametrize("source", ["ref", "port"])
@pytest.mark.parametrize("edit", ["batch_size", "new_org_value", "drop_anchor", "same"])
def test_compute_update_gives_the_same_bytes(blocks, source, edit):
    cfg_bytes = _parts(blocks[source])["common.Config"]
    new = configtx_pb2.Config.FromString(cfg_bytes)
    if edit == "batch_size":
        ordg = new.channel_group.groups["Orderer"]
        bs = orderer_pb2.BatchSize.FromString(ordg.values["BatchSize"].value)
        bs.max_message_count = 999
        ordg.values["BatchSize"].value = bs.SerializeToString()
    elif edit == "new_org_value":
        g = new.channel_group.groups["Application"].groups["Org1MSP"]
        g.values["Extra"].value = b"x"
        g.values["Extra"].mod_policy = "Admins"
    elif edit == "drop_anchor":
        del new.channel_group.groups["Application"].groups["Org1MSP"].values["AnchorPeers"]
    new_bytes = new.SerializeToString(deterministic=True)
    want = configtx_pb2.ConfigUpdate.FromString(
        jctl.compute_update(CHANNEL, cfg_bytes, new_bytes)).SerializeToString(deterministic=True)
    assert pctl.compute_update(CHANNEL, cfg_bytes, new_bytes) == want


# -- ledgerutil and nodeops -----------------------------------------------------


def _mk_ledger(path, n_blocks=6):
    lg = KVLedger(path, state_db=SqliteVersionedDB(os.path.join(path, "state.db")))
    prev = b""
    for n in range(n_blocks):
        blk = jpu.new_block(n, prev)
        blk.data.data.append(b"tx%d" % n)
        blk = jpu.finalize_block(blk)
        batch = UpdateBatch()
        batch.put("ns", f"k{n}", b"v%d" % n, (n, 0))
        lg.commit_block(blk, bytes([0]), batch, [])
        prev = jpu.block_header_hash(blk.header)
    lg.close()


@pytest.fixture(scope="module")
def ledger(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ledger") / "chan")
    _mk_ledger(d)
    return d


def _copies(ledger, tmp_path):
    p, j = str(tmp_path / "p" / "chan"), str(tmp_path / "j" / "chan")
    shutil.copytree(ledger, p)
    shutil.copytree(ledger, j)
    return p, j


def _tree(root) -> dict:
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _corrupt(path, what):
    seg = os.path.join(path, "chains", sorted(n for n in os.listdir(os.path.join(path, "chains"))
                                              if n.startswith("blocks_"))[0])
    with open(seg, "r+b") as f:
        raw = bytearray(f.read())
        if what == "data":
            i = raw.index(b"tx3")
            raw[i + 2] = ord("9")  # block 3's data no longer hashes to its header
        else:  # truncate the tail block
            raw = raw[:-7]
        f.seek(0)
        f.truncate()
        f.write(raw)


@pytest.mark.parametrize("damage", ["none", "data", "truncated"])
def test_ledgerutil_verify_gives_the_same_json(ledger, tmp_path, damage):
    p, j = _copies(ledger, tmp_path)
    if damage != "none":
        _corrupt(p, damage)
        _corrupt(j, damage)
    got, want = plu.verify_ledger(p), jlu.verify_ledger(j)
    assert (got.height, got.ok, got.errors) == (want.height, want.ok, want.errors)
    # the store drops a torn tail block when it opens: the chain verifies
    assert got.ok == (damage != "data")


@pytest.mark.parametrize("other", ["same", "shorter", "diverged"])
def test_ledgerutil_compare_gives_the_same_json(ledger, tmp_path, other):
    a = str(tmp_path / "a" / "chan")
    shutil.copytree(ledger, a)
    b = str(tmp_path / "b" / "chan")
    if other == "same":
        shutil.copytree(ledger, b)
    elif other == "shorter":
        _mk_ledger(b, n_blocks=4)
    else:
        os.makedirs(b)
        lg = KVLedger(b, state_db=SqliteVersionedDB(os.path.join(b, "state.db")))
        prev = b""
        for n in range(6):
            blk = jpu.new_block(n, prev)
            blk.data.data.append(b"tx%d" % n if n < 2 else b"other%d" % n)
            blk = jpu.finalize_block(blk)
            lg.commit_block(blk, bytes([0]), UpdateBatch(), [])
            prev = jpu.block_header_hash(blk.header)
        lg.close()
    assert plu.compare_ledgers(a, b) == jlu.compare_ledgers(a, b)


@pytest.mark.parametrize("op", ["reset", "rebuild_dbs", "rollback", "rollback_past_end",
                                "unjoin"])
def test_nodeops_give_the_same_json_and_files(ledger, tmp_path, op):
    p, j = _copies(ledger, tmp_path)
    for mod, d in ((pnodeops, p), (jnodeops, j)):
        if op.startswith("rollback"):
            res = mod.rollback(d, 2 if op == "rollback" else 99)
        else:
            res = getattr(mod, op)(d)
        res["channel_dir"] = os.path.relpath(res["channel_dir"], str(tmp_path))[2:]
        if mod is pnodeops:
            got = res
        else:
            want = res
    assert got == want
    assert os.path.exists(p) == os.path.exists(j)
    if os.path.exists(p):
        assert _tree(p) == _tree(j)
        assert plu.verify_ledger(p).height == jlu.verify_ledger(j).height
    with pytest.raises(FileNotFoundError):
        if op == "unjoin":
            pnodeops.unjoin(p)
        else:
            pnodeops.rollback(str(tmp_path / "nosuch"), 1)
