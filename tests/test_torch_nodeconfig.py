"""Typed node configs (``fabric_tpu_torch/nodeconfig.py``) against the
reference's (``fabric_tpu/nodeconfig.py``): the reference's
``tests/test_nodeconfig.py`` cases and the env overrides, each through
both loaders.  Where the reference accepts a config the port builds the
same typed config (``dataclasses.asdict``), less its ``device``; where
it refuses one the ``ConfigError`` text is the same; a key whose module
the port has not ported raises a ``ConfigError`` naming its ROADMAP
item."""

import dataclasses

import pytest

from fabric_tpu import nodeconfig as jnc
from fabric_tpu_torch import nodeconfig as pnc

PEER_MIN = {"id": "p0", "data_dir": "/tmp/p0", "msp_id": "Org1MSP", "msp_dir": "/tmp/msp"}
ORD_MIN = {"id": "o0", "data_dir": "/tmp/o0"}
ENV_ALL = {"FABTPU_PORT": "7051", "FABTPU_GROUP_COMMIT": "16",
           "FABTPU_DELIVER_CENSORSHIP_CHECK_S": "0.75", "FABTPU_TLS_CA": "/etc/ca.pem",
           "FABTPU_TLS_CERT": "/etc/cert.pem", "FABTPU_TLS_KEY": "/etc/key.pem",
           "IRRELEVANT": "x"}

# (case id, "peer" | "orderer", the raw config, the environment)
CASES = [
    ("peer_defaults", "peer", PEER_MIN, {}),
    ("missing_required", "peer", {"id": "p0"}, {}),
    ("peer_needs_msp_dir", "peer", {"id": "p0", "data_dir": "d", "msp_id": "O"}, {}),
    ("orderer_minimal", "orderer", ORD_MIN, {}),
    ("ops_port_type", "peer", {**PEER_MIN, "operations_port": "not-a-port"}, {}),
    ("ops_port", "peer", {**PEER_MIN, "operations_port": 9443}, {}),
    ("ops_port_env", "peer", PEER_MIN, {"FABTPU_OPERATIONS_PORT": "9444"}),
    ("partial_tls", "peer", {**PEER_MIN, "tls": {"cert": "c.pem"}}, {}),
    ("empty_tls", "peer", {**PEER_MIN, "tls": {}}, {}),
    ("unknown_key", "peer", {**PEER_MIN, "prot": 7051}, {}),
    ("unknown_tls_key", "peer", {**PEER_MIN, "tls": {"certt": "x"}}, {}),
    ("unknown_channel_key", "peer", {**PEER_MIN, "channels": [{"nam": "ch"}]}, {}),
    ("port_type", "peer", {**PEER_MIN, "port": "abc"}, {}),
    ("bool_for_int", "peer", {**PEER_MIN, "port": True}, {}),
    ("timeout_type", "orderer", {**ORD_MIN, "batch_timeout_s": []}, {}),
    ("consensus", "orderer", {**ORD_MIN, "consensus": "paxos"}, {}),
    ("orderer_sections", "orderer", {
        **ORD_MIN, "cluster": {"o0": ["127.0.0.1", 7050]}, "max_message_count": 10,
        "batch_timeout_s": 0.5, "consensus": "bft", "view_timeout": 1.5,
        "wal_retention": 64, "tls": {"cert": "c.pem", "key": "k.pem", "ca": "ca.pem"},
        "channels": [{"name": "ch1", "genesis": "g.block"}, "devch"]}, {}),
    ("peer_sections", "peer", {
        **PEER_MIN, "org_msps": ["/a", "/b"], "chaincodes": [{"name": "cc", "port": 9}],
        "peers": [{"msp_id": "Org2MSP", "port": 7}],
        "channels": [{"name": "c", "genesis": "g", "orderers": [["h", 1]],
                      "replay_from": "/r", "anti_entropy": True}, "dev"]}, {}),
    ("cluster_type", "orderer", {**ORD_MIN, "cluster": [1]}, {}),
    ("channels_type", "peer", {**PEER_MIN, "channels": "c"}, {}),
    ("section_type", "peer", {**PEER_MIN, "tls": "x"}, {}),
    ("env_overrides", "peer", {**PEER_MIN, "port": 1}, ENV_ALL),
    ("env_bad_port", "peer", PEER_MIN, {"FABTPU_PORT": "not-a-port"}),
    ("env_unknown_tls", "peer", PEER_MIN, {"FABTPU_TLS_BOGUS": "x"}),
    ("env_non_scalar_tls", "peer", PEER_MIN, {"FABTPU_TLS": "x"}),
    ("env_non_scalar_list", "peer", PEER_MIN, {"FABTPU_CHANNELS": "x"}),
    ("env_bool", "peer", PEER_MIN, {"FABTPU_ASYNC_COMMIT": "no"}),
    ("env_bad_bool", "peer", PEER_MIN, {"FABTPU_ASYNC_COMMIT": "maybe"}),
    ("orderer_env", "orderer", ORD_MIN, {"FABTPU_WAL_RETENTION": "512",
                                         "FABTPU_BATCH_TIMEOUT_S": "2"}),
    ("sign_defaults", "peer", PEER_MIN, {}),
    ("sign_knobs", "peer", {**PEER_MIN, "sign_device": True, "sign_batch_max": 1024,
                            "sign_batch_wait_ms": 0.5, "sign_self_check": True}, {}),
    ("sign_batch_max", "peer", {**PEER_MIN, "sign_batch_max": 0}, {}),
    ("sign_wait", "peer", {**PEER_MIN, "sign_batch_wait_ms": -1}, {}),
    ("sign_env", "peer", PEER_MIN, {"FABTPU_SIGN_DEVICE": "1", "FABTPU_SIGN_BATCH_MAX": "512"}),
    ("resident_knobs", "peer", {**PEER_MIN, "state_resident": True, "state_resident_mb": 256,
                                "state_resident_range_bits": 16}, {}),
    ("resident_mb", "peer", {**PEER_MIN, "state_resident_mb": 0}, {}),
    ("resident_bits_low", "peer", {**PEER_MIN, "state_resident_range_bits": 0}, {}),
    ("resident_bits_high", "peer", {**PEER_MIN, "state_resident_range_bits": 25}, {}),
    ("resident_env", "peer", PEER_MIN, {"FABTPU_STATE_RESIDENT": "1",
                                        "FABTPU_STATE_RESIDENT_MB": "8"}),
    ("pipeline_depth", "peer", {**PEER_MIN, "pipeline_depth": 0}, {}),
    ("apply_queue", "peer", {**PEER_MIN, "apply_queue_blocks": 0}, {}),
    ("stage_mode", "peer", {**PEER_MIN, "host_stage_mode": "fiber"}, {}),
    ("vitals_interval", "peer", {**PEER_MIN, "vitals_interval_s": -1.0}, {}),
    ("vitals_retention", "peer", {**PEER_MIN, "vitals_retention": 0}, {}),
    ("mesh_coordinator", "peer", {**PEER_MIN, "mesh_distributed": True}, {}),
    ("mesh_processes", "peer", {**PEER_MIN, "mesh_num_processes": 0}, {}),
    ("mesh_rank", "peer", {**PEER_MIN, "mesh_process_id": 3, "mesh_num_processes": 2}, {}),
    ("autopilot_tick", "peer", {**PEER_MIN, "autopilot_tick_s": 0}, {}),
    ("ported_knobs", "peer", {
        **PEER_MIN, "pipeline_depth": 3, "coalesce_blocks": 4, "host_stage_workers": -1,
        "trace_ring_blocks": 0, "trace_slow_factor": 2.0, "device_ledger": False,
        "tx_flow": False, "device_fail_threshold": 2, "device_retries": 1,
        "device_recovery_s": 0.5, "faults": "x:raise", "sidecar_endpoint": "h:1",
        "sidecar_weight": 2.0, "sidecar_recovery_s": 1.0, "async_commit": False,
        "apply_queue_blocks": 2, "max_package_size": 1024, "install_require_admin": True,
        "group_commit": 1, "transient_retention": 5, "deliver_censorship_check_s": 9.0},
     {}),
]

# keys whose module waits: the reference accepts them, the port names its item
UNPORTED = [
    ("slos", {"slos": "commit:latency:ms=250"}, 10),
    ("autopilot", {"autopilot": True}, 10),
    ("autopilot_knobs", {"autopilot_knobs": "coalesce_blocks:min=0:max=8"}, 10),
    ("autopilot_tick_s", {"autopilot_tick_s": 2.0}, 10),
    ("vitals_interval_s", {"vitals_interval_s": 1.0}, 10),
    ("vitals_retention", {"vitals_retention": 10}, 10),
    ("blackbox_dir", {"blackbox_dir": "/tmp/bb"}, 10),
    ("mesh_devices", {"mesh_devices": 2}, 9),
    ("mesh_shape", {"mesh_shape": "2x4"}, 9),
    ("mesh_distributed", {"mesh_distributed": True, "mesh_coordinator": "h:1"}, 9),
    ("mesh_num_processes", {"mesh_num_processes": 2}, 9),
    ("verify_chunk", {"verify_chunk": 64}, 9),
    ("recode_device", {"recode_device": True}, 10),
    ("verify_deadline_ms", {"verify_deadline_ms": 5.0}, 10),
    ("host_stage_mode", {"host_stage_mode": "process"}, 10),
    ("sidecar_listen", {"sidecar_listen": "127.0.0.1:7054"}, 10),
    ("sidecar_queue_blocks", {"sidecar_queue_blocks": 4}, 10),
    ("sidecar_coalesce", {"sidecar_coalesce": 2}, 10),
]


def _load(mod, kind, raw, env):
    fn = mod.load_peer_config if kind == "peer" else mod.load_orderer_config
    return fn(dict(raw), environ=dict(env))


def _typed(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("device", None)
    return d


@pytest.mark.parametrize("case,kind,raw,env", CASES, ids=[c[0] for c in CASES])
def test_the_reference_cases_load_alike(case, kind, raw, env):
    try:
        want = _load(jnc, kind, raw, env)
    except jnc.ConfigError as e:
        with pytest.raises(pnc.ConfigError) as got:
            _load(pnc, kind, raw, env)
        assert str(got.value) == str(e)
        return
    got = _load(pnc, kind, raw, env)
    assert type(got).__name__ == type(want).__name__
    assert _typed(got) == _typed(want)
    if kind == "peer":
        assert got.device == "cuda"


@pytest.mark.parametrize("key,raw,item", UNPORTED, ids=[u[0] for u in UNPORTED])
def test_an_unported_key_names_its_roadmap_item(key, raw, item):
    _load(jnc, "peer", {**PEER_MIN, **raw}, {})  # the reference takes it
    with pytest.raises(pnc.ConfigError) as e:
        _load(pnc, "peer", {**PEER_MIN, **raw}, {})
    assert str(e.value).startswith(f"key '{key}': ")
    assert str(e.value).endswith(f"is not ported yet (ROADMAP Queue 1 item {item})")


@pytest.mark.parametrize("where", ["file", "env"])
def test_the_device_key(tmp_path, where):
    """``device`` is the port's one addition: settable in the file or by
    ``FABTPU_DEVICE``, the reference refuses it as an unknown key."""
    raw, env = (({**PEER_MIN, "device": "cpu"}, {}) if where == "file"
                else (PEER_MIN, {"FABTPU_DEVICE": "cpu"}))
    cfg = _load(pnc, "peer", raw, env)
    assert cfg.device == "cpu"
    ref = jnc.load_peer_config(dict(PEER_MIN))
    assert _typed(cfg) == _typed(ref)
    if where == "file":
        with pytest.raises(jnc.ConfigError, match="unknown key 'device'"):
            _load(jnc, "peer", raw, env)


def test_a_file_with_bad_json_is_refused_alike(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text('{"id": ')
    with pytest.raises(jnc.ConfigError) as want:
        jnc.load_peer_config(str(path))
    with pytest.raises(pnc.ConfigError) as got:
        pnc.load_peer_config(str(path))
    assert str(got.value) == str(want.value)
    path.write_text('{"id": "p0", "data_dir": "d", "msp_id": "O", "msp_dir": "m"}')
    assert _typed(pnc.load_peer_config(str(path), environ={})) == \
        _typed(jnc.load_peer_config(str(path), environ={}))


def test_defaults_and_the_package_size_are_the_references():
    assert pnc.DEFAULT_MAX_PACKAGE_SIZE == jnc.DEFAULT_MAX_PACKAGE_SIZE
    assert _typed(pnc.PeerConfig()) == _typed(jnc.PeerConfig())
    assert _typed(pnc.OrdererConfig()) == _typed(jnc.OrdererConfig())
