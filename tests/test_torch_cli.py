"""The port's operator CLI (``python -m fabric_tpu_torch.cli``) against
the reference's (``fabric_tpu/cli.py``): every verb takes the reference's
options (plus ``--device`` on ``cryptogen`` and ``sidecar-serve``), a
config error and a peer asking for a card this host lacks exit 2, and
``tests/test_cli_network.py``'s whole flow runs against the port's
daemons on the CPU (``"device": "cpu"``): cryptogen, configtxgen, an
orderer, a ccaas chaincode server and two peers as processes of their
own with mutual TLS on every node, ccpackage / ccinstall /
ccqueryinstalled, approve and commit, invoke, query, discover,
/healthz and /metrics on every node, then ``ledgerutil`` and ``replay``
after the stop.  No assertion on timing; every wait is 120 s or more."""

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from fabric_tpu_torch import cli as pcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNEL = "clichan"
CC = "clicc"
WAIT_S = 180


def _reference_parser() -> argparse.ArgumentParser:
    """The reference's parser: ``fabric_tpu.cli.main`` builds it
    inline, so it is caught at ``parse_args``."""
    from fabric_tpu import cli as jcli

    class Caught(Exception):
        pass

    orig = argparse.ArgumentParser.parse_args

    def catch(self, *a, **kw):
        raise Caught(self)

    argparse.ArgumentParser.parse_args = catch
    try:
        jcli.main(["ledgerutil", "verify", "x"])
    except Caught as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("the reference's main did not parse")


def _options(p: argparse.ArgumentParser) -> set:
    out = set()
    for a in p._actions:
        if isinstance(a, argparse._SubParsersAction):
            continue
        out |= set(a.option_strings) or {a.dest}
    return out


def _subparsers(p: argparse.ArgumentParser) -> dict:
    (sp,) = [a for a in p._actions if isinstance(a, argparse._SubParsersAction)]
    return dict(sp.choices)


_REF = _reference_parser()
_VERBS = sorted(_subparsers(_REF))


@pytest.mark.parametrize("verb", ["(global)"] + _VERBS)
def test_every_verb_takes_the_reference_options(verb):
    port = pcli.parser()
    if verb == "(global)":
        assert _options(port) == _options(_REF)
        assert sorted(_subparsers(port)) == _VERBS
        return
    want = _options(_subparsers(_REF)[verb])
    if verb in ("cryptogen", "sidecar-serve"):
        want |= {"--device"}
    assert _options(_subparsers(port)[verb]) == want
    for a in _subparsers(port)[verb]._actions:  # choices and defaults as the reference's
        ref = {r.dest: r for r in _subparsers(_REF)[verb]._actions}.get(a.dest)
        if ref is not None:
            assert (a.choices, a.default, a.required) == (ref.choices, ref.default, ref.required)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    env.pop("FABTPU_FAULTS", None)
    return env


def _cli(*args, timeout=WAIT_S):
    return subprocess.run([sys.executable, "-m", "fabric_tpu_torch.cli", *args], cwd=REPO,
                          env=_env(), capture_output=True, text=True, timeout=timeout)


def _spawn(log, *args):
    """A daemon, its output in ``log`` (a file: an unread pipe could fill)."""
    with open(log, "ab") as out:
        return subprocess.Popen([sys.executable, "-m", "fabric_tpu_torch.cli", *args],
                                cwd=REPO, env=_env(), stdout=out, stderr=subprocess.STDOUT)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_port(port, proc, timeout=WAIT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            return False
        try:
            socket.create_connection(("127.0.0.1", port), 1).close()
            return True
        except OSError:
            time.sleep(0.2)
    return False


def _last_json(res):
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.read()


@pytest.mark.parametrize("case", ["peer_bad_key", "peer_unported", "orderer_bad_consensus",
                                  "replay_bad_json"])
def test_a_config_error_exits_2(tmp_path, case):
    cfg = {"id": "p0", "data_dir": str(tmp_path / "d"), "msp_id": "O", "msp_dir": "m",
           "device": "cpu"}
    verb = "peer"
    if case == "peer_bad_key":
        cfg["prot"] = 7051
    elif case == "peer_unported":
        cfg["slos"] = "commit:latency:ms=250"
    elif case == "orderer_bad_consensus":
        verb, cfg = "orderer", {"id": "o", "data_dir": "d", "consensus": "paxos"}
    path = tmp_path / "cfg.json"
    path.write_text("{not json" if case == "replay_bad_json" else json.dumps(cfg))
    args = (["replay", "--config", str(path), "--channel", "c"] if case == "replay_bad_json"
            else [verb, "--config", str(path)])
    res = _cli(*args)
    assert res.returncode == 2, res.stdout + res.stderr
    assert res.stderr.startswith("config error: ")
    if case == "peer_unported":
        assert "ROADMAP Queue 1 item 10" in res.stderr


@pytest.mark.parametrize("flag,value,item", [
    ("--slos", "req:latency:ms=50", 10), ("--autopilot", None, 10),
    ("--vitals-interval-s", "0.5", 10), ("--blackbox-dir", "bb", 10),
    ("--mesh-shape", "2x4", 9), ("--verify-chunk", "64", 9), ("--recode-device", None, 10)])
def test_sidecar_serve_flags_of_unported_modules_exit_2(flag, value, item):
    res = _cli("sidecar-serve", "--device", "cpu", flag, *([value] if value else []))
    assert res.returncode == 2, res.stdout + res.stderr
    assert res.stderr.strip().endswith(f"is not ported yet (ROADMAP Queue 1 item {item})")
    assert res.stderr.startswith(flag)


@pytest.mark.parametrize("verb", ["peer", "cryptogen", "sidecar-serve"])
def test_a_cuda_device_on_a_host_without_one_exits_2(tmp_path, verb):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    if verb == "peer":
        path = tmp_path / "p.json"
        path.write_text(json.dumps({"id": "p0", "data_dir": str(tmp_path / "d"),
                                    "msp_id": "O", "msp_dir": "m"}))  # device: cuda
        res = _cli("peer", "--config", str(path))
    elif verb == "sidecar-serve":
        res = _cli("sidecar-serve", "--listen", "127.0.0.1:0")
    else:
        res = _cli("cryptogen", "--org", "Org1MSP:org1.example.com", "--output",
                   str(tmp_path / "c"))
    assert res.returncode == 2, res.stdout + res.stderr
    lines = res.stderr.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("device error: ") and "CUDA" in lines[0]
    assert not (tmp_path / "c").exists()


def test_sidecar_serve_serves_and_stops(tmp_path):
    """``sidecar-serve`` on the CPU: the validate stream and the
    operations port open, /healthz answers, SIGINT ends it with 0."""
    port, ops = _free_port(), _free_port()
    log = tmp_path / "sidecar.log"
    proc = _spawn(log, "sidecar-serve", "--device", "cpu", "--listen", f"127.0.0.1:{port}",
                  "--operations-port", str(ops))
    try:
        assert _wait_port(port, proc) and _wait_port(ops, proc), log.read_text()
        status, body = _get(ops, "/healthz")
        assert status == 200 and json.loads(body)["status"] == "OK"
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log.read_text()
    assert f"validation sidecar serving on 127.0.0.1:{port}" in log.read_text()


def _refused(port, ca_bundle, cert=None, key=None) -> bool:
    """Whether a client with this material is refused at the transport
    (an ``Info`` RPC that fails to connect or is cut)."""
    import asyncio

    from fabric_tpu_torch.comm.rpc import RpcClient, make_client_tls

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    ctx = None if ca_bundle is None else make_client_tls(
        read(ca_bundle), cert and read(cert), key and read(key))

    async def go():
        cli = RpcClient("127.0.0.1", port, ssl_ctx=ctx)
        try:
            await cli.connect()
            await cli.unary("Info", b'{"channel": "x"}', timeout=WAIT_S)
            return False
        except Exception:
            return True
        finally:
            await cli.close()

    return asyncio.run(go())


def test_cli_network_on_the_port_daemons(tmp_path):
    crypto = str(tmp_path / "crypto")
    res = _cli("cryptogen", "--device", "cpu", "--org", "Org1MSP:org1.example.com",
               "--org", "Org2MSP:org2.example.com", "--org", "OrdererMSP:ord.example.com",
               "--orderers", "1", "--output", crypto)
    assert res.returncode == 0, res.stderr
    org1, org2, ordorg = (f"{crypto}/{d}.example.com" for d in ("org1", "org2", "ord"))

    # one trusted TLS-CA bundle: every listener demands a client
    # certificate and every dial presents one
    ca_bundle = str(tmp_path / "tls-ca-bundle.pem")
    with open(ca_bundle, "wb") as bf:
        for od in (org1, org2, ordorg):
            with open(f"{od}/tlsca/tlsca-cert.pem", "rb") as cf:
                bf.write(cf.read())

    def tls_cfg(org_dir, node):
        tdir = f"{org_dir}/nodes/{node}/tls"
        return {"cert": f"{tdir}/server.pem", "key": f"{tdir}/key.pem", "ca": ca_bundle}

    profile = {"channel": CHANNEL,
               "application_orgs": [{"msp_id": "Org1MSP", "dir": org1},
                                    {"msp_id": "Org2MSP", "dir": org2}],
               # the orderer org in the genesis config: peers verify every
               # delivered block's signature against BlockValidation
               "orderer_orgs": [{"msp_id": "OrdererMSP", "dir": ordorg}],
               "max_message_count": 1, "batch_timeout_ms": 100}
    prof_path = str(tmp_path / "profile.json")
    with open(prof_path, "w") as f:
        json.dump(profile, f)
    genesis = str(tmp_path / "genesis.block")
    res = _cli("configtxgen", "--profile", prof_path, "--output", genesis)
    assert res.returncode == 0, res.stderr

    cc_port, ord_port, p1_port, p2_port = (_free_port() for _ in range(4))
    ops = {"orderer": _free_port(), "p1": _free_port(), "p2": _free_port()}
    ord_cfg = {"id": "o0", "data_dir": str(tmp_path / "o0"), "port": ord_port,
               "cluster": {"o0": ["127.0.0.1", ord_port]}, "max_message_count": 1,
               "batch_timeout_s": 0.1, "msp_id": "OrdererMSP",
               "msp_dir": f"{ordorg}/nodes/orderer0.ord.example.com/msp",
               "tls": tls_cfg(ordorg, "orderer0.ord.example.com"),
               "operations_port": ops["orderer"],
               "channels": [{"name": CHANNEL, "genesis": genesis}]}

    def peer_cfg(pid, port, org_dir, msp_id, other_port, other_msp):
        node = f"peer0.{os.path.basename(org_dir)}"
        return {"id": pid, "data_dir": str(tmp_path / pid), "port": port, "msp_id": msp_id,
                "msp_dir": f"{org_dir}/nodes/{node}/msp", "tls": tls_cfg(org_dir, node),
                "org_msps": [org1, org2], "device": "cpu",
                # no static chaincode registration: the peers resolve CC
                # from the installed package their org's approval binds
                "peers": [{"msp_id": other_msp, "host": "127.0.0.1", "port": other_port}],
                "channels": [{"name": CHANNEL, "genesis": genesis,
                              "orderers": [["127.0.0.1", ord_port]]}],
                "operations_port": ops[pid]}

    cfgs = {"orderer": ord_cfg,
            "p1": peer_cfg("p1", p1_port, org1, "Org1MSP", p2_port, "Org2MSP"),
            "p2": peer_cfg("p2", p2_port, org2, "Org2MSP", p1_port, "Org1MSP")}
    for name, cfg in cfgs.items():
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump(cfg, f)

    procs = []
    try:
        procs.append(_spawn(tmp_path / "cc.log", "chaincode", "--name", CC,
                            "--port", str(cc_port)))
        procs.append(_spawn(tmp_path / "o0.log", "orderer", "--config",
                            str(tmp_path / "orderer.json")))
        assert _wait_port(cc_port, procs[0]) and _wait_port(ord_port, procs[1])
        procs.append(_spawn(tmp_path / "p1.log", "peer", "--config", str(tmp_path / "p1.json")))
        procs.append(_spawn(tmp_path / "p2.log", "peer", "--config", str(tmp_path / "p2.json")))
        assert _wait_port(p1_port, procs[2]) and _wait_port(p2_port, procs[3]), \
            (tmp_path / "p1.log").read_text() + (tmp_path / "p2.log").read_text()

        user_msp = f"{org1}/users/User1@org1.example.com/msp"
        ptls = f"{org1}/nodes/peer0.org1.example.com/tls"
        cli_tls = ("--tls-ca", ca_bundle, "--tls-cert", f"{ptls}/server.pem",
                   "--tls-key", f"{ptls}/key.pem")

        # a plaintext client and a client without a certificate are
        # refused by every node's listener; a certified one is served
        for port in (ord_port, p1_port, p2_port):
            assert _refused(port, None)
            assert _refused(port, ca_bundle)
        assert not _refused(p1_port, ca_bundle, f"{ptls}/server.pem", f"{ptls}/key.pem")

        # package + install on both peers; the approvals bind its id
        pkg_path = str(tmp_path / "kv.tgz")
        pkg_id = _last_json(_cli("ccpackage", "--label", "kv_1", "--address",
                                 f"127.0.0.1:{cc_port}", "--output", pkg_path))["package_id"]
        for pp in (p1_port, p2_port):
            out = _last_json(_cli(*cli_tls, "ccinstall", "--port", str(pp),
                                  "--package", pkg_path))
            assert out["status"] == 200 and out["package_id"] == pkg_id
        out = _last_json(_cli(*cli_tls, "ccqueryinstalled", "--port", str(p1_port)))
        assert out["installed"] == [{"package_id": pkg_id, "label": "kv_1"}]

        spec = json.dumps({"policy": {"ref": "Endorsement"}, "package_id": pkg_id})
        for msp_id, org_dir in (("Org1MSP", org1), ("Org2MSP", org2)):
            u = f"{org_dir}/users/User1@{os.path.basename(org_dir)}/msp"
            out = _last_json(_cli(*cli_tls, "invoke", "--port", str(p1_port), "--channel",
                                  CHANNEL, "--chaincode", "_lifecycle", "--msp-dir", u,
                                  "--msp-id", msp_id, "approve", CC, "1", spec))
            assert out["code"] == 0, out
        out = _last_json(_cli(*cli_tls, "invoke", "--port", str(p1_port), "--channel", CHANNEL,
                              "--chaincode", "_lifecycle", "--msp-dir", user_msp,
                              "--msp-id", "Org1MSP", "commit", CC, "1", spec))
        assert out["code"] == 0, out

        # endorsed on both orgs by the committed Endorsement reference
        out = _last_json(_cli(*cli_tls, "invoke", "--port", str(p1_port), "--channel", CHANNEL,
                              "--chaincode", CC, "--msp-dir", user_msp, "--msp-id", "Org1MSP",
                              "put", "city", "lucerne"))
        assert out["code_name"] == "VALID", out
        out = _last_json(_cli(*cli_tls, "query", "--port", str(p2_port), "--channel", CHANNEL,
                              "--chaincode", CC, "--msp-dir", user_msp, "--msp-id", "Org1MSP",
                              "get", "city"))
        assert out["payload"] == "lucerne", out
        desc = _last_json(_cli(*cli_tls, "discover", "--port", str(p1_port), "--channel",
                               CHANNEL, "--query", "endorsers", "--chaincode", CC))
        assert desc["status"] == 200
        assert {"Org1MSP": 1, "Org2MSP": 1} in desc["descriptor"]["layouts"]

        out = _last_json(_cli(*cli_tls, "snapshot", "--port", str(p1_port), "--channel",
                              CHANNEL, "--output", str(tmp_path / "snap")))
        assert out["status"] == 200 and out["metadata"]["height"] == 5, out
        out = _last_json(_cli(*cli_tls, "osnadmin", "--port", str(ord_port), "--channel",
                              "devchan"))
        assert out == {"status": 201}

        for name, port in ops.items():
            status, body = _get(port, "/healthz")
            assert status == 200 and json.loads(body)["status"] == "OK", name
        for name in ("p1", "p2"):
            _, body = _get(ops[name], "/metrics")
            assert b"ledger_blockchain_height" in body
            _, body = _get(ops[name], "/launches")
            assert json.loads(body)["enabled"] is True
    finally:
        for p in procs:
            p.send_signal(signal.SIGINT)
        for p in procs:
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    # offline forensics on the stopped peers' ledgers
    p1_dir, p2_dir = str(tmp_path / "p1" / CHANNEL), str(tmp_path / "p2" / CHANNEL)
    out = _last_json(_cli("ledgerutil", "verify", p1_dir))
    assert out["ok"] and out["height"] == 5  # genesis, two approvals, the commit, the put
    out = _last_json(_cli("ledgerutil", "compare", p1_dir, p2_dir))
    assert out["identical"]

    # the offline channel ops on a copy of the stopped peer's channel
    import shutil

    copy = str(tmp_path / "p2copy" / CHANNEL)
    shutil.copytree(p2_dir, copy)
    out = _last_json(_cli("node", "reset", "--channel-dir", copy))
    assert out["dropped"], out
    assert _last_json(_cli("ledgerutil", "verify", copy))["ok"]
    res = _cli("node", "rollback", "--channel-dir", copy)
    assert res.returncode == 2 and "requires --block-number" in res.stderr
    out = _last_json(_cli("node", "rollback", "--channel-dir", copy, "--block-number", "3"))
    assert out["rolled_back_to"] == 3 and out["truncated"]
    assert _last_json(_cli("ledgerutil", "verify", copy))["height"] == 4
    assert _last_json(_cli("node", "unjoin", "--channel-dir", copy))["removed"]

    # the genesis block through configtxlator and back
    js = str(tmp_path / "genesis.json")
    res = _cli("configtxlator", "proto_decode", "--type", "common.Block", "--input", genesis,
               "--output", js)
    assert res.returncode == 0, res.stderr
    with open(js) as f:
        header = json.load(f)["header"]
    assert "number" not in header and "data_hash" in header  # block 0: a default, left out
    back = str(tmp_path / "genesis.again")
    res = _cli("configtxlator", "proto_encode", "--type", "common.Block", "--input", js,
               "--output", back)
    assert res.returncode == 0, res.stderr
    with open(back, "rb") as a, open(genesis, "rb") as b:
        assert a.read() == b.read()

    # replay Org2's config into a fresh data dir from Org1's block store
    rcfg = dict(cfgs["p2"], data_dir=str(tmp_path / "p2r"))
    with open(tmp_path / "p2r.json", "w") as f:
        json.dump(rcfg, f)
    stats = _last_json(_cli("replay", "--config", str(tmp_path / "p2r.json"), "--channel",
                            CHANNEL, "--source", f"{p1_dir}/chains"))
    assert stats["height"] == _last_json(_cli("ledgerutil", "verify", p1_dir))["height"]
    out = _last_json(_cli("ledgerutil", "compare", p1_dir, str(tmp_path / "p2r" / CHANNEL)))
    assert out["identical"], out
