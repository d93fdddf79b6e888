"""Chaincode packages, the install RPC and chaincode as a service, the
port (``fabric_tpu_torch/peer/{ccpackage,ccaas}.py``, ``PeerNode``'s
``_on_install`` / ``_on_query_installed`` / ``_resolve_chaincode``)
against the reference's: byte-equal packages and package ids, the same
store listings, either package's chaincode server behind the other's
proxy, the install RPC's decision and JSON for the same requests, and
the approved package's binding."""

import asyncio
import json
import os
from types import SimpleNamespace

import pytest

from fabric_tpu.crypto import cryptogen as jcg
from fabric_tpu.crypto.msp import MSPManager as JMSPManager
from fabric_tpu.peer import ccaas as jccaas
from fabric_tpu.peer import ccpackage as jpkg
from fabric_tpu.peer import chaincode as jchaincode
from fabric_tpu.peer.node import PeerNode as JPeerNode
from fabric_tpu_torch.crypto.identity import SigningIdentity
from fabric_tpu_torch.crypto.msp import MSP, MSPManager
from fabric_tpu_torch.ledger.statedb import MemVersionedDB, UpdateBatch
from fabric_tpu_torch.peer import ccaas as pccaas
from fabric_tpu_torch.peer import ccpackage as ppkg
from fabric_tpu_torch.peer import chaincode as pchaincode
from fabric_tpu_torch.peer.lifecycle import (LIFECYCLE_NS, ChaincodeDefinition, approval_key,
                                             definition_key)
from fabric_tpu_torch.peer.node import PeerNode

PACKAGES = [("kv_1", "127.0.0.1:7052"), ("basic.v2+build-3", "cc.example.com:9999"),
            ("x", "")]


@pytest.mark.parametrize("label,address", PACKAGES)
def test_packages_and_ids_are_the_references(label, address):
    raw = ppkg.package_ccaas(label, address)
    assert raw == jpkg.package_ccaas(label, address)
    assert ppkg.package_id(label, raw) == jpkg.package_id(label, raw)
    assert ppkg.parse_package(raw) == jpkg.parse_package(raw)


@pytest.mark.parametrize("bad", [b"", b"not a tarball", b"\x1f\x8b\x08\x00garbage"])
def test_malformed_packages_are_refused_alike(bad):
    with pytest.raises(ValueError) as pe:
        ppkg.parse_package(bad)
    with pytest.raises(ValueError) as je:
        jpkg.parse_package(bad)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("label", ["", "-lead", "has space", "slash/no"])
def test_bad_labels_are_refused_alike(label):
    with pytest.raises(ValueError) as pe:
        ppkg.package_ccaas(label, "h:1")
    with pytest.raises(ValueError) as je:
        jpkg.package_ccaas(label, "h:1")
    assert str(pe.value) == str(je.value)


def test_package_stores_agree(tmp_path):
    ps, js = ppkg.PackageStore(str(tmp_path / "p")), jpkg.PackageStore(str(tmp_path / "j"))
    raws = [ppkg.package_ccaas(lbl, addr) for lbl, addr in PACKAGES]
    for raw in raws + raws[:1]:  # the same bytes twice: idempotent
        assert ps.install(raw) == js.install(raw)
    assert ps.list() == js.list()
    assert sorted(os.listdir(ps.dir)) == sorted(os.listdir(js.dir))
    for raw, (lbl, _) in zip(raws, PACKAGES):
        pid = ppkg.package_id(lbl, raw)
        assert ps.get(pid) == js.get(pid) == raw
        assert ps.connection(pid) == js.connection(pid)
    for pid in ("kv_1:" + "0" * 64, "bad", "kv_1:zz"):
        assert ps.get(pid) == js.get(pid) is None
        assert ps.connection(pid) == js.connection(pid) is None


class _Stub:
    """A chaincode stub over a dict: what the proxy's state callbacks reach."""

    def __init__(self, args, state):
        self.args, self.state = args, state
        self.transient, self.creator, self.events = {}, b"creator", []

    def get_state(self, key):
        return self.state.get(key)

    def put_state(self, key, value):
        self.state[key] = value

    def del_state(self, key):
        self.state.pop(key, None)

    def get_state_range(self, start, end, limit=0):
        rows = [(k, v) for k, v in sorted(self.state.items()) if start <= k < end]
        return rows[:limit] if limit else rows

    def get_private(self, coll, key):
        return self.state.get(f"{coll}/{key}")

    def put_private(self, coll, key, value):
        self.state[f"{coll}/{key}"] = value

    def set_event(self, name, payload):
        self.events.append((name, payload))


CALLS = [[b"put", b"a", b"10"], [b"put", b"b", b"5"], [b"get", b"a"],
         [b"transfer", b"a", b"b", b"3"], [b"get", b"b"], [b"del", b"a"], [b"get", b"a"],
         [b"nosuch"]]


def _drive(server_pkg, proxy_pkg):
    """One chaincode server of ``server_pkg`` (a kv contract) behind a
    proxy of ``proxy_pkg`` → each call's (status, payload, message) and
    the stub state after."""
    srv_mod = pccaas if server_pkg == "port" else jccaas
    contract = (pchaincode if server_pkg == "port" else jchaincode).KVContract()
    proxy_mod = pccaas if proxy_pkg == "port" else jccaas
    loop = asyncio.new_event_loop()
    srv = srv_mod.ChaincodeServer()
    loop.run_until_complete(srv.start())
    srv.register("kvcc", contract)
    import threading

    t = threading.Thread(target=loop.run_forever, daemon=True)
    t.start()
    try:
        proxy = proxy_mod.CCaaSProxy("kvcc", "127.0.0.1", srv.port)
        state, out = {}, []
        for args in CALLS:
            resp = proxy.invoke(_Stub(args, state))
            out.append((resp.status, resp.payload, resp.message))
        missing = proxy_mod.CCaaSProxy("other", "127.0.0.1", srv.port).invoke(
            _Stub([b"get", b"a"], state))
        out.append((missing.status, missing.payload, missing.message))
        return out, dict(state)
    finally:
        asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        t.join(10)
        loop.close()


@pytest.mark.parametrize("server,proxy", [("port", "ref"), ("ref", "port"), ("port", "port")])
def test_either_packages_server_serves_the_others_proxy(server, proxy):
    assert _drive(server, proxy) == _drive("ref", "ref")


# -- the install RPC ------------------------------------------------------------


@pytest.fixture(scope="module")
def orgs():
    return {msp: jcg.generate_org(msp, f"{msp.lower()[:4]}.inst.example.com", peers=1,
                                  users=1)
            for msp in ("Org1MSP", "Org2MSP")}


def _nodes(orgs, tmp_path, **kw):
    """The reference's and the port's peer of Org1 over the same material
    (never started: the RPC handlers are called directly)."""
    o1 = orgs["Org1MSP"]
    jsig = jcg.signing_identity(o1, "peer0.org1.inst.example.com")
    psig = SigningIdentity.from_pem("Org1MSP", jsig.key.private_bytes(
        *_pkcs8()), jsig.cert_pem)
    jnode = JPeerNode("p", str(tmp_path / "j"), JMSPManager(
        {m: o.msp() for m, o in orgs.items()}), jsig, **kw)
    pnode = PeerNode("p", str(tmp_path / "p"), MSPManager(
        {m: MSP(m, root_certs=[o.ca.cert_pem]) for m, o in orgs.items()}), psig,
        device="cpu", **kw)
    return jnode, pnode


def _pkcs8():
    from cryptography.hazmat.primitives import serialization

    return (serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption())


def _envelope(orgs, msp, who, pkg, signed=None):
    ident = jcg.signing_identity(orgs[msp], f"{who}@{msp.lower()[:4]}.inst.example.com")
    return json.dumps({"package": pkg.hex(), "identity": ident.serialized.hex(),
                       "signature": ident.sign(pkg if signed is None else signed).hex()
                       }).encode()


def _ask(node, method, req):
    return json.loads(asyncio.run(getattr(node, method)(req)))


REQUESTS = ["admin", "unsigned", "user", "other_org_admin", "wrong_bytes", "not_json",
            "too_large", "malformed_package"]


@pytest.mark.parametrize("case", REQUESTS)
@pytest.mark.parametrize("require_admin", [True, False])
def test_the_install_rpc_decides_as_the_reference(orgs, tmp_path, case, require_admin):
    pkg = ppkg.package_ccaas("kv_1", "127.0.0.1:7052")
    req = {"admin": lambda: _envelope(orgs, "Org1MSP", "Admin", pkg),
           "unsigned": lambda: pkg,
           "user": lambda: _envelope(orgs, "Org1MSP", "User1", pkg),
           "other_org_admin": lambda: _envelope(orgs, "Org2MSP", "Admin", pkg),
           "wrong_bytes": lambda: _envelope(orgs, "Org1MSP", "Admin", pkg, signed=b"other"),
           "not_json": lambda: b"{not json",
           "too_large": lambda: b"x" * 4097,
           "malformed_package": lambda: _envelope(orgs, "Org1MSP", "Admin", b"junk")
           if require_admin else b"junk"}[case]()
    jnode, pnode = _nodes(orgs, tmp_path, install_require_admin=require_admin,
                          max_package_size=4096 if case == "too_large" else 1 << 20)
    got, want = _ask(pnode, "_on_install", req), _ask(jnode, "_on_install", req)
    assert got == want
    assert _ask(pnode, "_on_query_installed", b"{}") == \
        _ask(jnode, "_on_query_installed", b"{}")
    if (case == "admin") == require_admin and case in ("admin", "unsigned"):
        assert got["status"] == 200


def test_query_installed_is_registered_to_its_own_handler(orgs, tmp_path):
    """``QueryInstalled`` lists the store (it once reached the install
    handler, which took ``{}`` for a package)."""
    from fabric_tpu_torch.comm.rpc import RpcClient

    _, pnode = _nodes(orgs, tmp_path)

    async def go():
        await pnode.start()
        cli = RpcClient("127.0.0.1", pnode.port)
        try:
            await cli.connect()
            pkg = ppkg.package_ccaas("kv_1", "127.0.0.1:7052")
            installed = json.loads(await cli.unary("InstallChaincode", pkg))
            listed = json.loads(await cli.unary("QueryInstalled", b"{}"))
            return installed, listed
        finally:
            await cli.close()
            await pnode.stop()

    installed, listed = asyncio.run(go())
    assert installed["status"] == 200
    assert listed == {"status": 200, "installed": [
        {"package_id": installed["package_id"], "label": "kv_1"}]}


@pytest.mark.parametrize("case", ["bound", "no_definition", "no_approval",
                                  "not_installed", "other_org_approved", "bad_address"])
def test_resolve_chaincode_binds_the_approved_package(orgs, tmp_path, case):
    jnode, pnode = _nodes(orgs, tmp_path)
    addr = "cc.host:7777" if case != "bad_address" else "nohostport"
    pkg = ppkg.package_ccaas("kv_1", addr)
    pid = ppkg.package_id("kv_1", pkg)
    if case != "not_installed":
        pnode.packages.install(pkg)
        jnode.packages.install(pkg)
    batch = UpdateBatch()
    if case != "no_definition":
        batch.put(LIFECYCLE_NS, definition_key("kvcc"),
                  ChaincodeDefinition("kvcc", 2).to_bytes(), (1, 0))
    if case != "no_approval":
        msp = "Org2MSP" if case == "other_org_approved" else "Org1MSP"
        batch.put(LIFECYCLE_NS, approval_key("kvcc", 2, msp),
                  json.dumps({"package_id": pid}).encode(), (1, 1))
    state = MemVersionedDB()
    state.apply_updates(batch, (1, 1))
    chan = SimpleNamespace(ledger=SimpleNamespace(state=state))
    pnode.channels["ch"] = chan
    jnode.channels["ch"] = chan  # the reference reads the same state interface
    got = pnode._resolve_chaincode("kvcc", "ch")
    want = jnode._resolve_chaincode("kvcc", "ch")
    assert (got is None) == (want is None)
    if case == "bound":
        assert isinstance(got, pccaas.CCaaSProxy)
        assert (got.chaincode, got.host, got.port) == (want.chaincode, want.host, want.port) \
            == ("kvcc", "cc.host", 7777)
    else:
        assert got is None
    assert pnode._resolve_chaincode("kvcc", "no-such-channel") is None
    # the runtime falls back to the resolver on a registry miss
    assert pnode.runtime.resolver == pnode._resolve_chaincode
