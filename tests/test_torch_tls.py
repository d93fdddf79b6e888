"""TLS material and mutual TLS: the port's cryptogen disk layout, its
PKCS#8 keys and ``SigningIdentity.from_pem`` against the reference's
(``fabric_tpu/crypto/cryptogen.py``, ``crypto/identity.py``), TLS
handshakes between either package's servers and clients
(``comm/rpc.py::make_server_tls`` / ``make_client_tls`` /
``TlsProfile``), plaintext and uncertified clients refused, and the
reference's ``tests/test_mtls_sigfilter.py`` scenario on the port's
nodes."""

import asyncio
import os

import numpy as np
import pytest
import torch

from fabric_tpu.comm import rpc as jrpc
from fabric_tpu.crypto import cryptogen as jcg
from fabric_tpu.crypto.msp import MSPManager as JMSPManager
from fabric_tpu_torch.comm import rpc as prpc
from fabric_tpu_torch.crypto import cryptogen as pcg
from fabric_tpu_torch.crypto import der
from fabric_tpu_torch.crypto.identity import SigningIdentity
from fabric_tpu_torch.crypto.msp import MSPManager, verify_signature

CHANNEL = "tlschan"
CC = "tlscc"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(coro, timeout=120):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """One org written by each package: {package: (org material, org dir)}."""
    base = tmp_path_factory.mktemp("orgs")
    porg = pcg.generate_org("Org1MSP", "org1.port.example.com", np.random.default_rng(7),
                            peers=1, orderers=1, users=1)
    jorg = jcg.generate_org("Org2MSP", "org2.ref.example.com", peers=1, orderers=1, users=1)
    return {"port": (porg, pcg.write_org(porg, str(base / "port"))),
            "ref": (jorg, jcg.write_org(jorg, str(base / "ref")))}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_the_disk_layouts_are_the_same(layouts):
    port = [p.replace("port.example.com", "X").replace("Org1", "Org") for p in
            _files(layouts["port"][1])]
    ref = [p.replace("ref.example.com", "X").replace("org2", "org1") for p in
           _files(layouts["ref"][1])]
    assert sorted(p.replace("org1.X", "X") for p in port) == \
        sorted(p.replace("org1.X", "X") for p in ref)
    for pkg in ("port", "ref"):
        with open(os.path.join(layouts[pkg][1], "msp", "config.json")) as f:
            assert f.read() == '{"msp_id": "%s", "node_ous": true}' % (
                "Org1MSP" if pkg == "port" else "Org2MSP")


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("member", ["peer0", "orderer0", "Admin", "User1"])
def test_each_package_loads_the_others_layout(layouts, writer, member):
    """An msp/ directory written by either package: both loaders read
    the same scalar and certificate, the reference's MSP accepts the
    identity with its role, and each package's signature verifies under
    the other's MSP."""
    org, org_dir = layouts[writer]
    msp_id = "Org1MSP" if writer == "port" else "Org2MSP"
    group, name = (("nodes", f"{member}.{org.domain}") if member[0].islower()
                   else ("users", f"{member}@{org.domain}"))
    msp_dir = os.path.join(org_dir, group, name, "msp")
    psig = pcg.load_signing_identity(msp_dir, msp_id)
    jsig = jcg.load_signing_identity(msp_dir, msp_id)
    assert psig.d == jsig.key.private_numbers().private_value
    assert psig.serialized == jsig.serialized
    jmgr = JMSPManager({msp_id: jcg.load_org_msp(org_dir)})
    pmgr = MSPManager({msp_id: pcg.load_org_msp(org_dir)})
    jid = jmgr.deserialize_identity(psig.serialized)
    pid = pmgr.deserialize_identity(jsig.serialized)
    role = {"peer0": "peer", "orderer0": "orderer", "Admin": "admin", "User1": "client"}[member]
    assert jid.is_valid and pid.is_valid and jid.role == pid.role == role
    msg = b"signed by %s" % member.encode()
    assert jid.verify(msg, psig.sign(msg))
    assert verify_signature(pid, msg, jsig.sign(msg))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_tls_profiles_load_in_both_packages(layouts, writer):
    org, org_dir = layouts[writer]
    node = f"peer0.{org.domain}"
    pprof = pcg.load_tls_profile(org_dir, node)
    jprof = jcg.load_tls_profile(org_dir, node)
    assert (pprof.cert_pem, pprof.key_pem, pprof.ca_pem) == \
        (jprof.cert_pem, jprof.key_pem, jprof.ca_pem)
    for prof in (pprof, jprof):  # OpenSSL takes the pair and the CA
        prof.server_ctx()
        prof.client_ctx()


def test_keys_and_sans_are_what_cryptography_writes(layouts):
    from cryptography import x509
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import ec

    porg, _ = layouts["port"]
    ident = porg.tls["peer0.org1.port.example.com"]
    key = ec.derive_private_key(ident.d, ec.SECP256R1())
    assert der.pem_private_key(ident.d) == key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption())
    sec1 = key.private_bytes(serialization.Encoding.PEM,
                             serialization.PrivateFormat.TraditionalOpenSSL,
                             serialization.NoEncryption())
    assert der.read_pem_private_key(sec1) == ident.d
    cert = x509.load_pem_x509_certificate(ident.cert_pem)
    san = cert.extensions.get_extension_for_class(x509.SubjectAlternativeName)
    assert not san.critical
    assert san.value.get_values_for_type(x509.DNSName) == ["peer0.org1.port.example.com",
                                                           "localhost"]
    assert [str(a) for a in san.value.get_values_for_type(x509.IPAddress)] == ["127.0.0.1"]
    tlsca = x509.load_pem_x509_certificate(porg.tls_ca.cert_pem)
    assert tlsca.subject.get_attributes_for_oid(x509.NameOID.COMMON_NAME)[0].value == \
        "tlsca.org1.port.example.com"
    cert.verify_directly_issued_by(tlsca)


def test_from_pem_over_a_reference_key_signs_what_the_reference_verifies(layouts):
    jorg, org_dir = layouts["ref"]
    user = jorg.users["User1@org2.ref.example.com"]
    ident = SigningIdentity.from_pem("Org2MSP", user.key_pem, user.cert_pem)
    ref = jcg.signing_identity(jorg, "User1@org2.ref.example.com")
    assert ident.serialized == ref.serialized
    msg = b"a proposal"
    assert JMSPManager({"Org2MSP": jorg.msp()}).deserialize_identity(
        ident.serialized).verify(msg, ident.sign(msg))
    with pytest.raises(der.DERError):
        SigningIdentity.from_pem("Org2MSP", user.cert_pem, user.cert_pem)


def _bundle(layouts):
    return layouts["port"][0].tls_ca.cert_pem + layouts["ref"][0].tls_ca.cert_pem


async def _echo_server(rpc, ctx):
    srv = rpc.RpcServer("127.0.0.1", 0, ssl_ctx=ctx)

    async def echo(req):
        return b"echo:" + req

    srv.register_unary("Echo", echo)
    return await srv.start()


async def _call(rpc, port, ctx):
    cli = rpc.RpcClient("127.0.0.1", port, ssl_ctx=ctx)
    try:
        await cli.connect()
        return await cli.unary("Echo", b"hi", timeout=10)
    finally:
        await cli.close()


@pytest.mark.parametrize("server", ["port", "ref"])
def test_a_server_of_either_package_takes_the_others_client(layouts, server):
    """mTLS both ways: the server's package and material on one side,
    the other package's client with its own material on the other."""
    bundle = _bundle(layouts)
    client = "ref" if server == "port" else "port"
    srv_org, srv_dir = layouts[server]
    cli_org, cli_dir = layouts[client]
    srv_rpc, cli_rpc = (prpc, jrpc) if server == "port" else (jrpc, prpc)
    srv_prof = (pcg if server == "port" else jcg).load_tls_profile(
        srv_dir, f"peer0.{srv_org.domain}", bundle)
    cli_prof = (pcg if client == "port" else jcg).load_tls_profile(
        cli_dir, f"orderer0.{cli_org.domain}", bundle)

    async def go():
        srv = await _echo_server(srv_rpc, srv_prof.server_ctx())
        try:
            assert await _call(cli_rpc, srv.port, cli_prof.client_ctx()) == b"echo:hi"
            ctx = cli_rpc.make_client_tls(bundle, cli_prof.cert_pem, cli_prof.key_pem)
            assert await _call(cli_rpc, srv.port, ctx) == b"echo:hi"
        finally:
            await srv.stop()

    run(go())


@pytest.mark.parametrize("client", ["plaintext", "no_certificate", "untrusted_ca"])
def test_a_port_listener_refuses_clients_without_a_trusted_certificate(layouts, client):
    bundle = layouts["port"][0].tls_ca.cert_pem
    porg, pdir = layouts["port"]
    jorg, jdir = layouts["ref"]
    srv_prof = pcg.load_tls_profile(pdir, f"peer0.{porg.domain}", bundle)
    ctx = {"plaintext": None,
           "no_certificate": prpc.make_client_tls(bundle),
           # a certificate the server's bundle does not trust
           "untrusted_ca": prpc.make_client_tls(
               bundle, jorg.tls[f"peer0.{jorg.domain}"].cert_pem,
               jorg.tls[f"peer0.{jorg.domain}"].key_pem)}[client]

    async def go():
        srv = await _echo_server(prpc, srv_prof.server_ctx())
        try:
            with pytest.raises(Exception):
                await asyncio.wait_for(_call(prpc, srv.port, ctx), 15)
            # the listener still serves a certified client
            assert await _call(prpc, srv.port, srv_prof.client_ctx()) == b"echo:hi"
        finally:
            await srv.stop()

    run(go())


def test_mtls_network_and_sig_filter_on_the_port_nodes(tmp_path):
    """``tests/test_mtls_sigfilter.py`` on the port's ``OrdererNode`` and
    ``PeerNode`` (device "cpu"): mTLS on every listener, plaintext and
    uncertified clients refused, an mTLS broadcast committed through
    the peer's deliver, and the orderer's Writers filter refusing a
    broken signature and an outsider's envelope."""
    from fabric_tpu_torch.ledger.rwset import TxRWSet
    from fabric_tpu_torch.ordering import BatchConfig, BroadcastClient, OrdererNode
    from fabric_tpu_torch.peer import txassembly as txa
    from fabric_tpu_torch.peer.chaincode import ChaincodeRuntime, KVContract
    from fabric_tpu_torch.peer.node import PeerNode
    from fabric_tpu_torch.tools import configtxgen as ctg

    rng = np.random.default_rng(11)
    org1 = pcg.generate_org("Org1MSP", "org1.example.com", rng, peers=1, users=1)
    oorg = pcg.generate_org("OrdererMSP", "ord.example.com", rng, peers=0, orderers=1,
                            users=0)
    bundle = org1.tls_ca.cert_pem + oorg.tls_ca.cert_pem

    def tls_of(org, name):
        ident = org.tls[name]
        return prpc.TlsProfile(ident.cert_pem, der.pem_private_key(ident.d), bundle)

    genesis = ctg.genesis_block(ctg.Profile(
        CHANNEL, application_orgs=[ctg.OrgProfile(org1.msp_id, org1.msp())],
        orderer_orgs=[ctg.OrgProfile(oorg.msp_id, oorg.msp())]))
    client = pcg.signing_identity(org1, "User1@org1.example.com")
    peer_id = pcg.signing_identity(org1, "peer0.org1.example.com")
    peer_tls = tls_of(org1, "peer0.org1.example.com")

    def env(key=b"k", sign_with=None):
        _, _, prop = txa.create_signed_proposal(client, CHANNEL, CC, [b"i"])
        tx = TxRWSet()
        tx.ns_rwset(CC).writes[key.decode()] = b"v"
        resps = [txa.create_proposal_response(prop, tx.to_bytes(), peer_id, CC)]
        return txa.assemble_transaction(prop, resps, sign_with or client)

    async def scenario():
        orderer = OrdererNode("o0", str(tmp_path / "o0"), {},
                              batch_config=BatchConfig(max_message_count=1,
                                                       batch_timeout_s=0.1),
                              signer=pcg.signing_identity(oorg, "orderer0.ord.example.com"),
                              tls=tls_of(oorg, "orderer0.ord.example.com"))
        await orderer.start()
        orderer.cluster["o0"] = ("127.0.0.1", orderer.port)
        orderer.join_channel(CHANNEL, genesis_block=genesis)
        rt = ChaincodeRuntime()
        rt.register(CC, KVContract())
        mgr = MSPManager({"Org1MSP": org1.msp(), "OrdererMSP": oorg.msp()})
        peer = PeerNode("p0", str(tmp_path / "p0"), mgr, peer_id, rt, tls=peer_tls,
                        device="cpu")
        await peer.start()
        chan = peer.join_channel(CHANNEL, genesis_block=genesis)
        chan.start_deliver([("127.0.0.1", orderer.port)])
        bc = BroadcastClient([("127.0.0.1", orderer.port)], ssl_ctx=peer_tls.client_ctx())
        try:
            for port in (orderer.port, peer.port):
                for ctx in (None, prpc.make_client_tls(bundle)):
                    cli = prpc.RpcClient("127.0.0.1", port, ssl_ctx=ctx)
                    with pytest.raises(Exception):
                        await asyncio.wait_for(cli.connect(), 5)
                        await asyncio.wait_for(cli.unary("Info", b"{}", timeout=3), 5)
                    await cli.close()
            res = await bc.broadcast(CHANNEL, env().serialize(), retries=40)
            assert res["status"] == 200
            await chan.wait_height(2, timeout=90)
            bad = env(key=b"k2")
            bad.signature = bad.signature[:-3] + bytes(3)
            res = await bc.broadcast(CHANNEL, bad.serialize(), retries=3)
            assert res["status"] == 400 and "Writers" in res.get("info", "")
            rogue_org = pcg.generate_org("RogueMSP", "rogue.example.com", rng, users=1)
            rogue = pcg.signing_identity(rogue_org, "User1@rogue.example.com")
            res = await bc.broadcast(CHANNEL, env(key=b"k3", sign_with=rogue).serialize(),
                                     retries=3)
            assert res["status"] == 400
        finally:
            await bc.close()
            await peer.stop()
            await orderer.stop()

    run(scenario(), timeout=180)
