"""The port's MSP, X.509 reader and DER signature codec against the
reference's (``fabric_tpu/crypto/msp.py`` over ``cryptography``) on
the CPU: certificates made by the reference's cryptogen and by
``cryptography`` directly — valid peer, client and admin identities, an
unknown CA, expired and not-yet-valid certificates, two role OUs and
none, a revoked serial, intermediate chains, an unknown MSP id, the
admin list without NodeOUs — must give the same (MSP id, role, key,
validity).  A certificate signature with a high S (CAs do not
normalize s) must be accepted; an RSA issuer raises in the port.
``decode_dss_signature`` semantics hold on a corpus of malformed
encodings, the certificate parser agrees with ``cryptography`` on
mutated certificates, and certificates the port's cryptogen makes load
in ``cryptography`` and pass the reference MSP."""

import datetime
import hashlib
import random
import warnings

import numpy as np
import pytest
from cryptography import x509
from cryptography.exceptions import UnsupportedAlgorithm
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec, rsa
from cryptography.hazmat.primitives.asymmetric.utils import (
    decode_dss_signature,
    encode_dss_signature,
)
from cryptography.x509.oid import NameOID

from fabric_tpu.crypto import cryptogen as jcryptogen
from fabric_tpu.crypto.msp import MSP as JMSP
from fabric_tpu.crypto.msp import MSPManager as JMSPManager
from fabric_tpu.protos import common_pb2
from fabric_tpu_torch.crypto import cryptogen as pcryptogen
from fabric_tpu_torch.crypto import der, ec_ref
from fabric_tpu_torch.crypto import msp as pmsp

NOW = datetime.datetime.now(datetime.timezone.utc)
DAY = datetime.timedelta(days=1)


def _pem(cert) -> bytes:
    return cert.public_bytes(serialization.Encoding.PEM)


def _name(cn, ous=(), org="org1.msp.example.com"):
    attrs = [x509.NameAttribute(NameOID.COUNTRY_NAME, "US"),
             x509.NameAttribute(NameOID.ORGANIZATION_NAME, org)]
    attrs += [x509.NameAttribute(NameOID.ORGANIZATIONAL_UNIT_NAME, ou) for ou in ous]
    attrs.append(x509.NameAttribute(NameOID.COMMON_NAME, cn))
    return x509.Name(attrs)


def _cert(cn, ous, issuer, key=None, nb=-DAY, na=3650 * DAY, serial=None, ca=False):
    """(key, certificate) issued by ``issuer`` = (name, key), or
    self-signed when ``issuer`` is None."""
    key = key or ec.generate_private_key(ec.SECP256R1())
    name = _name(cn, ous)
    iname, ikey = issuer if issuer is not None else (name, key)
    b = (x509.CertificateBuilder().subject_name(name).issuer_name(iname)
         .public_key(key.public_key())
         .serial_number(serial or x509.random_serial_number())
         .not_valid_before(NOW + nb).not_valid_after(NOW + na)
         .add_extension(x509.BasicConstraints(ca=ca, path_length=None), critical=True))
    return key, b.sign(ikey, hashes.SHA256())


def _sid(msp_id, cert) -> bytes:
    return common_pb2.SerializedIdentity(mspid=msp_id, id_bytes=_pem(cert)).SerializeToString()


@pytest.fixture(scope="module")
def ca():
    return _cert("ca.org1", (), None, ca=True)


def _both(msps_cfg, serialized):
    """(reference, port) identity tuples for one serialized identity
    under MSPs made from the same configuration."""
    jm = JMSPManager({mid: JMSP(mid, **cfg) for mid, cfg in msps_cfg.items()})
    pm = pmsp.MSPManager({mid: pmsp.MSP(mid, **cfg) for mid, cfg in msps_cfg.items()})
    j = jm.deserialize_identity(serialized)
    try:
        jkey = j.public_numbers
    except ValueError:
        jkey = None
    p = pm.deserialize_identity(serialized)
    pkey = (p.qx, p.qy) if p.has_ec_key else None
    return (j.msp_id, j.role, bool(j.is_valid), jkey), (p.msp_id, p.role, p.is_valid, pkey)


def _cases(ca):
    ca_key, ca_cert = ca
    issuer = (ca_cert.subject, ca_key)
    root = {"root_certs": [_pem(ca_cert)]}
    _, other_ca = _cert("ca.other", (), None, ca=True)
    other_key = ec.generate_private_key(ec.SECP256R1())
    mid_key, mid = _cert("ica.org1", (), issuer, ca=True)
    stale_mid_key, stale_mid = _cert("ica2.org1", (), issuer, ca=True, na=-DAY / 2)
    _, revoked = _cert("peer9", ("peer",), issuer, serial=4242)
    _, admin_cert = _cert("admin0", ("admin",), issuer)
    _, plain_admin = _cert("boss", (), issuer)
    return {
        "peer": (root, _cert("peer0", ("peer",), issuer)[1]),
        "client": (root, _cert("user1", ("client",), issuer)[1]),
        "admin_ou": (root, admin_cert),
        "admin_list_with_node_ous": ({**root, "admins": [_pem(admin_cert)]}, admin_cert),
        "admin_list_without_node_ous": (
            {**root, "admins": [_pem(plain_admin)], "node_ous": False}, plain_admin),
        "no_node_ous_client": ({**root, "node_ous": False}, _cert("u", (), issuer)[1]),
        "unknown_ca": (root, _cert("peer0", ("peer",), (other_ca.subject, other_key))[1]),
        "expired": (root, _cert("peer0", ("peer",), issuer, nb=-10 * DAY, na=-DAY)[1]),
        "not_yet_valid": (root, _cert("peer0", ("peer",), issuer, nb=DAY, na=10 * DAY)[1]),
        "two_role_ous": (root, _cert("peer0", ("peer", "client"), issuer)[1]),
        "same_role_ou_twice": (root, _cert("peer0", ("peer", "peer"), issuer)[1]),
        "no_role_ou": (root, _cert("peer0", ("dept7",), issuer)[1]),
        "role_and_other_ou": (root, _cert("peer0", ("dept7", "peer"), issuer)[1]),
        "revoked": ({**root, "revoked_serials": {4242}}, revoked),
        "intermediate": ({**root, "intermediate_certs": [_pem(mid)]},
                         _cert("peer0", ("peer",), (mid.subject, mid_key))[1]),
        "intermediate_not_configured": (
            root, _cert("peer0", ("peer",), (mid.subject, mid_key))[1]),
        "expired_intermediate": ({**root, "intermediate_certs": [_pem(stale_mid)]},
                                 _cert("peer0", ("peer",), (stale_mid.subject,
                                                            stale_mid_key))[1]),
        "revoked_intermediate": (
            {**root, "intermediate_certs": [_pem(mid)], "revoked_serials": {mid.serial_number}},
            _cert("peer0", ("peer",), (mid.subject, mid_key))[1]),
        "ca_itself": (root, ca_cert),
    }


CASES = ("peer", "client", "admin_ou", "admin_list_with_node_ous",
         "admin_list_without_node_ous", "no_node_ous_client", "unknown_ca", "expired",
         "not_yet_valid", "two_role_ous", "same_role_ou_twice", "no_role_ou",
         "role_and_other_ou", "revoked", "intermediate", "intermediate_not_configured",
         "expired_intermediate", "revoked_intermediate", "ca_itself")
VALID = {"peer", "client", "admin_ou", "admin_list_with_node_ous",
         "admin_list_without_node_ous", "no_node_ous_client", "role_and_other_ou",
         "intermediate"}


@pytest.fixture(scope="module")
def cases(ca):
    return _cases(ca)


@pytest.mark.parametrize("name", CASES)
def test_msp_matches_reference(cases, name):
    cfg, cert = cases[name]
    ref, port = _both({"Org1MSP": cfg}, _sid("Org1MSP", cert))
    assert port == ref
    assert port[2] == (name in VALID)


def test_unknown_msp_and_undecodable_identities(cases):
    cfg, cert = cases["peer"]
    ref, port = _both({"Org1MSP": cfg}, _sid("Org9MSP", cert))
    assert port == ref and port[1:3] == ("client", False)
    pm = pmsp.MSPManager({"Org1MSP": pmsp.MSP("Org1MSP", **cfg)})
    jm = JMSPManager({"Org1MSP": JMSP("Org1MSP", **cfg)})
    for bad in (b"\x0a\x07Org1MSP\x12\x05junk!",
                common_pb2.SerializedIdentity(mspid="Org1MSP", id_bytes=_pem(cert)[:-40])
                .SerializeToString(), b"\xff\xff"):
        with pytest.raises(Exception):
            jm.deserialize_identity(bad)
        with pytest.raises(ValueError):
            pm.deserialize_identity(bad)


def test_high_s_certificate_signature_is_accepted(ca):
    """OpenSSL leaves half of its ECDSA signatures high-S; the chain
    check must not apply Fabric's low-S rule to them."""
    ca_key, ca_cert = ca
    for _ in range(64):
        _, cert = _cert("peer0", ("peer",), (ca_cert.subject, ca_key))
        r, s = decode_dss_signature(cert.signature)
        if s > ec_ref.HALF_N:
            break
    else:
        pytest.fail("no high-S certificate signature in 64 tries")
    ref, port = _both({"Org1MSP": {"root_certs": [_pem(ca_cert)]}}, _sid("Org1MSP", cert))
    assert port == ref and port[2] is True
    pub = ca_key.public_key().public_numbers()
    e = int.from_bytes(hashlib.sha256(cert.tbs_certificate_bytes).digest(), "big")
    assert ec_ref.verify_digest((pub.x, pub.y), e, r, s, low_s=False)
    assert not ec_ref.verify_digest((pub.x, pub.y), e, r, s)


def test_rsa_issuer_raises():
    rsa_key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = _name("rsa-ca")
    root = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
            .public_key(rsa_key.public_key()).serial_number(1)
            .not_valid_before(NOW - DAY).not_valid_after(NOW + DAY)
            .sign(rsa_key, hashes.SHA256()))
    _, leaf = _cert("peer0", ("peer",), (root.subject, rsa_key))
    jm = JMSPManager({"Org1MSP": JMSP("Org1MSP", [_pem(root)])})
    assert jm.deserialize_identity(_sid("Org1MSP", leaf)).is_valid
    pm = pmsp.MSPManager({"Org1MSP": pmsp.MSP("Org1MSP", [_pem(root)])})
    with pytest.raises(NotImplementedError, match="RSA"):
        pm.deserialize_identity(_sid("Org1MSP", leaf))


def test_non_ec_leaf_has_no_ec_key(ca):
    """An RSA leaf under the EC CA: valid in both, no EC key in either
    (the reference's ``public_numbers`` raises)."""
    ca_key, ca_cert = ca
    _, leaf = _cert("peer0", ("peer",), (ca_cert.subject, ca_key),
                    key=rsa.generate_private_key(public_exponent=65537, key_size=2048))
    ref, port = _both({"Org1MSP": {"root_certs": [_pem(ca_cert)]}}, _sid("Org1MSP", leaf))
    assert port == ref and port[2] is True and port[3] is None


def _dss_corpus():
    rng = random.Random(11)
    base = [encode_dss_signature(rng.getrandbits(256), rng.getrandbits(256)) for _ in range(8)]
    base += [encode_dss_signature(0, 1), encode_dss_signature(1, 1 << 300),
             encode_dss_signature(127, 128)]
    corpus = list(base)
    corpus += [
        b"\x30\x81\x06\x02\x01\x01\x02\x01\x01",           # long-form length below 128
        b"\x30\x06\x02\x02\x00\x01\x02\x01\x01",           # non-minimal integer
        b"\x30\x06\x02\x01\x81\x02\x01\x01",               # negative r
        b"\x30\x06\x02\x01\x01\x02\x01\xff",               # negative s
        b"\x30\x06\x02\x01\x00\x02\x01\x00",               # zero r and s
        b"\x30\x06\x02\x01\x01\x02\x01\x01\x00",           # trailing byte
        b"\x31\x06\x02\x01\x01\x02\x01\x01",               # wrong outer tag
        b"\x30\x07\x02\x01\x01\x02\x01\x01\x02",           # third element
        b"\x30\x05\x02\x00\x02\x01\x01",                   # empty integer
        b"\x30\x82\x00\x06\x02\x01\x01\x02\x01\x01",       # leading zero length byte
        b"\x30\x80\x02\x01\x01\x02\x01\x01\x00\x00",       # indefinite length
        b"", b"\x30", b"\x30\x00",
    ]
    for _ in range(3000):
        b = bytearray(rng.choice(base))
        op = rng.randrange(4)
        if op == 0:
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        elif op == 1:
            b = b[:rng.randrange(len(b) + 1)]
        elif op == 2:
            b.insert(rng.randrange(len(b) + 1), rng.choice([0, 0x80, 0xFF, 0x81, 0x02, 0x30]))
        else:
            b[rng.randrange(len(b))] = rng.choice([0, 0x80, 0x81, 0x82, 0xFF, 0x02, 0x30, 0x7F])
        corpus.append(bytes(b))
    return corpus


def test_dss_signature_codec_matches_cryptography():
    accepted = 0
    for sig in _dss_corpus():
        try:
            want = decode_dss_signature(sig)
        except ValueError:
            want = None
        try:
            got = ec_ref.der_decode_sig(sig)
        except ValueError:
            got = None
        assert got == want, sig.hex()
        accepted += want is not None
        if want is not None and 0 < want[0] < ec_ref.N and 0 < want[1] < ec_ref.N:
            assert ec_ref.der_encode_sig(*want) == encode_dss_signature(*want)
    assert 100 < accepted
    assert der.decode_dss_signature is ec_ref.der_decode_sig


def test_certificate_parser_matches_cryptography():
    """Mutated DER certificates: the port parses exactly those
    ``cryptography`` loads (with its issuer and subject readable), to the
    same serial, validity, signed bytes, key and OUs."""
    org = jcryptogen.generate_org("Org1MSP", "org1.parse.example.com", peers=1)
    raw = org.nodes["peer0.org1.parse.example.com"].cert.public_bytes(
        serialization.Encoding.DER)
    rng = random.Random(12)
    accepted = 0
    for _ in range(1500):
        b = bytearray(raw)
        for _ in range(rng.randrange(1, 3)):
            op = rng.randrange(3)
            if op == 0:
                b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
            elif op == 1:
                b[rng.randrange(len(b))] = rng.choice(
                    [0, 0x80, 0x81, 0xFF, 0x30, 0x31, 0x02, 0x13, 0x0C, 0x17, 0x18])
            else:
                del b[rng.randrange(len(b))]
        b = bytes(b)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # negative serials: a deprecation warning
                c = x509.load_der_x509_certificate(b)
                c.issuer.rfc4514_string()
                ous = tuple(a.value for a in c.subject.get_attributes_for_oid(
                    NameOID.ORGANIZATIONAL_UNIT_NAME))
                try:
                    pn = c.public_key().public_numbers()
                    key = (pn.x, pn.y)
                except (ValueError, UnsupportedAlgorithm):  # the reference's "no EC key"
                    key = None
                want = (c.serial_number, c.not_valid_before_utc.timestamp(),
                        c.not_valid_after_utc.timestamp(), c.tbs_certificate_bytes, key, ous)
        except Exception:  # noqa: BLE001 — the reference rejects on any load failure
            want = None
        try:
            p = der.parse_certificate(b)
            got = (p.serial, p.not_before, p.not_after, p.tbs, p.public_key, p.ous())
        except ValueError:
            got = None
        assert got == want, b.hex()
        accepted += want is not None
    assert accepted > 100


def test_port_certificates_load_and_pass_the_reference_msp():
    org = pcryptogen.generate_org("Org1MSP", "org1.port.example.com",
                                  np.random.default_rng(5), peers=2, users=2)
    cfg = {"root_certs": [org.ca.cert_pem]}
    ca = x509.load_pem_x509_certificate(org.ca.cert_pem)
    assert ca.extensions.get_extension_for_class(x509.BasicConstraints).value.ca
    roles = {}
    for name, si in {**org.nodes, **org.users}.items():
        cert = x509.load_pem_x509_certificate(si.cert_pem)
        assert cert.issuer == ca.subject
        pub = cert.public_key().public_numbers()
        assert (pub.x, pub.y) == si.public
        ref, port = _both({"Org1MSP": cfg}, si.serialized)
        assert port == ref and port[2] is True
        roles[name] = port[1]
    assert sorted(roles.values()) == ["admin", "client", "client", "peer", "peer"]
    again = pcryptogen.generate_org("Org1MSP", "org1.port.example.com",
                                    np.random.default_rng(5), peers=2, users=2,
                                    now=org.ca.now)
    assert again.ca.cert_pem == org.ca.cert_pem
    expired_d, expired = org.ca.issue("late", "peer", not_before=org.ca.now - 20 * 86400,
                                      not_after=org.ca.now - 86400)
    ref, port = _both({"Org1MSP": cfg}, pcryptogen.SigningIdentity(
        "Org1MSP", expired_d, expired).serialized)
    assert port == ref and port[2] is False
