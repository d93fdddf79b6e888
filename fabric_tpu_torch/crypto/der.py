"""A minimal DER / X.509 reader and writer with PEM armour (counterpart:
what ``fabric_tpu/crypto/identity.py`` and ``msp.py`` take from
``cryptography``: ``load_pem_x509_certificate``, the certificate's
fields, the P-256 public key, and ``decode_dss_signature`` /
``encode_dss_signature``).

The reader is strict DER, as the ``asn1`` parser behind
``cryptography`` is: definite lengths in their shortest form, minimal
INTEGERs, BOOLEANs of 0x00 or 0xFF, BIT STRINGs with zero padding
bits, no trailing bytes, a DEFAULT value never written out.  It reads
a certificate's tbsCertificate bytes, version (v1 or v3), serial,
issuer and subject names, validity (UTCTime and GeneralizedTime
without fractions), SubjectPublicKeyInfo, the framing of its
extensions (their contents are not interpreted, as ``cryptography``
leaves them until asked), and the signature algorithm and value.  A
key that is not a valid P-256 point reads as "no EC key"
(``Certificate.public_key`` None), as ``public_numbers`` raising does
in the reference.  PEM: the first ``CERTIFICATE`` (or ``X509
CERTIFICATE``) section, base64 in its canonical form with whitespace
ignored; sections with headers are refused.
"""

from __future__ import annotations

import base64
import binascii
import calendar
import re
import time
from dataclasses import dataclass

from fabric_tpu_torch.crypto import ec_ref


class DERError(ValueError):
    """Bytes that are not the DER the reader expects."""


# OIDs (dotted)
OID_EC_PUBLIC_KEY = "1.2.840.10045.2.1"
OID_P256 = "1.2.840.10045.3.1.7"
OID_ECDSA_SHA256 = "1.2.840.10045.4.3.2"
OID_OU = "2.5.4.11"
OID_CN = "2.5.4.3"
OID_O = "2.5.4.10"
OID_C = "2.5.4.6"
OID_BASIC_CONSTRAINTS = "2.5.29.19"
OID_KEY_USAGE = "2.5.29.15"
OID_SUBJECT_ALT_NAME = "2.5.29.17"

# signature algorithm → (hash name, family)
SIG_ALGS = {
    "1.2.840.10045.4.1": ("sha1", "ecdsa"),
    "1.2.840.10045.4.3.1": ("sha224", "ecdsa"),
    OID_ECDSA_SHA256: ("sha256", "ecdsa"),
    "1.2.840.10045.4.3.3": ("sha384", "ecdsa"),
    "1.2.840.10045.4.3.4": ("sha512", "ecdsa"),
    "1.2.840.113549.1.1.5": ("sha1", "rsa"),
    "1.2.840.113549.1.1.14": ("sha224", "rsa"),
    "1.2.840.113549.1.1.11": ("sha256", "rsa"),
    "1.2.840.113549.1.1.12": ("sha384", "rsa"),
    "1.2.840.113549.1.1.13": ("sha512", "rsa"),
}

SEQUENCE, SET, INTEGER, BOOLEAN, BIT_STRING, OCTET_STRING, NULL, OID = (
    0x30, 0x31, 0x02, 0x01, 0x03, 0x04, 0x05, 0x06)
UTC_TIME, GENERALIZED_TIME = 0x17, 0x18
# the attribute value types ``cryptography``'s Names take, and their codecs
_NAME_TAGS = {BIT_STRING: None, OCTET_STRING: "utf-8", 0x0C: "utf-8", 0x12: "utf-8",
              0x13: "ascii", 0x14: "utf-8", 0x16: "utf-8", UTC_TIME: "utf-8",
              GENERALIZED_TIME: "utf-8", 0x1A: "utf-8", 0x1C: "utf-32-be", 0x1E: "utf-16-be"}
_PRINTABLE = re.compile(rb"[A-Za-z0-9 '()+,\-./:=?]*\Z")

# ---------------------------------------------------------------------------
# Reading


def read_tlv(buf: bytes, pos: int, end: int):
    """One TLV at ``pos`` → (tag, content start, content end)."""
    if end - pos < 2:
        raise DERError("truncated TLV")
    tag = buf[pos]
    if tag & 0x1F == 0x1F:
        raise DERError("high tag numbers are not read")
    ln = buf[pos + 1]
    pos += 2
    if ln & 0x80:
        k = ln & 0x7F
        if k == 0 or k > 4 or end - pos < k:
            raise DERError("bad length")
        ln = int.from_bytes(buf[pos:pos + k], "big")
        if ln < 0x80 or buf[pos] == 0:
            raise DERError("length not in its shortest form")
        pos += k
    if ln > end - pos:
        raise DERError("length past the end")
    return tag, pos, pos + ln


def _expect(buf, pos, end, tag):
    t, s, e = read_tlv(buf, pos, end)
    if t != tag:
        raise DERError(f"expected tag {tag:#x}, got {t:#x}")
    return s, e


def _children(buf, s, e):
    out = []
    while s < e:
        t, cs, ce = read_tlv(buf, s, e)
        out.append((t, cs, ce, s))
        s = ce
    return out


def _integer(raw: bytes, unsigned: bool = False) -> int:
    if not raw:
        raise DERError("empty INTEGER")
    if len(raw) > 1 and ((raw[0] == 0 and raw[1] < 0x80) or (raw[0] == 0xFF and raw[1] >= 0x80)):
        raise DERError("INTEGER not minimal")
    if unsigned and raw[0] >= 0x80:
        raise DERError("negative INTEGER")
    return int.from_bytes(raw, "big", signed=True)


def _oid(raw: bytes) -> str:
    if not raw or raw[-1] & 0x80:
        raise DERError("bad OID")
    arcs, v, first = [], 0, True
    for i, b in enumerate(raw):
        if v == 0 and b == 0x80:
            raise DERError("OID arc not minimal")
        v = (v << 7) | (b & 0x7F)
        if not b & 0x80:
            if first:
                a = min(v // 40, 2)
                arcs += [a, v - 40 * a]
                first = False
            else:
                arcs.append(v)
            v = 0
    return ".".join(map(str, arcs))


def _bits(raw: bytes) -> bytes:
    if not raw or raw[0] > 7 or (len(raw) == 1 and raw[0]):
        raise DERError("bad BIT STRING")
    if raw[0] and raw[-1] & ((1 << raw[0]) - 1):
        raise DERError("BIT STRING padding bits set")
    return raw[1:]


def _string(tag: int, raw: bytes, oid: str = ""):
    """An attribute value as ``cryptography`` reads it when it builds a
    Name: a BIT STRING (x500UniqueIdentifier only) as bytes; a PrintableString checked against its
    alphabet; BMPString and UniversalString as UTF-16/32; every other
    known type as strict UTF-8; an unknown type refused."""
    if tag not in _NAME_TAGS:
        raise DERError(f"attribute value of type {tag:#x}")
    if tag == BIT_STRING:
        if oid != "2.5.4.45":  # x500UniqueIdentifier, the one BIT STRING attribute
            raise DERError("BIT STRING value for another attribute")
        return raw
    if tag == 0x13 and not _PRINTABLE.match(raw):
        raise DERError("bad PrintableString")
    try:
        return raw.decode(_NAME_TAGS[tag])
    except UnicodeDecodeError as e:
        raise DERError("bad string") from e


def _time(tag: int, raw: bytes) -> int:
    """UTCTime / GeneralizedTime → seconds since the epoch."""
    try:
        txt = raw.decode("ascii")
    except UnicodeDecodeError as e:
        raise DERError("bad time") from e
    if tag == UTC_TIME:
        if not re.fullmatch(r"\d{12}Z", txt):
            raise DERError("bad UTCTime")
        yy = int(txt[:2])
        year, rest = (1900 + yy if yy >= 50 else 2000 + yy), txt[2:]
    elif tag == GENERALIZED_TIME:
        if not re.fullmatch(r"\d{14}Z", txt):
            raise DERError("bad GeneralizedTime")
        year, rest = int(txt[:4]), txt[4:]
    else:
        raise DERError("expected a time")
    mo, d, h, mi, s = (int(rest[i:i + 2]) for i in range(0, 10, 2))
    if not (1 <= mo <= 12 and 1 <= d <= 31 and h < 24 and mi < 60 and s < 60):
        raise DERError("time out of range")
    if d > calendar.monthrange(year, mo)[1]:
        raise DERError("day out of range")
    return calendar.timegm((year, mo, d, h, mi, s, 0, 0, 0))


Name = tuple  # of frozensets of (oid, value): equal as cryptography's Names are


def _name(buf, s, e) -> Name:
    rdns = []
    for t, cs, ce, _ in _children(buf, s, e):
        if t != SET:
            raise DERError("RDN is not a SET")
        attrs = []
        for t2, as_, ae, _ in _children(buf, cs, ce):
            if t2 != SEQUENCE:
                raise DERError("attribute is not a SEQUENCE")
            parts = _children(buf, as_, ae)
            if len(parts) != 2 or parts[0][0] != OID:
                raise DERError("bad attribute")
            oid = _oid(buf[parts[0][1]:parts[0][2]])
            attrs.append((oid, _string(parts[1][0], buf[parts[1][1]:parts[1][2]], oid)))
        if not attrs:
            raise DERError("empty RDN")
        rdns.append(frozenset(attrs))
    return tuple(rdns)


def _alg(buf, s, e):
    """AlgorithmIdentifier → (oid, parameter TLV bytes or None)."""
    parts = _children(buf, s, e)
    if not 1 <= len(parts) <= 2 or parts[0][0] != OID:
        raise DERError("bad AlgorithmIdentifier")
    oid = _oid(buf[parts[0][1]:parts[0][2]])
    params = buf[parts[1][3]:parts[1][2]] if len(parts) == 2 else None
    return oid, params


def _decode_point(raw: bytes):
    """An uncompressed or compressed P-256 point → (x, y), None if it is
    not a point of the curve."""
    P = ec_ref.P
    if len(raw) == 65 and raw[0] == 4:
        x, y = int.from_bytes(raw[1:33], "big"), int.from_bytes(raw[33:], "big")
    elif len(raw) == 33 and raw[0] in (2, 3):
        x = int.from_bytes(raw[1:], "big")
        if x >= P:
            return None
        rhs = (x * x * x + ec_ref.A * x + ec_ref.B) % P
        y = pow(rhs, (P + 1) // 4, P)
        if y * y % P != rhs:
            return None
        if (y & 1) != (raw[0] & 1):
            y = P - y
    else:
        return None
    if not (x < P and y < P) or not ec_ref.is_on_curve((x, y)):
        return None
    return x, y


@dataclass
class Certificate:
    tbs: bytes                 # the tbsCertificate TLV, the signed bytes
    version: int               # 0 (v1) or 2 (v3)
    serial: int
    issuer: Name
    subject: Name
    not_before: int            # seconds since the epoch
    not_after: int
    key_alg: str               # SubjectPublicKeyInfo algorithm OID
    key_params: bytes | None
    key_bits: bytes
    sig_alg: str
    signature: bytes

    @property
    def on_p256(self) -> bool:
        """An EC key on the named curve P-256."""
        return self.key_alg == OID_EC_PUBLIC_KEY and self.key_params == _oid_tlv(OID_P256)

    @property
    def public_key(self):
        """(x, y) of a P-256 key, None for any other key."""
        return _decode_point(self.key_bits) if self.on_p256 else None

    def ous(self) -> tuple:
        """The subject's organizational-unit values, in order."""
        return tuple(v for rdn in self.subject for oid, v in sorted(rdn, key=repr)
                     if oid == OID_OU)


def parse_certificate(der: bytes) -> Certificate:
    der = bytes(der)
    s, e = _expect(der, 0, len(der), SEQUENCE)
    if e != len(der):
        raise DERError("trailing bytes after the certificate")
    top = _children(der, s, e)
    if len(top) != 3 or top[0][0] != SEQUENCE or top[1][0] != SEQUENCE \
            or top[2][0] != BIT_STRING:
        raise DERError("bad Certificate")
    tbs_tlv = der[top[0][3]:top[0][2]]
    sig_alg, _ = _alg(der, top[1][1], top[1][2])
    signature = _bits(der[top[2][1]:top[2][2]])
    f = _children(der, top[0][1], top[0][2])
    i, version = 0, 0
    if f and f[0][0] == 0xA0:
        (t, vs, ve, _), = _children(der, f[0][1], f[0][2]) or [(None, 0, 0, 0)]
        if t != INTEGER:
            raise DERError("bad version")
        version = _integer(der[vs:ve])
        if version != 2:  # v1 written out is a DEFAULT violation; v2 is refused
            raise DERError(f"certificate version {version}")
        i = 1
    need = [INTEGER, SEQUENCE, SEQUENCE, SEQUENCE, SEQUENCE, SEQUENCE]
    if len(f) < i + 6 or [x[0] for x in f[i:i + 6]] != need:
        raise DERError("bad tbsCertificate")
    serial = _integer(der[f[i][1]:f[i][2]])
    _alg(der, f[i + 1][1], f[i + 1][2])
    issuer = _name(der, f[i + 2][1], f[i + 2][2])
    validity = _children(der, f[i + 3][1], f[i + 3][2])
    if len(validity) != 2:
        raise DERError("bad Validity")
    nb, na = (_time(t, der[a:b]) for t, a, b, _ in validity)
    subject = _name(der, f[i + 4][1], f[i + 4][2])
    spki = _children(der, f[i + 5][1], f[i + 5][2])
    if len(spki) != 2 or spki[0][0] != SEQUENCE or spki[1][0] != BIT_STRING:
        raise DERError("bad SubjectPublicKeyInfo")
    key_alg, key_params = _alg(der, spki[0][1], spki[0][2])
    if key_alg == OID_EC_PUBLIC_KEY:  # EcParameters: a named curve, NULL or a SEQUENCE
        t, ps, pe = read_tlv(key_params or b"", 0, len(key_params or b""))
        if t == OID:
            _oid(key_params[ps:pe])
        elif not (t == SEQUENCE or (t == NULL and ps == pe)):
            raise DERError("bad EC parameters")
    key_bits = _bits(der[spki[1][1]:spki[1][2]])
    rest = f[i + 6:]
    for want in (0x81, 0x82):  # issuer / subject unique ids
        if rest and rest[0][0] == want:
            _bits(der[rest[0][1]:rest[0][2]])
            rest = rest[1:]
    if rest and rest[0][0] == 0xA3:  # framing checked, contents left alone
        (t, xs, xe, _), = _children(der, rest[0][1], rest[0][2]) or [(None, 0, 0, 0)]
        if t != SEQUENCE:
            raise DERError("bad Extensions")
        for t, cs, ce, _ in _children(der, xs, xe):
            parts = _children(der, cs, ce)
            if t != SEQUENCE or not 2 <= len(parts) <= 3 or parts[0][0] != OID \
                    or parts[-1][0] != OCTET_STRING:
                raise DERError("bad Extension")
            if len(parts) == 3 and (parts[1][0] != BOOLEAN
                                    or der[parts[1][1]:parts[1][2]] != b"\xff"):
                raise DERError("bad Extension critical flag")  # FALSE is the DEFAULT
            _oid(der[parts[0][1]:parts[0][2]])
        rest = rest[1:]
    if rest:
        raise DERError("trailing tbsCertificate fields")
    return Certificate(tbs=tbs_tlv, version=version, serial=serial, issuer=issuer,
                       subject=subject, not_before=nb, not_after=na, key_alg=key_alg,
                       key_params=key_params, key_bits=key_bits, sig_alg=sig_alg,
                       signature=signature)


# ECDSA-Sig-Value: the reference's ``decode_dss_signature`` semantics
decode_dss_signature = ec_ref.der_decode_sig


# ---------------------------------------------------------------------------
# Writing


def _len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def tlv(tag: int, content: bytes) -> bytes:
    return bytes([tag]) + _len(len(content)) + content


def der_integer(v: int) -> bytes:
    n = max(1, (v.bit_length() + 8) // 8) if v >= 0 else max(1, ((-v - 1).bit_length() + 8) // 8)
    return tlv(INTEGER, int(v).to_bytes(n, "big", signed=True))


def _oid_tlv(dotted: str) -> bytes:
    arcs = [int(a) for a in dotted.split(".")]
    body = bytearray()
    for v in [40 * arcs[0] + arcs[1], *arcs[2:]]:
        chunk = [v & 0x7F]
        v >>= 7
        while v:
            chunk.append(0x80 | (v & 0x7F))
            v >>= 7
        body += bytes(reversed(chunk))
    return tlv(OID, bytes(body))


def encode_dss_signature(r: int, s: int) -> bytes:
    return tlv(SEQUENCE, der_integer(r) + der_integer(s))


def encode_name(attrs) -> bytes:
    """[(oid, value)] → a Name of one attribute per RDN; the country is
    a PrintableString, every other value a UTF8String (as
    ``cryptography`` writes them)."""
    rdns = b""
    for oid, value in attrs:
        tag = 0x13 if oid == OID_C else 0x0C
        rdns += tlv(SET, tlv(SEQUENCE, _oid_tlv(oid) + tlv(tag, value.encode("utf-8"))))
    return tlv(SEQUENCE, rdns)


def encode_time(t: int) -> bytes:
    """UTCTime through 2049, GeneralizedTime after (RFC 5280)."""
    g = time.gmtime(t)
    if 1950 <= g.tm_year < 2050:
        return tlv(UTC_TIME, time.strftime("%y%m%d%H%M%SZ", g).encode())
    return tlv(GENERALIZED_TIME, time.strftime("%Y%m%d%H%M%SZ", g).encode())


def encode_tbs(serial: int, issuer: bytes, subject: bytes, not_before: int, not_after: int,
               public_key, extensions=()) -> bytes:
    """A v3 tbsCertificate signed with ecdsa-with-SHA256 over a P-256
    key ``(x, y)``.  ``issuer``/``subject``: encoded Names;
    ``extensions``: [(oid, critical, value bytes)]."""
    x, y = public_key
    alg = tlv(SEQUENCE, _oid_tlv(OID_ECDSA_SHA256))
    spki = tlv(SEQUENCE, tlv(SEQUENCE, _oid_tlv(OID_EC_PUBLIC_KEY) + _oid_tlv(OID_P256))
               + tlv(BIT_STRING, b"\x00\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")))
    body = (tlv(0xA0, der_integer(2)) + der_integer(serial) + alg + issuer
            + tlv(SEQUENCE, encode_time(not_before) + encode_time(not_after)) + subject + spki)
    if extensions:
        exts = b"".join(tlv(SEQUENCE, _oid_tlv(oid) + (tlv(BOOLEAN, b"\xff") if crit else b"")
                            + tlv(OCTET_STRING, val)) for oid, crit, val in extensions)
        body += tlv(0xA3, tlv(SEQUENCE, exts))
    return tlv(SEQUENCE, body)


def encode_certificate(tbs: bytes, r: int, s: int) -> bytes:
    """tbsCertificate + its ECDSA-SHA256 signature (r, s) → DER."""
    alg = tlv(SEQUENCE, _oid_tlv(OID_ECDSA_SHA256))
    return tlv(SEQUENCE, tbs + alg + tlv(BIT_STRING, b"\x00" + encode_dss_signature(r, s)))


def basic_constraints(ca: bool, path_length: int | None = None) -> bytes:
    body = (tlv(BOOLEAN, b"\xff") if ca else b"") + (
        der_integer(path_length) if path_length is not None else b"")
    return tlv(SEQUENCE, body)


def key_usage(digital_signature=True, key_cert_sign=False, crl_sign=False) -> bytes:
    bits = (digital_signature << 7) | (key_cert_sign << 2) | (crl_sign << 1)
    unused = (bits & -bits).bit_length() - 1 if bits else 0
    return tlv(BIT_STRING, bytes([unused, bits]))


def subject_alt_name(names) -> bytes:
    """A subjectAltName value: each name an IP address (``[7]``, its 4
    or 16 octets) when it parses as one, else a DNS name (``[2]``
    IA5String), in the given order, as ``cryptography``'s
    ``SubjectAlternativeName`` of ``IPAddress`` / ``DNSName`` writes it."""
    import ipaddress

    body = b""
    for name in names:
        try:
            body += tlv(0x87, ipaddress.ip_address(name).packed)
        except ValueError:
            body += tlv(0x82, name.encode("ascii"))
    return tlv(SEQUENCE, body)


# ---------------------------------------------------------------------------
# P-256 private keys: PKCS#8 PrivateKeyInfo (what ``cryptography``'s
# ``PrivateFormat.PKCS8`` writes) and SEC1 ECPrivateKey


def _ec_private_key(d: int, with_params: bool) -> bytes:
    x, y = ec_ref.pt_mul(d, ec_ref.G)
    params = tlv(0xA0, _oid_tlv(OID_P256)) if with_params else b""
    return tlv(SEQUENCE, der_integer(1) + tlv(OCTET_STRING, d.to_bytes(32, "big")) + params
               + tlv(0xA1, tlv(BIT_STRING, b"\x00\x04" + x.to_bytes(32, "big")
                               + y.to_bytes(32, "big"))))


def encode_pkcs8_key(d: int) -> bytes:
    """A P-256 scalar → PrivateKeyInfo DER: version 0, the
    id-ecPublicKey / prime256v1 AlgorithmIdentifier, and an
    ECPrivateKey (version 1, the 32-byte scalar, the public point)
    whose curve the AlgorithmIdentifier names."""
    alg = tlv(SEQUENCE, _oid_tlv(OID_EC_PUBLIC_KEY) + _oid_tlv(OID_P256))
    return tlv(SEQUENCE, der_integer(0) + alg + tlv(OCTET_STRING, _ec_private_key(d, False)))


def _read_ec_private_key(der: bytes, s: int, e: int, curve_known: bool) -> int:
    parts = _children(der, s, e)
    if len(parts) < 2 or parts[0][0] != INTEGER or parts[1][0] != OCTET_STRING \
            or _integer(der[parts[0][1]:parts[0][2]]) != 1:
        raise DERError("bad ECPrivateKey")
    raw = der[parts[1][1]:parts[1][2]]
    d = int.from_bytes(raw, "big")
    for t, cs, ce, _ in parts[2:]:
        if t == 0xA0:
            if der[cs:ce] != _oid_tlv(OID_P256):
                raise DERError("EC private key on another curve than P-256")
            curve_known = True
        elif t != 0xA1:
            raise DERError("bad ECPrivateKey field")
    if not curve_known:
        raise DERError("EC private key without its curve")
    if not 0 < d < ec_ref.N:
        raise DERError("EC private scalar out of range")
    return d


def decode_private_key(der: bytes) -> int:
    """PrivateKeyInfo (PKCS#8) or SEC1 ECPrivateKey DER → the P-256
    scalar; any other key or curve raises ``DERError``."""
    der = bytes(der)
    s, e = _expect(der, 0, len(der), SEQUENCE)
    if e != len(der):
        raise DERError("trailing bytes after the key")
    parts = _children(der, s, e)
    if len(parts) >= 3 and parts[1][0] == SEQUENCE:  # PKCS#8
        if _integer(der[parts[0][1]:parts[0][2]]) != 0 or parts[2][0] != OCTET_STRING:
            raise DERError("bad PrivateKeyInfo")
        oid, params = _alg(der, parts[1][1], parts[1][2])
        if oid != OID_EC_PUBLIC_KEY or params != _oid_tlv(OID_P256):
            raise DERError("not a P-256 EC key")
        ks, ke = _expect(der, parts[2][1], parts[2][2], SEQUENCE)
        return _read_ec_private_key(der, ks, ke, True)
    return _read_ec_private_key(der, s, e, False)


# ---------------------------------------------------------------------------
# PEM


_PEM = re.compile(rb"-----BEGIN ([^\r\n-]*)-----(.*?)-----END ([^\r\n-]*)-----", re.S)


def pem_encode(der: bytes, label: bytes = b"CERTIFICATE") -> bytes:
    """DER as PEM under ``label``, 64 base64 characters a line."""
    b64 = base64.b64encode(der)
    lines = b"\n".join(b64[i:i + 64] for i in range(0, len(b64), 64))
    return b"-----BEGIN %s-----\n%s\n-----END %s-----\n" % (label, lines, label)


def pem_private_key(d: int) -> bytes:
    """A P-256 scalar as a ``PRIVATE KEY`` (PKCS#8) PEM."""
    return pem_encode(encode_pkcs8_key(d), b"PRIVATE KEY")


def read_pem_private_key(data: bytes) -> int:
    """The P-256 scalar of the first ``PRIVATE KEY`` (PKCS#8) or ``EC
    PRIVATE KEY`` (SEC1) section of a PEM document."""
    return decode_private_key(pem_section(data, (b"PRIVATE KEY", b"EC PRIVATE KEY")))


def pem_certificate(data: bytes) -> bytes:
    """The DER of the first CERTIFICATE section of a PEM document."""
    return pem_section(data, (b"CERTIFICATE", b"X509 CERTIFICATE"))


def pem_section(data: bytes, labels) -> bytes:
    """The DER of the first section labelled one of ``labels``."""
    found = None
    sections = list(_PEM.finditer(bytes(data)))
    if not sections:
        raise DERError("no PEM section")
    for sec in sections:
        if sec.group(1) != sec.group(3):
            raise DERError("mismatched PEM labels")
        body = re.sub(rb"\s+", b"", sec.group(2))
        try:
            raw = binascii.a2b_base64(body, strict_mode=True)
        except binascii.Error as e:
            raise DERError("bad base64") from e
        if base64.b64encode(raw) != body:
            raise DERError("base64 not in its canonical form")
        if found is None and sec.group(1) in labels:
            found = raw
    if found is None:
        raise DERError(f"no {labels[0].decode()} section")
    return found
