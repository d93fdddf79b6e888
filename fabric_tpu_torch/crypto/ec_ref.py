"""Pure-Python NIST P-256 reference (counterpart:
``fabric_tpu/crypto/ec_ref.py``, a copy trimmed to verification,
deterministic signing and the DER signature codec).

The oracle the port's verify kernel and its plain version are held
against, and the deterministic (RFC 6979) signer that the sign lane
(``ops/p256sign.py``) is held bit-equal to and ``chip_smoke.py`` uses
to make its signatures.  ``wrapped_x_signature`` is the port's own
addition: a test vector for the one verify branch random signatures
never reach.  ECDSA P-256 over SHA-256 digests with the
low-S rule of the reference's SW BCCSP (bccsp/sw/ecdsa.go:41-58).

Python ints only; NOT constant-time; verify-only paths don't need to be.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

# NIST P-256 (secp256r1) domain parameters.
P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
A = P - 3
B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5
HALF_N = N >> 1

INF = None  # point at infinity


def is_on_curve(pt) -> bool:
    if pt is INF:
        return True
    x, y = pt
    return (y * y - (x * x * x + A * x + B)) % P == 0


def pt_add(p1, p2):
    if p1 is INF:
        return p2
    if p2 is INF:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return INF
        return pt_double(p1)
    lam = ((y2 - y1) * pow(x2 - x1, -1, P)) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def pt_double(pt):
    if pt is INF:
        return INF
    x, y = pt
    if y == 0:
        return INF
    lam = ((3 * x * x + A) * pow(2 * y, -1, P)) % P
    x3 = (lam * lam - 2 * x) % P
    y3 = (lam * (x - x3) - y) % P
    return (x3, y3)


def pt_mul(k: int, pt):
    k %= N
    acc = INF
    addend = pt
    while k:
        if k & 1:
            acc = pt_add(acc, addend)
        addend = pt_double(addend)
        k >>= 1
    return acc


G = (GX, GY)


# ---------------------------------------------------------------------------
# RFC 6979 deterministic nonce derivation (HMAC-SHA256, qlen = 256).
#
# k is derived from (d, e) with the HMAC_DRBG construction of RFC 6979
# §3.2, so a signature is a pure function of (key, digest): a seeded
# run reproduces its signatures.

_QLEN_BYTES = 32  # qlen = 256 bits; SHA-256 ⇒ holen = 32 too


def rfc6979_candidates(d: int, e: int):
    """Successive RFC 6979 §3.2 nonce candidates for P-256/SHA-256.

    ``d``: private scalar in [1, n−1].  ``e``: the message digest as a
    256-bit integer (``digest_int``) — re-serialized to the 32 bytes
    H(m) so the derivation matches the RFC byte for byte.  With
    qlen == hlen == 256, bits2int is the identity and bits2octets is
    one reduction mod n.  Yields k values in [1, n−1]; the caller
    advances past a candidate only when it degenerates (r or s zero,
    the RFC's step h.3 retry — probability ≈ 2⁻²⁵⁶)."""
    if not (1 <= d < N):
        raise ValueError("private scalar out of range")
    x_oct = int(d).to_bytes(_QLEN_BYTES, "big")          # int2octets(x)
    h_oct = (int(e) % N).to_bytes(_QLEN_BYTES, "big")    # bits2octets
    V = b"\x01" * 32
    K = b"\x00" * 32
    mac = lambda key, msg: hmac.new(key, msg, hashlib.sha256).digest()
    K = mac(K, V + b"\x00" + x_oct + h_oct)
    V = mac(K, V)
    K = mac(K, V + b"\x01" + x_oct + h_oct)
    V = mac(K, V)
    while True:
        V = mac(K, V)
        k = int.from_bytes(V, "big")  # T is exactly qlen bits
        if 1 <= k < N:
            yield k
        K = mac(K, V + b"\x00")
        V = mac(K, V)


def rfc6979_k(d: int, e: int) -> int:
    """The first RFC 6979 nonce candidate: THE deterministic k for
    (d, e) except in the ~2^-256 case of a degenerate signature."""
    return next(rfc6979_candidates(d, e))


# ---------------------------------------------------------------------------
# Minimal DER (r, s) codec, the SW BCCSP signature wire form.  P-256 r
# and s are < 2^256, so every length fits the short form.


def _der_int(v: int) -> bytes:
    b = int(v).to_bytes((v.bit_length() + 8) // 8 or 1, "big")
    return b"\x02" + bytes([len(b)]) + b


def der_encode_sig(r: int, s: int) -> bytes:
    """(r, s) → DER ECDSA-Sig-Value (SEQUENCE of two INTEGERs)."""
    if not (0 < r < N and 0 < s < N):
        raise ValueError("r/s out of range")
    body = _der_int(r) + _der_int(s)
    return b"\x30" + bytes([len(body)]) + body


def _der_tlv(der: bytes, pos: int, end: int, tag: int):
    """The TLV at ``pos`` with tag ``tag`` → (content start, end);
    definite lengths in their shortest form only."""
    if end - pos < 2 or der[pos] != tag:
        raise ValueError("bad DER tag")
    ln = der[pos + 1]
    pos += 2
    if ln & 0x80:
        k = ln & 0x7F
        if k == 0 or k > 4 or end - pos < k or der[pos] == 0:
            raise ValueError("bad DER length")
        ln = int.from_bytes(der[pos:pos + k], "big")
        if ln < 0x80:
            raise ValueError("DER length not in its shortest form")
        pos += k
    if ln > end - pos:
        raise ValueError("DER length past the end")
    return pos, pos + ln


def der_decode_sig(der: bytes) -> tuple[int, int]:
    """DER ECDSA-Sig-Value → (r, s), accepting exactly what
    ``cryptography``'s ``decode_dss_signature`` accepts (the reference's
    decoder): one SEQUENCE of two minimal, non-negative INTEGERs of any
    size, nothing after it.  Range checks are the verifier's."""
    der = bytes(der)
    s, e = _der_tlv(der, 0, len(der), 0x30)
    if e != len(der):
        raise ValueError("trailing DER bytes")
    out = []
    for _ in range(2):
        a, b = _der_tlv(der, s, e, 0x02)
        raw = der[a:b]
        if not raw or raw[0] >= 0x80:
            raise ValueError("empty or negative DER integer")
        if len(raw) > 1 and raw[0] == 0 and raw[1] < 0x80:
            raise ValueError("DER integer not minimal")
        out.append(int.from_bytes(raw, "big"))
        s = b
    if s != e:
        raise ValueError("extra DER elements")
    return out[0], out[1]


@dataclass(frozen=True)
class SigningKey:
    d: int  # private scalar in [1, n-1]

    @property
    def public(self):
        return pt_mul(self.d, G)

    def sign_digest(self, e: int, k: int | None = None) -> tuple[int, int]:
        """ECDSA sign; returns low-S normalized (r, s).

        ``k`` None derives the nonce DETERMINISTICALLY per RFC 6979
        (``rfc6979_candidates``) — a signature is then a pure function of
        (d, e).  An explicit ``k`` is for tests/vectors only; r == 0
        or s == 0 with a fixed k raises instead of looping."""
        fixed = k is not None
        cands = iter([k]) if fixed else rfc6979_candidates(self.d, e)
        for kk in cands:
            x1, _ = pt_mul(kk, G)
            r = x1 % N
            s = (pow(kk, -1, N) * (e + r * self.d)) % N if r else 0
            if r == 0 or s == 0:
                if fixed:
                    raise ValueError("bad fixed k")
                continue  # RFC 6979 step h.3: next candidate
            if s > HALF_N:
                s = N - s  # low-S normalization (bccsp/sw/ecdsa.go ToLowS)
            return r, s
        raise ValueError("bad fixed k")  # exhausted the fixed candidate


def digest_int(msg: bytes) -> int:
    return int.from_bytes(hashlib.sha256(msg).digest(), "big")


def verify_digest(pub, e: int, r: int, s: int, low_s: bool = True) -> bool:
    """Reference verify incl. Fabric's low-S rule; ``low_s=False`` is
    plain ECDSA (X.509 certificate signatures, which OpenSSL and other
    CAs make without normalizing s)."""
    if pub is INF or not (0 <= pub[0] < P and 0 <= pub[1] < P) or not is_on_curve(pub):
        return False
    if not (1 <= r < N and 1 <= s < N):
        return False
    if low_s and s > HALF_N:  # low-S enforcement per bccsp/sw/ecdsa.go:41-58
        return False
    w = pow(s, -1, N)
    u1 = (e * w) % N
    u2 = (r * w) % N
    pt = pt_add(pt_mul(u1, G), pt_mul(u2, pub))
    if pt is INF:
        return False
    return pt[0] % N == r % N


def wrapped_x_signature(t: int, e: int, s: int):
    """A valid (e, r, s, Q) whose R = u1*G + u2*Q has x(R) in [n, p), so
    r = x(R) - n and only the verifier's X == (r+n)*Z compare accepts it
    (random signatures land there with probability ~2^-128).  Built
    without a discrete log: walk x = n + t, t + 1, ... to the first x
    with a point R = (x, y), fix e and a low s, then solve for the
    public key Q = u2^-1 * (R - u1*G).  → (e, r, s, qx, qy)."""
    assert 1 <= s <= HALF_N
    x = N + max(1, t % (P - N))
    while True:
        if x >= P:
            x = N + 1
        rhs = (x * x * x + A * x + B) % P
        y = pow(rhs, (P + 1) // 4, P)  # p = 3 (mod 4)
        if y * y % P == rhs:
            break
        x += 1
    r = x - N
    w = pow(s, -1, N)
    u1, u2 = e * w % N, r * w % N
    u1g = pt_mul(u1, G)
    q = pt_mul(pow(u2, -1, N), pt_add((x, y), None if u1g is INF else (u1g[0], P - u1g[1])))
    assert q is not INF and pt_add(pt_mul(u1, G), pt_mul(u2, q)) == (x, y)
    return e, r, s, q[0], q[1]
