"""Pure-Python NIST P-256 reference (counterpart:
``fabric_tpu/crypto/ec_ref.py``, a copy trimmed to verification and
deterministic signing).

The oracle the port's verify kernel and its plain version are held
against, and the deterministic (RFC 6979) signer ``chip_smoke.py`` uses
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


def verify_digest(pub, e: int, r: int, s: int) -> bool:
    """Reference verify incl. Fabric's low-S rule."""
    if pub is INF or not (0 <= pub[0] < P and 0 <= pub[1] < P) or not is_on_curve(pub):
        return False
    if not (1 <= r < N and 1 <= s < N):
        return False
    if s > HALF_N:  # low-S enforcement per bccsp/sw/ecdsa.go:41-58
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
