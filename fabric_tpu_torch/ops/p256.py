"""The verify facade with its kernel selection, and the v1 verifier
(counterpart: ``fabric_tpu/ops/p256.py``).

Facade.  ``KERNEL`` is read from ``FABRIC_TPU_P256`` as in the
reference (:409), default ``"v3"``: ``"v1"`` selects this module's
Montgomery ladder, ``"v2"`` the signed-digit verifier of
``ops/p256v2.py``, and any other value the default v3 kernel of
``ops/p256v3.py`` (:434-439).  ``verify_host``, ``verify_launch`` and
``verify_launch_many`` take ``kernel=`` (None: ``KERNEL``) so a caller
need not edit the environment.  The launches return ``VerifyHandle``s
whose ``fetch()`` gives a list of bools.  Under v1 and v2,
``verify_launch_many`` launches each batch on its own, as the
reference's comparison kernels do.

v1 (the reference's ``verify_batch`` :307).  Everything runs on the
device: the r, s range and low-S checks, Q's range, not-infinity and
on-curve checks, e mod n, s^-1 by Fermat (exponent n - 2: 256
squarings and a multiply at each set bit), u1 and u2, then a 256-step
double-and-add Shamir ladder over {infinity, G, Q, G+Q} with the
reference's complete Jacobian addition (dbl-2001-b doubling, and the
identity and doubling cases computed and selected), and the
X = r*Z^2 or (r+n)*Z^2 (mod p) compare.  Host staging is the
reference's ``_verify_host_v1`` (:474): pad with (0, 0, 0, 0, 0) to
``max(16, next_pow2(n))``.  One deliberate difference: a component
outside [0, 2^256) makes the lane the all-zero item, which every
verifier rejects, where the reference's limb conversion keeps the low
256 bits.

v1's launch frame is int32 ``[B, 80]``: e | r | s | qx | qy as 16
little-endian 16-bit limbs each (the reference's ``ints_to_limbs``).
The plain version ``verify_batch_v1_ref`` works mod p on the port's
``ops/fp256.py`` core (reduced-form limbs, comparisons through
``canon``) and mod n with an exact 16-bit-word CIOS product, the
reference's ``_mont_mul``; ``verify_batch_v1`` is the kernel wrapper
(``kernels/csrc/p256_v1.cu`` for a CUDA frame).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from fabric_tpu_torch import kernels
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.device import resolve_device
from fabric_tpu_torch.ops import fp256, p256v2, p256v3
from fabric_tpu_torch.ops.p256v3 import VerifyHandle
from fabric_tpu_torch.utils.batching import next_pow2

P = ec_ref.P
N = ec_ref.N
B_COEF = ec_ref.B
GX, GY = ec_ref.GX, ec_ref.GY
HALF_N = ec_ref.HALF_N

LIMBS = 16
MASK = 0xFFFF
MIN_BUCKET = 16
FRAME_COLS = 5 * LIMBS
PAD_ITEM = (0, 0, 0, 0, 0)
N_MINUS_2 = N - 2
_R = 1 << 256

KERNEL = os.environ.get("FABRIC_TPU_P256", "v3")


def selected(kernel: str | None = None) -> str:
    """The kernel a call runs: ``kernel`` (None: ``KERNEL``); anything
    but "v1" or "v2" is the default v3."""
    k = KERNEL if kernel is None else kernel
    return k if k in ("v1", "v2") else "v3"


# ---------------------------------------------------------------------------
# Facade


def _empty(dev) -> VerifyHandle:
    return VerifyHandle(torch.zeros(0, dtype=torch.bool, device=dev), 0)


def verify_launch(items, kernel: str | None = None, device="cuda", chunk: int | None = None,
                  pool=None) -> VerifyHandle:
    """Stage (digest, r, s, qx, qy) tuples and launch the selected
    kernel over the bucketed batch without waiting.  ``chunk`` and
    ``pool`` go to v3 (chunked launches, ``p256v3.verify_launch``); v1
    and v2 launch the whole batch at once."""
    k = selected(kernel)
    if k == "v3":
        return p256v3.verify_launch(items, device=device, chunk=chunk, pool=pool)
    dev = resolve_device(device)
    items = list(items)
    n = len(items)
    if not n:
        return _empty(dev)
    if k == "v1":
        frame = stage_frame(items, bucket(n))
        out = verify_batch_v1(torch.from_numpy(frame).to(dev))
    else:
        frame = p256v2.stage_frame(items, p256v2.bucket(n))
        out = p256v2.verify_batch_v2(torch.from_numpy(frame).to(dev))
    return VerifyHandle(out, n)


def verify_launch_many(batches, kernel: str | None = None, device="cuda",
                       chunk: int | None = None, pool=None) -> list:
    """Several blocks' batches: ONE coalesced launch under v3 (chunked
    with ``chunk``), one launch per batch under v1 and v2."""
    if selected(kernel) == "v3":
        return p256v3.verify_launch_many(batches, device=device, chunk=chunk, pool=pool)
    return [verify_launch(b, kernel=kernel, device=device) for b in batches]


def verify_host(items, kernel: str | None = None, device="cuda") -> list[bool]:
    """Synchronous verify: the accept set of ``ec_ref.verify_digest``."""
    return verify_launch(items, kernel=kernel, device=device).fetch()


# ---------------------------------------------------------------------------
# v1 host staging


def bucket(n: int) -> int:
    return max(MIN_BUCKET, next_pow2(n))


def stage_frame(items, pad_to: int | None = None) -> np.ndarray:
    """(digest, r, s, qx, qy) tuples → the [pad_to, 80] int32 frame."""
    items = list(items)
    Bp = len(items) if pad_to is None else pad_to
    full = [it if all(0 <= v < _R for v in it) else PAD_ITEM for it in items]
    full += [PAD_ITEM] * (Bp - len(items))
    frame = np.zeros((Bp, FRAME_COLS), np.int32)
    if Bp:
        for k, col in enumerate(zip(*full)):
            frame[:, k * LIMBS:(k + 1) * LIMBS] = fp256.ints_to_limbs(col).numpy()
    return frame


# ---------------------------------------------------------------------------
# v1 plain version


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b over canonical limbs (b broadcastable), top limb first."""
    b = b.expand_as(a)
    gt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    less = torch.zeros_like(gt)
    for k in range(LIMBS - 1, -1, -1):
        undecided = ~gt & ~less
        gt = gt | (undecided & (a[..., k] > b[..., k]))
        less = less | (undecided & (a[..., k] < b[..., k]))
    return less


def sub_raw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod 2^256 over canonical limbs."""
    return fp256._ripple(a - b.expand_as(a)) & MASK


def mont_mul_n(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod n, exact, for canonical limbs with a * b < n * 2^256
    (16-bit-word CIOS, the reference's ``_mont_mul``); output in [0, n)."""
    nl, n0 = _n_consts(a.device)
    lead = a.shape[:-1]
    t = torch.zeros(*lead, LIMBS + 2, dtype=torch.int64, device=a.device)
    for i in range(LIMBS):
        t[..., :LIMBS] += a[..., i:i + 1] * b
        m = ((t[..., 0] & MASK) * n0) & MASK
        t[..., :LIMBS] += m.unsqueeze(-1) * nl
        c = t[..., 0] >> 16
        t = torch.nn.functional.pad(t[..., 1:], (0, 1))
        t[..., 0] += c
    t = fp256._ripple(t)[..., :LIMBS + 1]  # value < 2n: 17 limbs
    n17 = torch.nn.functional.pad(nl, (0, 1))
    d = fp256._ripple(t - n17)
    return torch.where(d[..., -1:] < 0, t, d)[..., :LIMBS]


@lru_cache(maxsize=None)
def _n_consts(device: torch.device):
    n0 = (-pow(N, -1, 1 << 16)) % (1 << 16)
    return fp256.const(N, device), n0


@lru_cache(maxsize=None)
def _v1_consts(device: torch.device):
    """Montgomery-form constants mod p (fp256 limbs) and R^2 mod n."""
    c = lambda x: fp256.const(x, device)
    m = lambda x: c((x * fp256.R) % P)
    return {"r2": c(fp256.R2), "b": m(B_COEF), "gx": m(GX), "gy": m(GY),
            "one": c(fp256.R_MOD_P), "r2n": c((_R * _R) % N), "rn": c(_R % N), "n": c(N), "p": c(P),
            "half_n": c(HALF_N)}


def _mul(a, b):
    return fp256.mont_mul(a, b)


def _add(a, b):
    return fp256.reduce(a + b)


def _sub(a, b):
    return fp256.reduce(a - b)


def pt_double_v1(X, Y, Z):
    """dbl-2001-b for a = -3 (the reference's ``_pt_double``); infinity
    (Z = 0) stays infinity."""
    delta = _mul(Z, Z)
    gamma = _mul(Y, Y)
    beta = _mul(X, gamma)
    t1 = _sub(X, delta)
    t2 = _add(X, delta)
    t3 = _add(t2, _add(t2, t2))
    alpha = _mul(t1, t3)
    beta4 = _add(_add(beta, beta), _add(beta, beta))
    X3 = _sub(_mul(alpha, alpha), _add(beta4, beta4))
    yz = _add(Y, Z)
    Z3 = _sub(_sub(_mul(yz, yz), gamma), delta)
    g2 = _mul(gamma, gamma)
    g8 = _add(_add(g2, g2), _add(g2, g2))
    g8 = _add(g8, g8)
    Y3 = _sub(_mul(alpha, _sub(beta4, X3)), g8)
    return X3, Y3, Z3


def pt_add_v1(X1, Y1, Z1, X2, Y2, Z2):
    """Complete Jacobian addition (the reference's ``_pt_add``): the
    generic sum, the doubling when P1 = P2, and the identity cases,
    selected per lane; P1 = -P2 gives Z3 = 0."""
    z1z = _mul(Z1, Z1)
    z2z = _mul(Z2, Z2)
    u1 = _mul(X1, z2z)
    u2 = _mul(X2, z1z)
    s1 = _mul(_mul(Y1, Z2), z2z)
    s2 = _mul(_mul(Y2, Z1), z1z)
    h = _sub(u2, u1)
    rr = _sub(s2, s1)
    hh = _mul(h, h)
    hhh = _mul(h, hh)
    v = _mul(u1, hh)
    x3 = _sub(_sub(_mul(rr, rr), hhh), _add(v, v))
    y3 = _sub(_mul(rr, _sub(v, x3)), _mul(s1, hhh))
    z3 = _mul(_mul(Z1, Z2), h)
    p1_inf = fp256.is_zero(Z1).unsqueeze(-1)
    p2_inf = fp256.is_zero(Z2).unsqueeze(-1)
    same = (fp256.is_zero(h) & fp256.is_zero(rr)).unsqueeze(-1) & ~p1_inf & ~p2_inf
    dX, dY, dZ = pt_double_v1(X1, Y1, Z1)
    out = []
    for d, g, a, b in ((dX, x3, X1, X2), (dY, y3, Y1, Y2), (dZ, z3, Z1, Z2)):
        out.append(torch.where(p2_inf, a, torch.where(p1_inf, b, torch.where(same, d, g))))
    return tuple(out)


def _bit(u: torch.Tensor, j: int) -> torch.Tensor:
    return (u[..., j // 16] >> (j % 16)) & 1


def verify_batch_v1_ref(frame: torch.Tensor) -> torch.Tensor:
    """Plain version of the v1 kernel: [B, 80] int32 frame → [B] bool."""
    dev = frame.device
    f = frame.to(torch.int64) & MASK
    e, r, s, qx, qy = (f[:, k * LIMBS:(k + 1) * LIMBS] for k in range(5))
    c = _v1_consts(dev)
    B = f.shape[0]
    zero_l = lambda x: (x == 0).all(dim=-1)

    r_ok = ~zero_l(r) & lt(r, c["n"])
    s_ok = ~zero_l(s) & lt(s, c["n"])
    low_s = ~lt(c["half_n"].expand(B, -1), s)
    q_range = lt(qx, c["p"]) & lt(qy, c["p"]) & ~(zero_l(qx) & zero_l(qy))

    r2 = c["r2"].expand(B, -1)
    qxm, qym = _mul(qx, r2), _mul(qy, r2)
    y2 = _mul(qym, qym)
    x3 = _mul(_mul(qxm, qxm), qxm)
    rhs = x3 - 3 * qxm + c["b"]
    on_curve = fp256.eq(y2, rhs) & q_range

    e_red = torch.where(lt(e, c["n"]).unsqueeze(-1), e, sub_raw(e, c["n"]))
    sm = mont_mul_n(s, c["r2n"].expand(B, -1))
    w = c["rn"].expand(B, -1)  # Montgomery form of 1
    for k in range(256):  # w = sm^(n-2), Montgomery form: s^-1 * R mod n
        w = mont_mul_n(w, w)
        if (N_MINUS_2 >> (255 - k)) & 1:
            w = mont_mul_n(w, sm)
    u1 = mont_mul_n(e_red, w)
    u2 = mont_mul_n(r, w)

    gx, gy, one = (c[k].expand(B, -1) for k in ("gx", "gy", "one"))
    zero = torch.zeros_like(one)
    gq = pt_add_v1(gx, gy, one, qxm, qym, one)
    X, Y, Z = zero, zero, zero
    for k in range(256):
        X, Y, Z = pt_double_v1(X, Y, Z)
        j = 255 - k
        idx = (_bit(u1, j) + 2 * _bit(u2, j)).unsqueeze(-1)
        tX = torch.where(idx == 3, gq[0], torch.where(idx == 2, qxm, gx))
        tY = torch.where(idx == 3, gq[1], torch.where(idx == 2, qym, gy))
        tZ = torch.where(idx == 0, zero, torch.where(idx == 3, gq[2], one))
        X, Y, Z = pt_add_v1(X, Y, Z, tX, tY, tZ)

    not_inf = ~fp256.is_zero(Z)
    z2 = _mul(Z, Z)
    cmp1 = fp256.eq(X, _mul(_mul(r, r2), z2))
    rpn = fp256._ripple(torch.nn.functional.pad(r, (0, 1)) + torch.nn.functional.pad(c["n"], (0, 1)))
    rpn_lt_p = (rpn[..., -1] == 0) & lt(rpn[..., :LIMBS], c["p"])
    cmp2 = fp256.eq(X, _mul(_mul(rpn[..., :LIMBS], r2), z2)) & rpn_lt_p
    return r_ok & s_ok & low_s & on_curve & not_inf & (cmp1 | cmp2)


# ---------------------------------------------------------------------------
# v1 kernel wrapper


@lru_cache(maxsize=None)
def kernel_consts(device: torch.device) -> torch.Tensor:
    """The v1 kernel's constant block as int32 bit patterns of uint32
    little-endian limbs: R^2 mod p | b R | Gx R | Gy R | R mod p |
    R^2 mod n | R mod n | n | n/2 | p."""
    vals = [fp256.R2, (B_COEF * _R) % P, (GX * _R) % P, (GY * _R) % P, fp256.R_MOD_P,
            (_R * _R) % N, _R % N, N, HALF_N, P]
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return torch.from_numpy(np.frombuffer(raw, "<u4").view(np.int32).copy()).to(device)


def verify_batch_v1(frame: torch.Tensor) -> torch.Tensor:
    """[B, 80] int32 frame → [B] bool.  A CPU frame runs the plain
    version; a CUDA frame launches the kernel."""
    if frame.dtype != torch.int32 or frame.dim() != 2 or frame.shape[1] != FRAME_COLS:
        raise ValueError(f"expected an int32 [B, {FRAME_COLS}] frame, "
                         f"got {frame.dtype} {tuple(frame.shape)}")
    if frame.device.type == "cpu":
        return verify_batch_v1_ref(frame)
    return kernels.p256_verify_v1(frame.contiguous(), kernel_consts(frame.device))
