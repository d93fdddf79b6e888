"""The v2 ECDSA-P256 verifier: signed base-2^6 digits, RCB complete
formulas, a 4-bit windowed ladder (counterpart: ``fabric_tpu/ops/p256v2.py``).

A comparison kernel, reached through the facade ``ops/p256.py`` under
``kernel="v2"`` (``FABRIC_TPU_P256=v2``).  What it computes is the
reference accept set (bccsp/sw/ecdsa.go:41-58): r, s in [1, n-1],
s <= n/2, Q on the curve, R = u1*G + u2*Q not infinity, x(R) = r
(mod n).  On the device: the on-curve check, s^-1 by Fermat (256
squarings, a multiply at each set bit of n - 2), u1 and u2 as
canonical digits, the 16-entry u2*Q window table, 64 steps of
[4 doublings + add T_Q[w2] + mixed add T_G[w1], skipped at digit 0]
with a settle of the running point after each step, and the
X = r*Z or (r+n)*Z (mod p) compare.  The host does the admission checks
(``pre_ok``) and r + n (``rpn``, ``rpn_ok``), as the reference's
``verify_host`` does.

``FV`` carries a |digit| bound beside each value and settles
("condenses") an operand exactly where the reference's ``FV.__mul__``
does: the decisions depend only on the bounds, which are the same for
every lane, so the kernel carries the same bound as a lane-uniform
integer and takes the same branch everywhere.

Launch frame: int32 ``[B, 260]`` = e | r | s | rpn | qx | qy as 43
canonical digits each (values mod 2^258), then rpn_ok, pre_ok.
``verify_batch_v2`` is the kernel wrapper: a CPU frame runs the plain
version ``verify_batch_v2_ref`` (``ops/digits.py`` in int64 tensors),
a CUDA frame launches ``kernels/csrc/p256_v2.cu``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from fabric_tpu_torch import kernels
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.ops import digits as dg
from fabric_tpu_torch.utils.batching import next_pow2

K = dg.K
P = ec_ref.P
N = ec_ref.N
B_COEF = ec_ref.B
GX, GY = ec_ref.GX, ec_ref.GY
HALF_N = ec_ref.HALF_N

MODP = dg.DigitMod(P)
MODN = dg.DigitMod(N)

WINDOW = 4
STEPS = 64
MIN_BUCKET = 16
FRAME_COLS = 6 * K + 2
_RPN_OK, _PRE_OK = 6 * K, 6 * K + 1
PAD_ITEM = (0, 1, 1, 0, 0)  # fails pre_ok

# the pairing limit: |a|*|b| must stay under it (|a|*|b|*K < 2^24)
SUM_LIMIT = (1 << 24) // K
# mul+settle certified at the largest legal pairing (624^2 * 43 < 2^24);
# FV.__mul__ never exceeds it, so these settled bounds hold everywhere
MAX_SIDE = int(((1 << 24) / K) ** 0.5)  # 624
SETTLED = {P: MODP.bound_check(MAX_SIDE, MAX_SIDE), N: MODN.bound_check(MAX_SIDE, MAX_SIDE)}


class FV:
    """A field value with its |digit| bound.  The bound decides where
    a product condenses (settles) an operand; condensing makes a new
    value and leaves the operand as it was, as in the reference."""

    __slots__ = ("arr", "bound", "mod")

    def __init__(self, arr, bound: int, mod: dg.DigitMod):
        self.arr = arr
        self.bound = int(bound)
        self.mod = mod

    def __add__(self, other):
        return FV(self.arr + other.arr, self.bound + other.bound, self.mod)

    def __sub__(self, other):
        return FV(self.arr - other.arr, self.bound + other.bound, self.mod)

    def condensed(self) -> "FV":
        return FV(self.mod.settle(self.arr), SETTLED[self.mod.m], self.mod)

    def __mul__(self, other):
        a, b = self, other
        if a.bound * b.bound >= SUM_LIMIT:
            if a.bound >= b.bound:
                a = a.condensed()
            else:
                b = b.condensed()
            if a.bound * b.bound >= SUM_LIMIT:
                a, b = a.condensed(), b.condensed()
        return FV(a.mod.mul(a.arr, b.arr), SETTLED[a.mod.m], a.mod)


def settled_fv(arr, mod: dg.DigitMod) -> FV:
    return FV(arr, SETTLED[mod.m], mod)


# ---------------------------------------------------------------------------
# RCB complete point ops (projective X:Y:Z, a = -3), the reference's
# statement order


def pt_add(p1, p2, b_fv):
    """Complete projective addition (RCB16 algorithm 4, a = -3)."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    t0 = X1 * X2
    t1 = Y1 * Y2
    t2 = Z1 * Z2
    t3 = X1 + Y1
    t4 = X2 + Y2
    t3 = t3 * t4
    t4 = t0 + t1
    t3 = t3 - t4
    t4 = Y1 + Z1
    X3 = Y2 + Z2
    t4 = t4 * X3
    X3 = t1 + t2
    t4 = t4 - X3
    X3 = X1 + Z1
    Y3 = X2 + Z2
    X3 = X3 * Y3
    Y3 = t0 + t2
    Y3 = X3 - Y3
    Z3 = b_fv * t2
    X3 = Y3 - Z3
    Z3 = X3 + X3
    X3 = X3 + Z3
    Z3 = t1 - X3
    X3 = t1 + X3
    Y3 = b_fv * Y3
    t1 = t2 + t2
    t2 = t1 + t2
    Y3 = Y3 - t2
    Y3 = Y3 - t0
    t1 = Y3 + Y3
    Y3 = t1 + Y3
    t1 = t0 + t0
    t0 = t1 + t0
    t0 = t0 - t2
    t1 = t4 * Y3
    t2 = t0 * Y3
    Y3 = X3 * Z3
    Y3 = Y3 + t2
    X3 = t3 * X3
    X3 = X3 - t1
    Z3 = t4 * Z3
    t1 = t3 * t0
    Z3 = Z3 + t1
    return (X3, Y3, Z3)


def pt_add_mixed(p1, x2, y2, b_fv):
    """Complete mixed addition (RCB16 algorithm 5, Z2 = 1); P2 is
    affine and never infinity."""
    X1, Y1, Z1 = p1
    X2, Y2 = x2, y2
    t0 = X1 * X2
    t1 = Y1 * Y2
    t3 = X2 + Y2
    t4 = X1 + Y1
    t3 = t3 * t4
    t4 = t0 + t1
    t3 = t3 - t4
    t4 = Y2 * Z1
    t4 = t4 + Y1
    Y3 = X2 * Z1
    Y3 = Y3 + X1
    Z3 = b_fv * Z1
    X3 = Y3 - Z3
    Z3 = X3 + X3
    X3 = X3 + Z3
    Z3 = t1 - X3
    X3 = t1 + X3
    Y3 = b_fv * Y3
    t1 = Z1 + Z1
    t2 = t1 + Z1
    Y3 = Y3 - t2
    Y3 = Y3 - t0
    t1 = Y3 + Y3
    Y3 = t1 + Y3
    t1 = t0 + t0
    t0 = t1 + t0
    t0 = t0 - t2
    t1 = t4 * Y3
    t2 = t0 * Y3
    Y3 = X3 * Z3
    Y3 = Y3 + t2
    X3 = t3 * X3
    X3 = X3 - t1
    Z3 = t4 * Z3
    t1 = t3 * t0
    Z3 = Z3 + t1
    return (X3, Y3, Z3)


def pt_double(p, b_fv):
    """Complete projective doubling (RCB16 algorithm 6, a = -3)."""
    X, Y, Z = p
    t0 = X * X
    t1 = Y * Y
    t2 = Z * Z
    t3 = X * Y
    t3 = t3 + t3
    Z3 = X * Z
    Z3 = Z3 + Z3
    Y3 = b_fv * t2
    Y3 = Y3 - Z3
    X3 = Y3 + Y3
    Y3 = X3 + Y3
    X3 = t1 - Y3
    Y3 = t1 + Y3
    Y3 = X3 * Y3
    X3 = X3 * t3
    t3 = t2 + t2
    t2 = t2 + t3
    Z3 = b_fv * Z3
    Z3 = Z3 - t2
    Z3 = Z3 - t0
    t3 = Z3 + Z3
    Z3 = Z3 + t3
    t3 = t0 + t0
    t0 = t3 + t0
    t0 = t0 - t2
    t0 = t0 * Z3
    Y3 = Y3 + t0
    t0 = Y * Z
    t0 = t0 + t0
    Z3 = t0 * Z3
    X3 = X3 - Z3
    Z3 = t0 * t1
    Z3 = Z3 + Z3
    Z3 = Z3 + Z3
    return (X3, Y3, Z3)


# u1*G window table: TG[d] = d*G affine, d = 1..15 (digit 0 = infinity,
# handled by a select)
_TG = np.zeros((16, 2, K), np.int64)
for _d in range(1, 16):
    _px, _py = ec_ref.pt_mul(_d, (GX, GY))
    _TG[_d, 0] = dg.int_to_digits(_px)
    _TG[_d, 1] = dg.int_to_digits(_py)

N_MINUS_2_BITS = [((N - 2) >> (255 - i)) & 1 for i in range(256)]


def window_digits(scalar_digits: torch.Tensor) -> torch.Tensor:
    """Canonical base-64 digits [B, K] → 4-bit window digits [B, 64],
    most-significant window first."""
    sh = torch.arange(dg.W, device=scalar_digits.device)
    bits = (scalar_digits.unsqueeze(-1) >> sh) & 1
    bits = bits.reshape(*scalar_digits.shape[:-1], K * dg.W)[..., :256]
    w = bits.reshape(*scalar_digits.shape[:-1], STEPS, WINDOW)
    weights = torch.tensor([1, 2, 4, 8], dtype=w.dtype, device=w.device)
    return (w * weights).sum(dim=-1).flip(-1)


# ---------------------------------------------------------------------------
# Host staging (the reference's verify_host)


def bucket(n: int) -> int:
    return max(MIN_BUCKET, next_pow2(n))


def stage_frame(items, pad_to: int | None = None) -> np.ndarray:
    """(digest, r, s, qx, qy) int tuples → the [pad_to, 260] int32
    frame; padding lanes carry ``PAD_ITEM``."""
    items = list(items)
    Bp = len(items) if pad_to is None else pad_to
    full = items + [PAD_ITEM] * (Bp - len(items))
    frame = np.zeros((Bp, FRAME_COLS), np.int32)
    if not Bp:
        return frame
    pre_ok, rpn, rpn_ok = [], [], []
    for e, r, s, qx, qy in full:
        pre_ok.append(0 < r < N and 0 < s <= HALF_N and 0 <= qx < P and 0 <= qy < P
                      and not (qx == 0 and qy == 0))
        rp = r + N
        rpn_ok.append(rp < P)
        rpn.append(rp if rp < P else 0)
    cols = list(zip(*full))
    for k, col in enumerate((cols[0], cols[1], cols[2], rpn, cols[3], cols[4])):
        frame[:, k * K:(k + 1) * K] = dg.ints_to_digits([int(x) % (1 << 258) for x in col])
    frame[:, _RPN_OK] = rpn_ok
    frame[:, _PRE_OK] = pre_ok
    return frame


# ---------------------------------------------------------------------------
# Plain version


@lru_cache(maxsize=None)
def _tg(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_TG).to(device)


def _const(x: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(dg.int_to_digits(x)).to(like.device).expand_as(like)


def verify_batch_v2_ref(frame: torch.Tensor) -> torch.Tensor:
    """Plain version of the v2 kernel: [B, 260] int32 frame → [B] bool."""
    f = frame.to(torch.int64)
    col = lambda k: f[:, k * K:(k + 1) * K]
    e, r, s, rpn, qx, qy = (col(k) for k in range(6))
    rpn_ok = f[:, _RPN_OK] != 0
    pre_ok = f[:, _PRE_OK] != 0

    # on-curve (mod p): y^2 == x^3 - 3x + b
    qx_p, qy_p = FV(qx, 63, MODP), FV(qy, 63, MODP)
    b_p = FV(_const(B_COEF, qx), 63, MODP)
    y2 = qy_p * qy_p
    x2 = qx_p * qx_p
    x3 = x2 * qx_p
    rhs = x3 - (qx_p + qx_p + qx_p) + b_p
    on_curve = MODP.eq_zero((y2 - rhs).arr)

    # u1 = e/s, u2 = r/s (mod n) by Fermat
    s_n = FV(s, 63, MODN)
    acc = _const(1, s)
    for bit in N_MINUS_2_BITS:
        a = settled_fv(acc, MODN)
        sq = a * a
        acc = (sq * s_n).arr if bit else sq.arr
    s_inv = settled_fv(acc, MODN)
    u1 = MODN.canonical((FV(e, 63, MODN) * s_inv).arr)
    u2 = MODN.canonical((FV(r, 63, MODN) * s_inv).arr)

    # u2*Q window table: T[d] = d*Q, T[0] = infinity (0 : 1 : 0)
    zero = torch.zeros_like(qx)
    one = _const(1, qx)
    inf = (FV(zero, 0, MODP), FV(one, 63, MODP), FV(zero, 0, MODP))
    q1 = (qx_p, qy_p, FV(one, 63, MODP))
    table = [inf, q1]
    acc_pt = q1
    for _ in range(2, 16):
        acc_pt = pt_add(acc_pt, q1, b_p)
        table.append(acc_pt)
    tq = torch.stack([torch.stack([c.arr for c in pt], dim=1) for pt in table], dim=1)
    tq_bound = max(c.bound for pt in table for c in pt)

    w1, w2 = window_digits(u1), window_digits(u2)
    tg = _tg(frame.device)
    lanes = torch.arange(f.shape[0], device=frame.device)
    X, Y, Z = zero, one, zero
    for i in range(STEPS):
        R = (settled_fv(X, MODP), settled_fv(Y, MODP), settled_fv(Z, MODP))
        for _ in range(WINDOW):
            R = pt_double(R, b_p)
        sel = tq[lanes, w2[:, i]]
        R = pt_add(R, tuple(FV(sel[:, c], tq_bound, MODP) for c in range(3)), b_p)
        g = tg[w1[:, i]]
        Rg = pt_add_mixed(R, FV(g[:, 0], 63, MODP), FV(g[:, 1], 63, MODP), b_p)
        skip = (w1[:, i] == 0).unsqueeze(-1)
        X, Y, Z = (MODP.settle(torch.where(skip, a.arr, c.arr)) for a, c in zip(R, Rg))

    Z_fv, X_fv = settled_fv(Z, MODP), settled_fv(X, MODP)
    not_inf = ~MODP.eq_zero(Z)
    cmp1 = MODP.eq_zero((X_fv - FV(r, 63, MODP) * Z_fv).arr)
    cmp2 = MODP.eq_zero((X_fv - FV(rpn, 63, MODP) * Z_fv).arr) & rpn_ok
    return pre_ok & on_curve & not_inf & (cmp1 | cmp2)


# ---------------------------------------------------------------------------
# Kernel wrapper


# the kernel's reduction matrix: row c*48 + q (c: lo, mid, hi & 63, hi >> 6)
# holds R's row of chunk kind min(c, 2) for the high column the kernel
# keeps at position q of its chunk tiles, 48 + q (h = q + 5) for q < 37 and
# 43..47 (h = q - 43) for q >= 43; the rows of q = 37..42 hold no column
CHUNK_POS = [q + 5 if q < 37 else (q - 43 if q >= 43 else None) for q in range(48)]


def chunk_matrix(mod: dg.DigitMod) -> np.ndarray:
    """The int8 [192, 48] reduction matrix of ``mod`` as the kernel reads
    it, row c*48 + q: see ``CHUNK_POS``."""
    m = np.zeros((4 * 48, 48), np.int8)
    for q, h in enumerate(CHUNK_POS):
        if h is not None:
            for c in range(4):
                m[c * 48 + q, :K] = mod.R_np[min(c, 2) * dg.H + h]
    return m


def _tiles(m: np.ndarray) -> np.ndarray:
    """[192, 48] → [12 k-tiles][3 n-tiles][16][16], flat."""
    return np.ascontiguousarray(m.reshape(12, 16, 3, 16).transpose(0, 2, 1, 3)).reshape(-1)


def _pad48(a) -> np.ndarray:
    a = np.asarray(a, np.int64)
    return np.concatenate([a, np.zeros(a.shape[:-1] + (48 - a.shape[-1],), np.int64)], axis=-1)


@lru_cache(maxsize=None)
def kernel_consts(device: torch.device) -> torch.Tensor:
    """The kernel's int32 constant block: the settled bounds of mod p and
    mod n (and two zero words), then the tables each block copies into
    shared memory — the int8 reduction matrices of mod p and mod n as
    16 x 16 tiles, F_p and F_n, the digits of p and n (int32, padded to
    48), TG[16][2][48] (int8) and the digits of b (int32)."""
    parts = [np.array([SETTLED[P], SETTLED[N], 0, 0], np.int32),
             _tiles(chunk_matrix(MODP)), _tiles(chunk_matrix(MODN)),
             _pad48(np.stack([MODP.F_np, MODN.F_np])).astype(np.int32),
             _pad48(np.stack([MODP.digits_np, MODN.digits_np])).astype(np.int32),
             _pad48(_TG).astype(np.int8),
             _pad48(dg.int_to_digits(B_COEF)).astype(np.int32)]
    raw = b"".join(np.ascontiguousarray(a).tobytes() for a in parts)
    return torch.from_numpy(np.frombuffer(raw, np.int32).copy()).to(device)


def verify_batch_v2(frame: torch.Tensor) -> torch.Tensor:
    """[B, 260] int32 frame → [B] bool.  A CPU frame runs the plain
    version; a CUDA frame launches the kernel."""
    if frame.dtype != torch.int32 or frame.dim() != 2 or frame.shape[1] != FRAME_COLS:
        raise ValueError(f"expected an int32 [B, {FRAME_COLS}] frame, "
                         f"got {frame.dtype} {tuple(frame.shape)}")
    if frame.device.type == "cpu":
        return verify_batch_v2_ref(frame)
    return kernels.p256_verify_v2(frame.contiguous(), kernel_consts(frame.device))
