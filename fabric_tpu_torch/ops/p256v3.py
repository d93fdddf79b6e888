"""Batched ECDSA-P256 verification (counterpart: ``fabric_tpu/ops/p256v3.py``).

What it computes is the reference accept set (bccsp/sw/ecdsa.go:41-58):
r, s in [1, n-1], s <= n/2 (low-S), Q on the curve and not infinity,
R = u1*G + u2*Q not infinity, x(R) = r (mod n).  The schedule is the JAX
kernel's: a 16-entry u2*Q window table, 64 steps of [4 complete
doublings + add T_Q[w2] + mixed add T_G[w1], skipped at digit 0] with
the Renes-Costello-Batina complete formulas (a = -3), and the final
X = r*Z or (r+n)*Z (mod p) compare.

Host staging (admission checks, one Montgomery batch inversion for
s^-1, u1/u2) is the JAX package's numpy/Python staging.  The launch
frame is the port's own: it drops the TPU's RNS residues for 16-bit
big-endian positional limbs, one int16 row per signature:

    qx | qy | r | r+n | u1 | u2   (16 limbs each)  | rpn_ok | pre_ok

so ``FRAME_COLS`` = 98.  The kernel recodes the 4-bit windows from the
u1/u2 limbs itself (``device_recode_windows`` in the reference).

``verify_batch_packed`` is the kernel wrapper: a CPU frame runs the
plain version ``verify_batch_ref`` (torch ops over ``ops/fp256.py``), a
CUDA frame launches ``kernels/csrc/p256_verify.cu``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from fabric_tpu_torch import kernels
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.device import resolve_device
from fabric_tpu_torch.ops import fp256
from fabric_tpu_torch.utils.batching import next_pow2

P = ec_ref.P
N = ec_ref.N
B_COEF = ec_ref.B
GX, GY = ec_ref.GX, ec_ref.GY
HALF_N = ec_ref.HALF_N

WINDOW = 4
STEPS = 64
MIN_BUCKET = 16
_PK_LIMBS = 16
FRAME_COLS = 6 * _PK_LIMBS + 2
_RPN_OK, _PRE_OK = 6 * _PK_LIMBS, 6 * _PK_LIMBS + 1


# ---------------------------------------------------------------------------
# Host staging (copied from the reference's numpy/Python staging)


def _bucket(n: int) -> int:
    """Batch bucket: powers of two up to 512, then multiples of 512 —
    a 1000-tx block's ~3000 signatures pad to 3072, not 4096."""
    if n <= 512:
        return max(MIN_BUCKET, next_pow2(n))
    return -(-n // 512) * 512


def _batch_inv_mod_n(ss: list[int]) -> list[int]:
    """Montgomery's simultaneous inversion: one pow(., -1, n) for the
    whole batch + 3(B-1) modmuls."""
    B = len(ss)
    pref = [1] * (B + 1)
    for i, s in enumerate(ss):
        pref[i + 1] = (pref[i] * s) % N
    inv_all = pow(pref[B], -1, N)
    out = [0] * B
    for i in range(B - 1, -1, -1):
        out[i] = (pref[i] * inv_all) % N
        inv_all = (inv_all * ss[i]) % N
    return out


def _windows(us: list[int]) -> np.ndarray:
    """[B] ints → [B, 64] 4-bit window digits, MSB-first."""
    if not us:
        return np.zeros((0, STEPS), np.int32)
    raw = np.frombuffer(
        b"".join(int(u).to_bytes(32, "big") for u in us), np.uint8
    ).reshape(len(us), 32)
    hi, lo = raw >> 4, raw & 0xF
    return np.stack([hi, lo], axis=-1).reshape(len(us), 64).astype(np.int32)


def _limbs16(us) -> np.ndarray:
    """[B] ints (< 2^256) → [B, 16] int16 BIG-endian 16-bit limbs.
    Values >= 2^15 wrap into the sign bit (same bit pattern)."""
    if not len(us):
        return np.zeros((0, _PK_LIMBS), np.int16)
    raw = np.frombuffer(
        b"".join(int(u).to_bytes(32, "big") for u in us), np.uint8
    ).reshape(len(us), 32).astype(np.uint16)
    return ((raw[:, 0::2] << 8) | raw[:, 1::2]).astype(np.int16)


def admit(e: int, r: int, s: int, qx: int, qy: int) -> bool:
    """Host admission: r, s ranges, low-S, Q's coordinates in range and
    not the (0, 0) encoding of infinity (on-curve is checked on device)."""
    return (0 < r < N and 0 < s <= HALF_N
            and 0 <= qx < P and 0 <= qy < P and not (qx == 0 and qy == 0))


def stage_frame(items, pad_to: int | None = None) -> np.ndarray:
    """(digest, r, s, qx, qy) int tuples → the [pad_to, 98] int16 launch
    frame.  Rejected and padding rows stay all-zero (pre_ok 0)."""
    items = list(items)
    n = len(items)
    Bp = n if pad_to is None else pad_to
    frame = np.zeros((Bp, FRAME_COLS), np.int16)
    if not n:
        return frame
    pre_ok = [admit(*it) for it in items]
    ss = [it[2] if ok else 1 for it, ok in zip(items, pre_ok)]
    s_inv = _batch_inv_mod_n(ss)
    rows = [i for i, ok in enumerate(pre_ok) if ok]
    if not rows:
        return frame
    cols = [[], [], [], [], [], []]
    rpn_ok = []
    for i in rows:
        e, r, s, qx, qy = items[i]
        si = s_inv[i]
        rp = r + N
        rpn_ok.append(rp < P)
        for c, v in zip(cols, (qx, qy, r, rp if rp < P else 0,
                               (e * si) % N, (r * si) % N)):
            c.append(v)
    idx = np.asarray(rows)
    for k, c in enumerate(cols):
        frame[idx, k * _PK_LIMBS:(k + 1) * _PK_LIMBS] = _limbs16(c)
    frame[idx, _RPN_OK] = np.asarray(rpn_ok, np.int16)
    frame[idx, _PRE_OK] = 1
    return frame


# ---------------------------------------------------------------------------
# Plain version (torch ops)


@lru_cache(maxsize=None)
def _plain_consts(device: torch.device):
    """Montgomery-form constants as fp256 limbs: b, 1, and the affine
    u1*G window table TG[d] = d*G (d = 1..15; slot 0 unused)."""
    tg = [[0, 0]]
    for d in range(1, 16):
        x, y = ec_ref.pt_mul(d, (GX, GY))
        tg.append([(x * fp256.R) % P, (y * fp256.R) % P])
    flat = fp256.ints_to_limbs([v for pt in tg for v in pt], device)
    return (fp256.const((B_COEF * fp256.R) % P, device),
            fp256.const(fp256.R_MOD_P, device),
            flat.reshape(16, 2, fp256.LIMBS))


def pt_add(p1, p2, b):
    """RCB16 algorithm 4 (complete projective addition, a = -3) in three
    stacked multiplication stages: the reference's op schedule."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    mm = fp256.mul_many
    t0, t1, t2, s1, s2, s3 = mm(
        [(X1, X2), (Y1, Y2), (Z1, Z2),
         (X1 + Y1, X2 + Y2), (Y1 + Z1, Y2 + Z2), (X1 + Z1, X2 + Z2)])
    t3 = s1 - (t0 + t1)
    t4 = s2 - (t1 + t2)
    y3a = s3 - (t0 + t2)
    bz, by = mm([(b, t2), (b, y3a)])
    x3b = 3 * (y3a - bz)
    z3a = t1 - x3b
    x3c = t1 + x3b
    t2b = 3 * t2
    y3c = 3 * (by - t2b - t0)
    t0c = 3 * t0 - t2b
    m1, m2, m3, m4, m5, m6 = mm(
        [(t4, y3c), (t0c, y3c), (x3c, z3a), (t3, x3c), (t4, z3a), (t3, t0c)])
    return (m4 - m1, m3 + m2, m5 + m6)


def pt_add_mixed(p1, x2, y2, b):
    """RCB16 algorithm 5 (Z2 = 1): P2 affine and never infinity."""
    X1, Y1, Z1 = p1
    mm = fp256.mul_many
    t0, t1, s1, myz, mxz, bz1 = mm(
        [(X1, x2), (Y1, y2), (x2 + y2, X1 + Y1), (y2, Z1), (x2, Z1), (b, Z1)])
    t3 = s1 - (t0 + t1)
    t4 = myz + Y1
    y3a = mxz + X1
    x3b = 3 * (y3a - bz1)
    z3a = t1 - x3b
    x3c = t1 + x3b
    (by,) = mm([(b, y3a)])
    t2b = 3 * Z1
    y3c = 3 * (by - t2b - t0)
    t0c = 3 * t0 - t2b
    m1, m2, m3, m4, m5, m6 = mm(
        [(t4, y3c), (t0c, y3c), (x3c, z3a), (t3, x3c), (t4, z3a), (t3, t0c)])
    return (m4 - m1, m3 + m2, m5 + m6)


def pt_double(p, b):
    """RCB16 algorithm 6 (a = -3): 6 + 2 + 5 products in three stages."""
    X, Y, Z = p
    mm = fp256.mul_many
    t0, t1, t2, xy, xz, yz = mm([(X, X), (Y, Y), (Z, Z), (X, Y), (X, Z), (Y, Z)])
    t3 = 2 * xy
    zz2 = 2 * xz
    bt2, bz = mm([(b, t2), (b, zz2)])
    y3b = 3 * (bt2 - zz2)
    x3a = t1 - y3b
    y3c = t1 + y3b
    t2b = 3 * t2
    z3b = 3 * (bz - t2b - t0)
    t0c = 3 * t0 - t2b
    yz2 = 2 * yz
    y3m, x3m, a1, a2, a3 = mm(
        [(x3a, y3c), (x3a, t3), (t0c, z3b), (yz2, z3b), (yz2, t1)])
    return (x3m - a2, y3m + a1, 4 * a3)


def recode_windows(limbs: torch.Tensor) -> torch.Tensor:
    """[B, 16] big-endian 16-bit limbs (any int dtype) → [B, 64] int64
    window digits, MSB-first (``device_recode_windows``)."""
    l = limbs.to(torch.int64) & 0xFFFF
    sh = torch.tensor([12, 8, 4, 0], dtype=torch.int64, device=l.device)
    return ((l.unsqueeze(-1) >> sh) & 0xF).reshape(*limbs.shape[:-1], STEPS)


def verify_batch_ref(frame: torch.Tensor) -> torch.Tensor:
    """Plain version of the verify kernel: [B, 98] int16 frame → [B] bool."""
    dev = frame.device
    f = frame.to(torch.int64) & 0xFFFF

    def col(k):  # big-endian 16-bit limbs → little-endian fp256 limbs
        return f[:, k * _PK_LIMBS:(k + 1) * _PK_LIMBS].flip(-1)

    qx, qy, rr, rpn = col(0), col(1), col(2), col(3)
    w1 = recode_windows(f[:, 4 * _PK_LIMBS:5 * _PK_LIMBS])
    w2 = recode_windows(f[:, 5 * _PK_LIMBS:6 * _PK_LIMBS])
    rpn_ok = f[:, _RPN_OK] != 0
    pre_ok = f[:, _PRE_OK] != 0
    B = f.shape[0]
    b_c, one_c, tg = _plain_consts(dev)
    b = b_c.expand(B, -1)
    one = one_c.expand(B, -1)
    r2 = fp256.const(fp256.R2, dev).expand(B, -1)
    zero = torch.zeros_like(one)

    qx_m, qy_m = fp256.mul_many([(qx, r2), (qy, r2)])
    y2, x2 = fp256.mul_many([(qy_m, qy_m), (qx_m, qx_m)])
    (x3,) = fp256.mul_many([(x2, qx_m)])
    on_curve = fp256.eq(y2, x3 + b - 3 * qx_m)

    q1 = (qx_m, qy_m, one)
    table = [(zero, one, zero), q1]
    acc = q1
    for _ in range(2, 16):
        acc = pt_add(acc, q1, b)
        table.append(acc)
    tq = torch.stack([torch.stack(pt, dim=1) for pt in table], dim=1)  # [B,16,3,L]

    lanes = torch.arange(B, device=dev)
    X, Y, Z = zero, one, zero
    for i in range(STEPS):
        R = (X, Y, Z)
        for _ in range(WINDOW):
            R = pt_double(R, b)
        sel = tq[lanes, w2[:, i]]
        R = pt_add(R, (sel[:, 0], sel[:, 1], sel[:, 2]), b)
        g = tg[w1[:, i]]
        Rg = pt_add_mixed(R, g[:, 0], g[:, 1], b)
        skip = (w1[:, i] == 0).unsqueeze(-1)
        X, Y, Z = (torch.where(skip, a, c) for a, c in zip(R, Rg))

    not_inf = ~fp256.is_zero(Z)
    r_m, rpn_m = fp256.mul_many([(rr, r2), (rpn, r2)])
    rz, rpnz = fp256.mul_many([(r_m, Z), (rpn_m, Z)])
    cmp1 = fp256.eq(X, rz)
    cmp2 = fp256.eq(X, rpnz) & rpn_ok
    return pre_ok & on_curve & not_inf & (cmp1 | cmp2)


# ---------------------------------------------------------------------------
# Kernel wrapper


@lru_cache(maxsize=None)
def _kernel_consts(device: torch.device) -> torch.Tensor:
    """The kernel's constant block as int32 bit patterns of uint32
    little-endian limbs: R^2 | b*R | R | TG[16][2] (TG[0] = 0)."""
    vals = [fp256.R2, (B_COEF * fp256.R) % P, fp256.R_MOD_P]
    vals.append(0)
    vals.append(0)
    for d in range(1, 16):
        x, y = ec_ref.pt_mul(d, (GX, GY))
        vals += [(x * fp256.R) % P, (y * fp256.R) % P]
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    arr = np.frombuffer(raw, "<u4").view(np.int32).copy()
    return torch.from_numpy(arr).to(device)


def verify_batch_packed(frame: torch.Tensor) -> torch.Tensor:
    """[B, 98] int16 launch frame → [B] bool accept bits.  A CPU frame
    runs ``verify_batch_ref``; a CUDA frame launches the kernel."""
    if frame.dtype != torch.int16 or frame.dim() != 2 or frame.shape[1] != FRAME_COLS:
        raise ValueError(f"expected an int16 [B, {FRAME_COLS}] frame, "
                         f"got {frame.dtype} {tuple(frame.shape)}")
    if frame.device.type == "cpu":
        return verify_batch_ref(frame)
    return kernels.p256_verify(frame.contiguous(), _kernel_consts(frame.device))


# ---------------------------------------------------------------------------
# Launch API


class VerifyHandle:
    """An in-flight verify batch: the device-resident accept vector
    (``device_out``, bool, padded to the bucket) and ``fetch()``, which
    syncs and returns the first ``n_real`` bits."""

    __slots__ = ("device_out", "n_real")

    def __init__(self, device_out: torch.Tensor, n_real: int):
        self.device_out = device_out
        self.n_real = n_real

    def fetch(self) -> list[bool]:
        return self.device_out[: self.n_real].to("cpu").tolist()

    def __call__(self) -> list[bool]:
        return self.fetch()


def verify_launch(items, device="cuda") -> VerifyHandle:
    """Stage (digest, r, s, qx, qy) tuples and launch the verify kernel
    without waiting: one launch over the whole bucketed batch."""
    dev = resolve_device(device)
    items = list(items)
    n = len(items)
    if not n:
        return VerifyHandle(torch.zeros(0, dtype=torch.bool, device=dev), 0)
    frame = stage_frame(items, _bucket(n))
    return VerifyHandle(verify_batch_packed(torch.from_numpy(frame).to(dev)), n)


def verify_launch_many(batches, device="cuda") -> list[VerifyHandle]:
    """Several blocks' signature batches as ONE launch.  Block b keeps
    the lane layout a solo launch would give it — lanes
    [off_b, off_b + _bucket(n_b)) — so each handle's ``device_out`` is a
    slice; the total pads out to ``_bucket(sum of buckets)``."""
    dev = resolve_device(device)
    batches = [list(b) for b in batches]
    offs, total = [], 0
    for b in batches:
        offs.append(total)
        total += _bucket(len(b)) if b else 0
    if not total:
        return [VerifyHandle(torch.zeros(0, dtype=torch.bool, device=dev), 0)
                for _ in batches]
    grand = _bucket(total)
    frame = np.zeros((grand, FRAME_COLS), np.int16)
    for off, b in zip(offs, batches):
        if b:
            frame[off:off + _bucket(len(b))] = stage_frame(b, _bucket(len(b)))
    out = verify_batch_packed(torch.from_numpy(frame).to(dev))
    return [
        VerifyHandle(out[off:off + _bucket(len(b))], len(b)) if b
        else VerifyHandle(torch.zeros(0, dtype=torch.bool, device=dev), 0)
        for off, b in zip(offs, batches)
    ]


def verify_host(items, device="cuda") -> list[bool]:
    """Synchronous verify: same accept set as ``ec_ref.verify_digest``."""
    return verify_launch(items, device=device).fetch()
