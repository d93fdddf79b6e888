"""Batched ECDSA-P256 verification (counterpart: ``fabric_tpu/ops/p256v3.py``).

What it computes is the reference accept set (bccsp/sw/ecdsa.go:41-58):
r, s in [1, n-1], s <= n/2 (low-S), Q on the curve and not infinity,
R = u1*G + u2*Q not infinity, x(R) = r (mod n).  The schedule is the JAX
kernel's: a 16-entry u2*Q window table, 64 steps of [4 complete
doublings + add T_Q[w2] + mixed add T_G[w1], skipped at digit 0] with
the Renes-Costello-Batina complete formulas (a = -3), and the final
X = r*Z or (r+n)*Z (mod p) compare.

Host staging (admission checks, one Montgomery batch inversion for
s^-1, u1/u2) is one call into the port's copy of the reference's
``native/ecprep.cpp`` (``stage_frame``); ``stage_frame_ref`` is its
plain version, the JAX package's Python staging.  The launch frame is
the port's own: it drops the TPU's RNS residues for 16-bit big-endian
positional limbs, one int16 row per signature:

    qx | qy | r | r+n | u1 | u2   (16 limbs each)  | rpn_ok | pre_ok

so ``FRAME_COLS`` = 98.  The kernel recodes the 4-bit windows from the
u1/u2 limbs itself (``device_recode_windows`` in the reference).  A
batch arrives as (digest, r, s, qx, qy) int tuples, packed into 32-byte
rows for the C call, or as ``SigColumns``, the rows the validator
gathers from a wire block (the reference's ``ColumnarSigBatch``).

``verify_batch_packed`` is the kernel wrapper: a CPU frame runs the
plain version ``verify_batch_ref`` (torch ops over ``ops/fp256.py``), a
CUDA frame launches ``kernels/csrc/p256_verify.cu``.

Telemetry (the reference's :1011-1093, :1330-1342): each launch opens a
``verify`` record on the launch ledger (``observe/ledger.py``), notes the
frame's bytes, re-anchors at the copy to the card and marks the
dispatch; ``VerifyHandle.fetch`` brackets its copy to the host (a
coalesced launch's record rides the first live block's handle).  On the
card the record's cache verdict is the kernel's first launch in the
process; on the CPU it is the reference's first sight of the bucket.
The copy and the launch run inside the ``fabtpu.verify_dispatch``
annotation; ``h2d_bytes_per_block`` and ``coalesced_blocks_per_launch``
go to the registry.

Chunked verify (the reference's :1103-1180, :1247, :1358):
``verify_launch(chunk=)`` and ``verify_launch_many(chunk=)`` split a
batch into ``_chunk_bounds`` microbatches, each one ``p256_verify``
launch on the current stream writing its slice of ONE device-resident
output vector: every chunk but the last is exactly ``chunk`` lanes and
the last pads the total to ``_bucket(n)``, so item i sits at index i as
in a monolithic launch.  On the card every frame, chunked or not, is
staged into pinned host memory (PyTorch's caching host allocator) and
copied with ``non_blocking=True``, so staging chunk k+1 overlaps chunk k's copy and
kernel; with a host pool, chunk k+1 is staged on a worker meanwhile
(the reference's one-chunk lookahead).  A chunked batch observes
``verify_chunk_stage_seconds`` and ``verify_chunks_per_batch``, adds one
``verify_chunk`` span a chunk, and keeps one ledger record with each
chunk's bytes noted.  A failed chunk launch raises.
"""

from __future__ import annotations

import time
from functools import lru_cache

import numpy as np
import torch

from fabric_tpu_torch import faults, kernels, native
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.device import resolve_device
from fabric_tpu_torch.observe import device_annotation, global_tracer
from fabric_tpu_torch.observe import ledger as _ledger
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


_R256 = 1 << 256


def pack256(vals) -> tuple[np.ndarray, np.ndarray]:
    """Ints → ([n, 32] uint8 big-endian rows, [n] bool in [0, 2^256));
    a value out of range packs as 0."""
    vals = list(vals)
    n = len(vals)
    try:
        raw = b"".join([v.to_bytes(32, "big") for v in vals])
        ok = np.ones(n, bool)
    except (OverflowError, AttributeError, TypeError):
        vals = [int(v) for v in vals]
        ok = np.array([0 <= v < _R256 for v in vals], bool)
        raw = b"".join([(v if 0 <= v < _R256 else 0).to_bytes(32, "big") for v in vals])
    return np.frombuffer(raw, np.uint8).reshape(n, 32), ok


def q_admit(q_pool: np.ndarray) -> np.ndarray:
    """[k, 64] public keys (qx || qy, big-endian) → [k] bool: both
    coordinates below p and not (0, 0) (one C call)."""
    q_pool = np.ascontiguousarray(q_pool, np.uint8)
    ok = np.zeros(len(q_pool), np.uint8)
    if len(q_pool):
        native.lib("ecprep").ec_q_admit(native.ptr(q_pool), len(q_pool), native.ptr(ok))
    return ok.astype(bool)


class SigColumns:
    """A signature batch in column form (the reference's
    ``ColumnarSigBatch``): digest, r and s as [k, 32] big-endian rows,
    each row's public key a row of ``q_pool`` ([u, 64], qx || qy) picked
    by ``q_idx``, with that key's admission ``q_ok``; ``idents[u]`` is
    the identity of pool row u.  The int tuples in ``extra`` follow the
    rows (the validator's envelopes that took the front end).
    Iterating gives (digest, r, s, qx, qy) int tuples, for the
    comparison kernels and the sidecar."""

    __slots__ = ("digest_b", "r_b", "s_b", "q_idx", "q_pool", "q_ok", "idents", "extra")

    def __init__(self, digest_b, r_b, s_b, q_idx, q_pool, q_ok, idents):
        self.digest_b, self.r_b, self.s_b = digest_b, r_b, s_b
        self.q_idx, self.q_pool, self.q_ok, self.idents = q_idx, q_pool, q_ok, idents
        self.extra: list = []

    def __len__(self) -> int:
        return len(self.digest_b) + len(self.extra)

    def __iter__(self):
        big = lambda a: [int.from_bytes(a[i].tobytes(), "big") for i in range(len(a))]
        es, rs, ss = big(self.digest_b), big(self.r_b), big(self.s_b)
        for j, u in enumerate(self.q_idx.tolist()):
            ident = self.idents[u]
            yield es[j], rs[j], ss[j], ident.qx, ident.qy
        yield from self.extra

    def columns(self):
        """→ (digest, r, s [B, 32] uint8; q_idx [B] int32; q_pool
        [u, 64] uint8; q_ok [u] uint8), the tuples appended."""
        if not self.extra:
            return (self.digest_b, self.r_b, self.s_b, self.q_idx, self.q_pool,
                    self.q_ok.astype(np.uint8))
        e, r, s, q, ok = _pack_tuples(self.extra)
        u = len(self.q_pool)
        return (np.concatenate([self.digest_b, e]), np.concatenate([self.r_b, r]),
                np.concatenate([self.s_b, s]),
                np.concatenate([self.q_idx, np.arange(u, u + len(e), dtype=np.int32)]),
                np.concatenate([self.q_pool, q]),
                np.concatenate([self.q_ok, ok]).astype(np.uint8))


def _pack_tuples(items):
    """Int tuples → (digest, r, s [B, 32]; q [B, 64]; q_ok [B] bool).
    A digest outside [0, 2^256) packs reduced mod n (u1 is unchanged);
    any other value out of range rejects its row through q_ok."""
    es = [it[0] for it in items]
    e_b, e_in = pack256(es)
    if not e_in.all():
        e_b, _ = pack256([int(v) % N for v in es])
    r_b, r_in = pack256([it[1] for it in items])
    s_b, s_in = pack256([it[2] for it in items])
    qx_b, qx_in = pack256([it[3] for it in items])
    qy_b, qy_in = pack256([it[4] for it in items])
    q = np.concatenate([qx_b, qy_b], axis=1)
    return e_b, r_b, s_b, q, q_admit(q) & r_in & s_in & qx_in & qy_in


def _frame_cols(items):
    """(digest, r, s, qx, qy) int tuples or ``SigColumns`` → the
    columns ``_stage_rows`` reads: (digest, r, s [B, 32] uint8; q_idx
    [B] int32; q_pool [u, 64] uint8; q_ok [u] uint8)."""
    if isinstance(items, SigColumns):
        return items.columns()
    items = list(items)
    e_b, r_b, s_b, q_pool, ok = _pack_tuples(items)
    return e_b, r_b, s_b, np.arange(len(items), dtype=np.int32), q_pool, ok.astype(np.uint8)


def _stage_rows(cols, lo: int, hi: int, frame: np.ndarray) -> None:
    """Rows [lo, hi) of a column set → ``frame[:hi - lo]``, in one C
    call (``native/ecprep.cpp``; its batch inversion covers these rows
    only).  The caller zeroes the frame: rejected and padding rows stay
    all-zero (pre_ok 0)."""
    n = hi - lo
    if n <= 0:
        return
    e_b, r_b, s_b, q_idx, q_pool, q_ok = cols
    p = native.ptr
    arrs = [np.ascontiguousarray(a) for a in (e_b[lo:hi], r_b[lo:hi], s_b[lo:hi],
                                              q_idx[lo:hi], q_pool, q_ok)]
    native.lib("ecprep").ec_stage_frame(*(p(a) for a in arrs), n, p(frame), FRAME_COLS)


def stage_frame(items, pad_to: int | None = None) -> np.ndarray:
    """(digest, r, s, qx, qy) int tuples or ``SigColumns`` → the
    [pad_to, 98] int16 launch frame, in one C call
    (``native/ecprep.cpp``).  Rejected and padding rows stay all-zero
    (pre_ok 0)."""
    cols = _frame_cols(items)
    n = len(cols[0])
    if pad_to is not None and pad_to < n:  # the C call writes every item's row
        raise ValueError(f"pad_to={pad_to} is below the {n} items")
    frame = np.zeros((n if pad_to is None else pad_to, FRAME_COLS), np.int16)
    _stage_rows(cols, 0, n, frame)
    return frame


def stage_frame_ref(items, pad_to: int | None = None) -> np.ndarray:
    """Plain version of ``stage_frame`` (int tuples only): admission,
    ``_batch_inv_mod_n`` and the limbs with Python ints."""
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


def verify_batch_packed(frame: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """[B, 98] int16 launch frame → [B] bool accept bits, written into
    ``out`` (a [B] bool tensor, e.g. a slice of a larger vector) when
    given.  A CPU frame runs ``verify_batch_ref``; a CUDA frame launches
    the kernel."""
    if frame.dtype != torch.int16 or frame.dim() != 2 or frame.shape[1] != FRAME_COLS:
        raise ValueError(f"expected an int16 [B, {FRAME_COLS}] frame, "
                         f"got {frame.dtype} {tuple(frame.shape)}")
    if frame.device.type == "cpu":
        res = verify_batch_ref(frame)
        if out is None:
            return res
        out.copy_(res)
        return out
    consts = _kernel_consts(frame.device)
    if out is None:
        return kernels.p256_verify(frame.contiguous(), consts)
    return kernels.p256_verify(frame.contiguous(), consts, out=out)


# ---------------------------------------------------------------------------
# Launch API




def _h2d_hist():
    from fabric_tpu_torch.ops_metrics import global_registry

    return global_registry().histogram(
        "h2d_bytes_per_block",
        "packed verify-batch H2D bytes per launch",
        buckets=(1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22,
                 float("inf")),
    )


def _coalesce_metric():
    from fabric_tpu_torch.ops_metrics import global_registry

    return global_registry().histogram(
        "coalesced_blocks_per_launch",
        "signature batches (blocks) concatenated per verify dispatch",
        buckets=(1, 2, 3, 4, 6, 8, float("inf")),
    )


def _chunk_metrics():
    from fabric_tpu_torch.ops_metrics import global_registry

    reg = global_registry()
    return (
        reg.histogram(
            "verify_chunk_stage_seconds",
            "per-chunk host staging / dispatch time (s)",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, float("inf")),
        ),
        reg.histogram(
            "verify_chunks_per_batch",
            "microbatch chunks per verify batch",
            buckets=(1, 2, 4, 8, 16, 32, float("inf")),
        ),
    )


class VerifyHandle:
    """An in-flight verify batch: the device-resident accept vector
    (``device_out``, bool, padded to the bucket) and ``fetch()``, which
    syncs and returns the first ``n_real`` bits.  ``rec``: the launch
    ledger's record, which ``fetch`` brackets."""

    __slots__ = ("device_out", "n_real", "rec")

    def __init__(self, device_out: torch.Tensor, n_real: int, rec=None):
        self.device_out = device_out
        self.n_real = n_real
        self.rec = rec

    def fetch(self) -> list[bool]:
        rec = self.rec
        if rec is not None:
            rec.sync_begin()
        out = self.device_out[: self.n_real].to("cpu")
        if rec is not None:
            rec.sync_end(d2h_bytes=out.nbytes)
        return out.tolist()

    def __call__(self) -> list[bool]:
        return self.fetch()


def _chunk_bounds(n_real: int, chunk: int) -> list[tuple[int, int, int]]:
    """[(lo, hi, pad)] microbatch slicing (the reference's): every chunk
    except the last is exactly ``chunk`` lanes and the last pads the
    total out to ``_bucket(n_real)``, so item i sits at index i of the
    one output vector (stage 2's gathers need no remapping) and the
    vector keeps a monolithic launch's length."""
    bounds = []
    off = 0
    total = _bucket(n_real)
    while off < n_real:
        k = min(chunk, n_real - off)
        pad = chunk if off + k < n_real else total - off
        bounds.append((off, off + k, pad))
        off += k
    return bounds


def _host_frame(dev: torch.device, rows: int):
    """A zeroed [rows, 98] int16 host frame: pinned memory for a copy
    to the card, a plain tensor on the CPU.  The pinned block comes from
    PyTorch's caching host allocator, which hands it out again only once
    the ``non_blocking`` copy that read it has completed."""
    return torch.zeros((rows, FRAME_COLS), dtype=torch.int16,
                       pin_memory=dev.type == "cuda")


def _launch(stage, n: int, chunk: int, dev: torch.device, pool=None) -> tuple:
    """Launch ``p256_verify`` over ``n`` lanes → (ONE device-resident
    bool vector of ``_bucket(n)`` lanes, its ledger record or None).
    With ``chunk`` (and more than ``chunk`` lanes), one launch a
    ``_chunk_bounds`` chunk, in order on the current stream, each
    writing its slice of the vector; else one launch.
    ``stage(lo, hi, pad)`` → a zeroed host frame of ``pad`` rows holding
    lanes [lo, hi); on the card it is pinned and copied with
    ``non_blocking=True``.  With a
    host ``pool``, chunk k+1 is staged on a worker while chunk k is
    copied and launched (the reference's one-chunk lookahead,
    ``_launch_chunked``).  A chunked batch observes the chunk
    histograms and adds one ``verify_chunk`` span a chunk."""
    chunked = bool(chunk) and n > chunk
    bounds = _chunk_bounds(n, chunk) if chunked else [(0, n, _bucket(n))]
    compiled = kernels.first_launch("p256_verify") if dev.type == "cuda" else None
    rec = _ledger.launch("verify", key=(bounds[0][2], True, 0), lanes=n, compiled=compiled)
    # one launch writes its own vector; chunks write slices of one
    out = torch.empty(_bucket(n), dtype=torch.bool, device=dev) if chunked else None
    lookahead = chunked and pool is not None
    nxt = pool.submit(stage, *bounds[0], stage="chunk_stage") if lookahead else None
    hist = _h2d_hist()
    if chunked:
        stage_hist, chunks_hist = _chunk_metrics()
        trc = global_tracer()
    for i, (lo, hi, pad) in enumerate(bounds):
        t0 = time.perf_counter()
        host = nxt.result() if lookahead else stage(lo, hi, pad)
        if lookahead and i + 1 < len(bounds):
            nxt = pool.submit(stage, *bounds[i + 1], stage="chunk_stage")
        nbytes = host.numel() * host.element_size()
        hist.observe(nbytes, recode="device")
        if rec is not None:
            rec.note_h2d(nbytes)
            rec.begin_dispatch()  # the first chunk's staging was host work
        with device_annotation("fabtpu.verify_dispatch"):
            frame = host.to(dev, non_blocking=True) if dev.type == "cuda" else host
            if out is None:
                out = verify_batch_packed(frame)
            else:
                verify_batch_packed(frame, out=out[lo:lo + pad])
        if chunked:
            t1 = time.perf_counter()
            stage_hist.observe(t1 - t0, stage="stage_dispatch")
            trc.add("verify_chunk", t0, t1, chunk=i, lanes=int(hi - lo))
    if chunked:
        chunks_hist.observe(len(bounds))
    if rec is not None:
        rec.dispatched()
    return out, rec


def _empty(dev) -> VerifyHandle:
    return VerifyHandle(torch.zeros(0, dtype=torch.bool, device=dev), 0)


def _chunk_arg(chunk) -> int:
    return max(int(chunk), MIN_BUCKET) if chunk else 0


def verify_launch(items, device="cuda", chunk: int | None = None, pool=None) -> VerifyHandle:
    """Stage (digest, r, s, qx, qy) tuples or ``SigColumns`` and launch
    the verify kernel without waiting: one launch over the whole
    bucketed batch, or with ``chunk`` (at least ``MIN_BUCKET``) one
    launch a chunk of ``_chunk_bounds`` into one output vector; a host
    ``pool`` stages chunk k+1 while chunk k launches.  The accept set is
    the same either way.  Fires the ``p256v3.verify_launch`` fault
    point once a batch."""
    faults.fire("p256v3.verify_launch")
    dev = resolve_device(device)
    if not isinstance(items, SigColumns):
        items = list(items)
    n = len(items)
    if not n:
        return _empty(dev)
    cols = _frame_cols(items)

    def stage(lo, hi, pad):  # each chunk staged from its own rows
        host = _host_frame(dev, pad)
        _stage_rows(cols, lo, hi, host.numpy())
        return host

    out, rec = _launch(stage, n, _chunk_arg(chunk), dev, pool=pool)
    return VerifyHandle(out, n, rec)


def verify_launch_many(batches, device="cuda", chunk: int | None = None,
                       pool=None) -> list[VerifyHandle]:
    """Several blocks' signature batches as ONE launch (or, with
    ``chunk``, one chunked launch sequence over their concatenation).
    Block b keeps the lane layout a solo launch would give it — lanes
    [off_b, off_b + _bucket(n_b)) — so each handle's ``device_out`` is a
    slice; the total pads out to ``_bucket(sum of buckets)``.  One
    ledger record covers the launch, on the first live block's handle.
    Fires the ``p256v3.verify_launch`` fault point once."""
    faults.fire("p256v3.verify_launch")
    dev = resolve_device(device)
    batches = [b if isinstance(b, SigColumns) else list(b) for b in batches]
    offs, total = [], 0
    for b in batches:
        offs.append(total)
        total += _bucket(len(b)) if b else 0
    if not total:
        return [_empty(dev) for _ in batches]
    grand = _bucket(total)
    spans = [(off, off + len(b), _frame_cols(b)) for off, b in zip(offs, batches) if b]
    _coalesce_metric().observe(len(spans))

    def stage(lo, hi, pad):
        # every one of the `grand` lanes counts as real to the chunker
        # (padding rows are zero, pre-rejected), and _bucket(grand) == grand;
        # each block's rows inside [lo, hi) go straight into the frame
        host = _host_frame(dev, pad)
        dst = host.numpy()
        for a, z, cols in spans:
            s, e = max(a, lo), min(z, hi)
            if s < e:
                _stage_rows(cols, s - a, e - a, dst[s - lo:e - lo])
        return host

    out, rec = _launch(stage, grand, _chunk_arg(chunk), dev, pool=pool)
    handles = []
    for off, b in zip(offs, batches):
        if b:
            handles.append(VerifyHandle(out[off:off + _bucket(len(b))], len(b), rec))
            rec = None
        else:
            handles.append(_empty(dev))
    return handles


def verify_host(items, device="cuda") -> list[bool]:
    """Synchronous verify: same accept set as ``ec_ref.verify_digest``."""
    return verify_launch(items, device=device).fetch()
