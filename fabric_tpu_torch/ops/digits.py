"""Signed-digit modular arithmetic, the field core of the v2 verifier
(counterpart: ``fabric_tpu/ops/digits.py``).

A value is K = 43 little-endian signed base-2^6 digits (43 * 6 = 258
bits).  Canonical digits are 0..63; intermediates may run negative or
above 63, only the value mod m matters.  ``mul`` is the digit
convolution (column k = sum of a_i * b_(k-i)) followed by a LINEAR
reduction of the 42 high columns: each is cut into three 6-bit chunks
and chunk c of column K + h contributes chunk * (2^(6(K+h+c)) mod m),
whose balanced digits are row c*42 + h of the table ``R`` [126, 43].
Carries follow ``settle``'s fixed schedule (3 rounds of 3 passes and a
chunked fold, then one tidy pass) certified by ``bound_check``: every
column stays under 2^24 in magnitude, so the CUDA kernel
(``kernels/csrc/p256_v2.cu``) computes in int32 exactly.

This plain version works in exact int64 tensors.  The reference's
float32 matmuls were the TPU matrix unit's constraint (exact below
2^24, which is what the certificate bounds); they are not part of what
it computes, so the convolution here is an ``index_add_`` over the
outer product and the reduction a broadcast sum.  ``bound_check`` and
``_settle_bound`` are the reference's numpy interval arithmetic,
unchanged: they certify the schedule the kernel runs.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

W = 6                      # bits per digit
BASE = 1 << W              # 64
DMASK = BASE - 1
K = 43                     # digits per 256-bit value (43*6 = 258 bits)
PRODCOLS = 2 * K - 1       # columns of a KxK digit product
H = PRODCOLS - K           # high columns folded by the reduction (42)

SETTLE_PASSES = 3
SETTLE_ROUNDS = 3

# |a|_inf * |b|_inf * K < 2^24 keeps every column in range; SETTLED <= 96
# is certified by bound_check()
SETTLED_MAX = 96
assert (6 * SETTLED_MAX) ** 2 * K < 1 << 24


def int_to_digits(x: int) -> np.ndarray:
    return np.array([(x >> (W * i)) & DMASK for i in range(K)], np.int64)


def ints_to_digits(xs) -> np.ndarray:
    """[n] ints (reduced mod 2^258 by the caller) → [n, K] int64 digits."""
    if not len(xs):
        return np.zeros((0, K), np.int64)
    return np.stack([int_to_digits(int(x)) for x in xs])


def digits_to_int(row) -> int:
    return sum(int(d) << (W * i) for i, d in enumerate(np.asarray(row).tolist()))


def _balanced_digits(x: int, n: int) -> np.ndarray:
    """n signed digits in [-32, 32] representing x."""
    out = np.zeros(n, np.int64)
    for i in range(n):
        d = x & DMASK
        if d > BASE // 2:
            d -= BASE
        out[i] = d
        x = (x - d) >> W
    assert x == 0, "balanced_digits overflow"
    return out


@lru_cache(maxsize=None)
def _conv_index(device: torch.device) -> torch.Tensor:
    """[K*K] column index i + j of product term (i, j)."""
    i = torch.arange(K, device=device)
    return (i.unsqueeze(1) + i.unsqueeze(0)).reshape(K * K)


class DigitMod:
    """Reduction and fold tables for one modulus m < 2^257."""

    def __init__(self, m: int):
        self.m = m
        self.digits_np = int_to_digits(m)
        R = np.zeros((3 * H, K), np.int64)
        for k in range(H):
            for c in range(3):
                R[c * H + k] = _balanced_digits(pow(2, W * (K + k + c), m), K)
        self.R_np = R
        self.F_np = np.stack([_balanced_digits(pow(2, W * (K + j), m), K)
                              for j in range(SETTLE_PASSES + 1)])
        self._dev: dict = {}

    def tables(self, device: torch.device):
        """(digits of m, R, F) as int64 tensors on ``device``."""
        t = self._dev.get(device)
        if t is None:
            t = self._dev[device] = tuple(
                torch.from_numpy(a).to(device) for a in (self.digits_np, self.R_np, self.F_np))
        return t

    # -- core ops (all shapes [..., K] int64) -----------------------------

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a*b mod m value-wise; output settled (|d| <= SETTLED_MAX).
        Caller contract: |a|_inf * |b|_inf * K < 2^24."""
        _, R, _ = self.tables(a.device)
        lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        a = a.expand(*lead, K)
        b = b.expand(*lead, K)
        prod = (a.unsqueeze(-1) * b.unsqueeze(-2)).reshape(-1, K * K)
        cols = torch.zeros(prod.shape[0], PRODCOLS, dtype=torch.int64, device=a.device)
        cols.index_add_(1, _conv_index(a.device), prod)
        cols = cols.reshape(*lead, PRODCOLS)
        low, high = cols[..., :K], cols[..., K:]
        chunks = torch.cat([high & DMASK, (high >> W) & DMASK, high >> (2 * W)], dim=-1)
        red = (chunks.unsqueeze(-1) * R).sum(dim=-2)
        return self.settle(low + red)

    def settle(self, t: torch.Tensor) -> torch.Tensor:
        """Carry-normalize (|d| < 2^24) to |d| <= SETTLED_MAX, value
        kept mod m: each pass drops every digit to [0, 63] plus the
        incoming carry, the carry-outs of weight 2^(6K) summed into
        ``top`` fold back chunked through the F rows."""
        _, _, F = self.tables(t.device)
        for _ in range(SETTLE_ROUNDS):
            top = None
            for _p in range(SETTLE_PASSES):
                lo = t & DMASK
                carry = t >> W
                t = lo + torch.nn.functional.pad(carry[..., :-1], (1, 0))
                top = carry[..., -1] if top is None else top + carry[..., -1]
            t0 = (top & DMASK).unsqueeze(-1)
            t1 = ((top >> W) & DMASK).unsqueeze(-1)
            t2 = (top >> (2 * W)).unsqueeze(-1)
            t = t + t0 * F[0] + t1 * F[1] + t2 * F[2]
        lo = t & DMASK
        carry = t >> W
        t = lo + torch.nn.functional.pad(carry[..., :-1], (1, 0))
        return t + carry[..., -1:] * F[0]

    @staticmethod
    def _sweep(t: torch.Tensor):
        """Sequential carry over the digits → (carry out, digits in [0, 63])."""
        carry = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
        out = []
        for k in range(K):
            v = t[..., k] + carry
            out.append(v & DMASK)
            carry = v >> W
        return carry, torch.stack(out, dim=-1)

    def canonical(self, t: torch.Tensor) -> torch.Tensor:
        """Canonical digits of (value mod m): digits in [0, 63], value
        in [0, m)."""
        m_d, _, F = self.tables(t.device)
        t = self.settle(t)
        for _ in range(3):
            over, t = self._sweep(t)
            t = t + over.unsqueeze(-1) * F[0]
        _, t = self._sweep(t)
        for _ in range(4):  # value < 2^258 < 5m for both P-256 moduli
            ge = self._geq(t, m_d)
            t = t - torch.where(ge.unsqueeze(-1), m_d, torch.zeros_like(m_d))
            _, t = self._sweep(t)
        return t

    @staticmethod
    def _geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a >= b over canonical digit arrays (b broadcastable)."""
        b = b.expand_as(a)
        gt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
        lt = torch.zeros_like(gt)
        for k in range(K - 1, -1, -1):
            undecided = ~gt & ~lt
            gt = gt | (undecided & (a[..., k] > b[..., k]))
            lt = lt | (undecided & (a[..., k] < b[..., k]))
        return gt | ~lt

    def eq_zero(self, t: torch.Tensor) -> torch.Tensor:
        """value ≡ 0 (mod m), any representation."""
        return (self.canonical(t) == 0).all(dim=-1)

    # -- bound certification (numpy interval arithmetic) ------------------

    def bound_check(self, a_bound: int = SETTLED_MAX * 3,
                    b_bound: int = SETTLED_MAX * 3) -> int:
        """Interval-arithmetic certificate of the mul+settle schedule:
        every column stays under 2^24 and the settled output meets
        SETTLED_MAX; returns the settled bound."""
        prod = a_bound * b_bound
        assert prod * K < (1 << 24), ("product columns", prod * K)
        colbound = prod * K
        Rabs = np.abs(self.R_np)
        hi_max = colbound >> (2 * W)
        per_digit = (63 * Rabs[:H].sum(axis=0) + 63 * Rabs[H:2 * H].sum(axis=0)
                     + hi_max * Rabs[2 * H:].sum(axis=0))
        worst_col = int(per_digit.max())
        assert worst_col < (1 << 24), ("reduction columns", worst_col)
        t = np.full(K, colbound + worst_col, np.int64)  # low + red
        out = self._settle_bound(t)
        assert out <= SETTLED_MAX, ("settled bound", out)
        return out

    def _settle_bound(self, t) -> int:
        """Interval image of settle() for a per-digit bound vector."""
        Fabs = np.abs(self.F_np)
        for _ in range(SETTLE_ROUNDS):
            top = 0
            for _p in range(SETTLE_PASSES):
                carry = t >> W
                t = np.concatenate([[0], carry[:-1]]) + DMASK
                top = top + int(carry[-1])
            fold = (min(top, DMASK) * Fabs[0] + min(top >> W, DMASK) * Fabs[1]
                    + (top >> (2 * W)) * Fabs[2])
            t = t + fold
        carry = t >> W
        t = np.concatenate([[0], carry[:-1]]) + DMASK
        t = t + int(carry[-1]) * Fabs[0]
        return int(t.max())
