"""256-bit Montgomery arithmetic mod the P-256 prime in torch ops — the
field core of the plain verify (counterpart: ``fabric_tpu/ops/rns.py``).

The JAX package works in a residue number system because the TPU's
matrix unit turns RNS base extension into a bf16 matmul.  The CUDA
kernel (``kernels/csrc/p256_verify.cu``) drops RNS for eight 32-bit
positional limbs; this plain version keeps the same Montgomery domain
(R = 2^256, so every Montgomery-form constant is shared with the
kernel) on sixteen 16-bit limbs held in int64, little-endian.

Representation.  A field element is a ``[..., 16]`` int64 tensor of
*signed* limbs whose value ``sum(limb_k * 2^(16k))`` is congruent to
the element mod p.  ``add``/``sub``/small multiples are single limb-wise
ops; ``mont_mul`` returns the "reduced form" with every limb in
[-2^7, 2^16 + 2^7].  Inputs to ``mont_mul`` may be sums of up to 15
reduced-form values (|limb| < 2^20, the most any RCB formula of
``ops/p256v3.py`` builds); the exactness argument below needs
|a_i| * |b_j| * 16 < 2^53.

``mont_mul(a, b)`` = a * b * 2^-256 mod p, exactly, in four steps:
1. the 31-column product polynomial, as one float64 matmul of the outer
   product against a 0/1 summing matrix (every partial sum is an
   integer below 2^53, so float64 is exact — and a float64 matmul is
   what both the CPU and the card run fast; int64 matmul is not
   supported on CUDA);
2. two carry passes bring the columns to limbs in (-2^12, 2^16 + 2^12)
   over 33 limbs, value unchanged;
3. Montgomery reduction is linear in the limbs: column m contributes
   limb_m * (2^(16m) * 2^-256 mod p), so one float64 matmul against the
   precomputed [33, 16] table (balanced limbs, |entry| <= 2^15, partial
   sums < 2^37) gives 16 limbs congruent to a*b*2^-256;
4. two cyclic carry passes fold the carry out of limb 15 back with
   2^256 = 2^224 - 2^192 - 2^96 + 1 (mod p).

``canon`` gives the canonical limbs of the value mod p; comparisons go
through it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from fabric_tpu_torch.crypto import ec_ref

P = ec_ref.P
LIMBS = 16
MASK = 0xFFFF
R = 1 << 256
R_MOD_P = R % P           # Montgomery form of 1
R2 = (R * R) % P          # to_mont multiplier
RINV = pow(R, -1, P)


def ints_to_limbs(xs, device="cpu") -> torch.Tensor:
    """[n] ints in [0, 2^256) → [n, 16] int64 little-endian 16-bit limbs."""
    raw = b"".join(int(x).to_bytes(32, "little") for x in xs)
    arr = np.frombuffer(raw, "<u2").reshape(len(xs), LIMBS).astype(np.int64)
    return torch.from_numpy(arr).to(device)


def limbs_to_ints(t: torch.Tensor) -> list[int]:
    """[n, 16] signed limbs → their exact (unreduced) integer values."""
    out = []
    for row in t.to("cpu").tolist():
        v = 0
        for k in range(LIMBS - 1, -1, -1):
            v = (v << 16) + row[k]
        out.append(v)
    return out


def _balanced(v: int, n: int = LIMBS) -> list[int]:
    """v (|v| <= p/2) → n digits in (-2^15, 2^15] with sum d_k 2^(16k) == v."""
    ds = []
    for _ in range(n):
        d = v & MASK
        if d > 0x8000:
            d -= 0x10000
        ds.append(d)
        v = (v - d) >> 16
    if v != 0:
        raise ValueError("value does not fit the balanced digits")
    return ds


@lru_cache(maxsize=None)
def _tables(device: torch.device):
    """Per-device constants: the column-summing matrix, the linear
    Montgomery-reduction table, the cyclic carry fold and p's limbs."""
    S = torch.zeros(LIMBS * LIMBS, 2 * LIMBS - 1, dtype=torch.float64)
    for i in range(LIMBS):
        for j in range(LIMBS):
            S[i * LIMBS + j, i + j] = 1.0
    K = []
    for m in range(2 * LIMBS + 1):
        c = (pow(2, 16 * m, P) * RINV) % P
        if c > P // 2:
            c -= P
        K.append(_balanced(c))
    K = torch.tensor(K, dtype=torch.float64)
    fold = torch.zeros(LIMBS, dtype=torch.int64)
    fold[6], fold[12], fold[14] = -1, -1, 1  # limb 0's +1 rides the roll
    p17 = torch.tensor(
        [(P >> (16 * k)) & MASK for k in range(LIMBS)] + [0], dtype=torch.int64
    )
    return S.to(device), K.to(device), fold.to(device), p17.to(device)


def const(x: int, device) -> torch.Tensor:
    """A constant in [0, 2^256) as [16] canonical limbs on ``device``."""
    return ints_to_limbs([x], device)[0]


def _carry_cyclic(u: torch.Tensor) -> torch.Tensor:
    """One carry pass over 16 limbs; the carry out of limb 15 (weight
    2^256) folds back as 2^224 - 2^192 - 2^96 + 1.  Value mod p kept."""
    _, _, fold, _ = _tables(u.device)
    c = u >> 16
    u = (u & MASK) + torch.roll(c, 1, dims=-1)
    return u + c[..., -1:] * fold


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod p in reduced form (see the module docstring)."""
    S, K, _, _ = _tables(a.device)
    lead = a.shape[:-1]
    prod = a.to(torch.float64).unsqueeze(-1) * b.to(torch.float64).unsqueeze(-2)
    col = (prod.reshape(*lead, LIMBS * LIMBS) @ S).to(torch.int64)
    col = torch.nn.functional.pad(col, (0, 2))
    for _ in range(2):
        c = col >> 16
        col = col & MASK
        col[..., 1:] += c[..., :-1]
    u = (col.to(torch.float64) @ K).to(torch.int64)
    return _carry_cyclic(_carry_cyclic(u))


def mul_many(pairs) -> list[torch.Tensor]:
    """Independent products of one formula stage as ONE stacked call."""
    if len(pairs) == 1:
        return [mont_mul(*pairs[0])]
    a = torch.cat([x for x, _ in pairs])
    b = torch.cat([y for _, y in pairs])
    return list(torch.split(mont_mul(a, b), pairs[0][0].shape[0]))


def _ripple(u: torch.Tensor) -> torch.Tensor:
    """Exact sequential carry over the last axis (17 limbs): every limb
    but the top lands in [0, 2^16)."""
    u = u.clone()
    for k in range(u.shape[-1] - 1):
        c = u[..., k] >> 16
        u[..., k] &= MASK
        u[..., k + 1] += c
    return u


def canon(x: torch.Tensor) -> torch.Tensor:
    """Canonical limbs (each in [0, 2^16)) of the value mod p, for
    inputs of up to 15 summed reduced-form values."""
    _, _, _, p17 = _tables(x.device)
    u = _carry_cyclic(_carry_cyclic(x))
    # value now in (-2^248, 2^256 * 1.002); adding p makes it positive
    u = _ripple(torch.nn.functional.pad(u, (0, 1)) + p17)
    for _ in range(3):  # value < 3p: three conditional subtractions
        d = _ripple(u - p17)
        u = torch.where((d[..., -1:] < 0), u, d)
    return u[..., :LIMBS]


def is_zero(x: torch.Tensor) -> torch.Tensor:
    return (canon(x) == 0).all(dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return is_zero(a - b)


def to_mont(x: torch.Tensor) -> torch.Tensor:
    return mont_mul(x, const(R2, x.device).expand_as(x))


def from_mont(x: torch.Tensor) -> torch.Tensor:
    return canon(mont_mul(x, const(1, x.device).expand_as(x)))
