"""Batched ECDSA-P256 signing, the endorsement lane (counterpart:
``fabric_tpu/ops/p256sign.py``).

R = k·G is a fixed-base scalar multiplication: over a comb table
``T[j][d] = d · 16^(63−j) · G`` (affine, Montgomery form with R = 2^256,
the verify kernel's domain) the ladder is complete mixed adds, one per
nonzero 4-bit digit of k, with no doublings, so the 64 digits may be
summed in C chains whose partial points are then added (``sign_chains``
picks C per batch size; C changes the projective representative, not
the point).  Per batch of B digests:

    host:    k = RFC 6979(d, e); k⁻¹ by one batch inversion mod n;
             k → [B, 16] int16 big-endian limbs (pad lanes k = 1)
    device:  R = k·G → projective (X̃, Z̃), Montgomery form, [B, 2, 8] u32
    host:    x = X̃·Z̃⁻¹ mod p (one batch inversion mod p; the Montgomery
             factors cancel, no from_mont); r = x mod n;
             s = k⁻¹(e + r·d) mod n; low-S

(r, s) is bit-equal to ``ec_ref.SigningKey(d).sign_digest(e)``; a lane
whose r or s comes out 0 (probability ~2^-256) is handed to ``ec_ref``,
which walks to the next RFC 6979 candidate as the oracle does.
``verify_after`` sends the finished batch through ``p256v3.verify_launch``
and refuses a batch with a rejected lane.  The reference's ``chunk``,
``mesh`` and ``pool`` knobs are left out: one launch covers a batch.

``sign_batch_limbs`` is the kernel wrapper: a CPU tensor runs the plain
version ``sign_batch_ref`` (torch ops over ``ops/fp256.py``), a CUDA
tensor launches ``p256_sign`` (``kernels/csrc/p256_sign.cu``).

Telemetry (the reference's :121, :270-290, :385-425): each launch opens a
``sign`` record on the launch ledger (``observe/ledger.py``; on the card
its cache verdict is the kernel's first launch in the process, on the
CPU the reference's first sight of the bucket), inside the
``fabtpu.sign_dispatch`` annotation; ``SignHandle.fetch`` brackets its
copy to the host; the kernel's comb table is the ledger's
``comb_table`` owner once it is on the card.
"""

from __future__ import annotations

import threading
from functools import lru_cache

import numpy as np
import torch

from fabric_tpu_torch import kernels
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.device import resolve_device
from fabric_tpu_torch.observe import device_annotation
from fabric_tpu_torch.observe import ledger as _ledger
from fabric_tpu_torch.ops import fp256, p256v3

P = ec_ref.P
N = ec_ref.N
HALF_N = ec_ref.HALF_N
STEPS = p256v3.STEPS

_COMB: list | None = None
_COMB_LOCK = threading.Lock()


def comb_points() -> list:
    """[64][16] affine points ``d · 16^(63−j) · G`` (None at d = 0), j
    MSB-first like the digits; built once (~1,000 ``ec_ref`` adds)."""
    global _COMB
    with _COMB_LOCK:
        if _COMB is None:
            tab = [None] * STEPS
            base = ec_ref.G  # weight 16^0: the last step
            for step in range(STEPS - 1, -1, -1):
                row, pt = [None], base
                for _ in range(1, 16):
                    row.append(pt)
                    pt = ec_ref.pt_add(pt, base)
                tab[step] = row
                base = pt  # 16 · base: the next, more significant step
            _COMB = tab
        return _COMB


def _mont_ints(points) -> list[int]:
    """Row of points (None → 0, 0) → x·R mod p, y·R mod p interleaved."""
    out = []
    for pt in points:
        out += [0, 0] if pt is None else [(pt[0] * fp256.R) % P, (pt[1] * fp256.R) % P]
    return out


@lru_cache(maxsize=None)
def _kernel_tables(device: torch.device):
    """(constants b·R | R, comb table [64·16·2·8]) as int32 bit patterns
    of uint32 little-endian limbs, on ``device``."""
    def words(vals):
        raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
        return torch.from_numpy(np.frombuffer(raw, "<u4").view(np.int32).copy()).to(device)

    consts = words([(ec_ref.B * fp256.R) % P, fp256.R_MOD_P])
    comb = words([v for row in comb_points() for v in _mont_ints(row)])
    # the ledger's comb_table owner: on the card for the process's life
    _ledger.account_hbm("comb_table", comb.nbytes)
    return consts, comb


@lru_cache(maxsize=None)
def _plain_tables(device: torch.device):
    """(b·R, R, comb table [64, 16, 2, 16]) as fp256 limbs on ``device``."""
    flat = [v for row in comb_points() for v in _mont_ints(row)]
    comb = fp256.ints_to_limbs(flat, device).reshape(STEPS, 16, 2, fp256.LIMBS)
    return (fp256.const((ec_ref.B * fp256.R) % P, device),
            fp256.const(fp256.R_MOD_P, device), comb)


def _words(x: torch.Tensor) -> torch.Tensor:
    """[B, 16] canonical 16-bit limbs → [B, 8] int32 bit patterns of
    the uint32 little-endian words."""
    w = x[:, 0::2] | (x[:, 1::2] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


# the chain counts the kernel takes
CHAINS = (1, 2, 4, 8, 16)


def sign_chains(B: int) -> int:
    """Chains per lane for a B-lane batch: small batches split each
    lane's 64 digit steps to shorten the dependent chain, larger ones
    split less as the card fills.  The kernel runs TPI = 8 threads a
    chain up to 3,072 lanes and 4 above, where 4 chains again lead.
    The switch points come from card runs (``tools/launch_steps.py
    --phase sign_shapes``, PERF.md §6)."""
    if B <= 256:
        return 16
    if B <= 768:
        return 8
    if B <= 1664:
        return 4
    if B <= 3072:
        return 2
    return 4


def sign_batch_ref(limbs: torch.Tensor, chains: int | None = None) -> torch.Tensor:
    """Plain ``p256_sign``: [B, 16] int16 big-endian nonce limbs →
    [B, 2, 8] int32 (X̃, Z̃ of k·G, canonical Montgomery form), in the
    kernel's schedule at ``chains`` chains (``sign_chains(B)`` when
    None): chain c takes digits c·64/C .. (c+1)·64/C − 1, starts from
    its first digit's comb entry (infinity for a zero digit) and mixed-
    adds the rest, a zero digit keeping the point; then adjacent
    partials are summed pairwise by complete adds, log2(C) levels."""
    B = limbs.shape[0]
    C = sign_chains(B) if chains is None else int(chains)
    if C not in CHAINS:
        raise ValueError(f"chains must be one of {CHAINS}, got {C}")
    dev = limbs.device
    S = STEPS // C
    w = p256v3.recode_windows(limbs).reshape(B * C, S)  # row = lane·C + chain
    b_c, one_c, comb = _plain_tables(dev)
    n = B * C
    step0 = (torch.arange(n, device=dev) % C) * S  # each row's first comb step
    b = b_c.expand(n, -1)
    zero = torch.zeros(n, fp256.LIMBS, dtype=torch.int64, device=dev)
    one = one_c.expand(n, -1)
    g = comb[step0, w[:, 0]]  # [n, 2, 16]
    live = (w[:, 0] != 0).unsqueeze(-1)
    X, Y, Z = (torch.where(live, a, c) for a, c in ((g[:, 0], zero), (g[:, 1], one), (one, zero)))
    for s in range(1, S):
        d = w[:, s]
        g = comb[step0 + s, d]
        Rg = p256v3.pt_add_mixed((X, Y, Z), g[:, 0], g[:, 1], b)
        skip = (d == 0).unsqueeze(-1)
        X, Y, Z = (torch.where(skip, a, c) for a, c in zip((X, Y, Z), Rg))
    while C > 1:  # adjacent partials, pairwise
        pairs = [t.reshape(-1, 2, fp256.LIMBS) for t in (X, Y, Z)]
        C //= 2
        X, Y, Z = p256v3.pt_add(tuple(t[:, 0] for t in pairs), tuple(t[:, 1] for t in pairs),
                                b_c.expand(B * C, -1))
    return torch.stack([_words(fp256.canon(X)), _words(fp256.canon(Z))], dim=1)


def sign_batch_limbs(limbs: torch.Tensor) -> torch.Tensor:
    """[B, 16] int16 nonce limbs → [B, 2, 8] int32, at ``sign_chains(B)``
    chains.  A CPU tensor runs ``sign_batch_ref``; a CUDA tensor
    launches the kernel."""
    if limbs.dtype != torch.int16 or limbs.dim() != 2 or limbs.shape[1] != 16:
        raise ValueError(f"expected int16 [B, 16] nonce limbs, got {limbs.dtype} "
                         f"{tuple(limbs.shape)}")
    if limbs.device.type == "cpu":
        return sign_batch_ref(limbs)
    consts, comb = _kernel_tables(limbs.device)
    return kernels.p256_sign(limbs.contiguous(), consts, comb, sign_chains(limbs.shape[0]))


# ---------------------------------------------------------------------------
# Host side


def _batch_inv(xs: list[int], mod: int) -> list[int]:
    """Montgomery's simultaneous inversion mod ``mod``: one pow(., -1)."""
    B = len(xs)
    pref = [1] * (B + 1)
    for i, x in enumerate(xs):
        pref[i + 1] = (pref[i] * x) % mod
    inv_all = pow(pref[B], -1, mod)
    out = [0] * B
    for i in range(B - 1, -1, -1):
        out[i] = (pref[i] * inv_all) % mod
        inv_all = (inv_all * xs[i]) % mod
    return out


def derive_nonces(digests, ds) -> list[int]:
    """Per-lane RFC 6979 nonces for (digest, scalar) pairs."""
    return [ec_ref.rfc6979_k(d, e) for e, d in zip(digests, ds)]


def _to_ints(words: np.ndarray) -> list[int]:
    """[B, 8] uint32 little-endian words → [B] ints."""
    raw = np.ascontiguousarray(words, "<u4").tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") for i in range(len(words))]


class SignHandle:
    """An in-flight sign batch: the device's (X̃, Z̃) and the host
    context that ``fetch()`` needs to finish (r, s)."""

    __slots__ = ("device_out", "n_real", "es", "ds", "k_invs", "verify_after", "rec")

    def __init__(self, device_out, n_real: int, es, ds, k_invs, verify_after: bool = False,
                 rec=None):
        self.device_out = device_out
        self.n_real = n_real
        self.es = es
        self.ds = ds
        self.k_invs = k_invs
        self.verify_after = verify_after
        self.rec = rec  # the launch ledger's record, which fetch brackets

    def fetch(self) -> list[tuple[int, int]]:
        """→ [(r, s)] low-S, bit-equal to the RFC 6979 oracle."""
        if not self.n_real:
            return []
        rec = self.rec
        if rec is not None:
            rec.sync_begin()
        host = self.device_out[:self.n_real].to("cpu")
        if rec is not None:
            rec.sync_end(d2h_bytes=host.nbytes)
        out = host.numpy().view(np.uint32)
        xs, zs = _to_ints(out[:, 0]), _to_ints(out[:, 1])
        if 0 in zs:
            raise ValueError("a sign lane returned the point at infinity")
        z_inv = _batch_inv(zs, P)
        sigs = []
        for e, d, kinv, X, zi in zip(self.es, self.ds, self.k_invs, xs, z_inv):
            r = (X * zi) % P % N
            s = (kinv * (e + r * d)) % N
            if r == 0 or s == 0:
                r, s = ec_ref.SigningKey(d).sign_digest(e)  # next RFC 6979 candidate
            elif s > HALF_N:
                s = N - s
            sigs.append((r, s))
        if self.verify_after:
            _self_check(self.es, self.ds, sigs, self.device_out.device)
        return sigs


@lru_cache(maxsize=64)
def _pub_of(d: int) -> tuple[int, int]:
    return ec_ref.pt_mul(d, ec_ref.G)


def _self_check(es, ds, sigs, device) -> None:
    """Verify-after-sign through ``p256v3.verify_launch``; a rejected
    lane refuses the whole batch."""
    items = [(e, r, s, *_pub_of(d)) for e, d, (r, s) in zip(es, ds, sigs)]
    ok = p256v3.verify_launch(items, device=device).fetch()
    if not all(ok):
        bad = [i for i, v in enumerate(ok) if not v]
        raise RuntimeError(f"verify-after-sign rejected lanes {bad[:8]} "
                           f"({len(bad)}/{len(items)} bad)")


def sign_launch(digests, key, ks=None, verify_after: bool = False,
                device="cuda") -> SignHandle:
    """Stage and launch a sign batch without waiting → ``SignHandle``.

    ``digests``: [B] digest ints (``ec_ref.digest_int``); ``key``: the
    private scalar d, or a [B] list of per-lane scalars; ``ks``:
    explicit nonces (tests and vectors only; RFC 6979 when None)."""
    dev = resolve_device(device)
    digests = [int(e) for e in digests]
    B0 = len(digests)
    if not B0:
        return SignHandle(None, 0, [], [], [])
    ds = [int(key)] * B0 if isinstance(key, int) else [int(d) for d in key]
    if len(ds) != B0:
        raise ValueError("per-lane key list length mismatch")
    if any(not (1 <= d < N) for d in ds):
        raise ValueError("private scalar out of range")
    if ks is None:
        ks = derive_nonces(digests, ds)
    else:
        ks = [int(k) for k in ks]
        if len(ks) != B0:
            raise ValueError("explicit nonce list length mismatch")
        if any(not (1 <= k < N) for k in ks):
            raise ValueError("nonce out of range")
    k_invs = _batch_inv(ks, N)
    limbs = np.zeros((p256v3._bucket(B0), 16), np.int16)
    limbs[:B0] = p256v3._limbs16(ks)
    limbs[B0:, -1] = 1  # pad lanes sign with k = 1
    rec = _ledger.launch("sign", key=(limbs.shape[0], 0), lanes=B0,
                         compiled=kernels.first_launch("p256_sign") if dev.type == "cuda"
                         else None,
                         h2d_bytes=limbs.nbytes)
    with device_annotation("fabtpu.sign_dispatch"):
        out = sign_batch_limbs(torch.from_numpy(limbs).to(dev))
    if rec is not None:
        rec.dispatched()
    return SignHandle(out, B0, digests, ds, k_invs, verify_after=verify_after, rec=rec)


def sign_digests(digests, key, **kw) -> list[tuple[int, int]]:
    """Synchronous ``sign_launch(...).fetch()``."""
    return sign_launch(digests, key, **kw).fetch()


def sign_host(digests, key) -> list[tuple[int, int]]:
    """The serial oracle: per-lane ``ec_ref`` RFC 6979 signing with the
    interface of ``sign_digests``."""
    digests = [int(e) for e in digests]
    ds = [int(key)] * len(digests) if isinstance(key, int) else [int(d) for d in key]
    return [ec_ref.SigningKey(d).sign_digest(e) for e, d in zip(digests, ds)]
