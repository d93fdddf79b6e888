"""Batched SHA-256 (counterpart: ``fabric_tpu/ops/sha256.py``).

Layout as in the reference: messages are padded on the host (standard
SHA-256 padding) into ``[B, M, 16]`` big-endian 32-bit words, held in an
int32 tensor as uint32 bit patterns, plus a per-message block count
``[B]`` int32; the output is ``[B, 8]`` int32 (uint32 bit patterns of
the digest words).  Message i runs the compression over its first
``nblocks[i]`` blocks; later blocks are padding and leave its state as
it is (the reference's per-message mask).

``sha256_blocks`` is the kernel wrapper: a CPU tensor runs the plain
version ``sha256_blocks_ref``, a CUDA tensor launches ``sha256_blocks``
(``kernels/csrc/sha256.cu``: producer warps stage the blocks and expand
the message schedule into a shared-memory ring, consumer warps run the
rounds, a thread a message).  ``sha256_host``
is the entry: pad, hash on ``device``, digests as bytes, with the
reference's power-of-two bucketing of the batch and block dimensions.

The commit path hashes its signed messages on the host with
``hashlib`` (``peer/frontend.py``), as the reference's validator does;
this module serves batch hashing and the ``sha256`` bench shape.
"""

from __future__ import annotations

import numpy as np
import torch

from fabric_tpu_torch import kernels
from fabric_tpu_torch.device import resolve_device
from fabric_tpu_torch.utils.batching import next_pow2

K = np.array([
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
], dtype=np.uint32)

H0 = np.array([0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
               0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19], dtype=np.uint32)

_M32 = 0xFFFFFFFF


def pad_messages(msgs, max_blocks: int | None = None):
    """SHA-256 padding into the kernel layout → (blocks [B, M, 16]
    uint32, nblocks [B] int32), bit-equal to the reference's."""
    nb = [(len(m) + 8) // 64 + 1 for m in msgs]
    M = max_blocks if max_blocks is not None else (max(nb) if nb else 1)
    if M < 1:
        raise ValueError(f"max_blocks must be >= 1, got {M}")
    if max(nb, default=0) > M:
        raise ValueError(f"message needs {max(nb)} blocks > max_blocks={M}")
    out = np.zeros((len(msgs), M, 16), dtype=np.uint32)
    for i, m in enumerate(msgs):
        padded = bytes(m) + b"\x80" + b"\x00" * ((55 - len(m)) % 64) \
            + (8 * len(m)).to_bytes(8, "big")
        words = np.frombuffer(padded, dtype=">u4").reshape(-1, 16)
        out[i, :words.shape[0]] = words
    return out, np.asarray(nb, dtype=np.int32)


def digests_to_bytes(digests) -> list[bytes]:
    """[B, 8] digest words (uint32, or int32 bit patterns) → B digests."""
    d = np.ascontiguousarray(digests.cpu() if isinstance(digests, torch.Tensor) else digests)
    if d.dtype == np.int32:
        d = d.view(np.uint32)
    return [d[i].astype(">u4").tobytes() for i in range(d.shape[0])]


# ---------------------------------------------------------------------------
# Plain version: int64 lanes masked to 32 bits after every add and rotate
# (torch's int32 ``>>`` is arithmetic and its uint32 arithmetic patchy).


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress(state, block):
    """One compression. state [B, 8], block [B, 16], int64 in [0, 2^32)."""
    w = [block[:, t] for t in range(16)]
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = (state[:, i] for i in range(8))
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ _M32) & g)
        t1 = (h + s1 + ch + int(K[t]) + w[t]) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & _M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    return (state + torch.stack([a, b, c, d, e, f, g, h], dim=1)) & _M32


def sha256_blocks_ref(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """The plain version: [B, M, 16] int32 words, [B] int32 counts →
    [B, 8] int32 digest words."""
    B, M, _ = blocks.shape
    words = blocks.to(torch.int64) & _M32
    state = torch.from_numpy(H0.astype(np.int64)).to(blocks.device).expand(B, 8)
    nb = nblocks.to(torch.int64)
    for i in range(M):
        new = _compress(state, words[:, i, :])
        state = torch.where((i < nb)[:, None], new, state)
    return torch.where(state >= 1 << 31, state - (1 << 32), state).to(torch.int32)


def sha256_blocks(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """[B, M, 16] int32 padded words, [B] int32 block counts → [B, 8]
    int32 digest words.  A CPU tensor runs ``sha256_blocks_ref``; a CUDA
    tensor launches the kernel."""
    if blocks.dtype != torch.int32 or blocks.dim() != 3 or blocks.shape[2] != 16:
        raise ValueError(f"expected int32 [B, M, 16] words, got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    if nblocks.dtype != torch.int32 or nblocks.shape != blocks.shape[:1]:
        raise ValueError("expected int32 [B] block counts")
    if blocks.device.type == "cpu":
        return sha256_blocks_ref(blocks, nblocks)
    return kernels.sha256_blocks(blocks.contiguous(), nblocks.contiguous())


def sha256_host(msgs, max_blocks: int | None = None, device="cuda") -> list[bytes]:
    """Pad on the host, hash on ``device``, digests as bytes.  Batch and
    block dimensions are bucketed to powers of two, as in the reference."""
    dev = resolve_device(device)
    if not msgs:
        return []
    msgs = [bytes(m) for m in msgs]
    n = len(msgs)
    need = max((len(m) + 8) // 64 + 1 for m in msgs)
    M = next_pow2(max_blocks if max_blocks is not None else need)
    B = next_pow2(n)
    blocks, nb = pad_messages(msgs + [b""] * (B - n), M)
    t = torch.from_numpy(blocks.view(np.int32)).to(dev)
    out = sha256_blocks(t, torch.from_numpy(nb).to(dev))
    return digests_to_bytes(out)[:n]
