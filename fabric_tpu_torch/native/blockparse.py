"""The binding of the block pre-parser (counterpart:
the JAX package's ``native/blockparse.py``).

``parse_envelopes(envs)`` → ``ParsedBlock``: numpy arrays over one
shared blob, from one ``bp_parse_block`` call.  Spans index into
``blob`` (offset -1: absent).  ``ok[i]`` is 1 where the walk carried
envelope i (a standard endorser transaction) and 0 where the validator
decodes it with the front end.  Identities are interned block-wide:
``creator_uid``/``e_uid`` index ``ident_span`` (-1: none) and ``e_dup``
marks an endorser already seen in its transaction.

Difference from the counterpart: where an array's capacity (8
endorsements a transaction, and as many identities again plus one a
transaction) is too small, the arrays grow and the call repeats; the
reference returns None and takes its Python path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fabric_tpu_torch import native


@dataclass
class ParsedBlock:
    blob: bytes
    ok: np.ndarray               # [n] uint8
    ch_type: np.ndarray          # [n] int64 (-1: no channel header)
    txid_span: np.ndarray        # [n, 2] int64
    channel_span: np.ndarray
    creator_span: np.ndarray
    nonce_span: np.ndarray
    results_span: np.ndarray
    events_span: np.ndarray
    payload_digest: np.ndarray   # [n, 32] uint8: sha256(payload)
    txid_digest: np.ndarray      # [n, 32] uint8: sha256(nonce || creator)
    creator_sig_ok: np.ndarray   # [n] uint8
    creator_r: np.ndarray        # [n, 32] uint8, big-endian
    creator_s: np.ndarray
    endo_start: np.ndarray       # [n] int64
    endo_count: np.ndarray
    e_endorser_span: np.ndarray  # [m, 2]
    e_digest: np.ndarray         # [m, 32]: sha256(prp || endorser)
    e_r: np.ndarray
    e_s: np.ndarray
    e_ok: np.ndarray             # [m] uint8
    creator_uid: np.ndarray      # [n] int32
    e_uid: np.ndarray            # [m] int32
    e_dup: np.ndarray            # [m] uint8
    ident_span: np.ndarray       # [n_ids, 2]
    n_ids: int
    n_endorsements: int


def _alloc(blob: bytes, n: int, cap: int, cap_ids: int) -> ParsedBlock:
    z = np.zeros
    return ParsedBlock(
        blob=blob, ok=z(n, np.uint8), ch_type=z(n, np.int64),
        txid_span=z((n, 2), np.int64), channel_span=z((n, 2), np.int64),
        creator_span=z((n, 2), np.int64), nonce_span=z((n, 2), np.int64),
        results_span=z((n, 2), np.int64), events_span=z((n, 2), np.int64),
        payload_digest=z((n, 32), np.uint8), txid_digest=z((n, 32), np.uint8),
        creator_sig_ok=z(n, np.uint8), creator_r=z((n, 32), np.uint8),
        creator_s=z((n, 32), np.uint8), endo_start=z(n, np.int64),
        endo_count=z(n, np.int64), e_endorser_span=z((cap, 2), np.int64),
        e_digest=z((cap, 32), np.uint8), e_r=z((cap, 32), np.uint8),
        e_s=z((cap, 32), np.uint8), e_ok=z(cap, np.uint8),
        creator_uid=np.full(n, -1, np.int32), e_uid=np.full(cap, -1, np.int32),
        e_dup=z(cap, np.uint8), ident_span=z((cap_ids, 2), np.int64),
        n_ids=0, n_endorsements=0)


_ORDER = ("ok", "ch_type", "txid_span", "channel_span", "creator_span", "nonce_span",
          "results_span", "events_span", "payload_digest", "txid_digest", "creator_sig_ok",
          "creator_r", "creator_s", "endo_start", "endo_count", "e_endorser_span", "e_digest",
          "e_r", "e_s", "e_ok", "creator_uid", "e_uid", "e_dup", "ident_span")


def parse_envelopes(envs) -> ParsedBlock:
    """Serialized envelopes → ``ParsedBlock`` (one C call; more only
    where a capacity had to grow)."""
    envs = list(envs)
    n = len(envs)
    blob = b"".join(envs)
    lens = np.fromiter((len(e) for e in envs), np.int64, count=n)
    offs = np.zeros(n, np.int64)
    if n:
        np.cumsum(lens[:-1], out=offs[1:])
    fn = native.lib("blockparse").bp_parse_block
    cap = max(8, 8 * n)
    while True:
        out = _alloc(blob, n, cap, cap + n)
        n_ids = np.zeros(1, np.int64)
        ne = fn(blob, native.ptr(offs), native.ptr(lens), n, cap, cap + n,
                *(native.ptr(getattr(out, f)) for f in _ORDER), native.ptr(n_ids))
        if ne >= 0:
            break
        cap *= 2
    out.n_ids, out.n_endorsements = int(n_ids[0]), int(ne)
    return out


def sha256(data: bytes, scalar: bool = False) -> bytes:
    """SHA-256 through the walk's own code and dispatch (SHA-NI where
    the CPU has it), or its scalar path alone."""
    out = np.zeros(32, np.uint8)
    native.lib("blockparse").bp_sha256(data, len(data), int(scalar), native.ptr(out))
    return out.tobytes()
