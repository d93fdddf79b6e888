"""The binding of the read/write-set preparation (counterpart:
the JAX package's ``native/mvccprep_py.py``).

``prep(parsed, use)`` → ``MvccPrep``: flat arrays over the block's blob
from one ``mvcc_prep`` call.  Per transaction ``status`` is 0 where the
flat arrays hold its set, 1 where the validator parses it with
``TxRWSet.from_bytes`` (a range query, a metadata write, a hashed
collection, non-UTF-8 text, bytes that do not parse), 2 where
``use[i]`` is 0 or it has no read/write set.  Arrays are sized from the
block's read/write-set bytes (an entry takes at least two of them), so
no transaction takes status 1 for want of room; only the first
``n_reads``/``n_writes``/``n_keys``/``n_ns`` rows of the flat arrays
are written.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fabric_tpu_torch import native


@dataclass
class MvccPrep:
    blob: bytes
    status: np.ndarray        # [n] uint8
    tx_ns_start: np.ndarray   # [n] int64
    tx_ns_count: np.ndarray
    ns_ids_flat: np.ndarray   # [.] int32
    r_start: np.ndarray       # [n] int64
    r_count: np.ndarray
    w_start: np.ndarray
    w_count: np.ndarray
    r_uid: np.ndarray         # [n_reads] int32
    r_has_ver: np.ndarray     # [n_reads] uint8
    r_ver: np.ndarray         # [n_reads, 2] uint64
    w_uid: np.ndarray         # [n_writes] int32
    w_is_del: np.ndarray      # [n_writes] uint8
    w_key_span: np.ndarray    # [n_writes, 2] int64
    w_val_span: np.ndarray    # [n_writes, 2] int64 (offset -1: no value)
    ns_of_ukey: np.ndarray    # [n_keys] int32
    ns_span: np.ndarray       # [n_ns, 2]
    ukey_span: np.ndarray     # [n_keys, 2]
    n_ns: int
    n_keys: int
    n_reads: int
    n_writes: int

    def ns_names(self) -> list:
        """[n_ns] namespace strings (UTF-8 checked by the walk)."""
        b = self.blob
        return [b[o:o + ln].decode() for o, ln in self.ns_span[:self.n_ns].tolist()]

    def ukey_strs(self) -> list:
        """[n_keys] key strings (UTF-8 checked by the walk)."""
        b = self.blob
        return [b[o:o + ln].decode() for o, ln in self.ukey_span[:self.n_keys].tolist()]

    def tx_rows(self, which: str, include: np.ndarray, lex_rank: np.ndarray):
        """The flat rows of the included transactions' reads
        (``which="r"``) or writes ("w"), by transaction, then key rank →
        (row's transaction [k], row [k], rows a transaction [n])."""
        start, count, uid = ((self.r_start, self.r_count, self.r_uid) if which == "r"
                             else (self.w_start, self.w_count, self.w_uid))
        n = len(include)
        cnt = np.where(include, count[:n], 0)
        tx = np.repeat(np.arange(n), cnt)
        first = np.repeat(np.cumsum(cnt) - cnt, cnt)
        row = np.arange(len(tx)) - first + np.repeat(start[:n], cnt)
        return tx, row[np.lexsort((lex_rank[uid[row]], tx))], cnt

    def tx_ns(self, include: np.ndarray):
        """The (transaction, namespace) pairs of the included
        transactions, in transaction order and each transaction's order
        → (transaction [k], namespace id [k])."""
        n = len(include)
        cnt = np.where(include, self.tx_ns_count[:n], 0)
        tx = np.repeat(np.arange(n), cnt)
        first = np.repeat(np.cumsum(cnt) - cnt, cnt)
        row = np.arange(len(tx)) - first + np.repeat(self.tx_ns_start[:n], cnt)
        return tx, self.ns_ids_flat[row]

    def key_table(self):
        """→ (namespace names, key strings, [n_keys] ('pub', ns, key),
        [n_keys] each key's rank in that tuple's order)."""
        ns_names, ukeys = self.ns_names(), self.ukey_strs()
        ns_of = self.ns_of_ukey.tolist()
        keys = [("pub", ns_names[ns_of[u]], ukeys[u]) for u in range(self.n_keys)]
        rank = np.empty(self.n_keys, np.int64)
        rank[sorted(range(self.n_keys), key=keys.__getitem__)] = np.arange(self.n_keys)
        return ns_names, ukeys, keys, rank


def prep(pb, use: np.ndarray) -> MvccPrep:
    """``pb``: a ``blockparse.ParsedBlock``; ``use``: [n] bool, the
    transactions whose sets to prepare."""
    n = len(use)
    rs = np.ascontiguousarray(pb.results_span[:n])
    use8 = np.ascontiguousarray(use, np.uint8)
    total = int(rs[:, 1][(rs[:, 0] >= 0) & use].sum()) if n else 0
    cap = total // 2 + 1
    e = np.empty
    out = MvccPrep(
        blob=pb.blob, status=np.zeros(n, np.uint8), tx_ns_start=np.zeros(n, np.int64),
        tx_ns_count=np.zeros(n, np.int64), ns_ids_flat=e(cap, np.int32),
        r_start=np.zeros(n, np.int64), r_count=np.zeros(n, np.int64),
        w_start=np.zeros(n, np.int64), w_count=np.zeros(n, np.int64),
        r_uid=e(cap, np.int32), r_has_ver=e(cap, np.uint8), r_ver=e((cap, 2), np.uint64),
        w_uid=e(cap, np.int32), w_is_del=e(cap, np.uint8), w_key_span=e((cap, 2), np.int64),
        w_val_span=e((cap, 2), np.int64), ns_of_ukey=e(cap, np.int32),
        ns_span=e((cap, 2), np.int64), ukey_span=e((cap, 2), np.int64),
        n_ns=0, n_keys=0, n_reads=0, n_writes=0)
    counts = np.zeros(4, np.int64)
    p = native.ptr
    native.lib("mvccprep").mvcc_prep(
        pb.blob, p(rs), p(use8), n, cap, cap, cap,
        p(out.status), p(out.tx_ns_start), p(out.tx_ns_count), p(out.ns_ids_flat),
        p(out.r_start), p(out.r_count), p(out.w_start), p(out.w_count),
        p(out.r_uid), p(out.r_has_ver), p(out.r_ver), p(out.w_uid), p(out.w_is_del),
        p(out.w_key_span), p(out.w_val_span), p(out.ns_of_ukey), p(out.ns_span),
        p(out.ukey_span), p(counts))
    out.n_ns, out.n_keys, out.n_reads, out.n_writes = (int(c) for c in counts)
    out.r_uid, out.r_has_ver, out.r_ver = (out.r_uid[:out.n_reads], out.r_has_ver[:out.n_reads],
                                           out.r_ver[:out.n_reads])
    out.w_uid, out.w_is_del = out.w_uid[:out.n_writes], out.w_is_del[:out.n_writes]
    out.w_key_span, out.w_val_span = out.w_key_span[:out.n_writes], out.w_val_span[:out.n_writes]
    out.ns_of_ukey, out.ukey_span = out.ns_of_ukey[:out.n_keys], out.ukey_span[:out.n_keys]
    out.ns_span, out.ns_ids_flat = out.ns_span[:out.n_ns], out.ns_ids_flat[:int(
        (out.tx_ns_start + out.tx_ns_count).max()) if n else 0]
    return out
