"""Batched MVCC read-set validation (counterpart: ``fabric_tpu/ops/mvcc.py``).

The reference validates a block's transactions serially
(core/ledger/kvledger/txmgmt/validation/validator.go:81-118): a read of
a key an earlier *valid* transaction wrote is a conflict, a stale or
presence-flipped committed version is a conflict, an earlier valid
write inside a recorded range is a phantom, and only valid
transactions' writes count.  The batched form keeps the JAX package's
reformulation: block-local dense key ids in lexicographic order (so a
range is an id interval), strictly lower-triangular [T, T] direct and
phantom relations, and the validity fixpoint
valid[j] = ver_ok[j] & !any(conflict[j, i] & valid[i], i < j), unique
because every dependency points to an earlier transaction.

``mvcc_validate`` and ``mvcc_validate_hostver`` are kernel wrappers:
CPU tensors run the plain versions here, CUDA tensors launch
``kernels/csrc/stage2.cu``.  ``mvcc_serial_reference`` is the serial
oracle.  Version columns are numpy arrays (uint32 pairs) on the host.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np
import torch

from fabric_tpu_torch import kernels
from fabric_tpu_torch.device import resolve_device
from fabric_tpu_torch.utils.batching import next_pow2


# ---------------------------------------------------------------------------
# Plain versions


def _relations(read_keys, write_keys, rq_lo, rq_hi):
    """Strictly lower-triangular [T, T] bool direct and phantom relations."""
    T = read_keys.shape[0]
    w_valid = (write_keys >= 0)[None, :, None, :]
    r_valid = (read_keys >= 0)[:, None, :, None]
    wk = write_keys[None, :, None, :]
    eq = (read_keys[:, None, :, None] == wk) & w_valid & r_valid
    direct = eq.any(dim=3).any(dim=2)
    q_valid = (rq_lo >= 0)[:, None, :, None]
    in_range = ((wk >= rq_lo[:, None, :, None]) & (wk < rq_hi[:, None, :, None])
                & w_valid & q_valid)
    phantom = in_range.any(dim=3).any(dim=2)
    order = torch.tril(torch.ones(T, T, dtype=torch.bool, device=read_keys.device),
                       diagonal=-1)
    return direct & order, phantom & order


def jacobi(direct, phantom, ver_ok):
    """Jacobi iteration of the validity fixpoint from the optimistic
    assignment (the reference's while_loop) → (valid, rounds): the
    rounds the kernel runs, the last one finding no change."""
    T = ver_ok.shape[0]
    conflict = direct | phantom
    v, prev, it = ver_ok, ~ver_ok, 0
    while it <= T + 1 and bool((v != prev).any()):
        hit = (conflict & v[None, :]).any(dim=1)
        v, prev, it = ver_ok & ~hit, v, it + 1
    return v, it


def _fixpoint(direct, phantom, ver_ok):
    """The validity fixpoint, then the flags."""
    v, _ = jacobi(direct, phantom, ver_ok)
    return (v, (direct & v[None, :]).any(dim=1) & ver_ok,
            (phantom & v[None, :]).any(dim=1) & ver_ok)


def mvcc_validate_hostver_ref(read_keys, ver_ok_host, write_keys, rq_lo, rq_hi, pre_ok):
    """Plain ``mvcc_validate_hostver`` → (valid, conflict, phantom) [T] bool."""
    direct, phantom = _relations(read_keys, write_keys, rq_lo, rq_hi)
    return _fixpoint(direct, phantom, ver_ok_host & pre_ok)


def ver_ok_ref(read_keys, read_present, read_vers, comm_present, comm_vers):
    """[T] bool per-tx committed-version check (validateKVRead: version
    equality when both present, presence flip = stale, padding inert)."""
    ver_eq = (read_vers == comm_vers).all(dim=-1)
    ok = torch.where(read_present & comm_present, ver_eq, read_present == comm_present)
    return (ok | (read_keys < 0)).all(dim=-1)


def mvcc_validate_ref(read_keys, read_present, read_vers, comm_present, comm_vers,
                      write_keys, rq_lo, rq_hi, pre_ok):
    """Plain ``mvcc_validate``."""
    ver_ok = ver_ok_ref(read_keys, read_present, read_vers, comm_present, comm_vers)
    return mvcc_validate_hostver_ref(read_keys, ver_ok, write_keys, rq_lo, rq_hi, pre_ok)


# ---------------------------------------------------------------------------
# Kernel wrappers


def _pack_static(read_keys, write_keys, rq_lo, rq_hi) -> torch.Tensor:
    return torch.cat([read_keys, write_keys, rq_lo, rq_hi], dim=1).to(torch.int32).contiguous()


def _split3(out: torch.Tensor, T: int):
    flat = out.bool()
    return flat[:T], flat[T:2 * T], flat[2 * T:3 * T]


def mvcc_validate(read_keys, read_present, read_vers, comm_present, comm_vers,
                  write_keys, rq_lo, rq_hi, pre_ok):
    """→ (valid, conflict, phantom) [T] bool.  Shapes: keys [T, R] /
    [T, W] int32 (-1 = padding), presence [T, R] bool, versions
    [T, R, 2] int32 bit patterns of the uint32 (block, txnum) pairs,
    range bounds [T, Q] int32, pre_ok [T] bool."""
    if read_keys.device.type == "cpu":
        return mvcc_validate_ref(read_keys, read_present, read_vers, comm_present,
                                 comm_vers, write_keys, rq_lo, rq_hi, pre_ok)
    T, R = read_keys.shape
    sp = _pack_static(read_keys, write_keys, rq_lo, rq_hi)
    out = torch.empty(3 * T, dtype=torch.int8, device=read_keys.device)
    i32 = lambda t: t.to(torch.int32).contiguous()
    kernels.mvcc_validate(i32(read_keys), read_present.contiguous(), i32(read_vers),
                          comm_present.contiguous(), i32(comm_vers), sp, R,
                          write_keys.shape[1], rq_lo.shape[1], pre_ok.contiguous(), out)
    return _split3(out, T)


def mvcc_validate_hostver(read_keys, ver_ok_host, write_keys, rq_lo, rq_hi, pre_ok):
    """``mvcc_validate`` with the per-read compare already done on the host."""
    if read_keys.device.type == "cpu":
        return mvcc_validate_hostver_ref(read_keys, ver_ok_host, write_keys, rq_lo,
                                         rq_hi, pre_ok)
    T, R = read_keys.shape
    sp = _pack_static(read_keys, write_keys, rq_lo, rq_hi)
    out = torch.empty(3 * T, dtype=torch.int8, device=read_keys.device)
    kernels.mvcc_hostver(sp, R, write_keys.shape[1], rq_lo.shape[1],
                         ver_ok_host.contiguous(), pre_ok.contiguous(), out)
    return _split3(out, T)


# ---------------------------------------------------------------------------
# Host-side block preparation


@dataclass
class TxRWSet:
    """One transaction's read/write set in MVCC form.

    reads: list of (key, version | None) — None = absent at simulation.
    writes: list of keys written.
    range_reads: list of (start_key, end_key_exclusive) phantom bounds.
    Keys are hashable, ordered tuples such as ('pub', ns, key).
    """

    reads: list
    writes: list
    range_reads: list


@dataclass
class StaticBlock:
    """State-independent MVCC arrays of one block, plus the recipe for
    the committed-version fill that must wait for the predecessor."""

    read_keys: np.ndarray      # [T, R] int32
    read_present: np.ndarray   # [T, R] bool
    read_vers: np.ndarray      # [T, R, 2] uint32
    write_keys: np.ndarray     # [T, W] int32
    rq_lo: np.ndarray          # [T, Q] int32
    rq_hi: np.ndarray          # [T, Q] int32
    keys: list                 # [n_ids] the key of each id
    read_key_set: set
    # the unique-key form (``prepare_block_static(unique=True)``, blocks
    # without range reads): read key ids 0..U-1 index ``u_pairs``
    u_pairs: list | None = None   # [U] (ns, key) per unique read key id
    u_index: dict | None = None   # (ns, key) → id

    def fill_committed(self, committed: dict):
        """→ (comm_present [T, R] bool, comm_vers [T, R, 2] uint32)."""
        T, R = self.read_keys.shape
        comm_present = np.zeros((T, R), bool)
        comm_vers = np.zeros((T, R, 2), np.uint32)
        rows, cols = np.nonzero(self.read_keys >= 0)
        ids = self.read_keys[rows, cols]
        up = np.zeros(len(self.keys), bool)
        uv = np.zeros((len(self.keys), 2), np.uint32)
        for u in np.unique(ids).tolist():  # each read key looked up once
            cv = committed.get(self.keys[u])
            if cv is not None:
                up[u] = True
                uv[u] = cv
        comm_present[rows, cols] = up[ids]
        comm_vers[rows, cols] = uv[ids]
        return comm_present, comm_vers

    def host_ver_ok(self, committed: dict) -> np.ndarray:
        """[T] bool per-read committed-version compare on the host."""
        comm_present, comm_vers = self.fill_committed(committed)
        ver_eq = (self.read_vers == comm_vers).all(axis=-1)
        ok = np.where(self.read_present & comm_present, ver_eq,
                      self.read_present == comm_present)
        return np.logical_or(ok, self.read_keys < 0).all(axis=-1)

    @property
    def dims(self) -> tuple:
        """(R, W, Q): the column split of ``packed_static``."""
        return (self.read_keys.shape[1], self.write_keys.shape[1], self.rq_lo.shape[1])

    def packed_static(self) -> np.ndarray:
        """[T, R+W+2Q] int32: read_keys | write_keys | rq_lo | rq_hi."""
        return np.concatenate([self.read_keys, self.write_keys, self.rq_lo, self.rq_hi],
                              axis=1)

    def packed_read_pv(self) -> np.ndarray:
        """[T, R, 3] int32: expected present | ver_block | ver_txnum per
        read, the versions as int32 bit patterns (compared for equality
        only) — the expected side of the resident-state compare."""
        T, R = self.read_keys.shape
        rpv = np.zeros((T, R, 3), np.int32)
        rpv[:, :, 0] = self.read_present
        rpv[:, :, 1:3] = self.read_vers.view(np.int32)
        return rpv

    def ver_ok_from_u(self, up: np.ndarray, uv: np.ndarray) -> np.ndarray:
        """[T] bool from per-unique-key committed (present [U] bool,
        versions [U, 2] uint32): the plain form of the resident compare."""
        T = self.read_keys.shape[0]
        rows, cols = np.nonzero(self.read_keys >= 0)
        if not len(rows):
            return np.ones(T, bool)
        uid = self.read_keys[rows, cols]
        rp = self.read_present[rows, cols]
        rv = self.read_vers[rows, cols]
        cp = up[uid]
        ver_eq = (rv == uv[uid]).all(axis=1)
        okr = np.where(rp & cp, ver_eq, rp == cp)
        return np.bincount(rows[~okr], minlength=T) == 0

    def device_args(self, committed: dict, device) -> tuple:
        """``mvcc_validate`` arguments (minus pre_ok) as tensors on ``device``."""
        comm_present, comm_vers = self.fill_committed(committed)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return (t(self.read_keys), t(self.read_present), t(self.read_vers.view(np.int32)),
                t(comm_present), t(comm_vers.view(np.int32)), t(self.write_keys),
                t(self.rq_lo), t(self.rq_hi))


def prepare_block_static(txs: list[TxRWSet], bucketed: bool = False,
                         unique: bool = False) -> StaticBlock:
    """Dense key ids in lexicographic key order over the block's key
    universe, so range bounds map to id intervals; ``bucketed`` rounds
    T (to >= 16), R, W and Q up to powers of two (padding rows inert).

    Keys are ``('pub', ns, key)`` and, for a private collection's hashed
    keys, ``('pvt', ns, coll, key_hash)``: the two kinds sort apart, so
    hashed keys take a disjoint id range of the same table.

    ``unique`` (the resident-state path) on a block without range reads
    or hashed keys numbers the read keys first, 0..U-1 in key order,
    then the keys only written, and fills the unique-key form
    (``u_pairs``, ``u_index``: the state DB's (ns, key) of each).
    Without range reads only id equality matters, so the order changes
    no verdict (the reference's flat path interns keys in hash order for
    the same reason)."""
    universe = set()
    read_key_set = set()
    for tx in txs:
        for k, _ in tx.reads:
            universe.add(k)
            read_key_set.add(k)
        universe.update(tx.writes)
    unique = (unique and not any(tx.range_reads for tx in txs)
              and all(k[0] == "pub" for k in universe))
    for tx in txs:
        for lo, _ in tx.range_reads:
            universe.add(lo)
    if unique:
        rkeys = sorted(read_key_set)
        skeys = rkeys + sorted(universe - read_key_set)
    else:
        skeys = sorted(universe)
    kid = {k: i for i, k in enumerate(skeys)}

    T = len(txs)
    R = max(1, max((len(t.reads) for t in txs), default=1))
    W = max(1, max((len(t.writes) for t in txs), default=1))
    Q = max(1, max((len(t.range_reads) for t in txs), default=1))
    if bucketed:
        T = max(16, next_pow2(T))
        R, W, Q = next_pow2(R), next_pow2(W), next_pow2(Q)

    read_keys = np.full((T, R), -1, np.int32)
    read_present = np.zeros((T, R), bool)
    read_vers = np.zeros((T, R, 2), np.uint32)
    write_keys = np.full((T, W), -1, np.int32)
    rq_lo = np.full((T, Q), -1, np.int32)
    rq_hi = np.full((T, Q), -1, np.int32)
    for j, tx in enumerate(txs):
        for a, (k, ver) in enumerate(tx.reads):
            read_keys[j, a] = kid[k]
            if ver is not None:
                read_present[j, a] = True
                read_vers[j, a] = ver
        for a, k in enumerate(tx.writes):
            write_keys[j, a] = kid[k]
        for a, (lo, hi) in enumerate(tx.range_reads):
            rq_lo[j, a] = bisect.bisect_left(skeys, lo)
            rq_hi[j, a] = bisect.bisect_left(skeys, hi)
    static = StaticBlock(
        read_keys=read_keys, read_present=read_present, read_vers=read_vers,
        write_keys=write_keys, rq_lo=rq_lo, rq_hi=rq_hi,
        keys=skeys, read_key_set=read_key_set,
    )
    if unique:
        static.u_pairs = [(k[1], k[2]) for k in rkeys]
        static.u_index = {pr: i for i, pr in enumerate(static.u_pairs)}
    return static


def prepare_block_from_flat(rwp, include: np.ndarray, lex_rank: np.ndarray, keys: list,
                            unique: bool = False) -> StaticBlock:
    """``prepare_block_static(txs, bucketed=True, unique=unique)`` from
    the flat arrays of ``native.mvccprep`` (counterpart:
    ``fabric_tpu/ops/mvcc.py::prepare_block_from_flat`` :426) with numpy
    scatters, no loop over reads or writes.  ``include``: [n] bool, the
    transactions whose sets count (status 0); every other row stays
    empty.  ``lex_rank``: [n_keys] each interned key's rank in
    (namespace, key) order; ``keys``: [n_keys] its ('pub', ns, key).
    The arrays, so ``packed_static()`` and ``packed_read_pv()``, are
    byte-equal to the decoded form's: key ids in lexicographic order
    (read keys first under ``unique``), each transaction's reads and
    writes in key order."""
    n = len(include)
    r_tx, r_row, rc = rwp.tx_rows("r", include, lex_rank)
    w_tx, w_row, wc = rwp.tx_rows("w", include, lex_rank)
    r_uid = rwp.r_uid[r_row].astype(np.int64)
    w_uid = rwp.w_uid[w_row].astype(np.int64)
    read_u = np.unique(r_uid)
    all_u = np.unique(np.concatenate([r_uid, w_uid]))
    if unique:
        wonly = np.setdiff1d(all_u, read_u)
        order = np.concatenate([read_u[np.argsort(lex_rank[read_u])],
                                wonly[np.argsort(lex_rank[wonly])]])
    else:
        order = all_u[np.argsort(lex_rank[all_u])]
    new_id = np.full(len(lex_rank), -1, np.int64)
    new_id[order] = np.arange(len(order))

    T = max(16, next_pow2(n))
    R = next_pow2(max(1, int(rc.max()) if n else 1))
    W = next_pow2(max(1, int(wc.max()) if n else 1))
    col = lambda cnt: np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    read_keys = np.full((T, R), -1, np.int32)
    read_present = np.zeros((T, R), bool)
    read_vers = np.zeros((T, R, 2), np.uint32)
    write_keys = np.full((T, W), -1, np.int32)
    rcol = col(rc)
    read_keys[r_tx, rcol] = new_id[r_uid]
    read_present[r_tx, rcol] = rwp.r_has_ver[r_row].astype(bool)
    read_vers[r_tx, rcol] = rwp.r_ver[r_row].astype(np.uint32)
    write_keys[w_tx, col(wc)] = new_id[w_uid]

    id_keys = [keys[u] for u in order.tolist()]
    static = StaticBlock(
        read_keys=read_keys, read_present=read_present, read_vers=read_vers,
        write_keys=write_keys, rq_lo=np.full((T, 1), -1, np.int32),
        rq_hi=np.full((T, 1), -1, np.int32), keys=id_keys,
        read_key_set=set(id_keys[:len(read_u)]) if unique else
        {keys[u] for u in read_u.tolist()})
    if unique:
        static.u_pairs = [(k[1], k[2]) for k in id_keys[:len(read_u)]]
        static.u_index = {pr: i for i, pr in enumerate(static.u_pairs)}
    return static


def mvcc_validate_block(txs: list[TxRWSet], committed: dict, pre_ok=None, device="cuda"):
    """Prepare one block, run ``mvcc_validate`` on ``device`` → three
    numpy bool arrays (valid, conflict, phantom)."""
    device = resolve_device(device)
    if pre_ok is None:
        pre_ok = np.ones(len(txs), bool)
    static = prepare_block_static(txs)
    args = static.device_args(committed, device)
    pre = torch.from_numpy(np.asarray(pre_ok, bool).copy()).to(device)
    outs = mvcc_validate(*args, pre)
    return tuple(o.to("cpu").numpy() for o in outs)


def mvcc_serial_reference(txs: list[TxRWSet], committed: dict, pre_ok=None):
    """The reference's serial semantics (validator.go:81-118) — the
    oracle the batched forms are held against."""
    if pre_ok is None:
        pre_ok = [True] * len(txs)
    updates: set = set()
    out = []
    for tx, ok0 in zip(txs, pre_ok):
        ok = bool(ok0)
        if ok:
            for k, ver in tx.reads:
                if k in updates:
                    ok = False
                    break
                if committed.get(k) != ver:
                    ok = False
                    break
        if ok:
            for lo, hi in tx.range_reads:
                if any(lo <= w < hi for w in updates):
                    ok = False
                    break
        if ok:
            updates.update(tx.writes)
        out.append(ok)
    return out
