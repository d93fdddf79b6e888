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


def _fixpoint(direct, phantom, ver_ok):
    """Jacobi iteration of the validity fixpoint from the optimistic
    assignment (the reference's while_loop), then the flags."""
    T = ver_ok.shape[0]
    conflict = direct | phantom
    v, prev, it = ver_ok, ~ver_ok, 0
    while it <= T + 1 and bool((v != prev).any()):
        hit = (conflict & v[None, :]).any(dim=1)
        v, prev, it = ver_ok & ~hit, v, it + 1
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
    read_fill: list            # [(j, a, key)]
    read_key_set: set

    def fill_committed(self, committed: dict):
        """→ (comm_present [T, R] bool, comm_vers [T, R, 2] uint32)."""
        T, R = self.read_keys.shape
        comm_present = np.zeros((T, R), bool)
        comm_vers = np.zeros((T, R, 2), np.uint32)
        for j, a, k in self.read_fill:
            cv = committed.get(k)
            if cv is not None:
                comm_present[j, a] = True
                comm_vers[j, a] = cv
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

    def device_args(self, committed: dict, device) -> tuple:
        """``mvcc_validate`` arguments (minus pre_ok) as tensors on ``device``."""
        comm_present, comm_vers = self.fill_committed(committed)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return (t(self.read_keys), t(self.read_present), t(self.read_vers.view(np.int32)),
                t(comm_present), t(comm_vers.view(np.int32)), t(self.write_keys),
                t(self.rq_lo), t(self.rq_hi))


def prepare_block_static(txs: list[TxRWSet], bucketed: bool = False) -> StaticBlock:
    """Dense key ids in lexicographic key order over the block's key
    universe, so range bounds map to id intervals; ``bucketed`` rounds
    T (to >= 16), R, W and Q up to powers of two (padding rows inert)."""
    universe = set()
    read_key_set = set()
    for tx in txs:
        for k, _ in tx.reads:
            universe.add(k)
            read_key_set.add(k)
        universe.update(tx.writes)
    for tx in txs:
        for lo, _ in tx.range_reads:
            universe.add(lo)
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
    read_fill: list = []
    for j, tx in enumerate(txs):
        for a, (k, ver) in enumerate(tx.reads):
            read_keys[j, a] = kid[k]
            if ver is not None:
                read_present[j, a] = True
                read_vers[j, a] = ver
            read_fill.append((j, a, k))
        for a, k in enumerate(tx.writes):
            write_keys[j, a] = kid[k]
        for a, (lo, hi) in enumerate(tx.range_reads):
            rq_lo[j, a] = bisect.bisect_left(skeys, lo)
            rq_hi[j, a] = bisect.bisect_left(skeys, hi)
    return StaticBlock(
        read_keys=read_keys, read_present=read_present, read_vers=read_vers,
        write_keys=write_keys, rq_lo=rq_lo, rq_hi=rq_hi,
        read_fill=read_fill, read_key_set=read_key_set,
    )


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
