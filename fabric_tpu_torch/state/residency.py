"""Device-resident MVCC version table: an LRU key-range residency
manager with delta scatter commits (counterpart:
``fabric_tpu/state/residency.py``).

Without it every block re-reads the committed version of each unique
read key on the host and ships the [T] verdict column up with the
launch.  With it, the committed (present, version) of the working set
stays in a ``[capacity, 3]`` int32 table on the card, and per block the
host does a directory probe per unique read key, one small upload (the
``u_pack`` of slots and host lanes) and, at the commit boundary, one
scatter of the block's write set.  Keys hash into ``2^range_bits``
ranges (blake2b, as in the reference, so the two directories agree);
ranges are the unit of admission and LRU eviction.  A missed key rides
a host lane for its block and is admitted for the next.

Coherence with the depth-N pipeline (``peer/pipeline.py``), as in the
reference: the table holds committed state as of a prefix of the chain
and every launch overlays the in-flight commit window.

* ``apply_batch`` runs at the commit boundary, before the block's
  commit future resolves, so a launch whose overlay no longer covers
  block k is ordered after k's scatter.
* A launch whose overlay still covers block k forces k's keys onto host
  lanes with the overlay's values, whether or not k's scatter landed.
  Keys the overlay covers are never admitted from the (racy) committed
  read; their commit scatter lands them.

Where the port differs: the reference's table is an immutable jax
array, so a launch holds a snapshot that no later scatter can tear.
The port's table is one CUDA tensor updated in place (``table_scatter``
writes rows; no copy of 48 MiB per block).  So:

* One lock guards the directory, the LRU, the free pool and the table,
  and every read and write of the table is enqueued under that lock on
  ONE stream the manager owns (PyTorch's current stream is per thread:
  the committer thread's scatter and the launch thread's read would
  otherwise be unordered).  Work the caller's stream enqueued before
  (the block's uploaded operands) is waited for first; the caller's
  stream waits for the manager's stream after a read.
* ``build_launch_pack`` enqueues the block's table read (``read``, the
  ``resident_verok`` launch) after ``lookup`` and BEFORE ``admit``.
  Admission may evict a range this same block hit and hand its slot to
  a missed key (eviction protects only the ranges the call admits); in
  stream order the block has read the old row by then.
* Between ``lookup`` and the read, the committer's ``apply_batch`` may
  write rows: only rows of keys in an in-flight batch (forced onto host
  lanes in this block, never read from the table) or free slots (no
  hit points at them).  No hit row changes under the block.

The disable latch (the reference's ``_disable_locked``, :577-584,
:719-726, :759): a failed admission or commit scatter drops the table
and the directory and latches the cache off, with a warning.  From then
``enabled`` is False, every lookup misses, nothing is admitted or
scattered, ``read`` refuses (so a block whose lookup ran before the
latch, on another thread, takes the host read too), and the validator
reads every key on the host: the verdicts do not change, only where the
versions come from.  A failing table read
(``resident_verok``) raises, as the reference's manager does.

Telemetry (the reference's :287-321, :406, :436, :817): the
``state_resident_*`` counters and gauges and ``h2d_state_bytes_per_block``
go to the global metrics registry beside ``stats()`` (channel label
"": the port's validator names no channel); the table's bytes are the
launch ledger's ``resident_table`` owner (``observe/ledger.py``), each
scatter a ``resident_scatter`` record (enqueue-only: nothing waits for
it), and a block's state upload the ledger's ``state`` h2d lane.

Left out of the port: mesh sharding and ``reshard`` (a later multi-GPU
slice).  Two routings are semantics, not failure, and are counted in
``stats()``: a working set larger than the table takes the host path
(``host_path_oversize_total``), and so does a block with range queries
(``host_path_range_total``, counted by the validator).
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import threading
from collections import OrderedDict, deque

import numpy as np
import torch

from fabric_tpu_torch import kernels
from fabric_tpu_torch.device import resolve_device
from fabric_tpu_torch.observe import ledger as _ledger
from fabric_tpu_torch.ops_metrics import global_registry

#: bytes per table slot: (present, ver_block, ver_txnum) int32
SLOT_BYTES = 12

#: smallest table the capacity knob can produce
MIN_SLOTS = 256

#: per-apply_batch cap on brand-new ranges a write set may open (free
#: slots only, never evicting); the reference's default
WRITE_ADMIT_BUDGET = 2

_log = logging.getLogger("fabric_tpu_torch.state.residency")

#: the smallest u_pack bucket (pow2 rows)
_MIN_PACK = 16

#: trailing lookups the hit rate aggregates over
_HIT_WINDOW = 256


def _i32(v: int) -> int:
    """A uint32 → its int32 bit pattern."""
    if not 0 <= v < 1 << 32:
        raise OverflowError(f"version component {v} is not a uint32")
    return v - (1 << 32) if v >= 1 << 31 else v


def _ver_i32(block: int, txnum: int) -> tuple[int, int]:
    """(block, txnum) → int32 bit patterns of the uint32 pair (the table
    compares versions for equality only, so the view is exact)."""
    return _i32(int(block)), _i32(int(txnum))


def table_scatter_ref(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """Plain ``table_scatter``: ``table[idx] = rows`` in place."""
    table[idx.long()] = rows


def table_scatter(table: torch.Tensor, idx: np.ndarray, rows: np.ndarray) -> None:
    """``table[idx[i]] = rows[i]`` for the k real rows (the reference's
    pad rows with idx == capacity do not exist here).  Raises on any
    index outside [0, capacity).  A CPU table runs ``table_scatter_ref``;
    a CUDA table launches ``table_scatter`` on the current stream."""
    idx = np.ascontiguousarray(idx, np.int32)
    rows = np.ascontiguousarray(rows, np.int32).reshape(-1, 3)
    if len(idx) != len(rows):
        raise ValueError(f"table_scatter: {len(idx)} indices for {len(rows)} rows")
    if not len(idx):
        return
    cap = table.shape[0]
    bad = (idx < 0) | (idx >= cap)
    if bad.any():
        raise IndexError(f"table_scatter: index {int(idx[bad][0])} outside [0, {cap})")
    # enqueue-only ledger record: compile and h2d, no execute (nothing
    # waits for a scatter); on the CPU a miss is the reference's first
    # sight of the row bucket (its update program per bucket)
    cuda = table.device.type == "cuda"
    rec = _ledger.launch("resident_scatter", lanes=len(idx),
                         key=max(_MIN_PACK, 1 << (len(idx) - 1).bit_length()),
                         compiled=kernels.first_launch("table_scatter") if cuda else None,
                         h2d_bytes=idx.nbytes + rows.nbytes)
    it = torch.from_numpy(idx).to(table.device)
    rt = torch.from_numpy(rows).to(table.device)
    if cuda:
        kernels.table_scatter(table, it, rt)
    else:
        table_scatter_ref(table, it, rt)
    if rec is not None:
        rec.complete()


def build_launch_pack(res: "ResidencyManager", pairs: list, state, overlay=None,
                      u_index: dict | None = None, read=None):
    """One block's resident-state launch operand ``u_pack [Ub, 4]`` int32
    numpy (slot | present | vb | vt; slot −1 = host lane), or None when
    the block takes the host path: the working set exceeds the table, or
    the cache was disabled before its ``read`` (the disable latch may
    fire on the committer's thread between this block's lookup and its
    read).

    * hits reference table slots;
    * misses ride host lanes filled from ``state.get_versions_cols``
      over the miss set only, and are admitted for later blocks;
    * keys the in-flight ``overlay`` touches are forced onto host lanes
      with the overlay's values, and never admitted from the committed
      read.

    ``read(table, u_pack_tensor)`` is the block's table read (the
    ``resident_ver_ok`` launch): it runs under the manager's lock on its
    stream after the lookup and before the admissions, which may reuse
    a slot this block hit (module docstring)."""
    U = len(pairs)
    if U > res.capacity:
        res.route_host("oversize")
        return None
    over_vals: dict[int, tuple] = {}
    forced = None
    if overlay is not None and overlay.updates:
        if u_index is None:
            u_index = dict(zip(pairs, range(U)))
        iget = u_index.get
        for pr, vv in overlay.updates.items():
            ui = iget(pr)
            if ui is None:
                continue
            if vv.value is None:  # in-flight delete
                over_vals[ui] = (0, 0, 0)
            else:
                over_vals[ui] = (1, *_ver_i32(int(vv.version[0]), int(vv.version[1])))
        if over_vals:
            forced = {pairs[ui] for ui in over_vals}
    slots = res.lookup(pairs, forced_pairs=forced)
    host_pack = np.zeros((U, 3), np.int32)
    miss_rows = [i for i in np.flatnonzero(slots < 0).tolist() if i not in over_vals]
    if miss_rows:
        miss_pairs = [pairs[i] for i in miss_rows]
        up, uv = state.get_versions_cols(miss_pairs)
        rows = np.asarray(miss_rows)
        host_pack[rows, 0] = up
        host_pack[rows, 1:3] = uv.view(np.int32)
    for ui, row in over_vals.items():
        host_pack[ui] = row
    Ub = max(_MIN_PACK, 1 << max(U - 1, 0).bit_length())
    u_pack = np.full((Ub, 4), -1, np.int32)
    u_pack[:, 1:4] = 0
    if U:
        u_pack[:U, 0] = slots
        u_pack[:U, 1:4] = host_pack
    if read is not None and not res.read(read, u_pack):
        return None
    nbytes = res.admit(miss_pairs, up, uv) if miss_rows else 0
    res.note_upload(u_pack.nbytes)
    res.observe_block(nbytes + u_pack.nbytes)
    return u_pack


class ResidencyManager:
    """See the module docstring.  ``device``: where the table lives
    (default ``"cuda"``; ``"cpu"`` runs the plain versions)."""

    def __init__(self, capacity_mb: int = 64, range_bits: int = 12,
                 slots: int | None = None, device="cuda"):
        if capacity_mb < 1:
            raise ValueError("state_resident_mb must be >= 1")
        if not (1 <= int(range_bits) <= 24):
            raise ValueError("state_resident_range_bits must be in [1, 24]")
        if slots is not None:
            # an explicit slot count: the test seam for eviction churn
            if slots < 4:
                raise ValueError("slots must be >= 4")
            self.capacity = 1 << (int(slots).bit_length() - 1)
        else:
            want = (int(capacity_mb) * (1 << 20)) // SLOT_BYTES
            self.capacity = max(MIN_SLOTS, 1 << (max(want, 1).bit_length() - 1))
        self.range_bits = int(range_bits)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)
        self._enabled = True
        self._table: torch.Tensor | None = None
        self._dir: dict[tuple, tuple] = {}  # (ns, key) → (slot, range id)
        self._ranges: OrderedDict[int, list] = OrderedDict()  # LRU
        self._free: list[int] = list(range(self.capacity - 1, -1, -1))
        self._recent: deque[tuple[int, int]] = deque(maxlen=_HIT_WINDOW)
        self._hits_total = 0
        self._misses_total = 0
        self._overlay_forced_total = 0
        self._evictions_total = 0
        self._write_admits_total = 0
        self._h2d_bytes_total = 0
        self._host_path = {"oversize": 0, "range": 0, "hashed": 0}
        self.channel = ""  # the instruments' channel label
        registry = global_registry()
        self._hits_ctr = registry.counter(
            "state_resident_hits_total",
            "unique read keys served from the device-resident table",
        )
        self._miss_ctr = registry.counter(
            "state_resident_misses_total",
            "unique read keys that fell back to the host state gather",
        )
        self._forced_ctr = registry.counter(
            "state_resident_overlay_forced_total",
            "unique read keys routed onto overlay-valued host lanes "
            "(neither a resident hit nor a state-gather miss)",
        )
        self._evict_ctr = registry.counter(
            "state_resident_evictions_total",
            "key ranges evicted from the device-resident table (LRU)",
        )
        self._write_admit_ctr = registry.counter(
            "state_resident_write_admits_total",
            "brand-new key ranges the commit write path admitted into "
            "the resident table (budgeted per block, free slots only)",
        )
        self._hit_gauge = registry.gauge(
            "state_resident_hit_rate",
            "trailing resident hit rate over unique read keys",
        )
        self._enabled_gauge = registry.gauge(
            "state_resident_enabled",
            "1 while the device-resident state cache is serving lookups",
        )
        self._h2d_hist = registry.histogram(
            "h2d_state_bytes_per_block",
            "state bytes uploaded per block on the resident path "
            "(miss fill + launch slot frame + write-set delta)",
            buckets=(256, 1024, 4096, 16384, 65536, 262144, 1048576,
                     float("inf")),
        )
        self._enabled_gauge.set(1, channel=self.channel)

    @property
    def enabled(self) -> bool:
        return self._enabled

    def _disable_locked(self, reason: str) -> None:
        """Latch the cache off (module docstring); caller holds the lock."""
        was = self._enabled
        self._enabled = False
        self._table = None
        self._dir.clear()
        self._ranges.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
        self._enabled_gauge.set(0, channel=self.channel)
        if was:
            _log.warning("device-resident state cache DISABLED (%s); blocks read their "
                         "versions on the host", reason or "unspecified")

    def range_of(self, ns: str, key: str) -> int:
        """Stable range id: the top ``range_bits`` bits of a 64-bit
        blake2b digest of ``ns \\0 key`` (the reference's hash)."""
        h = hashlib.blake2b(f"{ns}\x00{key}".encode(), digest_size=8).digest()
        return int.from_bytes(h, "big") >> (64 - self.range_bits)

    # -- the table, under the lock on the manager's stream --------------------

    def _on_stream(self):
        """The manager's stream as the current stream (CUDA only)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _ensure_table(self) -> torch.Tensor:
        if self._table is None:
            with self._on_stream():
                self._table = torch.zeros((self.capacity, 3), dtype=torch.int32,
                                          device=self.device)
            # the ledger's resident_table owner: capacity * 12 bytes
            _ledger.account_hbm("resident_table", self.capacity * SLOT_BYTES)
        return self._table

    def _scatter(self, idx: list, rows: list) -> None:
        """table[idx] = rows, in place, on the manager's stream; caller
        holds the lock."""
        table = self._ensure_table()
        with self._on_stream():
            table_scatter(table, np.asarray(idx, np.int32),
                          np.asarray(rows, np.int32).reshape(-1, 3))

    def _scatter_or_disable(self, idx: list, rows: list, what: str) -> bool:
        """``_scatter``; a failure latches the cache off → False.
        Caller holds the lock."""
        try:
            self._scatter(idx, rows)
        except Exception as e:
            self._disable_locked(f"{what} scatter failed: {e}")
            return False
        return True

    def read(self, fn, u_pack: np.ndarray) -> bool:
        """``fn(table, u_pack tensor)`` under the lock on the manager's
        stream, after the caller's stream's pending work (the block's
        operands); the caller's stream then waits for it.  The one way
        a launch reads the table.  → False, calling nothing, once the
        cache is disabled: the pack's slots came from a lookup into the
        dropped table, which no table can serve."""
        with self._lock:
            if not self._enabled:
                return False
            table = self._ensure_table()
            with self._on_stream():
                # uploaded before the wait below: a blocking copy here
                # then waits for table work only, not the caller's queue
                u = torch.from_numpy(np.ascontiguousarray(u_pack, np.int32)).to(self.device)
            if self._stream is None:
                fn(table, u)
                return True
            caller = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(caller)
            with self._on_stream():
                fn(table, u)
            caller.wait_stream(self._stream)
            return True

    def table_rows(self) -> np.ndarray:
        """A host copy of the whole table (tests and checks); zeros once
        the cache is disabled."""
        with self._lock:
            if not self._enabled:
                return np.zeros((self.capacity, 3), np.int32)
            table = self._ensure_table()
            with self._on_stream():
                return table.to("cpu").numpy()

    # -- lookups (launch path) ------------------------------------------------

    def lookup(self, pairs: list, forced_pairs: set | None = None) -> np.ndarray:
        """Unique read keys → slots [U] int32, −1 for a miss.  No table
        snapshot comes back (there is none to take): the caller reads
        the table through ``read`` before admitting.  ``forced_pairs``
        (the overlay's keys) come back −1 and are counted on their own
        counter, neither hit nor miss; their ranges still touch the LRU.
        Every hit range moves to the LRU's recent end."""
        U = len(pairs)
        slots = np.full(U, -1, np.int32)
        with self._lock:
            if not self._enabled:
                return slots
            get = self._dir.get
            touched: set[int] = set()
            hits = forced = 0
            for i, pr in enumerate(pairs):
                e = get(pr)
                if forced_pairs is not None and pr in forced_pairs:
                    forced += 1
                    if e is not None and e[1] not in touched:
                        touched.add(e[1])
                        self._ranges.move_to_end(e[1])
                    continue
                if e is not None:
                    slots[i] = e[0]
                    hits += 1
                    if e[1] not in touched:
                        touched.add(e[1])
                        self._ranges.move_to_end(e[1])
            misses = U - hits - forced
            self._hits_total += hits
            self._misses_total += misses
            self._overlay_forced_total += forced
            if hits or misses:
                self._recent.append((hits, hits + misses))
            wh = sum(h for h, _t in self._recent)
            wt = sum(t for _h, t in self._recent)
        if hits:
            self._hits_ctr.add(hits, channel=self.channel)
        if misses:
            self._miss_ctr.add(misses, channel=self.channel)
        if forced:
            self._forced_ctr.add(forced, channel=self.channel)
        if wt:
            self._hit_gauge.set(round(wh / wt, 4), channel=self.channel)
        return slots

    def route_host(self, reason: str) -> None:
        """Count a block routed to the host path: ``"oversize"`` (working
        set larger than the table), ``"range"`` (range queries) or
        ``"hashed"`` (private-collection keys, which the reference's
        resident path leaves to the host read too)."""
        with self._lock:
            self._host_path[reason] += 1

    # -- admission + eviction ---------------------------------------------------

    def admit(self, pairs: list, present: np.ndarray, vers: np.ndarray,
              evict: bool = True) -> int:
        """Admit missed keys with their committed (present, version)
        values; absent keys are admitted too (row 0: cached absence).
        Evicts LRU ranges (never one this call admits into) when the
        free pool runs dry; keys that still find no slot stay misses.
        ``evict=False`` admits into free slots only.  Returns the bytes
        scattered."""
        if not pairs:
            return 0
        idx: list[int] = []
        rows: list[tuple] = []
        with self._lock:
            if not self._enabled:
                return 0
            admitting: set[int] = set()
            for i, pr in enumerate(pairs):
                if pr in self._dir:
                    continue
                rid = self.range_of(pr[0], pr[1])
                if not self._free and not (
                        evict and self._evict_locked(protect=admitting | {rid})):
                    break  # nothing evictable: the rest stay misses
                if not self._free:
                    break
                slot = self._free.pop()
                self._dir[pr] = (slot, rid)
                admitting.add(rid)
                if rid in self._ranges:
                    self._ranges[rid].append(pr)
                    self._ranges.move_to_end(rid)
                else:
                    self._ranges[rid] = [pr]
                idx.append(slot)
                p = bool(present[i])
                rows.append((int(p), *(_ver_i32(int(vers[i][0]), int(vers[i][1]))
                                       if p else (0, 0))))
            if not idx or not self._scatter_or_disable(idx, rows, "admission"):
                return 0
            nbytes = len(idx) * SLOT_BYTES
            self._h2d_bytes_total += nbytes
        return nbytes

    def warm(self, items) -> int:
        """Bulk-admit committed ``(ns, key, (block, txnum))`` triples in
        8192-key slabs into free slots (never evicting), stopping at
        capacity.  Returns the number of keys admitted."""
        admitted = 0
        pairs: list = []
        vers: list = []

        def flush() -> bool:
            nonlocal admitted
            if not pairs:
                return True
            got = self.admit(pairs, np.ones(len(pairs), np.bool_),
                             np.asarray(vers, np.int64).reshape(-1, 2),
                             evict=False) // SLOT_BYTES
            admitted += got
            full = got < len(pairs)
            pairs.clear()
            vers.clear()
            return not full

        for ns, key, ver in items:
            pairs.append((ns, key))
            vers.append((int(ver[0]), int(ver[1])))
            if len(pairs) >= 8192 and not flush():
                return admitted
        flush()
        return admitted

    def _evict_locked(self, protect: set) -> bool:
        """Evict the least-recently-touched range not in ``protect``;
        caller holds the lock.  Evicted rows need no clear: the
        directory is authoritative, and a reused slot is scattered
        before any pack can point at it."""
        for rid in self._ranges:
            if rid in protect:
                continue
            for pr in self._ranges.pop(rid):
                e = self._dir.pop(pr, None)
                if e is not None:
                    self._free.append(e[0])
            self._evictions_total += 1
            self._evict_ctr.add(1, channel=self.channel)
            return True
        return False

    # -- the commit boundary ----------------------------------------------------

    def apply_batch(self, batch) -> int:
        """Scatter one committed block's write set into the table, at the
        pipeline's commit boundary (module docstring).  Resident keys are
        updated in place (a delete scatters present = 0).  A written key
        without a slot is admitted into a free slot when its range is
        resident; a brand-new range opens only within
        ``WRITE_ADMIT_BUDGET`` per call and never evicts.  Returns the
        bytes scattered; replaying a batch scatters the same values."""
        if batch is None or not batch.updates:
            return 0
        with self._lock:
            if not self._enabled:
                return 0
            idx: list[int] = []
            rows: list[tuple] = []
            new_rids: set[int] = set()
            for (ns, key), vv in batch.updates.items():
                pr = (ns, key)
                e = self._dir.get(pr)
                if e is None:
                    if not self._free:
                        continue  # pool dry: stays a miss
                    rid = self.range_of(ns, key)
                    if rid not in self._ranges:
                        if len(new_rids) >= WRITE_ADMIT_BUDGET:
                            continue
                        new_rids.add(rid)
                        self._ranges[rid] = []
                    slot = self._free.pop()
                    self._dir[pr] = (slot, rid)
                    self._ranges[rid].append(pr)
                else:
                    slot = e[0]
                rows.append((0, 0, 0) if vv.value is None else
                            (1, *_ver_i32(int(vv.version[0]), int(vv.version[1]))))
                idx.append(slot)
            if not idx or not self._scatter_or_disable(idx, rows, "commit"):
                return 0
            nbytes = len(idx) * SLOT_BYTES
            self._h2d_bytes_total += nbytes
            self._write_admits_total += len(new_rids)
        if new_rids:
            self._write_admit_ctr.add(len(new_rids), channel=self.channel)
        return nbytes

    def invalidate_keys(self, pairs) -> None:
        """Drop keys from residency: a committed-state write that
        bypasses ``apply_batch`` must at least invalidate, or a stale
        resident version corrupts MVCC verdicts."""
        with self._lock:
            for pr in pairs:
                e = self._dir.pop(tuple(pr), None)
                if e is None:
                    continue
                slot, rid = e
                keys = self._ranges.get(rid)
                if keys is not None:
                    if tuple(pr) in keys:
                        keys.remove(tuple(pr))
                    if not keys:
                        self._ranges.pop(rid, None)
                self._free.append(slot)

    # -- accounting -------------------------------------------------------------

    def note_upload(self, nbytes: int) -> None:
        """Count a block's u_pack bytes toward the h2d total."""
        with self._lock:
            self._h2d_bytes_total += int(nbytes)

    def observe_block(self, nbytes: int) -> None:
        """One block's state upload (admissions and u_pack) → the
        ``h2d_state_bytes_per_block`` histogram and the launch ledger's
        ``state`` h2d lane."""
        self._h2d_hist.observe(int(nbytes), channel=self.channel)
        _ledger.note_h2d("state", nbytes)

    def stats(self) -> dict:
        """The reference's keys (one shard, never resharded) plus the
        host-path routings."""
        with self._lock:
            wh = sum(h for h, _t in self._recent)
            wt = sum(t for _h, t in self._recent)
            return {
                "enabled": self._enabled,
                "capacity_slots": self.capacity,
                "range_bits": self.range_bits,
                "shards": 1,
                "slots_per_shard": self.capacity,
                "reshards_total": 0,
                "resident_keys": len(self._dir),
                "resident_ranges": len(self._ranges),
                "hits_total": self._hits_total,
                "misses_total": self._misses_total,
                "overlay_forced_total": self._overlay_forced_total,
                "hit_rate": round(wh / wt, 4) if wt else None,
                "evictions_total": self._evictions_total,
                "write_admits_total": self._write_admits_total,
                "write_admit_budget": WRITE_ADMIT_BUDGET,
                "h2d_bytes_total": self._h2d_bytes_total,
                "host_path_oversize_total": self._host_path["oversize"],
                "host_path_range_total": self._host_path["range"],
                "host_path_hashed_total": self._host_path["hashed"],
            }
