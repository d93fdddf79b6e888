"""Append-only block store with a sqlite index and crash recovery
(counterpart: ``fabric_tpu/ledger/blockstore.py``).

Blocks are length-prefixed serialized ``Block`` messages in numbered
segment files (``blocks_000000.bin``, 64 MiB each); ``index.db`` maps
number, header hash and tx id to (segment, offset).  The on-disk format
is the reference's: a chain written by either package opens in the
other.  Blocks decode through ``protos/messages.py``, whose
``DecodeError`` takes the place of ``google.protobuf``'s.

On open, a torn tail record (a crash mid-append) is truncated and the
index is rebuilt forward from the last indexed block, and clamped back
to the files: the files are the source of truth in both directions.

Group commit (``group_commit`` blocks, ``group_max_lag_s`` while
traffic flows): the segment is fsynced once a window, so a crash
inside the window loses the unsynced tail, which ``_recover`` truncates
and redelivery or replay re-commits.  ``sync()`` closes the window,
``ensure_synced(num)`` is the durability fence of the async applier,
``close()`` syncs.  ``ledger.fsync.before`` and ``ledger.fsync.after``
fire around every ``os.fsync``.  ``stats()["fsyncs"]`` counts the
fsyncs by the trigger that closed their window, and so does the
registry's ``blockstore_fsync_total{trigger}`` (the reference's :210-224):
``group``, ``lag``, ``forced``, ``apply``.

Where the port departs: the index connection runs one statement at a
time under a lock (``_LockedIndex``).  The committer writes it while a
deliver loop's launch checks tx ids and the event loop answers commit
statuses; the reference shares its connection unguarded, and a status
read beside a launch raised ``InterfaceError`` there.
"""

from __future__ import annotations

import os
import sqlite3
import struct
import threading
import time

from fabric_tpu_torch import faults as _faults
from fabric_tpu_torch import protoutil
from fabric_tpu_torch.protos import messages as m
from fabric_tpu_torch.protos.wire import DecodeError

_SEGMENT_MAX = 64 * 1024 * 1024
_LEN = struct.Struct("<I")
_TRIGGERS = ("group", "lag", "forced", "apply")


def _tx_id(env_bytes: bytes) -> str:
    """The channel header's tx id of a serialized envelope ('' when it
    does not parse)."""
    try:
        env = m.Envelope.parse(env_bytes)
        payload = m.Payload.parse(env.payload)
        ch = m.ChannelHeader.parse((payload.header or m.Header()).channel_header)
    except DecodeError:
        return ""
    return ch.tx_id


class _Rows(list):
    """A statement's fetched rows, read as its cursor would be."""

    def fetchone(self):
        return self[0] if self else None


class _LockedIndex:
    """The index connection, one statement at a time: the committer
    writes it while a deliver loop's launch checks tx ids and the event
    loop answers commit statuses, and one sqlite3 connection used from
    two threads at once raises ``InterfaceError`` ("bad parameter or
    other API misuse").  ``execute`` returns the rows fetched."""

    def __init__(self, conn):
        self._conn = conn
        self._lock = threading.Lock()

    def execute(self, *args) -> _Rows:
        with self._lock:
            return _Rows(self._conn.execute(*args).fetchall())

    def executemany(self, *args) -> None:
        with self._lock:
            self._conn.executemany(*args)

    def commit(self) -> None:
        with self._lock:
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class BlockStore:
    def __init__(self, dirpath: str, group_commit: int = 8, group_max_lag_s: float = 0.5):
        self.dir = dirpath
        self.group_commit = max(1, int(group_commit))
        self.group_max_lag_s = group_max_lag_s
        self._unsynced = 0
        self._oldest_unsynced: float | None = None
        self.fsyncs = dict.fromkeys(_TRIGGERS, 0)
        self._fsync_ctr = None  # blockstore_fsync_total, looked up at first use
        self._last_hash: bytes | None = None
        # serializes segment writes and fsyncs between the committer
        # (add_block) and the applier thread (ensure_synced)
        self._io_lock = threading.Lock()
        os.makedirs(dirpath, exist_ok=True)
        self._idx = _LockedIndex(sqlite3.connect(os.path.join(dirpath, "index.db"),
                                                 check_same_thread=False))
        self._idx.execute("PRAGMA journal_mode=WAL")
        # derived state, rebuilt from the files: NORMAL keeps the WAL
        # checkpoint crash-safe without an fsync a commit
        self._idx.execute("PRAGMA synchronous=NORMAL")
        self._idx.execute("CREATE TABLE IF NOT EXISTS blocks ("
                          " num INTEGER PRIMARY KEY, hash BLOB, seg INTEGER, off INTEGER)")
        self._idx.execute("CREATE TABLE IF NOT EXISTS txids ("
                          " txid TEXT PRIMARY KEY, num INTEGER, txnum INTEGER, code INTEGER)")
        self._idx.execute("CREATE INDEX IF NOT EXISTS blocks_hash ON blocks(hash)")
        self._idx.execute("CREATE TABLE IF NOT EXISTS bootstrap ("
                          " id INTEGER PRIMARY KEY CHECK (id = 0),"
                          " first_block INTEGER, prev_hash BLOB, commit_hash BLOB)")
        self._recover()
        # what recovery left in the files is durable (or was truncated)
        self._last_appended = self.height - 1
        self._synced_num = self._last_appended

    # -- segment files ------------------------------------------------------

    def _seg_path(self, seg: int) -> str:
        return os.path.join(self.dir, f"blocks_{seg:06d}.bin")

    def _segments(self) -> list:
        return sorted(int(n[7:13]) for n in os.listdir(self.dir)
                      if n.startswith("blocks_") and n.endswith(".bin"))

    def _recover(self) -> None:
        """Truncate a torn tail record, index blocks past the last
        indexed one, and clamp the index back to the files (the
        reference's :105)."""
        segs = self._segments()
        if not segs:
            self._seg = 0
            self._fh = open(self._seg_path(0), "ab")
            return
        last = segs[-1]
        path = self._seg_path(last)
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            off = 0
            while off + _LEN.size <= size:
                (n,) = _LEN.unpack(f.read(_LEN.size))
                if off + _LEN.size + n > size:
                    break
                f.seek(n, 1)
                off += _LEN.size + n
        if off < size:
            with open(path, "ab") as f:
                f.truncate(off)
        row = self._idx.execute("SELECT MAX(num) FROM blocks").fetchone()
        next_num = (row[0] + 1) if row[0] is not None else 0
        file_max = -1
        for seg in segs:
            for block, offset in self._scan(seg):
                file_max = max(file_max, block.header.number)
                if block.header.number >= next_num:
                    self._index_block(block, seg, offset)
        if next_num - 1 > file_max:
            self._idx.execute("DELETE FROM blocks WHERE num > ?", (file_max,))
            self._idx.execute("DELETE FROM txids WHERE num > ?", (file_max,))
        self._idx.commit()
        self._seg = last
        self._fh = open(path, "ab")

    def _scan(self, seg: int):
        with open(self._seg_path(seg), "rb") as f:
            off = 0
            while True:
                hdr = f.read(_LEN.size)
                if len(hdr) < _LEN.size:
                    return
                (n,) = _LEN.unpack(hdr)
                data = f.read(n)
                if len(data) < n:
                    return
                yield m.Block.parse(data), off
                off += _LEN.size + n

    # -- index ----------------------------------------------------------------

    def _index_block(self, block: m.Block, seg: int, off: int, txids=None) -> None:
        """``txids``: the commit path's parsed [(txid, tx_num)], else
        each envelope is parsed for its channel header."""
        self._idx.execute("INSERT OR REPLACE INTO blocks VALUES (?,?,?,?)",
                          (block.header.number, protoutil.block_header_hash(block.header),
                           seg, off))
        flags = protoutil.get_tx_filter(block)
        if txids is None:
            data = block.data.data if block.data is not None else ()
            txids = [(t, i) for i, t in enumerate(map(_tx_id, data)) if t]
        self._idx.executemany(
            "INSERT OR IGNORE INTO txids VALUES (?,?,?,?)",
            [(txid, block.header.number, i, flags[i] if i < len(flags) else 254)
             for txid, i in txids if txid])

    # -- public API -------------------------------------------------------------

    @property
    def unsynced(self) -> int:
        """Blocks appended since the last fsync."""
        return self._unsynced

    def stats(self) -> dict:
        return {"fsyncs": dict(self.fsyncs), "unsynced": self._unsynced,
                "synced_height": self.synced_height}

    @property
    def height(self) -> int:
        row = self._idx.execute("SELECT MAX(num) FROM blocks").fetchone()
        if row[0] is not None:
            return row[0] + 1
        boot = self._idx.execute("SELECT first_block FROM bootstrap WHERE id=0").fetchone()
        return boot[0] if boot else 0

    def bootstrap_from_snapshot(self, first_block: int, prev_hash: bytes, txid_codes,
                                commit_hash: bytes = b"") -> None:
        """Position an empty store at a snapshot boundary: height
        ``first_block``, the snapshot's tx ids with their codes in the
        duplicate index, the chain anchors kept for reopen."""
        if self.height != 0:
            raise ValueError("bootstrap requires an empty block store")
        self._idx.execute("INSERT OR REPLACE INTO bootstrap VALUES (0, ?, ?, ?)",
                          (first_block, prev_hash, commit_hash))
        self._idx.executemany("INSERT OR IGNORE INTO txids VALUES (?,?,?,?)",
                              ((t, -1, -1, c) for t, c in txid_codes))
        self._idx.commit()

    def bootstrap_info(self):
        """→ (first_block, prev_hash, commit_hash) or None."""
        boot = self._idx.execute(
            "SELECT first_block, prev_hash, commit_hash FROM bootstrap WHERE id=0").fetchone()
        return tuple(boot) if boot else None

    def iter_txid_codes(self):
        """(txid, validation code) in txid order (snapshot export)."""
        for t, c in self._idx.execute("SELECT txid, code FROM txids ORDER BY txid"):
            yield t, int(c)

    def expected_prev_hash(self) -> bytes | None:
        """The previous_hash the next block must carry, when known (the
        last block's header hash, or the snapshot anchor)."""
        if self._last_hash is not None:
            return self._last_hash
        row = self._idx.execute("SELECT MAX(num) FROM blocks").fetchone()
        if row[0] is not None:
            self._last_hash = self._idx.execute(
                "SELECT hash FROM blocks WHERE num=?", (row[0],)).fetchone()[0]
            return self._last_hash
        boot = self.bootstrap_info()
        return boot[1] if boot else None

    def add_block(self, block: m.Block, txids=None, hd_bytes: bytes | None = None) -> None:
        """Append ``block`` (the reference's :292): its number must be
        the height and its previous_hash the last block's hash.
        ``hd_bytes``: ``protoutil.block_header_data_bytes(block)`` made
        off the commit thread; the metadata is spliced on here."""
        if block.header.number != self.height:
            raise ValueError(f"block number {block.header.number} != height {self.height}")
        want_prev = self.expected_prev_hash()
        if want_prev and block.header.previous_hash != want_prev:
            raise ValueError(f"block {block.header.number} previous_hash does not "
                             "extend this chain")
        data = (protoutil.append_block_metadata(hd_bytes, block) if hd_bytes is not None
                else block.serialize())
        with self._io_lock:
            if self._fh.tell() + len(data) > _SEGMENT_MAX and self._fh.tell() > 0:
                self._sync_locked("forced")  # a finished segment is durable
                self._fh.close()
                self._seg += 1
                self._fh = open(self._seg_path(self._seg), "ab")
            off = self._fh.tell()
            self._fh.write(_LEN.pack(len(data)))
            self._fh.write(data)
            self._fh.flush()
            self._last_appended = block.header.number
            self._unsynced += 1
            if self._oldest_unsynced is None:
                self._oldest_unsynced = time.monotonic()
            if self._unsynced >= self.group_commit:
                self._sync_locked("group")
            elif time.monotonic() - self._oldest_unsynced >= self.group_max_lag_s:
                self._sync_locked("lag")
        self._index_block(block, self._seg, off, txids=txids)
        self._idx.commit()
        self._last_hash = protoutil.block_header_hash(block.header)

    def _read_at(self, seg: int, off: int) -> m.Block | None:
        try:
            with open(self._seg_path(seg), "rb") as f:
                f.seek(off)
                (n,) = _LEN.unpack(f.read(_LEN.size))
                return m.Block.parse(f.read(n))
        except (OSError, struct.error):
            return None

    def get_block(self, number: int) -> m.Block | None:
        row = self._idx.execute("SELECT seg, off FROM blocks WHERE num=?", (number,)).fetchone()
        return self._read_at(*row) if row else None

    def get_block_by_hash(self, h: bytes) -> m.Block | None:
        row = self._idx.execute("SELECT seg, off FROM blocks WHERE hash=?", (h,)).fetchone()
        return self._read_at(*row) if row else None

    def get_tx_loc(self, txid: str):
        """→ (block_num, tx_num, validation_code) or None."""
        row = self._idx.execute("SELECT num, txnum, code FROM txids WHERE txid=?",
                                (txid,)).fetchone()
        return tuple(row) if row else None

    def tx_exists(self, txid: str) -> bool:
        return self.get_tx_loc(txid) is not None

    def iter_blocks(self, start: int = 0):
        num = start
        while True:
            blk = self.get_block(num)
            if blk is None:
                return
            yield blk
            num += 1

    def _count_fsync(self, trigger: str) -> None:
        """``blockstore_fsync_total{trigger}``: how each fsync window
        closed (the registry is looked up at the first fsync)."""
        ctr = self._fsync_ctr
        if ctr is None:
            from fabric_tpu_torch.ops_metrics import global_registry

            ctr = self._fsync_ctr = global_registry().counter(
                "blockstore_fsync_total",
                "segment fsyncs by closing trigger",
            )
        ctr.add(1, trigger=trigger)

    def _sync_locked(self, trigger: str) -> None:
        # the caller holds _io_lock
        if self._unsynced:
            self.fsyncs[trigger] += 1
            self._count_fsync(trigger)
            self._fh.flush()
            _faults.fire("ledger.fsync.before")
            os.fsync(self._fh.fileno())
            _faults.fire("ledger.fsync.after")
            self._unsynced = 0
            self._oldest_unsynced = None
        self._synced_num = self._last_appended

    def sync(self) -> None:
        """Fsync any open group-commit window."""
        with self._io_lock:
            self._sync_locked("forced")

    @property
    def synced_height(self) -> int:
        """The highest block known durable, plus one."""
        return self._synced_num + 1

    def ensure_synced(self, num: int) -> None:
        """Make every block up to ``num`` durable before returning."""
        with self._io_lock:
            if num > self._synced_num:
                self._sync_locked("apply")

    def abandon(self) -> None:
        """Close the files without a sync (``KVLedger.abort``)."""
        self._fh.close()
        self._idx.close()

    def close(self):
        self.sync()
        self._fh.close()
        self._idx.close()
