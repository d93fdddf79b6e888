"""Versioned state: the SPI, in memory and in sqlite (counterpart:
``fabric_tpu/ledger/statedb.py``, all but ``ColumnarUpdateBatch``).

Keyed (namespace, key) → (value, version, metadata); the validator
reads committed versions for every read key of a block
(``get_versions_bulk``, or ``get_versions_cols`` for the resident-state
miss set) and re-runs recorded range queries against it
(``get_state_range``).  A private collection's hashed keys live in the
namespace ``ns$coll#hashed`` under the key hash's hex.  ``metadata``
is a key's encoded metadata map (``ledger/rwset.encode_metadata``);
``meta_count`` counts the committed keys that carry any, so a channel
that never sets key-level policies skips the key-level endorsement
probes (the reference's :318-396).

``VersionedDB`` is the SPI the ledger opens (``KVLedger``,
``AsyncApplyEngine``, snapshots): savepoints (``apply_updates(batch,
savepoint)``, ``savepoint()``), range reads, rich queries and
``iter_all`` in (ns, key) order.  ``MemVersionedDB`` dies with the
process (``durable = False``: the ledger recovers it by replay);
``SqliteVersionedDB`` is the durable backend (WAL, ``synchronous=
NORMAL``), its rich queries sqlite's JSON1 ``json_extract``, the
stand-in for CouchDB selectors.  ``VersionedValue`` orders its fields
(value, version, metadata), the reference's (value, metadata,
version); both are built by keyword here.
"""

from __future__ import annotations

import json
import sqlite3
import threading
from bisect import bisect_left
from dataclasses import dataclass

import numpy as np

Version = tuple[int, int]


@dataclass
class VersionedValue:
    value: bytes | None
    version: Version
    metadata: bytes | None = None


class UpdateBatch:
    """Accumulated writes of a block (analog statedb.UpdateBatch);
    ``has_meta``: some entry carries key metadata."""

    def __init__(self):
        self.updates: dict = {}  # (ns, key) -> VersionedValue (value None = delete)
        self.has_meta = False

    def put(self, ns: str, key: str, value: bytes | None, version: Version,
            metadata: bytes | None = None):
        if metadata:
            self.has_meta = True
        self.updates[(ns, key)] = VersionedValue(value, version, metadata)

    def delete(self, ns: str, key: str, version: Version):
        self.put(ns, key, None, version)

    def items(self):
        return self.updates.items()

    def touches_namespace(self, ns: str) -> bool:
        """Some entry writes ``ns`` (the pipeline's lifecycle barrier)."""
        return any(k[0] == ns for k in self.updates)

    @classmethod
    def merged(cls, batches):
        """One overlay over a chain of in-flight predecessor batches,
        oldest first, newest-wins per key, ``has_meta`` the union.  None
        for an empty chain, the batch itself for a singleton."""
        batches = [b for b in batches if b is not None]
        if not batches:
            return None
        if len(batches) == 1:
            return batches[0]
        out = cls()
        for b in batches:
            out.updates.update(b.updates)
            out.has_meta |= b.has_meta
        return out


def _selector_match(value: bytes | None, sel: dict) -> bool:
    """A CouchDB-style equality selector over a JSON value."""
    if value is None:
        return False
    try:
        doc = json.loads(value)
    except (ValueError, UnicodeDecodeError):
        return False
    return isinstance(doc, dict) and all(doc.get(f) == want for f, want in sel.items())


class VersionedDB:
    """The state SPI (the reference's :224, statedb.go:36-76).
    ``durable``: the backend outlives the process, so the ledger keeps
    the block store's fsync ahead of its savepoint."""

    durable: bool = True
    meta_count: int = 0

    def open(self) -> None: ...
    def close(self) -> None: ...

    def get_state(self, ns: str, key: str) -> VersionedValue | None:
        raise NotImplementedError

    def get_version(self, ns: str, key: str) -> Version | None:
        vv = self.get_state(ns, key)
        return vv.version if vv else None

    def get_versions_bulk(self, keys) -> dict:
        """{(ns, key): Version} for the present keys."""
        out = {}
        for ns, key in keys:
            v = self.get_version(ns, key)
            if v is not None:
                out[(ns, key)] = v
        return out

    def get_versions_cols(self, keys):
        """Column form of ``get_versions_bulk``: → ``(present [U] bool,
        vers [U, 2] uint32)`` aligned with ``keys``."""
        present = np.zeros(len(keys), bool)
        vers = np.zeros((len(keys), 2), np.uint32)
        got = self.get_versions_bulk(keys)
        for i, k in enumerate(keys):
            v = got.get(k)
            if v is not None:
                present[i] = True
                vers[i] = v
        return present, vers

    def iter_all(self):
        """Yield ((ns, key), VersionedValue) over the whole state in
        (ns, key) order."""
        raise NotImplementedError

    def get_state_range(self, ns: str, start: str, end: str, limit: int = 0):
        """Yield (key, VersionedValue) for start <= key < end in key
        order ('' end = unbounded; ``limit`` 0 = all)."""
        raise NotImplementedError

    def execute_query(self, ns: str, query: dict, limit: int = 0):
        raise NotImplementedError("rich queries unsupported by this backend")

    def apply_updates(self, batch: UpdateBatch, savepoint: Version | None = None) -> None:
        raise NotImplementedError

    def savepoint(self) -> Version | None:
        raise NotImplementedError


class MemVersionedDB(VersionedDB):
    """In-memory state.  Range iteration takes a lock against a
    concurrent ``apply_updates`` (the commit pipeline applies block n on
    its committer thread while block n+1 re-runs its range queries);
    per-key read ordering under that overlap is the validator's overlay.
    ``apply_updates(batch)`` with no savepoint keeps the last one."""

    durable = False

    def __init__(self):
        self._data: dict = {}          # (ns, key) -> VersionedValue
        self._sorted_cache: dict = {}  # ns -> sorted key list
        self._savepoint: Version | None = None
        self._lock = threading.Lock()
        self.meta_count = 0            # committed keys carrying metadata

    def get_state(self, ns: str, key: str) -> VersionedValue | None:
        return self._data.get((ns, key))

    def get_versions_bulk(self, keys) -> dict:
        """{(ns, key): Version} for the present keys."""
        out = {}
        for k in keys:
            vv = self._data.get(k)
            if vv is not None:
                out[k] = vv.version
        return out

    def get_versions_cols(self, keys):
        present = np.zeros(len(keys), bool)
        vers = np.zeros((len(keys), 2), np.uint32)
        get = self._data.get
        for i, k in enumerate(keys):
            vv = get(k)
            if vv is not None:
                present[i] = True
                vers[i] = vv.version
        return present, vers

    def _sorted_keys(self, ns):
        keys = self._sorted_cache.get(ns)
        if keys is None:
            keys = sorted(k for (n, k) in self._data if n == ns)
            self._sorted_cache[ns] = keys
        return keys

    def iter_all(self):
        with self._lock:
            rows = [(k, self._data[k]) for k in sorted(self._data)]
        yield from rows

    def get_state_range(self, ns, start, end, limit=0):
        with self._lock:
            keys = self._sorted_keys(ns)
            i = bisect_left(keys, start)
            rows = []
            while i < len(keys) and (not end or keys[i] < end):
                vv = self._data.get((ns, keys[i]))
                if vv is not None:
                    rows.append((keys[i], vv))
                i += 1
                if limit and len(rows) >= limit:
                    break
        yield from rows

    def execute_query(self, ns, query, limit=0):
        """CouchDB-selector equality matching over JSON values."""
        sel = query.get("selector", {})
        with self._lock:
            keys = list(self._sorted_keys(ns))
        n = 0
        for key in keys:
            vv = self._data.get((ns, key))
            if vv is not None and _selector_match(vv.value, sel):
                yield key, vv
                n += 1
                if limit and n >= limit:
                    return

    def apply_updates(self, batch, savepoint=None):
        with self._lock:
            for (ns, key), vv in batch.items():
                old = self._data.get((ns, key))
                if old is not None and old.metadata:
                    self.meta_count -= 1
                if vv.value is None:
                    self._data.pop((ns, key), None)
                else:
                    if vv.metadata:
                        self.meta_count += 1
                    self._data[(ns, key)] = vv
                self._sorted_cache.pop(ns, None)
            if savepoint is not None:
                self._savepoint = tuple(savepoint)

    def savepoint(self):
        return self._savepoint


class SqliteVersionedDB(VersionedDB):
    """Durable state in sqlite (WAL), the reference's :406 and its file
    layout: a chain written by either package opens in the other.
    Every read and write takes one lock (the connection is shared by
    the validator's threads and the applier thread)."""

    def __init__(self, path: str):
        self.path = path
        self._conn: sqlite3.Connection | None = None
        self._lock = threading.RLock()

    def open(self):
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        c = self._conn
        c.execute("PRAGMA journal_mode=WAL")
        c.execute("PRAGMA synchronous=NORMAL")
        c.execute("CREATE TABLE IF NOT EXISTS state ("
                  " ns TEXT NOT NULL, key TEXT NOT NULL,"
                  " value BLOB, metadata BLOB,"
                  " block INTEGER NOT NULL, txnum INTEGER NOT NULL,"
                  " PRIMARY KEY (ns, key))")
        c.execute("CREATE TABLE IF NOT EXISTS savepoint ("
                  " id INTEGER PRIMARY KEY CHECK (id = 0),"
                  " block INTEGER, txnum INTEGER)")
        c.commit()
        self.meta_count = c.execute(
            "SELECT COUNT(*) FROM state WHERE metadata IS NOT NULL AND metadata != x''"
        ).fetchone()[0]

    def close(self):
        with self._lock:
            if self._conn:
                self._conn.close()
                self._conn = None

    def get_state(self, ns, key):
        with self._lock:
            row = self._conn.execute(
                "SELECT value, metadata, block, txnum FROM state WHERE ns=? AND key=?",
                (ns, key)).fetchone()
        if row is None:
            return None
        return VersionedValue(row[0], (row[2], row[3]), row[1])

    def get_versions_bulk(self, keys):
        out = {}
        with self._lock:
            cur = self._conn.cursor()
            for ns, key in keys:
                row = cur.execute("SELECT block, txnum FROM state WHERE ns=? AND key=?",
                                  (ns, key)).fetchone()
                if row:
                    out[(ns, key)] = (row[0], row[1])
        return out

    def get_versions_cols(self, keys):
        present = np.zeros(len(keys), bool)
        vers = np.zeros((len(keys), 2), np.uint32)
        with self._lock:
            cur = self._conn.cursor()
            for i, (ns, key) in enumerate(keys):
                row = cur.execute("SELECT block, txnum FROM state WHERE ns=? AND key=?",
                                  (ns, key)).fetchone()
                if row:
                    present[i] = True
                    vers[i] = row
        return present, vers

    def _rows(self, q: str, args) -> list:
        with self._lock:
            return self._conn.execute(q, args).fetchall()

    def iter_all(self):
        for ns, key, value, md, blk, txn in self._rows(
                "SELECT ns, key, value, metadata, block, txnum FROM state ORDER BY ns, key", ()):
            yield (ns, key), VersionedValue(value, (blk, txn), md)

    def get_state_range(self, ns, start, end, limit=0):
        q = "SELECT key, value, metadata, block, txnum FROM state WHERE ns=? AND key>=?"
        args = [ns, start]
        if end:
            q += " AND key<?"
            args.append(end)
        q += " ORDER BY key"
        if limit:
            q += f" LIMIT {int(limit)}"
        for key, value, md, blk, txn in self._rows(q, args):
            yield key, VersionedValue(value, (blk, txn), md)

    def execute_query(self, ns, query, limit=0):
        """Rich queries through sqlite's JSON1 (the reference's :499).
        A value that is not JSON never matches; the reference's query
        raises ``malformed JSON`` on one (it extracts before it checks)."""
        sel = query.get("selector", {})
        q = "SELECT key, value, metadata, block, txnum FROM state WHERE ns=? AND json_valid(value)"
        args: list = [ns]
        for fld, want in sel.items():
            q += " AND CASE WHEN json_valid(value) THEN json_extract(value, ?) END = ?"
            args += [f"$.{fld}", want]
        q += " ORDER BY key"
        if limit:
            q += f" LIMIT {int(limit)}"
        for key, value, md, blk, txn in self._rows(q, args):
            yield key, VersionedValue(value, (blk, txn), md)

    def apply_updates(self, batch, savepoint=None):
        with self._lock:
            cur = self._conn.cursor()
            # no committed key carries metadata: skip the per-key probe
            track = self.meta_count > 0
            for (ns, key), vv in batch.items():
                if track:
                    row = cur.execute("SELECT metadata FROM state WHERE ns=? AND key=?",
                                      (ns, key)).fetchone()
                    if row is not None and row[0]:
                        self.meta_count -= 1
                if vv.value is None:
                    cur.execute("DELETE FROM state WHERE ns=? AND key=?", (ns, key))
                else:
                    if vv.metadata:
                        self.meta_count += 1
                    cur.execute("INSERT OR REPLACE INTO state VALUES (?,?,?,?,?,?)",
                                (ns, key, vv.value, vv.metadata, vv.version[0],
                                 vv.version[1]))
            if savepoint is not None:
                cur.execute("INSERT OR REPLACE INTO savepoint VALUES (0,?,?)",
                            (savepoint[0], savepoint[1]))
            self._conn.commit()

    def savepoint(self):
        with self._lock:
            row = self._conn.execute("SELECT block, txnum FROM savepoint WHERE id=0").fetchone()
        return (row[0], row[1]) if row else None
