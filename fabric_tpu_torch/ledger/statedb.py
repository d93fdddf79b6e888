"""Versioned state, in memory (counterpart: ``fabric_tpu/ledger/statedb.py``,
the ``UpdateBatch`` and ``MemVersionedDB`` part).

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
"""

from __future__ import annotations

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


class MemVersionedDB:
    """In-memory state.  Range iteration takes a lock against a
    concurrent ``apply_updates`` (the commit pipeline applies block n on
    its committer thread while block n+1 re-runs its range queries);
    per-key read ordering under that overlap is the validator's overlay."""

    def __init__(self):
        self._data: dict = {}          # (ns, key) -> VersionedValue
        self._sorted_cache: dict = {}  # ns -> sorted key list
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
        """Column form of ``get_versions_bulk``: → ``(present [U] bool,
        vers [U, 2] uint32)`` aligned with ``keys``."""
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

    def get_state_range(self, ns, start, end):
        """Yield (key, VersionedValue) for start <= key < end in key
        order ('' end = unbounded)."""
        with self._lock:
            keys = self._sorted_keys(ns)
            i = bisect_left(keys, start)
            rows = []
            while i < len(keys) and (not end or keys[i] < end):
                vv = self._data.get((ns, keys[i]))
                if vv is not None:
                    rows.append((keys[i], vv))
                i += 1
        yield from rows

    def apply_updates(self, batch):
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
