"""Versioned state, in memory (counterpart: ``fabric_tpu/ledger/statedb.py``,
the ``UpdateBatch`` and ``MemVersionedDB`` part).

Keyed (namespace, key) → (value, version); the validator reads
committed versions for every read key of a block and re-runs recorded
range queries against it (``get_state_range``).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from dataclasses import dataclass

Version = tuple[int, int]


@dataclass
class VersionedValue:
    value: bytes | None
    version: Version


class UpdateBatch:
    """Accumulated writes of a block (analog statedb.UpdateBatch)."""

    def __init__(self):
        self.updates: dict = {}  # (ns, key) -> VersionedValue (value None = delete)

    def put(self, ns: str, key: str, value: bytes | None, version: Version):
        self.updates[(ns, key)] = VersionedValue(value, version)

    def delete(self, ns: str, key: str, version: Version):
        self.put(ns, key, None, version)

    def items(self):
        return self.updates.items()

    @classmethod
    def merged(cls, batches):
        """One overlay over a chain of in-flight predecessor batches,
        oldest first, newest-wins per key.  None for an empty chain,
        the batch itself for a singleton."""
        batches = [b for b in batches if b is not None]
        if not batches:
            return None
        if len(batches) == 1:
            return batches[0]
        out = cls()
        for b in batches:
            out.updates.update(b.updates)
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

    def get_versions_bulk(self, keys) -> dict:
        """{(ns, key): Version} for the present keys."""
        out = {}
        for k in keys:
            vv = self._data.get(k)
            if vv is not None:
                out[k] = vv.version
        return out

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
                if vv.value is None:
                    self._data.pop((ns, key), None)
                else:
                    self._data[(ns, key)] = vv
                self._sorted_cache.pop(ns, None)
