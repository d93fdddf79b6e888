"""Read/write sets in host form (counterpart: ``fabric_tpu/ledger/rwset.py``
without the protobuf wire form).

A ``TxRWSet`` is the namespace-keyed dict of reads, writes and range
queries that the front end decodes from a transaction's results and the
MVCC preparation (``ops/mvcc.prepare_block_static``) flattens into
arrays.  ``metadata_writes`` (key-level endorsement) and ``hashed``
(private-collection) entries are carried so the validator can refuse
them: they belong to a later slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

Version = tuple[int, int]  # (block_num, tx_num)


@dataclass
class NsRWSet:
    reads: dict = field(default_factory=dict)        # key -> Version | None
    writes: dict = field(default_factory=dict)       # key -> bytes | None (None = delete)
    range_queries: list = field(default_factory=list)  # (start, end, [(key, ver)])
    metadata_writes: dict = field(default_factory=dict)  # key -> {name: bytes}
    hashed: dict = field(default_factory=dict)       # collection -> hashed reads/writes


@dataclass
class TxRWSet:
    ns: dict = field(default_factory=dict)  # namespace -> NsRWSet

    def ns_rwset(self, namespace: str) -> NsRWSet:
        return self.ns.setdefault(namespace, NsRWSet())

    def mvcc_form(self):
        """→ (reads, writes, range_reads) with composite keys
        ``('pub', ns, key)`` for ``ops.mvcc.TxRWSet``.  An empty range
        end is an unbounded scan: ``ns + "\\x00"`` sorts after every key
        of the namespace, so the id interval covers all of it."""
        reads, writes, rqs = [], [], []
        for name in sorted(self.ns):
            n = self.ns[name]
            for k, ver in sorted(n.reads.items()):
                reads.append((("pub", name, k), ver))
            for k in sorted(n.writes):
                writes.append(("pub", name, k))
            for start, end, results in n.range_queries:
                for k, ver in results:
                    reads.append((("pub", name, k), ver))
                hi = ("pub", name, end) if end else ("pub", name + "\x00", "")
                rqs.append((("pub", name, start), hi))
        return reads, writes, rqs
