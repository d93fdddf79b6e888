"""Read/write sets (counterpart: ``fabric_tpu/ledger/rwset.py``).

A ``TxRWSet`` is the namespace-keyed dict of reads, writes and range
queries that the front end decodes from a transaction's results
(``from_bytes``, the wire form of ``rwset.TxReadWriteSet``) and the
MVCC preparation (``ops/mvcc.prepare_block_static``) flattens into
arrays.  ``metadata_writes`` carry key-level endorsement (a key's
``VALIDATION_PARAMETER`` entry is a serialized
``SignaturePolicyEnvelope``; ``encode_metadata`` / ``decode_metadata``
are the state DB's form of an entry map, the reference's :33-53), and
``hashed`` the private-collection reads and writes by key hash, which
``mvcc_form`` gives as ``('pvt', ns, coll, key_hash)`` keys: they sort
after every ``('pub', ...)`` key, a disjoint id range of one key table
(the reference's :165-197).  The host form holds
everything the reference's does, with the reference's losses: a range
query keeps its raw reads only (a Merkle summary reads as no results),
a repeated namespace merges into one entry, and a repeated key keeps
its last read or write.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from fabric_tpu_torch.protos import messages as pm

Version = tuple[int, int]  # (block_num, tx_num)

# the metadata entry that carries a key-level endorsement policy
VALIDATION_PARAMETER = "VALIDATION_PARAMETER"


def encode_metadata(entries: dict) -> bytes | None:
    """{name: value} → the state DB's bytes (a ``KVMetadataWrite`` with
    an empty key, entries by name); an empty map (metadata cleared) →
    None."""
    if not entries:
        return None
    return pm.KVMetadataWrite(key="", entries=[
        pm.KVMetadataEntry(name=n, value=entries[n]) for n in sorted(entries)]).serialize()


def decode_metadata(raw: bytes | None) -> dict:
    if not raw:
        return {}
    return {e.name: e.value for e in pm.KVMetadataWrite.parse(raw).entries}


def _version(ver):
    return None if ver is None else pm.Version(block_num=ver[0], tx_num=ver[1])


def _ver(v):
    return None if v is None else (v.block_num, v.tx_num)


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

    # -- wire form ---------------------------------------------------------

    def to_bytes(self) -> bytes:
        """The serialized ``TxReadWriteSet`` (the reference's
        ``to_proto().SerializeToString()``, byte for byte)."""
        out = pm.TxReadWriteSet(data_model=0)
        for name in sorted(self.ns):
            n = self.ns[name]
            kv = pm.KVRWSet()
            kv.reads = [pm.KVRead(key=k, version=_version(n.reads[k])) for k in sorted(n.reads)]
            kv.range_queries_info = [
                pm.RangeQueryInfo(start_key=start, end_key=end, itr_exhausted=True,
                                  raw_reads=pm.QueryReads(kv_reads=[
                                      pm.KVRead(key=k, version=_version(ver))
                                      for k, ver in results]) if results else None)
                for start, end, results in n.range_queries]
            kv.writes = [pm.KVWrite(key=k, is_delete=n.writes[k] is None,
                                    value=n.writes[k] or b"") for k in sorted(n.writes)]
            kv.metadata_writes = [
                pm.KVMetadataWrite(key=k, entries=[
                    pm.KVMetadataEntry(name=e, value=n.metadata_writes[k][e])
                    for e in sorted(n.metadata_writes[k])])
                for k in sorted(n.metadata_writes)]
            ns_pb = pm.NsReadWriteSet(namespace=name, rwset=kv.serialize())
            for coll in sorted(n.hashed):
                cdata = n.hashed[coll]
                h = pm.HashedRWSet()
                h.hashed_reads = [pm.KVReadHash(key_hash=kh, version=_version(ver))
                                  for kh, ver in sorted(cdata.get("reads", {}).items())]
                h.hashed_writes = [pm.KVWriteHash(key_hash=kh, value_hash=vh, is_delete=d)
                                   for kh, (vh, d) in sorted(cdata.get("writes", {}).items())]
                ns_pb.collection_hashed_rwset.append(pm.CollectionHashedReadWriteSet(
                    collection_name=coll, hashed_rwset=h.serialize(),
                    pvt_rwset_hash=cdata.get("pvt_hash", b"")))
            out.ns_rwset.append(ns_pb)
        return out.serialize()

    @classmethod
    def from_bytes(cls, data: bytes) -> "TxRWSet":
        """Decode a serialized ``TxReadWriteSet``; raises
        ``protos.wire.DecodeError`` where the reference's parse raises."""
        tx = cls()
        for ns_pb in pm.TxReadWriteSet.parse(data).ns_rwset:
            n = tx.ns_rwset(ns_pb.namespace)
            kv = pm.KVRWSet.parse(ns_pb.rwset)
            for r in kv.reads:
                n.reads[r.key] = _ver(r.version)
            for rq in kv.range_queries_info:
                raw = rq.raw_reads.kv_reads if rq.raw_reads is not None else []
                n.range_queries.append((rq.start_key, rq.end_key,
                                        [(r.key, _ver(r.version)) for r in raw]))
            for w in kv.writes:
                n.writes[w.key] = None if w.is_delete else w.value
            for mw in kv.metadata_writes:
                n.metadata_writes[mw.key] = {e.name: e.value for e in mw.entries}
            for coll in ns_pb.collection_hashed_rwset:
                h = pm.HashedRWSet.parse(coll.hashed_rwset)
                n.hashed[coll.collection_name] = {
                    "reads": {hr.key_hash: _ver(hr.version) for hr in h.hashed_reads},
                    "writes": {hw.key_hash: (hw.value_hash, hw.is_delete)
                               for hw in h.hashed_writes},
                    "pvt_hash": coll.pvt_rwset_hash}
        return tx

    def mvcc_form(self):
        """→ (reads, writes, range_reads) with composite keys
        ``('pub', ns, key)`` and ``('pvt', ns, coll, key_hash)`` for
        ``ops.mvcc.TxRWSet``.  An empty range end is an unbounded scan:
        ``ns + "\\x00"`` sorts after every key of the namespace, so the
        id interval covers all of it.  Metadata-only writes are left
        out: whether one writes depends on the state (the validator's
        ``_mvcc_inputs``)."""
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
            for coll in sorted(n.hashed):
                cdata = n.hashed[coll]
                for kh, ver in sorted(cdata.get("reads", {}).items()):
                    reads.append((("pvt", name, coll, kh), ver))
                for kh in sorted(cdata.get("writes", {})):
                    writes.append(("pvt", name, coll, kh))
        return reads, writes, rqs
