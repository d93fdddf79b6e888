"""Private-data coordinator: the pvt phase of StoreBlock (counterpart:
``fabric_tpu/peer/coordinator.py``).

Reference: gossip/privdata/coordinator.go:151-237 — after validation,
for every VALID tx that wrote private collections, source the
cleartext (local transient store → pull from peers), VERIFY it against
the committed hashed write-set (sha256(key)/sha256(value) must match
the rwset the endorsers signed), commit cleartext to the pvt state
namespaces + the pvtdata store, and record what's still missing for
the background reconciler (gossip/privdata/reconcile.go).

Where the port departs: given ``eligible(ns, coll)``, a collection this
peer's org is no member of is neither pulled nor recorded eligible — it
goes to ``ineligible``, which the peer stores with ``eligible=0``, as
Fabric's coordinator.go does (the JAX package pulls it, is refused by
every member, and records it eligible)."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field


@dataclass
class PvtResult:
    updates: list = field(default_factory=list)   # (ns$coll, key, value|None, ver)
    store_data: dict = field(default_factory=dict)  # txnum -> {(ns,coll): {k: v}}
    missing: list = field(default_factory=list)   # (txnum, txid, ns, coll)
    ineligible: list = field(default_factory=list)  # (txnum, txid, ns, coll)


def _match_cleartext(hashed_writes: dict, cleartext: dict) -> dict | None:
    """hashed_writes: {key_hash: (value_hash, is_delete)};
    cleartext: {key: value}.  → {key: value|None} covering EVERY hashed
    write, or None if any is missing/mismatched (tamper or gap)."""
    by_hash = {}
    for key, value in cleartext.items():
        kh = hashlib.sha256(
            key.encode() if isinstance(key, str) else key
        ).digest()
        by_hash[kh] = (key, value)
    out = {}
    for kh, (vh, is_del) in hashed_writes.items():
        got = by_hash.get(kh)
        if got is None:
            return None
        key, value = got
        if is_del or value is None:
            out[key] = None
            continue
        if hashlib.sha256(value).digest() != vh:
            return None
        out[key] = value
    return out


class PvtDataCoordinator:
    def __init__(self, transient, puller=None, eligible=None):
        """puller: ASYNC callable (txid, block_num, txnum, ns, coll) →
        {key: value} | None — the gossip pull path for data this peer
        never saw at endorsement time.  eligible: (ns, coll) → bool,
        whether this peer's org may hold the collection (None: every
        collection)."""
        self.transient = transient
        self.puller = puller
        self.eligible = eligible

    async def gather(self, block_num: int, parsed_txs, tx_filter: bytes) -> PvtResult:
        res = PvtResult()
        for ptx in parsed_txs:
            if ptx.rwset is None or tx_filter[ptx.idx] != 0:
                continue
            clear = None  # lazily loaded per tx
            for ns_name, n in ptx.rwset.ns.items():
                for coll, h in n.hashed.items():
                    writes = h.get("writes", {})
                    if not writes:
                        continue
                    if clear is None:
                        clear = self.transient.get(ptx.txid) if self.transient else {}
                    kv = _match_cleartext(writes, clear.get((ns_name, coll), {}))
                    if kv is None and self.eligible is not None \
                            and not self.eligible(ns_name, coll):
                        res.ineligible.append((ptx.idx, ptx.txid, ns_name, coll))
                        continue
                    if kv is None and self.puller is not None:
                        pulled = await self.puller(
                            ptx.txid, block_num, ptx.idx, ns_name, coll
                        )
                        if pulled is not None:
                            kv = _match_cleartext(writes, pulled)
                    if kv is None:
                        res.missing.append((ptx.idx, ptx.txid, ns_name, coll))
                        continue
                    ver = (block_num, ptx.idx)
                    for key, value in kv.items():
                        res.updates.append(
                            (f"{ns_name}${coll}", key, value, ver)
                        )
                    res.store_data.setdefault(ptx.idx, {})[
                        (ns_name, coll)
                    ] = kv
        return res
