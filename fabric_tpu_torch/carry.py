"""Carry a plain-data dump of the reference's world state, namespace
policies and identities into the port's objects, so both packages
validate against the same state.

    state rows:  (ns, key, value, (block, txnum)[, metadata])
                 (a private collection's hashed keys as rows of the
                 namespace ``ns$coll#hashed``; metadata: the encoded
                 key metadata, None without)
    namespaces:  {ns: policy DSL string}
    identities:  (msp_id, role, qx, qy)
"""

from __future__ import annotations

from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.crypto.identity import Identity
from fabric_tpu_torch.ledger.statedb import MemVersionedDB, UpdateBatch
from fabric_tpu_torch.peer.validator import NamespaceInfo, PolicyProvider


def from_reference(state_rows, namespaces: dict, identities):
    """→ (MemVersionedDB, PolicyProvider, [Identity]) — identities are
    taken as valid (the reference's MSP validated them)."""
    db = MemVersionedDB()
    seed = UpdateBatch()
    for ns, key, value, version, *meta in state_rows:
        seed.put(ns, key, value, (int(version[0]), int(version[1])),
                 metadata=meta[0] if meta else None)
    db.apply_updates(seed)
    provider = PolicyProvider({ns: NamespaceInfo(policy=pol.from_dsl(dsl))
                               for ns, dsl in namespaces.items()})
    idents = [Identity(msp_id, role, int(qx), int(qy), True)
              for msp_id, role, qx, qy in identities]
    return db, provider, idents
