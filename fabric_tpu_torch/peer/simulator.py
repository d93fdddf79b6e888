"""Transaction simulator: builds read/write sets by executing
chaincode against committed state (counterpart:
``fabric_tpu/peer/simulator.py``; ``done()``'s bytes are the
reference's, byte for byte: ``ledger/rwset.py::TxRWSet.to_bytes``).

Analog of the reference's lock-based TxSimulator
(core/ledger/kvledger/txmgmt/txmgr/tx_simulator.go): reads record the
committed version (block, txnum); writes are buffered, never applied;
range scans record their result versions AND the scan bounds so the
commit-time phantom re-check can re-execute them
(rwsetutil rangequery capture).  Private-data writes go to the hashed
collection space (sha256 key/value hashes on the public rwset) with
the cleartext kept aside for the transient store.

Simulation runs against a snapshot-height view: the ledger-wide commit
lock (endorser.go:379-401) is an asyncio lock owned by the peer node;
this object just records."""

from __future__ import annotations

import hashlib

from fabric_tpu_torch.ledger.rwset import (
    VALIDATION_PARAMETER, TxRWSet, decode_metadata,
)


class TxSimulator:
    def __init__(self, state_db):
        self.state = state_db
        self.rwset = TxRWSet()
        self.pvt_cleartext: dict = {}  # (ns, coll) -> {key: value|None}
        self._done = False

    # -- public state -------------------------------------------------------

    def get_state(self, ns: str, key: str) -> bytes | None:
        vv = self.state.get_state(ns, key)
        n = self.rwset.ns_rwset(ns)
        if key not in n.writes:  # read-your-own-writes doesn't re-read
            n.reads.setdefault(key, vv.version if vv is not None else None)
        if key in n.writes:
            return n.writes[key]
        return vv.value if vv is not None else None

    def set_state(self, ns: str, key: str, value: bytes) -> None:
        self.rwset.ns_rwset(ns).writes[key] = value

    def delete_state(self, ns: str, key: str) -> None:
        self.rwset.ns_rwset(ns).writes[key] = None

    def get_state_range(self, ns: str, start: str, end: str, limit: int = 0):
        """Iterate committed [start, end); records results + bounds for
        the phantom re-check.  end == '' scans to the namespace end."""
        n = self.rwset.ns_rwset(ns)
        results = []
        out = []
        for key, vv in self.state.get_state_range(ns, start, end, limit):
            results.append((key, vv.version))
            out.append((key, vv.value))
        n.range_queries.append((start, end, results))
        return out

    def set_state_metadata(self, ns: str, key: str, metadata: dict) -> None:
        self.rwset.ns_rwset(ns).metadata_writes[key] = dict(metadata)

    def set_state_validation_parameter(self, ns: str, key: str,
                                       policy_bytes: bytes) -> None:
        """Shim SetStateValidationParameter: a metadata write whose
        VALIDATION_PARAMETER entry is a serialized
        SignaturePolicyEnvelope — the key-level endorsement policy the
        commit-path SBE pass enforces (statebased/validator_keylevel)."""
        self.set_state_metadata(ns, key, {VALIDATION_PARAMETER: policy_bytes})

    def get_state_validation_parameter(self, ns: str, key: str) -> bytes | None:
        """Committed key-level policy (metadata reads are not recorded
        in the read set — the reference's GetStateMetadata likewise
        rides outside MVCC)."""
        vv = self.state.get_state(ns, key)
        if vv is None or not vv.metadata:
            return None
        return decode_metadata(vv.metadata).get(VALIDATION_PARAMETER)

    # -- private data (collections) ----------------------------------------

    def get_private_data(self, ns: str, coll: str, key: str) -> bytes | None:
        kh = hashlib.sha256(key.encode()).digest()
        hns = f"{ns}${coll}#hashed"
        vv = self.state.get_state(hns, kh.hex())
        coll_rw = self.rwset.ns_rwset(ns).hashed.setdefault(
            coll, {"reads": {}, "writes": {}}
        )
        coll_rw["reads"].setdefault(kh, vv.version if vv is not None else None)
        clear = self.pvt_cleartext.get((ns, coll), {})
        if key in clear:
            return clear[key]
        return None  # cleartext lives off-ledger; only the hash is public

    def set_private_data(self, ns: str, coll: str, key: str, value: bytes) -> None:
        kh = hashlib.sha256(key.encode()).digest()
        vh = hashlib.sha256(value).digest()
        coll_rw = self.rwset.ns_rwset(ns).hashed.setdefault(
            coll, {"reads": {}, "writes": {}}
        )
        coll_rw["writes"][kh] = (vh, False)
        self.pvt_cleartext.setdefault((ns, coll), {})[key] = value

    # -- results -------------------------------------------------------------

    def done(self) -> tuple[bytes, dict]:
        """→ (serialized public rwset for ChaincodeAction.results,
        private cleartext for the transient store)."""
        self._done = True
        return self.rwset.to_bytes(), self.pvt_cleartext
