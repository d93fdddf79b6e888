"""Transient store: endorsement-time private data held until commit
(counterpart: ``fabric_tpu/peer/transient.py``; the same sqlite table).

Reference: core/transientstore/store.go — the peer stores each
endorsement's private write-set cleartext keyed by txid, purges entries
below a retention height, and the commit-time coordinator reads it
back (gossip/privdata/coordinator.go:190).  Distribution to other
eligible peers writes into THEIR transient stores (PvtPush)."""

from __future__ import annotations

import sqlite3


# canonical pvt cleartext encoding lives with the store; re-exported
# here for the peer-layer callers
from fabric_tpu_torch.ledger.pvtdata import decode_kv, encode_kv  # noqa: F401


class TransientStore:
    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS pvt ("
            " txid TEXT, ns TEXT, coll TEXT, key TEXT, value BLOB,"
            " received_at_block INTEGER,"
            " PRIMARY KEY (txid, ns, coll, key))"
        )
        self._conn.commit()

    def persist(self, txid: str, cleartext: dict, height: int) -> None:
        """cleartext: {(ns, coll): {key: value|None}} — the simulator's
        pvt output (simulator.done())."""
        rows = []
        for (ns, coll), kv in cleartext.items():
            for key, value in kv.items():
                rows.append((txid, ns, coll, key, value, height))
        if rows:
            self._conn.executemany(
                "INSERT OR REPLACE INTO pvt VALUES (?,?,?,?,?,?)", rows
            )
            self._conn.commit()

    def get(self, txid: str) -> dict:
        """→ {(ns, coll): {key: value}} for one txid."""
        out: dict = {}
        for ns, coll, key, value in self._conn.execute(
            "SELECT ns, coll, key, value FROM pvt WHERE txid=?", (txid,)
        ):
            out.setdefault((ns, coll), {})[key] = value
        return out

    def purge_below(self, height: int) -> int:
        cur = self._conn.execute(
            "DELETE FROM pvt WHERE received_at_block < ?", (height,)
        )
        self._conn.commit()
        return cur.rowcount

    def close(self):
        self._conn.close()
