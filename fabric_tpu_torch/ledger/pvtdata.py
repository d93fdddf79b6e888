"""Private-data store: cleartext collection write-sets per block
(counterpart: ``fabric_tpu/ledger/pvtdata.py``, the store ``KVLedger``
opens).

Analog of core/ledger/pvtdatastorage/store.go: pvt write-sets keyed
(block, tx, namespace, collection) with an expiry block, the same
tables as the reference's (its ``missing`` table included, so either
package opens the other's file), and the reconciler's reads and
writes of missing data (``missing_data``, ``resolve_missing``).
"""

from __future__ import annotations

import json
import sqlite3


def encode_kv(kv: dict) -> bytes:
    """{key: value|None} → canonical stored/wire JSON bytes (hex
    values) — THE pvt cleartext encoding, shared by the pvtdata store
    payloads, gossip push/pull, and the reconciler."""
    return json.dumps(
        {k: (v.hex() if v is not None else None) for k, v in kv.items()},
        sort_keys=True,
    ).encode()


def decode_kv(raw) -> dict:
    data = json.loads(raw)
    return {k: (bytes.fromhex(v) if v is not None else None)
            for k, v in data.items()}


class PvtDataStore:
    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS pvt ("
            " block INTEGER, txnum INTEGER, ns TEXT, coll TEXT, rwset BLOB,"
            " expiry INTEGER DEFAULT 0,"  # 0 = never (btl unset)
            " PRIMARY KEY (block, txnum, ns, coll))"
        )
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS missing ("
            " block INTEGER, txnum INTEGER, ns TEXT, coll TEXT, eligible INTEGER,"
            " PRIMARY KEY (block, txnum, ns, coll))"
        )
        # purge_expired runs on EVERY commit: without this partial
        # index it would table-scan rows that mostly have expiry=0
        self._conn.execute(
            "CREATE INDEX IF NOT EXISTS pvt_expiry ON pvt(expiry)"
            " WHERE expiry > 0"
        )

    def commit_block(self, block_num: int, data: dict, missing: list | None = None):
        """data: {(txnum, ns, coll): (rwset_bytes, expiry_block)} —
        expiry_block 0 = no BTL.  missing: [(txnum, ns, coll, eligible)]."""
        cur = self._conn.cursor()
        for (txnum, ns, coll), val in data.items():
            rwset, expiry = val if isinstance(val, tuple) else (val, 0)
            cur.execute(
                "INSERT OR REPLACE INTO pvt VALUES (?,?,?,?,?,?)",
                (block_num, txnum, ns, coll, rwset, expiry),
            )
        for txnum, ns, coll, eligible in missing or ():
            cur.execute(
                "INSERT OR REPLACE INTO missing VALUES (?,?,?,?,?)",
                (block_num, txnum, ns, coll, int(eligible)),
            )
        self._conn.commit()

    def get_pvt_data(self, block_num: int) -> dict:
        out = {}
        for txnum, ns, coll, rwset in self._conn.execute(
            "SELECT txnum, ns, coll, rwset FROM pvt WHERE block=?", (block_num,)
        ):
            out[(txnum, ns, coll)] = rwset
        return out

    def missing_data(self, max_block: int, eligible_only: bool = True):
        q = "SELECT block, txnum, ns, coll FROM missing WHERE block<=?"
        if eligible_only:
            q += " AND eligible=1"
        return list(self._conn.execute(q, (max_block,)))

    def resolve_missing(self, block: int, txnum: int, ns: str, coll: str, rwset: bytes, expiry: int = 0):
        """Reconciler delivered previously missing data."""
        cur = self._conn.cursor()
        cur.execute(
            "INSERT OR REPLACE INTO pvt VALUES (?,?,?,?,?,?)",
            (block, txnum, ns, coll, rwset, expiry),
        )
        cur.execute(
            "DELETE FROM missing WHERE block=? AND txnum=? AND ns=? AND coll=?",
            (block, txnum, ns, coll),
        )
        self._conn.commit()

    def purge_expired(self, current_block: int) -> list:
        """BTL expiry (analog pvtstatepurgemgmt): drop pvt data whose
        expiry block has passed.  Returns the purged rows
        [(block, txnum, ns, coll, rwset)] so the ledger can also erase
        the corresponding private STATE (cleartext + key-hash spaces)."""
        rows = list(self._conn.execute(
            "SELECT block, txnum, ns, coll, rwset FROM pvt"
            " WHERE expiry > 0 AND expiry <= ?", (current_block,)
        ))
        if rows:
            self._conn.execute(
                "DELETE FROM pvt WHERE expiry > 0 AND expiry <= ?",
                (current_block,),
            )
            self._conn.commit()
        return rows

    def close(self):
        self._conn.close()
