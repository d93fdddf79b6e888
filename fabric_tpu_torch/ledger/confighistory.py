"""Config history: chaincode-definition (incl. collection config)
versions by commit height (counterpart:
``fabric_tpu/ledger/confighistory.py``).

Reference: core/ledger/confighistory/mgr.go — the committer records
each namespace's collection config at the block that changed it, so
the pvtdata reconciler can answer "what did ns X's config say at block
N" for eligibility decisions on OLD blocks."""

from __future__ import annotations

import sqlite3


class ConfigHistoryDB:
    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS confighistory ("
            " ns TEXT, block INTEGER, definition BLOB,"
            " PRIMARY KEY (ns, block))"
        )
        self._conn.commit()

    def record(self, block: int, ns: str, definition: bytes) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO confighistory VALUES (?,?,?)",
            (ns, block, definition),
        )
        self._conn.commit()

    def most_recent_below(self, ns: str, block: int):
        """→ (committed_block, definition_bytes) | None: the definition
        governing ns at height ``block`` (mgr.go MostRecentEntryBelow)."""
        row = self._conn.execute(
            "SELECT block, definition FROM confighistory"
            " WHERE ns=? AND block<=? ORDER BY block DESC LIMIT 1",
            (ns, block),
        ).fetchone()
        return (row[0], row[1]) if row else None

    def close(self):
        self._conn.close()
