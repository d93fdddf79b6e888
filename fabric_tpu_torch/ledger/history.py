"""History database: key → commit positions (counterpart:
``fabric_tpu/ledger/history.py``; the reference's
core/ledger/kvledger/history, GetHistoryForKey).  Same file layout as
the reference's, so either package opens the other's."""

from __future__ import annotations

import sqlite3


class HistoryDB:
    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        # history is DERIVED state: the kvledger recovery path replays
        # it from stored blocks (savepoint-gated), so a lost WAL tail
        # on crash self-heals — no per-commit fsync.  NORMAL, not OFF:
        # OFF can corrupt the DB file itself on power loss, and there
        # is no drop-and-rebuild path on open
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS hist ("
            " ns TEXT, key TEXT, block INTEGER, txnum INTEGER,"
            " PRIMARY KEY (ns, key, block, txnum))"
        )
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS savepoint ("
            " id INTEGER PRIMARY KEY CHECK (id = 0), block INTEGER)"
        )

    def commit_block(self, block_num: int, writes: list[tuple[str, str, int]]):
        """writes: [(ns, key, txnum)] for VALID txs of the block."""
        self._conn.executemany(
            "INSERT OR REPLACE INTO hist VALUES (?,?,?,?)",
            [(ns, key, block_num, txnum) for ns, key, txnum in writes],
        )
        self._conn.execute(
            "INSERT OR REPLACE INTO savepoint VALUES (0,?)", (block_num,)
        )
        self._conn.commit()

    def get_history_for_key(self, ns: str, key: str):
        """Yield (block, txnum) newest-first (like the reference's
        history iterator)."""
        yield from self._conn.execute(
            "SELECT block, txnum FROM hist WHERE ns=? AND key=?"
            " ORDER BY block DESC, txnum DESC",
            (ns, key),
        )

    def savepoint(self) -> int | None:
        row = self._conn.execute("SELECT block FROM savepoint WHERE id=0").fetchone()
        return row[0] if row else None

    def close(self):
        self._conn.close()
