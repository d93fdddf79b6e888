"""The channel's ledger: block store, state, history and private data
(counterpart: ``fabric_tpu/ledger/kvledger.py``; the reference's
core/ledger/kvledger/kv_ledger.go).

``commit_block`` takes a validated block, its TRANSACTIONS_FILTER and
its update batch (``peer/pipeline.py``'s ``CommittedBlock``):

  1. the commit hash, sha256(previous commit hash ‖ block header hash ‖
     filter), goes into the COMMIT_HASH metadata slot;
  2. the block store appends the block (the source of truth) and the
     private data store its collections;
  3. the state DB applies the batch under the savepoint (block, 0),
     inline, or queued on ``AsyncApplyEngine`` (``async_commit=True``);
  4. the history DB records the valid writes.

``recover(replayer)`` replays the blocks the state DB lacks (a crash
between steps 2 and 4) through ``replayer(block) -> (filter, batch,
history)``; ``validating_replayer`` makes one of a ``BlockValidator``
(on the card, ``p256_verify`` and stage 2 again for each block).
``last_commit_timings`` splits a commit into ``ledger_append`` (step 2)
and ``state_apply`` (steps 3 and 4; under the async engine its submit
and any back-pressure wait); ``commit_seconds`` sums them, and the
whole ``ledger_commit``, over the commits; the registry gets the
reference's ``ledger_append_seconds`` and ``ledger_state_apply_seconds``
(:193-205), and the serial path marks each block ``durable`` and
``applied`` on the tx-flow journal (``observe/txflow.py``; the async
engine marks them on its applier).  ``stats()`` gives these sums and
the block store's and the engine's counters.
``abort()`` leaves the directory as a process that died would.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.ledger.blockstore import BlockStore
from fabric_tpu_torch.ledger.history import HistoryDB
from fabric_tpu_torch.ledger.pvtdata import PvtDataStore, decode_kv
from fabric_tpu_torch.ledger.statedb import SqliteVersionedDB, UpdateBatch, VersionedDB
from fabric_tpu_torch.observe import txflow as _txflow
from fabric_tpu_torch.protos import messages as m

_log = logging.getLogger("fabric_tpu_torch.ledger")


class TxIndexBelow:
    """The ledger's tx-id index as it stood before block ``below``: the
    duplicate check of a block that is validated again (recovery) sees
    only the tx ids committed ahead of it (a snapshot's at -1)."""

    def __init__(self, blocks: BlockStore):
        self.blocks = blocks
        self.below = 0

    def tx_exists(self, txid: str) -> bool:
        loc = self.blocks.get_tx_loc(txid)
        return loc is not None and loc[0] < self.below


def validating_replayer(validator, blocks: BlockStore):
    """``recover``'s replayer over a ``BlockValidator``: each block is
    validated again with a ``TxIndexBelow`` of ``blocks`` in place of
    the validator's own ``block_store``, which is put back after the
    call, and a filter that differs from the one the block was
    committed with raises."""
    index = TxIndexBelow(blocks)

    def replay(block: m.Block):
        index.below = block.header.number
        stored = bytes(protoutil.get_tx_filter(block))
        own = validator.blocks
        validator.blocks = index
        try:
            flt, batch, history = validator.validate(block)
        finally:
            validator.blocks = own
        if bytes(flt) != stored:
            raise ValueError(f"block {block.header.number}: validated again to another "
                             "filter than the one it was committed with")
        return flt, batch, history

    return replay


class KVLedger:
    def __init__(self, ledger_dir: str, state_db: VersionedDB | None = None,
                 enable_history: bool = True, async_commit: bool = False,
                 apply_queue_blocks: int = 4):
        os.makedirs(ledger_dir, exist_ok=True)
        self.dir = ledger_dir
        self.blocks = BlockStore(os.path.join(ledger_dir, "chains"))
        inner = state_db or SqliteVersionedDB(os.path.join(ledger_dir, "state.db"))
        inner.open()
        self.engine = None
        if async_commit:
            from fabric_tpu_torch.ledger.committer import AsyncApplyEngine

            self.engine = AsyncApplyEngine(inner, blocks=self.blocks,
                                           queue_blocks=apply_queue_blocks)
        self.state = self.engine if self.engine is not None else inner
        self._reconcile_on_open()
        self.history = (HistoryDB(os.path.join(ledger_dir, "history.db"))
                        if enable_history else None)
        self.pvtdata = PvtDataStore(os.path.join(ledger_dir, "pvtdata.db"))
        self._commit_hash: bytes | None = self._load_last_commit_hash()
        self.last_commit_timings: dict = {}
        self.commit_seconds = {"ledger_commit": 0.0, "ledger_append": 0.0, "state_apply": 0.0}
        self.commits = 0
        self._commit_hists = None  # registry histograms, looked up at the first commit

    def _reconcile_on_open(self) -> None:
        """A savepoint behind the block height is the normal crash
        shape (``recover`` replays the gap); one ahead of it (a durable
        state over a crash-truncated block tail) cannot be replayed
        from here: it is logged, and redelivery of the missing blocks
        overwrites it."""
        sp = self.state.savepoint()
        height = self.blocks.height
        if sp is not None and sp[0] + 1 > height:
            _log.warning("state savepoint %s is ahead of block height %d; "
                         "awaiting block redelivery to reconcile", sp, height)
            self.savepoint_ahead = True
        else:
            self.savepoint_ahead = False

    # -- the commit hash chain ----------------------------------------------------

    def _load_last_commit_hash(self) -> bytes | None:
        h = self.blocks.height
        if h == 0:
            return None
        blk = self.blocks.get_block(h - 1)
        if blk is None:  # snapshot-joined, no block since: the anchor
            boot = self.blocks.bootstrap_info()
            return (boot[2] or None) if boot else None
        md = blk.metadata.metadata if blk.metadata is not None else []
        if len(md) > m.META_COMMIT_HASH and md[m.META_COMMIT_HASH]:
            return md[m.META_COMMIT_HASH]
        return None

    def _next_commit_hash(self, block: m.Block, tx_filter: bytes) -> bytes:
        return hashlib.sha256((self._commit_hash or b"")
                              + protoutil.block_header_hash(block.header)
                              + bytes(tx_filter)).digest()

    # -- commit (kv_ledger.go:612) ------------------------------------------------

    def commit_block(self, block: m.Block, tx_filter: bytes, batch: UpdateBatch,
                     history_writes: list | None = None, pvt_data: dict | None = None,
                     txids: list | None = None, hd_bytes: bytes | None = None) -> None:
        num = block.header.number
        if num != self.blocks.height:
            raise ValueError(f"commit out of order: {num} vs height {self.blocks.height}")
        t_in = time.perf_counter()
        protoutil.set_tx_filter(block, tx_filter)
        commit_hash = self._next_commit_hash(block, tx_filter)
        md = block.metadata.metadata
        while len(md) <= m.META_COMMIT_HASH:
            md.append(b"")
        md[m.META_COMMIT_HASH] = commit_hash

        t0 = time.perf_counter()
        self.blocks.add_block(block, txids=txids, hd_bytes=hd_bytes)
        if pvt_data:
            self.pvtdata.commit_block(num, pvt_data)
        t1 = time.perf_counter()
        if self.engine is not None:
            post_apply = None
            if self.history is not None and history_writes:
                hist = self.history

                def post_apply(hist=hist, num=num, hw=history_writes):
                    hist.commit_block(num, hw)

            self.engine.submit(num, batch, (num, 0), post_apply=post_apply)
        else:
            if getattr(self.state, "durable", True):
                # a durable savepoint never gets ahead of the block files
                self.blocks.sync()
                _txflow.block_durable(num)
            self.state.apply_updates(batch, (num, 0))
            if self.history is not None and history_writes:
                self.history.commit_block(num, history_writes)
            # the serial path's writes are readable from here
            _txflow.block_applied(num)
        self._purge_expired_pvt(num)
        t2 = time.perf_counter()
        self._commit_hash = commit_hash
        self.last_commit_timings = {"ledger_append": t1 - t0, "state_apply": t2 - t1}
        cs = self.commit_seconds
        cs["ledger_commit"] += t2 - t_in
        cs["ledger_append"] += t1 - t0
        cs["state_apply"] += t2 - t1
        self.commits += 1
        hists = self._commit_hists
        if hists is None:
            from fabric_tpu_torch.ops_metrics import global_registry

            reg = global_registry()
            hists = self._commit_hists = (
                reg.histogram("ledger_append_seconds",
                              "block-store append on the commit path"),
                reg.histogram("ledger_state_apply_seconds",
                              "state apply (or enqueue) on the commit path"),
            )
        hists[0].observe(t1 - t0)
        hists[1].observe(t2 - t1)

    def _purge_expired_pvt(self, num: int) -> None:
        """Expired collections leave the private data store and the
        private state, cleartext and hashed, where the live state
        still holds that write or an older one."""
        purged = self.pvtdata.purge_expired(num)
        if not purged:
            return
        batch = UpdateBatch()
        for blk_n, txnum, ns, coll, rwset in purged:
            try:
                kv = decode_kv(rwset)
            except ValueError as e:
                _log.warning("pvt purge: undecodable rwset for %s/%s at block %d tx %d: %s",
                             ns, coll, blk_n, txnum, e)
                continue
            hns = f"{ns}${coll}"
            for key in kv:
                vv = self.state.get_state(hns, key)
                if vv is None or vv.version[0] > blk_n:
                    continue
                batch.delete(hns, key, (num, 0))
                kh = hashlib.sha256(key.encode() if isinstance(key, str) else key).hexdigest()
                batch.delete(f"{hns}#hashed", kh, (num, 0))
        if batch.updates:
            self.state.apply_updates(batch, (num, 0))

    # -- recovery (kv_ledger.go:357 recoverDBs) -----------------------------------

    def recover(self, replayer) -> int:
        """Re-derive the state (and history) of the blocks past the
        state savepoint; ``replayer(block) -> (tx_filter, batch,
        history)``.  Returns the blocks replayed."""
        height = self.blocks.height
        sp = self.state.savepoint()
        replayed = 0
        for num in range((sp[0] + 1) if sp else 0, height):
            block = self.blocks.get_block(num)
            _, batch, history_writes = replayer(block)
            self.state.apply_updates(batch, (num, 0))
            if self.history is not None and history_writes:
                hsp = self.history.savepoint()
                if hsp is None or hsp < num:
                    self.history.commit_block(num, history_writes)
            replayed += 1
        self.drain_state()
        return replayed

    def drain_state(self) -> None:
        """Wait for the async apply queue (no-op when serial)."""
        if self.engine is not None:
            self.engine.drain()

    def state_digest(self) -> str:
        """``snapshot.state_digest`` of the committed state, after the
        apply queue drains."""
        from fabric_tpu_torch.ledger.snapshot import state_digest

        self.drain_state()
        return state_digest(self.state)

    def stats(self) -> dict:
        out = {"height": self.height, "commits": self.commits,
               "commit_seconds": dict(self.commit_seconds), "blockstore": self.blocks.stats()}
        if self.engine is not None:
            out["applier"] = self.engine.stats()
        return out

    @property
    def height(self) -> int:
        return self.blocks.height

    @property
    def commit_hash(self) -> bytes | None:
        return self._commit_hash

    def bootstrap_commit_hash(self, h: bytes | None) -> None:
        """Seed the chain when joining from a snapshot."""
        self._commit_hash = h

    def abort(self) -> None:
        """Leave the ledger as a dead process would: the apply queue
        dropped unapplied, nothing synced or drained, every file closed
        (``AsyncApplyEngine.abort``; a test and smoke seam, never a
        live peer's call)."""
        if self.engine is not None:
            self.engine.abort()
        else:
            self.state.close()
        self.blocks.abandon()
        if self.history is not None:
            self.history.close()
        self.pvtdata.close()

    def close(self):
        try:
            # state first: the engine drains, fencing on the block store
            # and committing history, both still open
            self.state.close()
        finally:
            self.blocks.close()
            if self.history is not None:
                self.history.close()
            self.pvtdata.close()
