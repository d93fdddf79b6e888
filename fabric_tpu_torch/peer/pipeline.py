"""Depth-N commit pipeline (counterpart: ``fabric_tpu/peer/pipeline.py``,
without its fault-injection, tracing, metrics and lifecycle-barrier
machinery).

    prefetch thread   preprocess(block n+1)     decode + verify launch
    caller thread     validate_finish(block n-1), validate_launch(block n)
                                                 overlay = merged batches
                                                 of the in-flight commits
    committer thread  commit(block n-1), commit(block n-2), ...

Up to ``depth - 1`` predecessors' commits drain in block order on the
committer thread while the newest block launches under the newest-wins
merge of their update batches (``UpdateBatch.merged``) and a duplicate
txid window spanning all of them, so a launch never waits for a
predecessor's commit.  ``depth=1`` is the strict serial
launch → finish → commit order.  The port's policies are static (no
config or lifecycle transactions in this slice), so no block forces a
barrier.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from fabric_tpu_torch.ledger.statedb import UpdateBatch


@dataclass
class CommittedBlock:
    block: object
    pend: object
    tx_filter: bytes
    batch: object
    history: list

    @property
    def txids(self) -> list:
        """[(txid, idx)] for the ledger's txid index."""
        return [(p.txid, p.idx) for p in self.pend.txs if p.txid]

    @property
    def n_valid(self) -> int:
        return sum(1 for c in self.tx_filter if c == 0)


@dataclass
class _InflightCommit:
    fut: object
    batch: object
    txids: object


class CommitPipeline:
    """``submit(block)`` feeds blocks in height order and returns the
    completed predecessor (its commit handed to the committer thread)
    or None while the pipe fills; ``flush()`` drains the tail.
    ``commit_fn(res: CommittedBlock)`` performs the ledger commit; it
    runs on the committer thread (inline at depth 1 and for the tail),
    serialized in block order.  A stage exception closes the pipe: it
    surfaces once and later submits raise."""

    def __init__(self, validator, commit_fn, depth: int = 2):
        self.validator = validator
        self.commit_fn = commit_fn
        self.depth = max(1, int(depth))
        self._prefetch = ThreadPoolExecutor(1, thread_name_prefix="fabtorch-prefetch")
        self._committer = ThreadPoolExecutor(1, thread_name_prefix="fabtorch-committer")
        self._pre = None        # (block, prefetch future)
        self._launched = None   # PendingBlock in flight
        self._commits: deque = deque()
        self._closed = False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(flush=exc_type is None)
        return False

    def close(self, flush: bool = True):
        if self._closed:
            return None
        res = None
        try:
            if flush:
                res = self.flush()
        finally:
            self._shutdown()
        return res

    def _shutdown(self) -> None:
        self._closed = True
        self._pre = None
        self._launched = None
        self._prefetch.shutdown(wait=True)
        self._committer.shutdown(wait=True)

    def _drain_commits(self, keep: int) -> None:
        while len(self._commits) > keep:
            self._commits.popleft().fut.result()

    def _launch_overlay(self):
        if not self._commits:
            return None, None
        recs = list(self._commits)
        return (UpdateBatch.merged([r.batch for r in recs]),
                set().union(*(r.txids for r in recs)))

    def submit(self, block):
        if self._closed:
            raise RuntimeError("pipeline is closed")
        try:
            if self.depth == 1:
                pend = self.validator.validate_launch(block)
                return self._finish_and_commit(pend, tail=True)
            self._pre = (block, self._prefetch.submit(self.validator.preprocess, block))
            out = None
            if self._launched is not None:
                out = self._finish_and_commit(self._launched)
            self._launch_next()
            return out
        except BaseException:
            self._shutdown()
            raise

    def flush(self):
        """Finish and commit everything in flight; returns the last
        CommittedBlock (None when the pipe was empty)."""
        try:
            out = None
            if self._launched is not None:
                out = self._finish_and_commit(self._launched, tail=True)
            if self._pre is not None:
                self._launch_next()
                out = self._finish_and_commit(self._launched, tail=True)
            self._drain_commits(0)
            return out
        except BaseException:
            self._shutdown()
            raise

    def _launch_next(self) -> None:
        block, fut = self._pre
        self._pre = None
        pre = fut.result()
        overlay, extra = self._launch_overlay()
        self._launched = self.validator.validate_launch(
            block, pre=pre, overlay=overlay, extra_txids=extra)

    def _finish_and_commit(self, pend, tail: bool = False) -> CommittedBlock:
        flt, batch, history = self.validator.validate_finish(pend)
        # keep at most depth-2 older commits in flight beside this one
        self._drain_commits(0 if tail else max(0, self.depth - 2))
        res = CommittedBlock(block=pend.block, pend=pend, tx_filter=flt, batch=batch,
                             history=history)
        self._launched = None
        if tail:
            self.commit_fn(res)
        else:
            self._commits.append(_InflightCommit(
                fut=self._committer.submit(self.commit_fn, res), batch=batch,
                txids=pend.txids))
        return res
