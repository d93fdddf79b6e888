"""Depth-N commit pipeline (counterpart: ``fabric_tpu/peer/pipeline.py``).

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
launch → finish → commit order.

A block that rotates validation inputs — one holding a config
transaction (its commit may rotate the validator's MSP manager,
``channelconfig.apply_committed_config``) or writing the ``_lifecycle``
namespace — is a barrier (the reference's :163-168): every in-flight
commit drains, the barrier block commits inline, and its successor
launches with no overlay.  The successor was already staged on the
prefetch thread against the pre-barrier inputs, so it is preprocessed
again (``stale_prefetches`` counts these; ``barriers`` the barrier
blocks).

``coalesce_blocks=k`` (k >= 2) turns on the catch-up entry
``submit_many(blocks)`` (the reference's, pipeline.py:580-664): the
prefetch thread stages k waiting blocks at once with the validator's
``preprocess_many`` (one ``p256_verify`` launch for all their
signatures), and each block then takes the per-block launch, finish and
commit on its own slice of that launch, so overlays and the duplicate
txid window are those of ``submit``.  With k < 2, depth 1, or a
validator without ``preprocess_many``, ``submit_many`` is one ``submit``
a block.  A whole group is staged before its first block launches,
which preprocessing allows: it reads no ledger state.  A barrier inside
or just before a group makes every later block of the group stale
(:622-657).

``set_depth`` and ``set_coalesce_blocks`` (the traffic autopilot's
actuators, the reference's :317-360) latch a value that the next
``submit`` / ``submit_many`` adopts, never mid-window; a serial pipe
stays serial and a pipelined one never drops below depth 2.  A stage
exception that closes the pipe is the flight recorder's
``pipeline_fail_closed`` incident (``observe/blackbox.py``).

Each commit runs ``commit_fn`` and then the validator's
``resident_commit`` when it has one (the device-resident state's
write-set scatter, ``state/residency.py``), on the committer thread or
inline, before the commit's future resolves: a launch whose overlay no
longer covers a block is ordered after that block's scatter.  An error
in either surfaces like any stage exception.

Telemetry (the reference's :234-292, :502-578, :625-699, :782-889): one
root span a block on the tracer (``observe/tracer.py``, the global one
unless ``tracer=`` is given), with ``prefetch`` (prefetch thread),
``prefetch_wait``, ``launch``, ``finish`` and ``commit_wait`` (caller's
thread) and ``commit`` (committer thread, or inline for a barrier, the
tail and depth 1) children; the validator's stage spans nest under
them.  The last block's root carries ``tail``, a barrier's ``barrier``,
a coalesced group's members ``coalesce_group``/``coalesce_size`` (the
group's ``prefetch`` hangs off its leader); a stale prefetch leaves a
``stale_prefetch_reparse`` event and a ``re-prefetch`` span.  The
registry (``registry=``, else the global one) gets
``commit_pipeline_stage_seconds{channel,stage}``,
``commit_pipeline_overlap_ratio``, ``commit_pipeline_inflight``,
``commit_pipeline_blocks_total{channel,mode}`` and
``commit_pipeline_stage_failures_total{channel,stage}``.  Each commit
first stamps the tx-flow journal's inclusion (``observe/txflow.py``,
``replay=True`` tags it as a catch-up block).

Containment (the reference's :364-410): a stage exception (prefetch,
launch, finish or commit) is recorded (``last_failure`` = (block
number, stage), ``stats()["stage_failures"]`` by stage) and closes the
pipe: it surfaces once, in-flight state is dropped, both worker threads
drain, and later submits raise.  The caller builds a new pipe and
resumes from its committed height.  The fault points
``pipeline.prefetch``, ``pipeline.launch`` and ``pipeline.commit`` fire
at the top of those stages.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from fabric_tpu_torch import faults
from fabric_tpu_torch.ledger.statedb import UpdateBatch
from fabric_tpu_torch.observe import txflow as _txflow
from fabric_tpu_torch.peer.validator import LIFECYCLE_NS

_log = logging.getLogger("fabric_tpu_torch.pipeline")


def _number(block):
    """A block's number: a ``DecodedBlock``'s or ``WireBlock``'s
    ``number``, else its header's."""
    num = getattr(block, "number", None)
    if num is None:
        num = getattr(getattr(block, "header", None), "number", None)
    return num


def _is_barrier(pend, batch) -> bool:
    """The block rotates validation inputs: it commits fully, without
    overlap, before its successor launches."""
    return batch.touches_namespace(LIFECYCLE_NS) or any(p.is_config for p in pend.txs)


@dataclass
class CommittedBlock:
    """One block through the pipeline: the validated triple and its
    ``PendingBlock`` (``pend.wire`` and ``pend.hd_bytes`` are what
    ``KVLedger.commit_block`` takes beside it)."""

    block: object
    pend: object
    tx_filter: bytes
    batch: object
    history: list
    barrier: bool = False
    # the block's stage seconds (launch, finish, commit_wait)
    stage_s: dict = field(default_factory=dict)
    # the block's root span: a commit_fn hangs its spans off it
    root_span: object = None

    @property
    def txids(self) -> list:
        """[(txid, idx)] for the ledger's txid index."""
        return [(p.txid, p.idx) for p in self.pend.txs if p.txid]

    @property
    def n_valid(self) -> int:
        return sum(1 for c in self.tx_filter if c == 0)


class _SliceFuture:
    """Block ``i``'s part of a group's ``preprocess_many`` future, in
    the shape ``_launch_next`` reads."""

    __slots__ = ("fut", "i")

    def __init__(self, fut, i: int):
        self.fut = fut
        self.i = i

    def result(self):
        return self.fut.result()[self.i]


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
    serialized in block order, followed by the validator's
    ``resident_commit``.  A stage exception closes the pipe: it
    surfaces once and later submits raise.  ``coalesce_blocks``: the
    group size of ``submit_many`` (0: off).  ``channel`` labels the
    metrics and the roots; ``tracer``/``registry``: the span tracer
    and metrics registry (None: the global ones); ``replay``: the
    blocks are catch-up blocks (the journal's inclusion tag).
    ``pre_launch_fn(block)`` runs on the caller's thread at the top of
    each block's launch (the reference's :214-220): a peer verifies the
    orderer's block signatures there, after any predecessor barrier has
    rotated the channel's bundle; a raise is the launch's failure."""

    def __init__(self, validator, commit_fn, depth: int = 2, coalesce_blocks: int = 0,
                 channel: str = "", tracer=None, registry=None, replay: bool = False,
                 pre_launch_fn=None):
        self.validator = validator
        self.pre_launch_fn = pre_launch_fn
        self.commit_fn = commit_fn
        self.depth = max(1, int(depth))
        self.coalesce_blocks = int(coalesce_blocks)
        self.channel = channel
        self.replay = bool(replay)
        if tracer is None:
            from fabric_tpu_torch.observe import global_tracer

            tracer = global_tracer()
        self.tracer = tracer
        if registry is None:
            from fabric_tpu_torch.ops_metrics import global_registry

            registry = global_registry()
        self._stage_hist = registry.histogram(
            "commit_pipeline_stage_seconds",
            "per-block commit pipeline stage time (s)",
        )
        self._overlap_hist = registry.histogram(
            "commit_pipeline_overlap_ratio",
            "1 - blocked/total per pipelined block",
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0, float("inf")),
        )
        self._inflight_gauge = registry.gauge(
            "commit_pipeline_inflight", "blocks launched or committing"
        )
        self._blocks_ctr = registry.counter(
            "commit_pipeline_blocks_total", "blocks through the pipeline"
        )
        self._stage_fail_ctr = registry.counter(
            "commit_pipeline_stage_failures_total",
            "pipeline stage exceptions by stage",
        )
        self._prefetch = ThreadPoolExecutor(1, thread_name_prefix="fabtpu-prefetch")
        self._committer = ThreadPoolExecutor(1, thread_name_prefix="fabtpu-committer")
        self._pre = None        # (block, prefetch future, root span)
        self._launched = None   # PendingBlock in flight
        self._launched_root = None  # its root span
        self._launch_s = 0.0    # its launch seconds, for its CommittedBlock
        self._commits: deque = deque()
        self._closed = False
        # the staged block was prefetched before a barrier predecessor
        # committed: it is preprocessed again at its launch
        self._stale_prefetch = False
        self.barriers = 0
        self.stale_prefetches = 0
        self.last_failure: tuple | None = None  # (block number, stage)
        self._failures: Counter = Counter()
        self._failures_lock = threading.Lock()
        # run-time knobs (the autopilot's actuators): set_depth and
        # set_coalesce_blocks latch a value that the next submit boundary
        # adopts, never mid-window (GIL-atomic attribute writes)
        self._pending_depth: int | None = None
        self._pending_coalesce: int | None = None

    # -- run-time knobs ---------------------------------------------------------

    def set_depth(self, depth: int) -> None:
        """A new depth, applied at the next submit boundary.  A serial
        pipe (depth 1) stays serial and a pipelined one never drops
        below 2: the serial/pipelined boundary is not crossed at run
        time; a shallower depth drains the excess at the next finish."""
        if self.depth <= 1:
            return
        self._pending_depth = max(2, int(depth))

    def set_coalesce_blocks(self, n: int) -> None:
        """A new ``submit_many`` group size (below 2: off), applied at
        the next submit boundary."""
        n = int(n)
        self._pending_coalesce = 0 if n < 2 else n

    def _apply_pending_knobs(self) -> None:
        """The block boundary: adopt the latched values (the top of
        ``submit`` / ``submit_many``, where no block is mid-stage on the
        caller's thread)."""
        d, self._pending_depth = self._pending_depth, None
        if d is not None:
            self.depth = d
        c, self._pending_coalesce = self._pending_coalesce, None
        if c is not None:
            self.coalesce_blocks = c

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

    def _fail_closed(self) -> None:
        """A stage exception closes the pipe: the flight recorder's
        ``pipeline_fail_closed`` incident (``observe/blackbox.py``, a
        no-op unarmed) is recorded before the in-flight state drops."""
        if not self._closed:
            from fabric_tpu_torch.observe import blackbox

            failure = self.last_failure
            blackbox.notify("pipeline_fail_closed", channel=self.channel,
                            block=failure[0] if failure else None,
                            stage=failure[1] if failure else None)
        self._shutdown()

    def _shutdown(self) -> None:
        self._closed = True
        self._pre = None
        self._launched = None
        self._launched_root = None
        self._prefetch.shutdown(wait=True)
        self._committer.shutdown(wait=True)
        self._inflight_gauge.set(0, channel=self.channel)

    @property
    def inflight(self) -> int:
        """Blocks accepted and not yet committed: staged, launched or
        committing (the ``commit_pipeline_inflight`` gauge)."""
        return (self._pre is not None) + (self._launched is not None) + len(self._commits)

    def stats(self) -> dict:
        """Barriers, stale re-preprocesses, stage failures by stage and
        the last failure."""
        with self._failures_lock:
            return {"barriers": self.barriers, "stale_prefetches": self.stale_prefetches,
                    "stage_failures": dict(self._failures), "last_failure": self.last_failure}

    def _note_stage_failure(self, stage: str, number) -> None:
        with self._failures_lock:
            self.last_failure = (number, stage)
            self._failures[stage] += 1
        self._stage_fail_ctr.add(1, channel=self.channel, stage=stage)
        _log.warning("pipeline %s stage failed for block %s; the pipe closes, resume from "
                     "the committed height", stage, number)

    def _drain_commits(self, keep: int) -> None:
        while len(self._commits) > keep:
            self._commits.popleft().fut.result()

    def _launch_overlay(self):
        if not self._commits:
            return None, None
        recs = list(self._commits)
        return (UpdateBatch.merged([r.batch for r in recs]),
                set().union(*(r.txids for r in recs)))

    def _begin(self, block, **attrs):
        return self.tracer.begin_block(_number(block), channel=self.channel, **attrs)

    def submit(self, block):
        if self._closed:
            raise RuntimeError("pipeline is closed")
        self._apply_pending_knobs()
        try:
            if self.depth == 1:
                return self._submit_serial(block)
            t_sub = time.perf_counter()
            root = self._begin(block)
            self._pre = (block, self._prefetch.submit(self._prefetch_one, block, root), root)
            self._inflight_gauge.set(self.inflight, channel=self.channel)
            out = None
            if self._launched is not None:
                out = self._finish_and_commit(self._launched)
            self._launch_next(out.stage_s if out is not None else {}, t_sub)
            return out
        except BaseException:
            self._fail_closed()
            raise

    def _prefetch_one(self, block, root):
        """Prefetch-thread task: its span is the validator's stage
        spans' parent (the handle crosses the executor explicitly)."""
        with self.tracer.span("prefetch", parent=root):
            faults.fire("pipeline.prefetch")
            return self.validator.preprocess(block)

    def _prefetch_group(self, many, group, root):
        with self.tracer.span("prefetch", parent=root, coalesced=len(group)):
            faults.fire("pipeline.prefetch")
            return many(group)

    def _submit_serial(self, block) -> CommittedBlock:
        """Depth 1: prefetch, launch, finish and commit in turn."""
        num = _number(block)
        tr = self.tracer
        root = self._begin(block, mode="serial")
        t0 = time.perf_counter()
        stage = "launch"
        try:
            with tr.span("launch", parent=root):
                faults.fire("pipeline.launch")
                if self.pre_launch_fn is not None:
                    self.pre_launch_fn(block)
                with tr.span("prefetch"):  # inline at depth 1
                    stage = "prefetch"
                    faults.fire("pipeline.prefetch")
                    pre = self.validator.preprocess(block)
                    stage = "launch"
                pend = self.validator.validate_launch(block, pre=pre)
            stage = "finish"
            with tr.span("finish", parent=root):
                flt, batch, history = self.validator.validate_finish(pend)
        except BaseException:
            self._note_stage_failure(stage, num)
            raise
        t1 = time.perf_counter()
        res = CommittedBlock(block=pend.block, pend=pend, tx_filter=flt, batch=batch,
                             history=history, barrier=_is_barrier(pend, batch),
                             stage_s={"finish": t1 - t0}, root_span=root)
        self._commit_traced(res, root)
        res.stage_s["commit_wait"] = time.perf_counter() - t1
        self._blocks_ctr.add(1, channel=self.channel, mode="serial")
        return res

    def submit_many(self, blocks) -> list:
        """Feed height-ordered blocks in groups of ``coalesce_blocks``,
        each group staged by one ``preprocess_many``; returns the
        CommittedBlocks these submissions completed (the last block stays
        in flight until the next submit or ``flush``).  One ``submit`` a
        block when coalescing is off, the pipe is serial, or the
        validator has no ``preprocess_many``."""
        blocks = list(blocks)
        if self._closed:
            raise RuntimeError("pipeline is closed")
        self._apply_pending_knobs()
        k = self.coalesce_blocks
        many = getattr(self.validator, "preprocess_many", None)
        if self.depth == 1 or k < 2 or len(blocks) < 2 or many is None:
            return [r for r in (self.submit(b) for b in blocks) if r is not None]
        try:
            return self._submit_many_coalesced(blocks, k, many)
        except BaseException:
            self._fail_closed()
            raise

    def _submit_many_coalesced(self, blocks, k: int, many) -> list:
        """Each group: one prefetch call stages every block and launches
        their signatures together; then each block finishes its
        predecessor and launches on its own slice, as ``submit`` does.
        The group's prefetch span hangs off its leader's root; every
        member's root names the group."""
        out = []
        for g in range(0, len(blocks), k):
            group = blocks[g:g + k]
            lead = _number(group[0])
            roots = []
            for b in group:
                r = self._begin(b)
                self.tracer.set_attrs(r, coalesce_group=int(lead), coalesce_size=len(group))
                roots.append(r)
            fut = self._prefetch.submit(self._prefetch_group, many, group, roots[0])
            # the whole group was staged at once: a barrier committing
            # during this loop makes every remaining block of it stale
            stale_group = False
            for j, block in enumerate(group):
                t_sub = time.perf_counter()
                self._pre = (block, _SliceFuture(fut, j), roots[j])
                self._inflight_gauge.set(self.inflight, channel=self.channel)
                res = None
                if self._launched is not None:
                    res = self._finish_and_commit(self._launched)
                if self._stale_prefetch:
                    stale_group = True
                elif stale_group:
                    self._stale_prefetch = True
                self._launch_next(res.stage_s if res is not None else {}, t_sub)
                if res is not None:
                    out.append(res)
        return out

    def flush(self):
        """Finish and commit everything in flight; returns the last
        CommittedBlock (None when the pipe was empty)."""
        try:
            out = None
            if self._launched is not None:
                out = self._finish_and_commit(self._launched, tail=True)
            if self._pre is not None:
                self._launch_next({}, time.perf_counter())
                out = self._finish_and_commit(self._launched, tail=True)
            self._drain_commits(0)
            self._stale_prefetch = False  # nothing is staged past this point
            self._inflight_gauge.set(0, channel=self.channel)
            return out
        except BaseException:
            self._fail_closed()
            raise

    def _launch_next(self, prev_stage_s: dict, t_sub: float) -> None:
        block, fut, root = self._pre
        self._pre = None
        num = _number(block)
        t0 = time.perf_counter()
        try:
            pre = fut.result()
            if self._stale_prefetch:
                self._stale_prefetch = False
                self.stale_prefetches += 1
                self.tracer.event("stale_prefetch_reparse", parent=root)
                with self.tracer.span("re-prefetch", parent=root):
                    pre = self.validator.preprocess(block)
        except BaseException:
            self._note_stage_failure("prefetch", num)
            raise
        t1 = time.perf_counter()
        self.tracer.add("prefetch_wait", t0, t1, parent=root)
        try:
            with self.tracer.span("launch", parent=root) as lsp:
                faults.fire("pipeline.launch")
                if self.pre_launch_fn is not None:
                    self.pre_launch_fn(block)
                overlay, extra = self._launch_overlay()
                self._launched = self.validator.validate_launch(
                    block, pre=pre, overlay=overlay, extra_txids=extra)
                # a block riding the host path (no fused stage 2) shows
                self.tracer.set_attrs(
                    lsp, device=getattr(self._launched, "fetch2", None) is not None)
        except BaseException:
            self._note_stage_failure("launch", num)
            raise
        self._launched_root = root
        t2 = time.perf_counter()
        self._launch_s = t2 - t1
        self._inflight_gauge.set(self.inflight, channel=self.channel)
        self._stage_hist.observe(t1 - t0, channel=self.channel, stage="prefetch_wait")
        self._stage_hist.observe(t2 - t1, channel=self.channel, stage="launch")
        total = t2 - t_sub
        if prev_stage_s and total > 0:
            blocked = (t1 - t0) + prev_stage_s.get("commit_wait", 0.0)
            self._overlap_hist.observe(max(0.0, 1.0 - blocked / total), channel=self.channel)

    def _run_commit(self, res: CommittedBlock) -> None:
        """The one commit body: the journal's inclusion stamp (before
        the ledger's durable and applied fences can look for it), the
        ledger commit, then the resident table's scatter of the same
        write set (a validator without ``resident_commit`` skips it)."""
        if _txflow.enabled():
            flt = res.tx_filter
            _txflow.block_included(_number(res.block),
                                   [(p.txid, int(flt[p.idx])) for p in res.pend.txs if p.txid],
                                   channel=self.channel, replay=self.replay)
        self.commit_fn(res)
        fn = getattr(self.validator, "resident_commit", None)
        if fn is not None:
            fn(res.batch)

    def _commit_traced(self, res: CommittedBlock, root) -> None:
        """A commit under its span, the ``pipeline.commit`` point first;
        then the block's root is finalized (ring and watchdog), on the
        committing thread.  A failure is recorded as the commit
        stage's."""
        try:
            with self.tracer.span("commit", parent=root):
                faults.fire("pipeline.commit")
                self._run_commit(res)
        except BaseException:
            self._note_stage_failure("commit", _number(res.block))
            raise
        finally:
            self.tracer.finish_block(root)

    def _finish_and_commit(self, pend, tail: bool = False) -> CommittedBlock:
        root = self._launched_root
        self._launched_root = None
        t0 = time.perf_counter()
        try:
            with self.tracer.span("finish", parent=root):
                flt, batch, history = self.validator.validate_finish(pend)
        except BaseException:
            self._note_stage_failure("finish", _number(pend.block))
            raise
        t1 = time.perf_counter()
        barrier = _is_barrier(pend, batch)
        # keep at most depth-2 older commits in flight beside this one;
        # a barrier drains them all and commits inline
        self._drain_commits(0 if tail or barrier else max(0, self.depth - 2))
        t2 = time.perf_counter()
        self.tracer.add("commit_wait", t1, t2, parent=root)
        res = CommittedBlock(block=pend.block, pend=pend, tx_filter=flt, batch=batch,
                             history=history, barrier=barrier,
                             stage_s={"launch": self._launch_s, "finish": t1 - t0,
                                      "commit_wait": t2 - t1},
                             root_span=root)
        self._launch_s = 0.0
        self._stage_hist.observe(t1 - t0, channel=self.channel, stage="finish")
        self._stage_hist.observe(t2 - t1, channel=self.channel, stage="commit_wait")
        self._launched = None
        if barrier:
            self.barriers += 1
            self._stale_prefetch = True
        if tail or barrier:
            self.tracer.set_attrs(root, **({"barrier": True} if barrier else {"tail": True}))
            self._commit_traced(res, root)
        else:
            self._commits.append(_InflightCommit(
                fut=self._committer.submit(self._commit_traced, res, root), batch=batch,
                txids=pend.txids))
        self._blocks_ctr.add(1, channel=self.channel,
                             mode="barrier" if barrier else "pipelined")
        return res
