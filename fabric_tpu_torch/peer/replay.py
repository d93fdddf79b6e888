"""Chain replay: validation back to back, the catch-up driver
(counterpart: ``fabric_tpu/peer/replay.py``).

A joining or restarted peer holds the chain's suffix and validates it
with no time between blocks.  ``ReplayDriver`` feeds the commit
pipeline (``peer/pipeline.py``) from a block iterator:

* a reader thread pulls blocks from the source (``BlockStore.iter_blocks``
  reads and decodes lazily, so the file read and the parse run there)
  into a queue of ``prefetch`` blocks;
* the caller's thread submits them at the pipeline's full ``depth``
  (with ``coalesce_blocks >= 2``, the blocks already queued, up to that
  many, go in one ``submit_many``);
* the committer side records the committed height in a
  ``ReplayCheckpoint`` (``{"height": H}``, tmp file and rename) every
  ``checkpoint_every`` blocks and at the end.  The destination ledger
  is the authority: ``KVLedger.commit_block`` refuses a block out of
  order, so a resume cannot apply a block twice.

The pipe runs with ``replay=True`` (the tx-flow journal records a
replayed block from inclusion to apply only); at depth >= 2 the run's
stats carry the overlap coverage of the global tracer's recent block
trees
(``pipeline_overlap_coverage``, the reference's :272-283).  The
reference's driver also holds its traffic autopilot in throughput mode
for the run; the port has no autopilot yet, and ``autopilot=`` accepts
only None.  ``pre_launch_fn`` (a peer's block-signature check),
``channel`` and ``tracer`` go to the pipe; ``pipe_hook`` is called with
the live pipe at the start and None at the end (a hosting
``PeerChannel`` exposes it as ``pipe`` meanwhile).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time

_log = logging.getLogger("fabric_tpu_torch.replay")

#: decoded blocks held ahead of the pipeline (it bounds the in-flight work)
DEFAULT_PREFETCH = 8

#: checkpoint cadence in blocks, the block store's group-commit window
DEFAULT_CHECKPOINT_EVERY = 8

_POLL_S = 5.0


class ReplayCheckpoint:
    """Replay progress ``{"height": H}``: blocks below H are committed."""

    def __init__(self, path: str):
        self.path = path

    def load(self) -> int | None:
        try:
            with open(self.path) as f:
                return int(json.load(f)["height"])
        except (OSError, ValueError, KeyError):
            return None

    def save(self, height: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"height": int(height)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)


class ReplayDriver:
    """Drive a ``CommitPipeline`` from a block iterator at full depth;
    ``validator`` and ``commit_fn`` are the pipeline's.  One instance
    runs one ``run()``."""

    def __init__(self, validator, commit_fn, *, depth: int = 4,
                 prefetch: int = DEFAULT_PREFETCH,
                 checkpoint: ReplayCheckpoint | str | None = None,
                 checkpoint_every: int = DEFAULT_CHECKPOINT_EVERY,
                 pre_launch_fn=None, channel: str = "",
                 coalesce_blocks: int = 0, tracer=None, autopilot=None, pipe_hook=None):
        if autopilot is not None:
            raise ValueError("the port has no traffic autopilot: autopilot= takes None")
        self.validator = validator
        self.pre_launch_fn = pre_launch_fn
        self.channel = channel
        self.tracer = tracer
        self._pipe_hook = pipe_hook
        self.depth = max(1, int(depth))
        self.prefetch = max(1, int(prefetch))
        if isinstance(checkpoint, str):
            checkpoint = ReplayCheckpoint(checkpoint)
        self.checkpoint = checkpoint
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.coalesce_blocks = int(coalesce_blocks)
        self._inner_commit = commit_fn
        # changed only on the committer thread, read after the pipe closes
        self._committed_blocks = 0
        self._committed_txs = 0
        self._last_height: int | None = None
        self._first_commit_s: float | None = None
        self._t0 = 0.0
        self._stop = threading.Event()

    def _commit(self, res):
        self._inner_commit(res)
        self._committed_blocks += 1
        self._committed_txs += res.n_valid
        self._last_height = res.block.number + 1
        if self._first_commit_s is None:
            self._first_commit_s = time.perf_counter() - self._t0
        if self.checkpoint is not None and self._committed_blocks % self.checkpoint_every == 0:
            self.checkpoint.save(self._last_height)

    def _reader(self, blocks, start, q: queue.Queue, errors: list) -> None:
        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    q.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for blk in blocks:
                if start is not None and blk.header.number < start:
                    continue
                if not put(blk):
                    return
        except BaseException as e:  # raised after the drain
            errors.append(e)
        finally:
            put(None)

    def run(self, blocks, start: int | None = None) -> dict:
        """Replay ``blocks`` (wire ``Block``s, e.g.
        ``store.iter_blocks(h)``); blocks numbered below ``start`` are
        skipped.  Returns the replay's stats: blocks, valid txs,
        seconds, blocks and tx a second, the first block's seconds from
        the start to its commit, the height reached."""
        from fabric_tpu_torch.peer.pipeline import CommitPipeline

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        reader_exc: list = []
        rt = threading.Thread(target=self._reader, args=(blocks, start, q, reader_exc),
                              name="fabtpu-replay-read", daemon=True)
        pipe = CommitPipeline(self.validator, self._commit, depth=self.depth,
                              coalesce_blocks=self.coalesce_blocks, replay=True,
                              pre_launch_fn=self.pre_launch_fn, channel=self.channel,
                              tracer=self.tracer)
        if self._pipe_hook is not None:
            self._pipe_hook(pipe)
        self._t0 = time.perf_counter()
        submitted = 0
        try:
            rt.start()
            ended = False
            while not ended:
                try:
                    blk = q.get(timeout=_POLL_S)
                except queue.Empty:
                    if not rt.is_alive():
                        break  # the reader died without its end mark
                    continue
                if blk is None:
                    break
                group = [blk]
                while self.coalesce_blocks >= 2 and len(group) < self.coalesce_blocks:
                    try:
                        nxt = q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        ended = True
                        break
                    group.append(nxt)
                if len(group) == 1:
                    pipe.submit(blk)
                else:
                    pipe.submit_many(group)
                submitted += len(group)
        except BaseException:
            # stop where it failed: the destination's height and the
            # checkpoint say where to resume
            self._stop.set()
            pipe.close(flush=False)
            raise
        else:
            pipe.close()
            if reader_exc:
                raise reader_exc[0]
        finally:
            if self._pipe_hook is not None:
                self._pipe_hook(None)
            self._stop.set()
            rt.join(timeout=_POLL_S)
            if rt.is_alive():
                _log.warning("replay reader did not stop")
            if self.checkpoint is not None and self._last_height is not None:
                self.checkpoint.save(self._last_height)
        dt = time.perf_counter() - self._t0
        stats = {
            "blocks": self._committed_blocks,
            "txs_valid": self._committed_txs,
            "submitted": submitted,
            "seconds": dt,
            "blocks_per_s": self._committed_blocks / dt if dt > 0 else None,
            "tx_per_s": self._committed_txs / dt if dt > 0 else None,
            "first_commit_s": self._first_commit_s,
            "height": self._last_height,
            "depth": self.depth,
        }
        if self.depth > 1:
            from fabric_tpu_torch import observe

            cov = observe.coverage_from_roots(pipe.tracer.recent_roots(),
                                              window=max(1, self.depth - 1))
            cov.pop("per_block", None)
            stats["pipeline_overlap_coverage"] = cov
        return stats


def replay_into(ledger, validator, source_store, *, depth: int = 4,
                prefetch: int = DEFAULT_PREFETCH,
                checkpoint: ReplayCheckpoint | str | None = None,
                checkpoint_every: int = DEFAULT_CHECKPOINT_EVERY,
                coalesce_blocks: int = 0, autopilot=None) -> dict:
    """Catch ``ledger`` (a ``KVLedger``) up from ``source_store`` (a
    ``BlockStore``), from the ledger's own height (the reference's
    :287).  Each block commits with its filter, batch, history, tx ids
    and ``hd_bytes`` through ``KVLedger.commit_block``."""

    def commit_fn(res):
        ledger.commit_block(res.pend.wire, res.tx_filter, res.batch, res.history, None,
                            res.txids, res.pend.hd_bytes)

    start = ledger.blocks.height
    drv = ReplayDriver(validator, commit_fn, depth=depth, prefetch=prefetch,
                       checkpoint=checkpoint, checkpoint_every=checkpoint_every,
                       coalesce_blocks=coalesce_blocks, autopilot=autopilot)
    stats = drv.run(source_store.iter_blocks(start), start=start)
    stats["resumed_from"] = start
    return stats
