"""The ordered state applier behind the block append (counterpart:
``fabric_tpu/ledger/committer.py::AsyncApplyEngine``).

A block is committed once it is in the block store; its state apply
trails on one applier thread and can be rebuilt from the block files
(``KVLedger.recover``).  The engine is itself a ``VersionedDB`` in
front of the real one:

* ordering: one FIFO queue, one applier, each batch under its own
  ``(block, 0)`` savepoint, as the serial engine lands them;
* read-your-writes: every read (``get_state``, ``get_versions_bulk``,
  ``get_versions_cols``, range reads, rich queries) goes through the
  pending overlay, newest batch first, so the validator's verdicts are
  those of the serial engine;
* durability fence: before applying block N to a durable backend the
  applier calls ``blocks.ensure_synced(N)``, so the durable savepoint
  never gets ahead of the block files;
* back-pressure: ``submit`` waits at the block boundary while
  ``queue_blocks`` batches are pending;
* fail-stop: a failed apply latches, and the error re-raises at the
  next ``submit``, ``drain`` or ``wait_applied``.

``ledger.apply.before`` and ``ledger.apply.after`` fire around each
apply (a ``raise`` there latches the engine like any apply error);
``abort()`` drops the queue as a crash would.  ``stats()`` holds the
queue depth, applies, apply ms (total and last) and back-pressure
waits; the registry gets the reference's ``commit_apply_queue_depth``,
``commit_state_apply_seconds`` and ``commit_state_applies_total``
(:387-407).  The tx-flow journal (``observe/txflow.py``) gets each
block's ``durable`` mark at the fence and ``applied`` after its apply.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from fabric_tpu_torch import faults as _faults
from fabric_tpu_torch.ledger.statedb import VersionedDB, _selector_match
from fabric_tpu_torch.observe import txflow as _txflow


class _Pending:
    """One queued block apply."""

    __slots__ = ("num", "batch", "sp", "post_apply", "enqueued_at")

    def __init__(self, num, batch, sp, post_apply, enqueued_at):
        self.num = num
        self.batch = batch
        self.sp = sp
        self.post_apply = post_apply
        self.enqueued_at = enqueued_at


def _merge_overlay(inner_iter, ov: dict):
    """Merge a key-ordered ``(key, VersionedValue)`` iterator with an
    overlay {key: VersionedValue or None (the row is suppressed)};
    the overlay wins a collision and the output stays in key order."""
    ks = sorted(ov)
    i, n = 0, len(ks)
    for key, vv in inner_iter:
        while i < n and ks[i] < key:
            if ov[ks[i]] is not None:
                yield ks[i], ov[ks[i]]
            i += 1
        if i < n and ks[i] == key:
            o = ov[ks[i]]
            i += 1
            if o is not None:
                yield key, o
        else:
            yield key, vv
    for k in ks[i:]:
        if ov[k] is not None:
            yield k, ov[k]


class AsyncApplyEngine(VersionedDB):
    """Ordered background applier in front of an open ``VersionedDB``;
    the thread starts at the first ``submit``.  ``close()`` drains the
    queue, joins the applier and closes the inner DB."""

    def __init__(self, inner: VersionedDB, blocks=None, queue_blocks: int = 4,
                 name: str = "state-applier"):
        self._inner = inner
        self._blocks = blocks  # the durability fence (a BlockStore), optional
        self._capacity = max(1, int(queue_blocks))
        self._name = name
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._thread: threading.Thread | None = None
        self._closing = False
        self._error: BaseException | None = None
        self._applied_num = -1
        self._applies_total = 0
        self._metrics = None  # registry instruments, looked up at the first apply
        self._apply_s_total = 0.0
        self._apply_s_last = 0.0
        self._backpressure_total = 0
        self._max_depth = 0
        self.durable = getattr(inner, "durable", True)

    # -- write side -------------------------------------------------------------

    def submit(self, num: int, batch, savepoint, post_apply=None) -> None:
        """Queue one block's batch; waits while the queue is full.
        ``post_apply`` (no argument) runs on the applier after the
        batch lands (the history commit)."""
        entry = _Pending(num, batch, savepoint, post_apply, time.monotonic())
        with self._cond:
            self._raise_if_failed()
            waited = False
            while (len(self._queue) >= self._capacity and self._error is None
                   and not self._closing):
                waited = True
                self._cond.wait()
            self._raise_if_failed()
            if self._closing:
                raise RuntimeError("state applier is closed")
            self._backpressure_total += waited
            self._queue.append(entry)
            self._max_depth = max(self._max_depth, len(self._queue))
            if self._thread is None:
                self._thread = threading.Thread(target=self._apply_loop,
                                                name=f"fabtorch-{self._name}", daemon=True)
                self._thread.start()
            self._cond.notify_all()

    def apply_updates(self, batch, savepoint=None) -> None:
        """The SPI's apply: queued behind every in-flight commit."""
        self.submit(savepoint[0] if savepoint else -1, batch, savepoint)

    def _raise_if_failed(self):
        # the caller holds _cond
        if self._error is not None:
            raise RuntimeError("state applier failed; the apply queue is fail-stop") \
                from self._error

    def _apply_loop(self):
        while True:
            with self._cond:
                while not self._queue and not self._closing and self._error is None:
                    self._cond.wait()
                if self._error is not None or (self._closing and not self._queue):
                    return
                entry = self._queue[0]  # stays queued: the overlay serves it
            try:
                dur = self._apply_one(entry)
            except BaseException as e:  # ordered apply cannot skip: latch
                with self._cond:
                    self._error = e
                    self._cond.notify_all()
                return
            with self._cond:
                if self._queue and self._queue[0] is entry:  # abort() may have cleared it
                    self._queue.popleft()
                self._applied_num = entry.num
                self._applies_total += 1
                self._apply_s_total += dur
                self._apply_s_last = dur
                self._cond.notify_all()
            self._observe(dur)

    def _apply_one(self, entry: _Pending) -> float:
        _faults.fire("ledger.apply.before", block=entry.num)
        if self._blocks is not None and self.durable:
            self._blocks.ensure_synced(entry.num)
            _txflow.block_durable(entry.num)
        t0 = time.perf_counter()
        self._inner.apply_updates(entry.batch, entry.sp)
        if entry.post_apply is not None:
            entry.post_apply()
        dur = time.perf_counter() - t0
        # the block's writes (and history) are readable from here
        _txflow.block_applied(entry.num)
        _faults.fire("ledger.apply.after", block=entry.num)
        return dur

    def _observe(self, dur: float) -> None:
        """The applier's registry instruments (looked up at the first
        apply): queue depth, the apply's seconds, the count."""
        m = self._metrics
        if m is None:
            from fabric_tpu_torch.ops_metrics import global_registry

            reg = global_registry()
            m = self._metrics = (
                reg.gauge("commit_apply_queue_depth", "pending state-apply batches"),
                reg.histogram("commit_state_apply_seconds",
                              "background state-DB apply per block"),
                reg.counter("commit_state_applies_total",
                            "state batches applied in the background"),
            )
        gauge, hist, ctr = m
        with self._cond:
            depth = len(self._queue)
        gauge.set(float(depth))
        hist.observe(dur)
        ctr.add(1)

    # -- read side: the pending overlay in front of the inner DB ------------------

    def _pending(self) -> list:
        with self._cond:
            return list(self._queue)

    def get_state(self, ns, key):
        for entry in reversed(self._pending()):
            vv = entry.batch.updates.get((ns, key))
            if vv is not None:
                return None if vv.value is None else vv
        return self._inner.get_state(ns, key)

    def get_versions_bulk(self, keys):
        pend = self._pending()
        if not pend:
            return self._inner.get_versions_bulk(keys)
        out, rest = {}, []
        for k in keys:
            for entry in reversed(pend):
                vv = entry.batch.updates.get(k)
                if vv is not None:
                    if vv.value is not None:
                        out[k] = vv.version
                    break
            else:
                rest.append(k)
        if rest:
            out.update(self._inner.get_versions_bulk(rest))
        return out

    def get_versions_cols(self, keys):
        pend = self._pending()
        present, vers = self._inner.get_versions_cols(keys)
        for i, k in enumerate(keys if pend else ()):
            for entry in reversed(pend):
                vv = entry.batch.updates.get(k)
                if vv is not None:
                    present[i] = vv.value is not None
                    vers[i] = vv.version if vv.value is not None else 0
                    break
        return present, vers

    @staticmethod
    def _overlay_for(ns, pend, keep) -> dict:
        """{key: vv, or None where ``keep(vv)`` is false} over the
        pending writes of ``ns``, oldest to newest."""
        ov = {}
        for entry in pend:
            for (n, k), vv in entry.batch.updates.items():
                if n == ns:
                    ov[k] = vv if keep(vv) else None
        return ov

    def _merged(self, inner_iter, ov: dict, limit: int):
        n = 0
        for key, vv in _merge_overlay(inner_iter, ov):
            yield key, vv
            n += 1
            if limit and n >= limit:
                return

    def get_state_range(self, ns, start, end, limit=0):
        pend = self._pending()
        if not pend:
            yield from self._inner.get_state_range(ns, start, end, limit)
            return
        ov = {k: v for k, v in self._overlay_for(ns, pend, lambda vv: vv.value is not None)
              .items() if k >= start and (not end or k < end)}
        # pending deletes and rewrites drop at most len(ov) inner rows
        inner = self._inner.get_state_range(ns, start, end, (limit + len(ov)) if limit else 0)
        yield from self._merged(inner, ov, limit)

    def execute_query(self, ns, query, limit=0):
        pend = self._pending()
        if not pend:
            yield from self._inner.execute_query(ns, query, limit)
            return
        sel = query.get("selector", {})
        # a pending rewrite that no longer matches suppresses the committed row
        ov = self._overlay_for(ns, pend, lambda vv: _selector_match(vv.value, sel))
        inner = self._inner.execute_query(ns, query, (limit + len(ov)) if limit else 0)
        yield from self._merged(inner, ov, limit)

    def iter_all(self):
        self.drain()  # the whole committed state
        yield from self._inner.iter_all()

    def savepoint(self):
        with self._cond:
            for entry in reversed(self._queue):
                if entry.sp is not None:
                    return entry.sp
        return self._inner.savepoint()

    @property
    def meta_count(self):
        """Conservative: a pending batch with metadata counts before
        the inner DB has it."""
        with self._cond:
            pend = sum(1 for e in self._queue if getattr(e.batch, "has_meta", False))
        return self._inner.meta_count + pend

    # -- lifecycle ----------------------------------------------------------------

    def drain(self) -> None:
        """Wait until every queued batch has applied; raises if the
        applier latched a failure."""
        with self._cond:
            while self._queue and self._error is None:
                self._cond.wait(0.5)
            self._raise_if_failed()

    def wait_applied(self, num: int, timeout: float = 30.0) -> bool:
        """Wait until block ``num`` has applied (or ``timeout``)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while (self._applied_num < num and self._error is None
                   and time.monotonic() < deadline):
                self._cond.wait(0.2)
            self._raise_if_failed()
            return self._applied_num >= num

    def stats(self) -> dict:
        with self._cond:
            oldest = self._queue[0].enqueued_at if self._queue else None
            return {
                "queue_depth": len(self._queue),
                "queue_capacity": self._capacity,
                "max_queue_depth": self._max_depth,
                "oldest_age_ms": (time.monotonic() - oldest) * 1000.0 if oldest else 0.0,
                "applied_num": self._applied_num,
                "applies_total": self._applies_total,
                "apply_ms_total": self._apply_s_total * 1000.0,
                "apply_ms_last": self._apply_s_last * 1000.0,
                "backpressure_total": self._backpressure_total,
                "failed": self._error is not None,
            }

    def abort(self) -> None:
        """Drop the pending queue unapplied, stop the applier and close
        the inner DB: what a process that died mid-queue leaves."""
        with self._cond:
            self._queue.clear()
            self._closing = True
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=10.0)
        self._inner.close()

    def close(self) -> None:
        """Drain (up to a latched failure, whose queued batches
        ``recover`` replays on reopen), join and close the inner DB."""
        with self._cond:
            while self._queue and self._error is None:
                self._cond.wait(0.5)
            self._closing = True
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=10.0)
        self._inner.close()
