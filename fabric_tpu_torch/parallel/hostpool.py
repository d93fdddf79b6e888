"""Host staging worker pool (counterpart: ``fabric_tpu/parallel/hostpool.py``).

The host side of a block (the envelope walk, the signature frame, the
policy groups and static MVCC arrays) runs ahead of the card on one
thread unless a pool shares it out.  This is that pool:

* threads: the hot loops are the port's C calls
  (``native/blockparse.cpp``, ``ecprep.cpp``, ``mvccprep.cpp``, which
  ctypes calls with the GIL released) and numpy, so threads overlap
  them without pickling block-sized arrays, and the validator's tasks
  are bound methods over shared blocks;
* one task a block: the validator submits each block's parse and its
  device preprocessing (``BlockValidator.preprocess_many``);
* per-task accounting: ``stats()`` holds the tasks and seconds per
  stage and worker, the registry's ``host_stage_pool_seconds{stage,worker}``
  the same times (the reference's :46-55), and each task runs as a span
  named for its stage under the span that was current on the thread
  that submitted it (the reference's :57-68);
* the ``hostpool.task`` fault point fires inside every task, so a
  fault plan can fail exactly one worker task.

The knob (``BlockValidator(host_stage_workers=)``) resolves as the
reference's: 0 is off (serial staging), -1 is one worker per core, n is
n workers (at most the core count); below 2 gives None, since a pool of
one worker is only queue overhead.  ``set_workers(n)`` (the traffic
autopilot's ``host_stage_workers`` actuator, the reference's :186-225)
latches a new size, clamped by ``clamp_workers``; the first ``submit``
that finds the pool idle drains the old executor and builds the new
one, so a task always finishes on the executor that started it.

Left out of the reference's pool until a caller of the port needs them:
its process mode, ``map`` and the row-slice helpers
``slice_bounds``/``map_slices``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from fabric_tpu_torch import faults
from fabric_tpu_torch.observe import global_tracer


def clamp_workers(n: int, cores: int | None = None) -> int:
    """The one resize-clamp rule (shared by ``set_workers`` and the
    validator's report of the size a resize will give): at least 2
    workers and at most the core count; dropping below 2 is a close,
    not a resize."""
    if cores is None:
        cores = os.cpu_count() or 1
    return max(2, min(int(n), max(2, cores)))


def _pool_hist():
    from fabric_tpu_torch.ops_metrics import global_registry

    return global_registry().histogram(
        "host_stage_pool_seconds",
        "host staging pool task time (s) by stage and worker",
        buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                 0.1, 0.25, 1.0, float("inf")),
    )


def _label_task_error(e: BaseException, stage: str, worker: str) -> None:
    """Name the failing stage and worker on a task's exception, in
    place: its type stays (callers catch specific exceptions), the first
    string argument gains a ``[host pool stage=… worker=…]`` suffix and
    ``fab_stage``/``fab_worker`` are set.  A second call changes
    nothing."""
    if getattr(e, "fab_stage", None) is not None:
        return
    try:
        e.fab_stage = stage
        e.fab_worker = worker
        if e.args and isinstance(e.args[0], str):
            e.args = (f"{e.args[0]} [host pool stage={stage} worker={worker}]",) + e.args[1:]
    except (AttributeError, TypeError):
        pass  # an exception type without a __dict__ propagates unlabelled


class HostStagePool:
    """A persistent staging pool (see the module docstring); made once
    per validator by ``resolve_host_pool`` and reused for every block."""

    def __init__(self, workers: int):
        if workers < 2:
            raise ValueError("HostStagePool needs >= 2 workers "
                             "(resolve_host_pool returns None below that)")
        self.workers = int(workers)
        self._ex = ThreadPoolExecutor(self.workers, thread_name_prefix="fabtpu-hoststage")
        self._hist = _pool_hist()
        self._trc = global_tracer()
        self._lock = threading.Lock()
        self._durs: deque = deque(maxlen=1024)  # recent task seconds
        self._tasks = 0
        self._by: dict = {}  # (stage, worker) → [tasks, seconds]
        # a resize waits for an idle task boundary: tasks in flight
        # (counted under _lock) and the latched size
        self._active = 0
        self._pending_workers: int | None = None

    # -- submission ------------------------------------------------------------

    def _observe(self, stage: str, worker: str, dt: float) -> None:
        self._hist.observe(dt, stage=stage, worker=worker)
        with self._lock:
            self._durs.append(dt)
            self._tasks += 1
            rec = self._by.setdefault((stage, worker), [0, 0.0])
            rec[0] += 1
            rec[1] += dt

    def _timed(self, fn, stage: str, parent):
        """``fn`` timed inside its worker (so the worker label names the
        thread that ran it), as a span under ``parent`` (the submitting
        thread's current span, captured at submit); an exception is
        labelled there."""
        trc = self._trc

        def run(*args, **kwargs):
            name = threading.current_thread().name
            worker = name.rsplit("_", 1)[-1] if "_" in name else name
            t0 = time.perf_counter()
            try:
                with trc.span(stage, parent=parent, worker=worker):
                    faults.fire("hostpool.task", stage=stage)
                    return fn(*args, **kwargs)
            except BaseException as e:
                _label_task_error(e, stage, worker)
                raise
            finally:
                self._observe(stage, worker, time.perf_counter() - t0)

        return run

    def set_workers(self, n: int) -> None:
        """Request ``clamp_workers(n)`` workers, applied at the next task
        boundary: the first ``submit`` that finds the pool idle swaps in
        a new executor (the old one, empty, shuts down at once)."""
        n = clamp_workers(n)
        with self._lock:
            self._pending_workers = None if n == self.workers else n

    def _maybe_resize_locked(self):
        """Caller holds ``_lock``.  → the executor a new task goes to,
        after the latched resize when the pool is idle."""
        n = self._pending_workers
        if n is None or self._active > 0:
            return self._ex
        self._pending_workers = None
        old = self._ex
        self._ex = ThreadPoolExecutor(n, thread_name_prefix="fabtpu-hoststage")
        self.workers = n
        old.shutdown(wait=False)  # idle: returns at once
        return self._ex

    def _task_done(self, _fut) -> None:
        with self._lock:
            self._active -= 1

    def submit(self, fn, *args, stage: str = "task", **kwargs):
        """One task → its Future, timed and labelled in its worker; a
        failed task raises at ``result()`` and is never retried."""
        with self._lock:
            ex = self._maybe_resize_locked()
            # counted before the lock drops: a concurrent resize check
            # never sees the pool idle while this task is on its way
            self._active += 1
        try:
            fut = ex.submit(self._timed(fn, stage, self._trc.current()), *args, **kwargs)
        except BaseException:
            with self._lock:
                self._active -= 1
            raise
        fut.add_done_callback(self._task_done)
        return fut

    # -- introspection and lifecycle ---------------------------------------------

    def stats(self) -> dict:
        """Workers, tasks, the median of recent task times, and
        ``by_stage``: {stage: {worker: {"tasks", "seconds"}}}."""
        with self._lock:
            durs = sorted(self._durs)
            by: dict = {}
            for (stage, worker), (k, s) in sorted(self._by.items()):
                by.setdefault(stage, {})[worker] = {"tasks": k, "seconds": s}
            return {"workers": self.workers, "tasks": self._tasks,
                    "per_shard_p50_ms": 1e3 * durs[len(durs) // 2] if durs else 0.0,
                    "by_stage": by}

    def shutdown(self) -> None:
        self._ex.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown()
        return False


def resolve_host_pool(workers: int) -> HostStagePool | None:
    """The ``host_stage_workers`` knob → a pool: 0 off, -1 one worker
    per core, n that many (at most the core count); below 2 → None."""
    if workers == 0:
        return None
    cores = os.cpu_count() or 1
    n = cores if workers < 0 else min(workers, cores)
    if n < 2:
        return None
    return HostStagePool(n)
