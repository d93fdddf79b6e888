"""Sign-batch ingest: coalescing concurrent endorsement sign requests into
device sign batches (counterpart: ``fabric_tpu/peer/signlane.py``).

Every proposal the endorser simulates ends in one ECDSA signature over
the proposal response.  Concurrent clients make that a stream of
one-item requests; the device lane (``ops/p256sign.py``) pays off only
when they launch as one batch.  ``SignBatcher`` sits between them:

* endorser threads call ``sign`` (blocking, like a serial signer);
* a flusher thread drains up to ``batch_max`` pending digests per
  flush, waiting at most ``wait_ms`` after the first arrival;
* a full admission queue answers a typed ``SignBusy`` instead of
  buffering without bound;
* ``stats()`` keeps the counters, wait percentiles and occupancy.

Nonces are RFC 6979 in both backends, so batched device signing and the
serial CPU backend give bit-equal signatures.

Telemetry (the reference's :95-120, :300-362): ``sign_batch_lanes``,
``sign_batch_wait_seconds``, ``sign_batch_backend_seconds``,
``sign_requests_total`` and ``sign_busy_total`` go to the registry
(``registry=``, else the global one); each flush is a trace root in the
global tracer's ``"sign"`` namespace, so the launch ledger's ``sign``
record and its device spans hang off it; ``observer(wait_ms, busy)``,
called outside the lock for each flushed request (its coalescing wait)
and each BUSY bounce (None), takes the tx-flow journal's
``sign_observer()``.  Left out of the port: the runtime knob setters
the reference's autopilot drives.
"""

from __future__ import annotations

import hashlib
import logging
import math
import threading
import time
from collections import deque

from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.observe import global_tracer

_log = logging.getLogger("fabric_tpu_torch.signlane")

#: retry hint a BUSY answer carries (ms)
SIGN_RETRY_MS = 50

#: admission bound, in batches: one signing plus one accumulating
_QUEUE_BATCHES = 2

#: seconds the busy-rate and wait-percentile windows look back
_SIGNAL_WINDOW_S = 30.0


def _nearest_rank(sorted_vals, q: float):
    """Nearest-rank percentile of a sorted list: rank = ceil(q/100 · n)."""
    rank = math.ceil(q / 100.0 * len(sorted_vals))
    return sorted_vals[max(0, min(len(sorted_vals) - 1, rank - 1))]


class SignBusy(Exception):
    """Typed overflow answer from a full sign batcher."""

    def __init__(self, depth: int, cap: int, retry_ms: int = SIGN_RETRY_MS):
        super().__init__(f"sign batcher full ({depth}/{cap} pending); "
                         f"retry in {retry_ms} ms")
        self.depth = depth
        self.cap = cap
        self.retry_ms = retry_ms


class _Pending:
    __slots__ = ("digest", "event", "result", "error", "t_submit")

    def __init__(self, digest: int, t_submit: float):
        self.digest = digest
        self.event = threading.Event()
        self.result: tuple[int, int] | None = None
        self.error: BaseException | None = None
        self.t_submit = t_submit


def _metrics(registry):
    if registry is None:
        from fabric_tpu_torch.ops_metrics import global_registry

        registry = global_registry()
    return (
        registry.histogram(
            "sign_batch_lanes",
            "sign requests coalesced per batch flush",
            buckets=(1, 4, 16, 64, 256, 1024, float("inf")),
        ),
        registry.histogram(
            "sign_batch_wait_seconds",
            "submit → batch-dispatch wait per sign request (s)",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                     0.05, 0.1, float("inf")),
        ),
        registry.histogram(
            "sign_batch_backend_seconds",
            "backend sign time per batch flush (s)",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
                     float("inf")),
        ),
        registry.counter(
            "sign_requests_total", "sign requests admitted"
        ),
        registry.counter(
            "sign_busy_total", "sign requests bounced with BUSY"
        ),
    )


class SignBatcher:
    """See the module docstring.  ``sign_many``: the backend,
    ``list[digest int] → list[(r, s)]`` (``device_sign_backend``,
    ``cpu_sign_backend`` or a test double); ``registry``: the metrics
    registry (None: the global one); ``observer``: the per-request
    observer."""

    def __init__(self, sign_many, batch_max: int = 256, wait_ms: float = 2.0,
                 registry=None, observer=None):
        if batch_max < 1:
            raise ValueError("batch_max must be >= 1")
        if wait_ms < 0:
            raise ValueError("wait_ms must be >= 0")
        self.sign_many = sign_many
        self._cond = threading.Condition()
        self._pending: deque[_Pending] = deque()
        self._batch_max = int(batch_max)
        self._wait_ms = float(wait_ms)
        self._stopped = False
        self._thread: threading.Thread | None = None
        # trailing admission record: (t, True = admitted | False = BUSY)
        self._recent: deque[tuple[float, bool]] = deque(maxlen=256)
        self._wait_samples: deque[tuple[float, float]] = deque(maxlen=256)  # (t, ms)
        self._occupancy: deque[int] = deque(maxlen=64)
        self._signed_total = 0
        self._busy_total = 0
        self._batches_total = 0
        (self._lanes_h, self._wait_h, self._backend_h,
         self._req_ctr, self._busy_ctr) = _metrics(registry)
        self.observer = observer
        self._flush_seq = 0

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "SignBatcher":
        if self._thread is None:
            with self._cond:
                self._stopped = False
            self._thread = threading.Thread(target=self._run, name="fabtpu-signlane",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        t = self._thread
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None
        with self._cond:  # fail stragglers rather than strand their waits
            while self._pending:
                p = self._pending.popleft()
                p.error = RuntimeError("sign batcher stopped")
                p.event.set()

    def __enter__(self) -> "SignBatcher":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False

    # -- the request side ---------------------------------------------------------

    def sign_digest(self, digest: int, timeout_s: float = 120.0) -> tuple[int, int]:
        """Block until the batch carrying ``digest`` flushes → (r, s).
        Raises ``SignBusy`` on admission overflow, and the backend's
        error if its batch failed."""
        now = time.monotonic()
        busy = None
        with self._cond:
            cap = self._batch_max * _QUEUE_BATCHES
            if self._stopped:
                raise RuntimeError("sign batcher stopped")
            if len(self._pending) >= cap:
                self._busy_total += 1
                self._recent.append((now, False))
                self._busy_ctr.add()
                busy = SignBusy(len(self._pending), cap)
            else:
                p = _Pending(int(digest), now)
                self._pending.append(p)
                self._recent.append((now, True))
                self._req_ctr.add()
                self._cond.notify_all()
        if busy is not None:
            self._observe(None, True)  # outside the lock
            raise busy
        if not p.event.wait(timeout=timeout_s):
            raise TimeoutError("sign batch never flushed")
        if p.error is not None:
            raise p.error
        return p.result

    def sign(self, message: bytes) -> bytes:
        """SHA-256 the message, batch-sign, return the DER-encoded
        low-S (r, s): the drop-in form of a serial signer's ``sign``."""
        e = int.from_bytes(hashlib.sha256(message).digest(), "big")
        return ec_ref.der_encode_sig(*self.sign_digest(e))

    # -- the flusher -----------------------------------------------------------------

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            self._flush(batch)

    def _collect(self) -> list[_Pending] | None:
        """Wait for the first request, then linger up to ``wait_ms`` (or
        until ``batch_max`` fill) before draining."""
        with self._cond:
            while not self._pending and not self._stopped:
                self._cond.wait(timeout=0.5)
            if self._stopped:
                return None
            deadline = self._pending[0].t_submit + self._wait_ms / 1000.0
            while len(self._pending) < self._batch_max and not self._stopped:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=min(remaining, 0.05))
            k = min(len(self._pending), self._batch_max)
            return [self._pending.popleft() for _ in range(k)]

    def _flush(self, batch: list[_Pending]) -> None:
        t0 = time.monotonic()
        with self._cond:
            for p in batch:
                self._wait_samples.append((t0, max(0.0, (t0 - p.t_submit) * 1000.0)))
            self._occupancy.append(len(batch))
        for p in batch:
            w = max(0.0, t0 - p.t_submit)
            self._wait_h.observe(w)
            self._observe(w * 1000.0, False)
        self._lanes_h.observe(len(batch))
        # one trace root a flush in the "sign" ring: the launch
        # ledger's device spans need a tree on the flusher thread
        tr = global_tracer()
        self._flush_seq += 1
        root = tr.begin_block(self._flush_seq, ns="sign", lanes=len(batch))
        tok = tr.attach(root) if root is not None else None
        try:
            sigs = self.sign_many([p.digest for p in batch])
            if len(sigs) != len(batch):
                raise RuntimeError(f"sign backend returned {len(sigs)} signatures "
                                   f"for {len(batch)} digests")
        except BaseException as e:  # every waiter gets the real error
            for p in batch:
                p.error = e
                p.event.set()
            return
        finally:
            if root is not None:
                tr.detach(tok)
                tr.finish_block(root)
        self._backend_h.observe(time.monotonic() - t0)
        with self._cond:
            self._batches_total += 1
            self._signed_total += len(batch)
        for p, rs in zip(batch, sigs):
            p.result = rs
            p.event.set()

    # -- observability ----------------------------------------------------------------

    def _observe(self, wait_ms, busy: bool) -> None:
        """One request event to ``observer``, contained: an observer's
        error never reaches the flusher or a signing thread."""
        obs = self.observer
        if obs is None:
            return
        try:
            obs(wait_ms, busy)
        except Exception as e:
            _log.debug("sign-lane observer failed: %s", e)

    def stats(self) -> dict:
        """Trailing busy rate, wait percentiles, batch occupancy and the
        counters."""
        horizon = time.monotonic() - _SIGNAL_WINDOW_S
        with self._cond:
            recent = [ok for t, ok in self._recent if t >= horizon]
            waits = sorted(w for t, w in self._wait_samples if t >= horizon)
            occ = sorted(self._occupancy)
            out = {
                "depth": len(self._pending),
                "cap": self._batch_max * _QUEUE_BATCHES,
                "batch_max": self._batch_max,
                "wait_ms_knob": self._wait_ms,
                "signed_total": self._signed_total,
                "busy_total": self._busy_total,
                "batches_total": self._batches_total,
            }
        out["busy_rate"] = recent.count(False) / len(recent) if recent else 0.0
        pct = lambda vals, q: _nearest_rank(vals, q) if vals else None
        out["wait_ms"] = {"n": len(waits), "p50": pct(waits, 50), "p99": pct(waits, 99)}
        out["occupancy"] = {"n": len(occ), "p50": pct(occ, 50),
                            "max": occ[-1] if occ else None}
        return out


# ---------------------------------------------------------------------------
# Backends and the provider wrapper


def private_scalar(signer) -> int:
    """The raw P-256 private scalar d of a signer: an
    ``ec_ref.SigningKey`` (``.d``) or anything with ``.key`` exposing
    ``private_numbers().private_value``."""
    d = getattr(signer, "d", None)
    if isinstance(d, int):
        return d
    key = getattr(signer, "key", None)
    pn = getattr(key, "private_numbers", None)
    if pn is not None:
        return int(pn().private_value)
    raise ValueError(f"cannot extract a P-256 private scalar from {type(signer).__name__}")


def cpu_sign_backend(d: int):
    """Serial RFC 6979 signing over ``ec_ref``: the bit-equal oracle."""
    key = ec_ref.SigningKey(int(d))
    return lambda digests: [key.sign_digest(int(e)) for e in digests]


def device_sign_backend(d: int, device="cuda", verify_after: bool = False):
    """Batched signing through ``ops.p256sign`` on ``device`` (default
    ``"cuda"``; raises here when CUDA is absent unless ``"cpu"`` was
    asked for).  ``verify_after`` re-verifies each batch before release.
    torch is imported here, not with the module: the endorser's and the
    gateway client's imports stay free of it."""
    from fabric_tpu_torch.device import resolve_device
    from fabric_tpu_torch.ops import p256sign

    d = int(d)
    dev = resolve_device(device)

    def sign_many(digests):
        return p256sign.sign_digests(digests, d, verify_after=verify_after, device=dev)

    return sign_many


class BatchedSigner:
    """A signing identity whose ``sign`` goes through the batcher; every
    other attribute is the wrapped signer's."""

    def __init__(self, base, batcher: SignBatcher):
        self._base = base
        self.batcher = batcher

    def sign(self, message: bytes) -> bytes:
        return self.batcher.sign(message)

    def __getattr__(self, name):
        return getattr(self._base, name)
