"""Device-lane degradation guard: bounded retry, a fallback latch and a
recovery probe (counterpart: ``fabric_tpu/peer/degrade.py``).

``DeviceLaneGuard`` is the state machine that lets a validator outlive a
failing verify lane (the card's, or a sidecar's link):

* **bounded retry**: a failed launch is retried up to ``retries`` times
  after a capped exponential backoff with jitter (``utils/backoff.py``);
* **latch**: after ``fail_threshold`` consecutive failed attempts the
  guard latches degraded, and blocks go to the caller's fallback (the
  validator's ``_host_verify_fallback``: the card's verify kernel
  launched and synced at once; same verdicts);
* **recovery probe**: every ``recovery_s`` a degraded guard risks one
  block on the lane, without retries; a completed launch re-arms it;
* **deadline**: with ``deadline_ms`` > 0 an eager attempt (or a
  duration a caller reports by ``check_deadline``) that takes longer
  counts as a failure toward the latch.  Its result is still used: the
  deadline is a signal for later blocks.  The port's validators set
  none.
* **retry** (port-only): work with no other lane, the validator's stage
  2, gets the same bounded retries and raises after the last.

Every device attempt passes the ``validator.verify_launch`` fault point,
and the fallback runs under ``faults.shield()``.  ``fail_threshold=0``
is the "no guard" setting of every validator: callers then construct
none, so a threshold of 0 here is an error.

The global registry gets the reference's
``validator_degraded`` gauge and its ``device_verify_retries_total`` and
``fallback_blocks_total`` counters (:95-107; the port's retries count
the stage-2 re-dispatches of ``retry`` too).  ``stats()`` holds the same
values with ``failures_total`` beside them: every failed device attempt
(each ``record_failure`` call and each failed probe), so a run can set
the lane's failures beside the faults it injected.  The latch is a
flight-recorder incident edge (``observe/blackbox.py``'s
``degrade_latch``, the reference's :155-157); its detail names the
port's route while degraded, a synchronous ``p256_verify`` on the card
(the reference's says "CPU fallback").
"""

from __future__ import annotations

import logging
import threading
import time

from fabric_tpu_torch import faults
from fabric_tpu_torch.ops_metrics import global_registry
from fabric_tpu_torch.utils.backoff import Backoff

_log = logging.getLogger("fabric_tpu_torch.validator.degrade")

LAUNCH_POINT = "validator.verify_launch"


class DeviceLaneGuard:
    """See the module docstring.  One lock guards the counters and the
    latch: launches record failures on the prefetch thread while fetches
    account on the caller's; the launch and fallback work run outside
    it."""

    def __init__(self, retries: int = 2, fail_threshold: int = 3, recovery_s: float = 30.0,
                 deadline_ms: float = 0.0, backoff: Backoff | None = None,
                 clock=time.monotonic, sleep=time.sleep, channel: str = ""):
        if fail_threshold <= 0:
            raise ValueError("DeviceLaneGuard needs fail_threshold >= 1 "
                             "(0 disables the guard: construct none)")
        self.retries = max(0, int(retries))
        self.fail_threshold = int(fail_threshold)
        self.recovery_s = float(recovery_s)
        self.deadline_ms = float(deadline_ms)
        self.channel = channel
        self._clock = clock
        self._sleep = sleep
        self._backoff = backoff or Backoff(base=0.05, cap=2.0, jitter=0.5)
        self._lock = threading.Lock()
        self._consecutive = 0
        self._degraded = False
        self._degraded_at = 0.0
        self._degraded_accum_s = 0.0
        self._last_probe = 0.0
        self._failures = 0
        self._retries_total = 0
        self._fallbacks = 0
        self._probes = 0
        registry = global_registry()
        self._gauge = registry.gauge(
            "validator_degraded",
            "1 while the device verify lane is latched to CPU fallback",
        )
        self._retries_ctr = registry.counter(
            "device_verify_retries_total",
            "device verify attempts retried after a failure",
        )
        self._fallback_ctr = registry.counter(
            "fallback_blocks_total",
            "blocks routed through the CPU verify fallback",
        )
        self._gauge.set(0, channel=self.channel)

    # -- state ------------------------------------------------------------------

    @property
    def degraded(self) -> bool:
        return self._degraded

    @property
    def consecutive_failures(self) -> int:
        return self._consecutive

    def degraded_seconds(self) -> float:
        """Seconds spent degraded, the current stretch included."""
        with self._lock:
            live = self._clock() - self._degraded_at if self._degraded else 0.0
            return self._degraded_accum_s + live

    def stats(self) -> dict:
        """The latch and its counters (the reference's gauge and
        registry counters, and ``failures_total``)."""
        degraded_s = self.degraded_seconds()
        with self._lock:
            return {"degraded": self._degraded, "consecutive_failures": self._consecutive,
                    "failures_total": self._failures, "retries_total": self._retries_total,
                    "fallback_blocks_total": self._fallbacks, "probes_total": self._probes,
                    "degraded_s": degraded_s}

    def record_failure(self, err: BaseException | None = None) -> None:
        with self._lock:
            self._failures += 1
            self._consecutive += 1
            latched = not self._degraded and self._consecutive >= self.fail_threshold
            if latched:
                self._degraded = True
                self._degraded_at = self._last_probe = self._clock()
                n = self._consecutive
        if latched:
            self._gauge.set(1, channel=self.channel)
            _log.warning("%s: device verify lane DEGRADED after %d consecutive failures (%s); "
                         "blocks take the fallback, a recovery probe every %.1fs",
                         self.channel or "validator", n, err, self.recovery_s)
            from fabric_tpu_torch.observe import blackbox

            blackbox.notify("degrade_latch", channel=self.channel, consecutive_failures=n,
                            error=str(err) if err is not None else None,
                            fallback="synchronous p256_verify on the card")

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._backoff.reset()
            rearmed = self._degraded
            if rearmed:
                down_s = self._clock() - self._degraded_at
                self._degraded_accum_s += down_s
                self._degraded = False
        if rearmed:
            self._gauge.set(0, channel=self.channel)
            _log.warning("%s: device verify lane RECOVERED after %.1fs degraded",
                         self.channel or "validator", down_s)

    def should_probe(self) -> bool:
        """Degraded and due for a lane attempt."""
        with self._lock:
            return self._degraded and self._clock() - self._last_probe >= self.recovery_s

    def check_deadline(self, elapsed_s: float) -> bool:
        """Report a device-side duration; over the deadline it counts as
        a failure (the caller still uses the result).  True when the
        deadline was exceeded."""
        if self.deadline_ms > 0 and elapsed_s * 1000.0 > self.deadline_ms:
            _log.warning("%s: device verify took %.1fms (deadline %.1fms); counted toward "
                         "the latch", self.channel or "validator", elapsed_s * 1000.0,
                         self.deadline_ms)
            self.record_failure()
            return True
        return False

    # -- the launch wrapper -------------------------------------------------------

    def run_launch(self, launch_fn, fallback_fn, eager: bool = False, fallback_count: int = 1):
        """``launch_fn`` on the lane with bounded retries, or
        ``fallback_fn`` when degraded or out of attempts.  ``eager``:
        ``launch_fn`` completes the work, so success is recorded on
        return; otherwise the launch is an asynchronous dispatch and the
        caller records success or failure at its sync.
        ``fallback_count``: the blocks the fallback covers."""
        if self._degraded:
            if not self.should_probe():
                return self._fallback(fallback_fn, fallback_count)
            # one attempt, no retries: a failure costs this block the fallback
            with self._lock:
                self._last_probe = self._clock()
                self._probes += 1
            try:
                faults.fire(LAUNCH_POINT, probe=True)
                t0 = self._clock()
                out = launch_fn()
            except Exception as e:
                with self._lock:
                    self._failures += 1
                _log.info("%s: recovery probe failed (%s); staying degraded",
                          self.channel or "validator", e)
                return self._fallback(fallback_fn, fallback_count)
            if eager and not self.check_deadline(self._clock() - t0):
                self.record_success()
            return out

        attempts = self.retries + 1
        last_err: BaseException | None = None
        for i in range(attempts):
            try:
                faults.fire(LAUNCH_POINT)
                t0 = self._clock()
                out = launch_fn()
            except Exception as e:
                last_err = e
                self.record_failure(e)
                if self._degraded or i == attempts - 1:
                    break
                with self._lock:
                    self._retries_total += 1
                self._retries_ctr.add(1, channel=self.channel)
                self._sleep(self._backoff.next())
                continue
            if eager and not self.check_deadline(self._clock() - t0):
                self.record_success()
            return out
        _log.warning("%s: device verify launch failed %d attempt(s) (%s); this block takes "
                     "the fallback", self.channel or "validator", self._consecutive, last_err)
        return self._fallback(fallback_fn, fallback_count)

    def retry(self, fn, what: str):
        """``fn()`` with the launch's bounded retries and no fallback:
        each failed attempt is recorded; the last one's error raises."""
        for i in range(self.retries + 1):
            try:
                return fn()
            except Exception as e:
                self.record_failure(e)
                if i == self.retries:
                    raise
                _log.warning("%s: %s failed (%s); retrying", self.channel or "validator",
                             what, e)
                with self._lock:
                    self._retries_total += 1
                self._retries_ctr.add(1, channel=self.channel)
                self._sleep(self._backoff.next())

    def count_fallback(self, count: int = 1) -> None:
        """Count blocks that took the fallback outside ``run_launch``
        (a fetch-side re-verify)."""
        with self._lock:
            self._fallbacks += count
        self._fallback_ctr.add(count, channel=self.channel)

    def _fallback(self, fallback_fn, count: int = 1):
        self.count_fallback(count)
        with faults.shield():
            return fallback_fn()
