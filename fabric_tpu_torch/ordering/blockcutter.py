"""Blockcutter: batch envelopes into block payloads (counterpart:
``fabric_tpu/ordering/blockcutter.py``).

Same cutting rules as the reference (orderer/common/blockcutter/
blockcutter.go:74-130 `Ordered`):

* an envelope larger than PreferredMaxBytes is cut into its OWN batch
  (isolated), flushing any pending batch first;
* if appending would exceed PreferredMaxBytes, the pending batch is
  cut and the envelope starts a new one;
* reaching MaxMessageCount cuts immediately;
* `pending` exposes whether a BatchTimeout timer should be running —
  the chain owns the actual timer (etcdraft/chain.go timer handling).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BatchConfig:
    max_message_count: int = 500
    preferred_max_bytes: int = 2 * 1024 * 1024
    absolute_max_bytes: int = 10 * 1024 * 1024
    batch_timeout_s: float = 2.0


@dataclass
class BlockCutter:
    config: BatchConfig = field(default_factory=BatchConfig)
    _pending: list = field(default_factory=list)
    _pending_bytes: int = 0

    def ordered(self, env_bytes: bytes) -> tuple[list[list[bytes]], bool]:
        """→ (batches_cut_now, pending_remains)."""
        cfg = self.config
        cut: list[list[bytes]] = []
        size = len(env_bytes)

        if size > cfg.preferred_max_bytes:
            # isolated oversize message: flush pending, own batch
            if self._pending:
                cut.append(self._flush())
            cut.append([env_bytes])
            return cut, False

        if self._pending_bytes + size > cfg.preferred_max_bytes and self._pending:
            cut.append(self._flush())

        self._pending.append(env_bytes)
        self._pending_bytes += size

        if len(self._pending) >= cfg.max_message_count:
            cut.append(self._flush())

        return cut, bool(self._pending)

    def cut(self) -> list[bytes]:
        """Force-cut the pending batch (timeout expiry / config msg)."""
        return self._flush() if self._pending else []

    def _flush(self) -> list[bytes]:
        batch, self._pending, self._pending_bytes = self._pending, [], 0
        return batch

    @property
    def pending(self) -> bool:
        return bool(self._pending)
