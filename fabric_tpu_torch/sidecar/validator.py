"""``SidecarValidator``: the ``BlockValidator`` whose signature verify
runs in a remote validation sidecar (counterpart:
``fabric_tpu/sidecar/validator.py``).

``preprocess`` ships the block's signature batch over the tenant's
``SidecarLink`` and keeps the ``RemoteVerifyHandle``; it builds no
stage-2 inputs, so every block finishes on ``_validate_host``: host
policy evaluation, then MVCC through the ``mvcc_validate`` kernel on the
peer's own device.  ``CommitPipeline`` needs no change.

The link runs under ``sidecar_guard``, a ``DeviceLaneGuard``
(``peer/degrade.py``) that is always on: its threshold is forced to at
least 1, since a client without the latch would turn every sidecar
restart into a dead channel.  After ``sidecar_fail_threshold``
consecutive failures (a lost link, an ERROR answer, a timeout) the
blocks take the peer's own ``_host_verify_fallback`` (the verify kernel
on the peer's card, launched and synced at once; a failure there
raises), and every ``sidecar_recovery_s``
a probe submits one block over the link, which re-attaches when the
sidecar is back.  The guard is aliased as ``device_guard``; the local
lane's guard stays off, so nothing is counted twice.  Its ``stats()``
shows every fallback.
"""

from __future__ import annotations

from fabric_tpu_torch.peer.degrade import DeviceLaneGuard
from fabric_tpu_torch.peer.validator import BlockValidator
from fabric_tpu_torch.sidecar.client import SidecarLink, parse_endpoint


class SidecarValidator(BlockValidator):
    """``BlockValidator(policy_provider, state_db, block_store, device=,
    msp=)`` plus the link: ``link`` (an existing ``SidecarLink``) or
    ``sidecar_endpoint`` ('host:port') with ``tenant``,
    ``sidecar_weight``, ``sidecar_timeout_s`` and ``sidecar_ssl``; and
    the latch: ``sidecar_fail_threshold`` (at least 1),
    ``sidecar_retries`` and ``sidecar_recovery_s``, the reference's
    defaults."""

    def __init__(self, policy_provider, state_db, block_store=None, *, link=None,
                 sidecar_endpoint: str = "", tenant: str = "chan", sidecar_weight: float = 1.0,
                 sidecar_timeout_s: float = 30.0, sidecar_ssl=None, device="cuda", msp=None,
                 sidecar_fail_threshold: int = 2, sidecar_retries: int = 0,
                 sidecar_recovery_s: float = 5.0):
        super().__init__(policy_provider, state_db, block_store, device=device, msp=msp)
        self.kernel = None  # the sidecar's server selects the verify kernel
        if link is None:
            host, port = parse_endpoint(sidecar_endpoint)
            link = SidecarLink(host, port, tenant=tenant, weight=sidecar_weight,
                               ssl_ctx=sidecar_ssl, timeout_s=sidecar_timeout_s)
        self.link = link
        self.sidecar_guard = DeviceLaneGuard(
            retries=sidecar_retries, fail_threshold=max(1, int(sidecar_fail_threshold)),
            recovery_s=sidecar_recovery_s, channel=tenant)
        self.device_guard = self.sidecar_guard

    def verify_launch(self, items):
        return self._guarded(lambda: self.link.submit(items), [items], many=False)

    def verify_launch_many(self, itemsets) -> list:
        itemsets = list(itemsets)
        return self._guarded(lambda: self.link.submit_many(itemsets), itemsets, many=True)

    def close(self) -> None:
        super().close()
        self.link.close()
