"""``SidecarValidator``: the ``BlockValidator`` whose signature verify
runs in a remote validation sidecar (counterpart:
``fabric_tpu/sidecar/validator.py``).

``preprocess`` ships the block's signature batch over the tenant's
``SidecarLink`` and keeps the ``RemoteVerifyHandle``; it builds no
stage-2 inputs, so every block finishes on ``_validate_host``: host
policy evaluation, then MVCC through the ``mvcc_validate`` kernel on the
peer's own device.  ``CommitPipeline`` needs no change.

Deliberate difference: the reference wraps the link in
``DeviceLaneGuard`` (``peer/degrade.py``) and latches to CPU
verification after repeated failures.  Here a lost or failing sidecar
raises ``SidecarUnavailable`` from ``validate_finish``: a quiet CPU
re-verify would hide the card from every measurement.
"""

from __future__ import annotations

from fabric_tpu_torch.peer.validator import BlockValidator
from fabric_tpu_torch.sidecar.client import SidecarLink, parse_endpoint


class SidecarValidator(BlockValidator):
    """``BlockValidator(policy_provider, state_db, block_store, device=,
    msp=)`` plus the link: ``link`` (an existing ``SidecarLink``) or
    ``sidecar_endpoint`` ('host:port') with ``tenant``,
    ``sidecar_weight``, ``sidecar_timeout_s`` and ``sidecar_ssl``."""

    def __init__(self, policy_provider, state_db, block_store=None, *, link=None,
                 sidecar_endpoint: str = "", tenant: str = "chan", sidecar_weight: float = 1.0,
                 sidecar_timeout_s: float = 30.0, sidecar_ssl=None, device="cuda", msp=None):
        super().__init__(policy_provider, state_db, block_store, device=device, msp=msp)
        self.kernel = None  # the sidecar's server selects the verify kernel
        if link is None:
            host, port = parse_endpoint(sidecar_endpoint)
            link = SidecarLink(host, port, tenant=tenant, weight=sidecar_weight,
                               ssl_ctx=sidecar_ssl, timeout_s=sidecar_timeout_s)
        self.link = link

    def verify_launch(self, items):
        return self.link.submit(items)

    def verify_launch_many(self, itemsets) -> list:
        return self.link.submit_many(itemsets)

    def close(self) -> None:
        super().close()
        self.link.close()
