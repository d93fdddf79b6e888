"""The validation sidecar (counterpart: ``fabric_tpu/sidecar/``): one
process owns the card and serves signature batches to many peers over
``comm.rpc``, with weighted-deficit-round-robin fairness and typed
backpressure.  ``SidecarValidator`` (``sidecar/validator.py``) is the
peer's ``BlockValidator`` whose verify goes over the link."""

from fabric_tpu_torch.sidecar.client import RemoteVerifyHandle, SidecarLink, SidecarUnavailable
from fabric_tpu_torch.sidecar.scheduler import Request, WeightedScheduler
from fabric_tpu_torch.sidecar.server import SidecarServer

__all__ = ["RemoteVerifyHandle", "Request", "SidecarLink", "SidecarServer",
           "SidecarUnavailable", "WeightedScheduler"]
