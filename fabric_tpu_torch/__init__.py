"""PyTorch/CUDA port of ``fabric_tpu``'s block-commit path for NVIDIA Hopper.

The JAX package ``fabric_tpu`` stays the reference; this package imports
nothing of it (nor ``jax``, ``google.protobuf`` or ``cryptography``).  It
keeps its own copies of the jax-free modules it needs, each naming its
counterpart file.  Module names follow ``fabric_tpu`` so a reader finds
the counterpart: ``ops/p256v3.py`` (batched ECDSA-P256 verify),
``peer/device_block.py`` (fused policy + MVCC stage 2),
``peer/validator.py`` and ``peer/pipeline.py`` (block validation and the
depth-N commit pipeline).

Entry points take an explicit ``device`` (default ``"cuda"``) and raise
when CUDA is absent unless the caller asked for ``device="cpu"``; on the
CPU every kernel wrapper runs its plain PyTorch version.
"""

from fabric_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
