"""Device resolution: an explicit device, never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` → ``torch.device``.  A CUDA device on a host where
    ``torch.cuda.is_available()`` is False raises: the caller must ask
    for ``device="cpu"`` to run the plain versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
