"""Device-resident MVCC state (counterpart: ``fabric_tpu/state``)."""

from fabric_tpu_torch.state.residency import ResidencyManager, build_launch_pack

__all__ = ["ResidencyManager", "build_launch_pack"]
