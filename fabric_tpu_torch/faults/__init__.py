"""Deterministic fault injection (counterpart: ``fabric_tpu/faults``; see
``plan.py``)."""

from fabric_tpu_torch.faults.plan import (  # noqa: F401
    FaultPlan,
    FaultSpecError,
    InjectedFault,
    configure,
    fire,
    reset,
)
