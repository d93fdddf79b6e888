"""Deterministic fault injection (counterpart: ``fabric_tpu/faults``; see
``plan.py``)."""

from fabric_tpu_torch.faults.plan import (  # noqa: F401
    CRASH_EXIT,
    ENV_SEED,
    ENV_SPEC,
    FaultPlan,
    FaultSpecError,
    InjectedFault,
    afire,
    configure,
    fire,
    install,
    on_crash,
    plan,
    remove_crash_hook,
    reset,
    shield,
)
