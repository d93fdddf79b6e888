"""The traffic autopilot (counterpart: ``fabric_tpu/control/``):
closed-loop overload control over the SLO burn-rate engine and the
scheduler telemetry (``autopilot.py``)."""

from fabric_tpu_torch.control.autopilot import (  # noqa: F401
    DEFAULT_BANDS,
    DEFAULT_KNOB_SPECS,
    OPT_IN_KNOBS,
    Autopilot,
    Decision,
    KnobSpec,
    KnobSpecError,
    Signals,
    global_autopilot,
    host_clamped_specs,
    parse_knob_specs,
    resolve_host_workers_initial,
    set_global,
)
