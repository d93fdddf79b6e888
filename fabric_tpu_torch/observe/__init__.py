"""The port's observability layer (counterpart: ``fabric_tpu/observe/``):
the block span tracer (``tracer.py``), the overlap-coverage analyser
(``overlap.py``), the per-launch device-time ledger (``ledger.py``),
the per-transaction flow journal (``txflow.py``), the SLO burn-rate
engine (``slo.py``) and the flight-data recorder: the metrics sampler
(``timeseries.py``, served at ``/vitals``) and the black-box incident
bundles (``blackbox.py``).  The metrics registry they publish to is
``fabric_tpu_torch/ops_metrics.py``."""

from fabric_tpu_torch.observe.overlap import (  # noqa: F401
    coverage_from_roots,
    coverage_from_spans,
    coverage_from_trace_dump,
)
from fabric_tpu_torch.observe.tracer import (  # noqa: F401
    DEFAULT_RING_BLOCKS,
    DEFAULT_SLOW_FACTOR,
    Span,
    Tracer,
    configure,
    device_annotation,
    format_block,
    global_tracer,
    span_from_dict,
)
