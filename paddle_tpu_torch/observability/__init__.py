"""Trace spans, the metrics registry and the flight recorder.

- ``trace``: a bounded ring of correlated spans, Chrome trace-event
  export, near-zero cost with ``PT_TRACE=0``;
- ``metrics``: Counter/Gauge/Histogram and pull collectors over the
  serving, gateway and capture counters, rendered as Prometheus text (the
  gateway's METRICS verb);
- the flight recorder: every typed ``DeadlineExceeded`` construction
  snapshots the last spans into ``last_incident()`` (hook installed here).
"""
from ..utils import deadline as _deadline
from . import metrics, trace  # noqa: F401
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, metrics_snapshot, register_collector,
    render_prometheus,
)
from .trace import (  # noqa: F401
    enable, enabled, event, export_trace, incidents, last_incident, span,
    trace_clear, trace_info, trace_records,
)

_deadline.set_incident_hook(trace.record_incident)
