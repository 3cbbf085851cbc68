"""paddle_tpu_torch.profiler: counterpart of ``paddle_tpu/profiler``.

``Profiler`` with ``make_scheduler``'s state machine, ``RecordEvent``
spans and op spans from the dispatch (host time: ``profiler.py``), the
Chrome-trace and ``PTPF`` exports, ``summary`` and the subsystem
summaries (``statistic.py``) and the ``benchmark()`` timer
(``timer.py``)."""
from .profiler import (  # noqa: F401
    Profiler, ProfilerState, ProfilerTarget, RecordEvent, SortedKeys,
    SummaryView, export_chrome_tracing, export_protobuf,
    load_profiler_result, make_scheduler,
)
from .statistic import (  # noqa: F401
    comm_summary, gateway_summary, lint_summary, op_cache_summary,
    reshard_summary, serving_summary, step_capture_summary,
    supervisor_summary, trace_summary,
)
from .timer import benchmark  # noqa: F401
