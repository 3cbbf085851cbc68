"""paddle_tpu_torch.profiler: counterpart of ``paddle_tpu/profiler``,
cut to the elastic tier's summaries (``reshard_summary``,
``supervisor_summary``)."""
from .statistic import reshard_summary, supervisor_summary  # noqa: F401
