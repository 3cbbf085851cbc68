"""paddle_tpu_torch.profiler: counterpart of ``paddle_tpu/profiler``,
cut to the capture tier's summaries (``step_capture_summary``,
``lint_summary``) and the elastic tier's (``reshard_summary``,
``supervisor_summary``)."""
from .statistic import (lint_summary, reshard_summary,  # noqa: F401
                        step_capture_summary, supervisor_summary)
