"""Step capture (``jit.capture``): serving steps and whole train steps as
CUDA graphs; ``jit.program`` the record of a captured train step,
``jit.passes`` its report and lint."""
from .capture import (  # noqa: F401
    CapturedStep, capture_clear, capture_info, capture_step, lower_step,
    set_step_capture_enabled, step_capture_enabled,
)
from . import capture  # noqa: F401
