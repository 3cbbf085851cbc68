"""``jit``: ``to_static`` (``api``, with ``dy2static``'s control-flow
conversion), ``jit.save`` / ``jit.load`` (``save_load``: a ``torch.export``
of the layer's functional form), and step capture (``capture``: serving
steps and whole train steps as CUDA graphs; ``program`` the record of a
captured train step, ``passes`` its report and lint)."""
from .api import (  # noqa: F401
    InputSpec, StaticFunction, enable_to_static, ignore_module, not_to_static,
    set_code_level, set_verbosity, to_static,
)
from . import api  # noqa: F401
from .capture import (  # noqa: F401
    CapturedStep, capture_clear, capture_info, capture_step, lower_step,
    set_step_capture_enabled, step_capture_enabled,
)
from . import capture  # noqa: F401
from .save_load import save, load, TranslatedLayer  # noqa: F401
