"""Host-side utilities: counterpart of ``paddle_tpu/utils``. The
deadlines and their typed errors (``deadline``), the flags (``flags``),
the host runtime's and the serving C ABI's builds (``native``), the audited
containers (``memo``), ``get_logger``, ``enforce``, DLPack exchange
(``dlpack``), the deprecation and import helpers (``compat``) and
``run_check``."""
from . import flags  # noqa: F401
from . import memo  # noqa: F401
from .enforce import EnforceNotMet, enforce  # noqa: F401
from .log import get_logger  # noqa: F401


def run_check(*, device=None):
    """Check that the port works end to end on ``device`` (default: the
    card; it raises without one unless ``device="cpu"``): a 128 x 128
    matmul of ones there, its corner checked against 128, and the device
    printed."""
    import torch

    from ..core.device import resolve_device
    dev = resolve_device(device)
    x = torch.ones((128, 128), device=dev)
    y = x @ x
    corner = float(y[0, 0])        # a host sync: the card ran the matmul
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if corner != 128.0:
        raise RuntimeError(f"run_check: a 128 x 128 matmul of ones on {dev} "
                           f"gave {corner}, want 128.0")
    print(f"paddle_tpu_torch is installed and working on {dev} ({name}; "
          f"{corner} == 128.0)")
    return True


from .compat import deprecated, require_version, try_import  # noqa: E402,F401
from . import dlpack  # noqa: E402,F401
from .deadline import (  # noqa: E402,F401
    DataLoaderTimeout, Deadline, DeadlineExceeded, RpcTimeout,
    StoreConnectionError, StoreTimeout,
)
