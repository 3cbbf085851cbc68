"""The op library (counterpart of ``paddle_tpu/ops``): ``dispatch``,
``creation``, ``math``, ``manip``, ``linalg`` and ``random``, and the
``Tensor`` methods installed from them. ``ops.kernels`` holds the
wrappers of the CUDA kernels."""
from . import dispatch  # noqa: F401
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manip import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from . import _method_patch  # noqa: F401  (installs Tensor methods)

from . import creation, linalg, manip, math, random  # noqa: F401
