"""The op library (counterpart of ``paddle_tpu/ops``): ``dispatch``,
``creation``, ``math``, ``manip``, ``linalg``, ``random`` and ``breadth``
(the stacking ops, scatter views, predicates, shifts and the in-place
``*_`` family), and the
``Tensor`` methods installed from them. ``ops.kernels`` holds the
wrappers of the CUDA kernels."""
from . import dispatch  # noqa: F401
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manip import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .breadth import *  # noqa: F401,F403
from . import _method_patch  # noqa: F401  (installs Tensor methods)

from . import breadth, creation, linalg, manip, math, random  # noqa: F401
