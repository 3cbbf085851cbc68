"""paddle_tpu_torch.nn.functional: counterpart of
``paddle_tpu/nn/functional``, file for file: ``activation``, ``common``,
``conv``, ``norm``, ``pooling``, ``loss``, ``attention`` and
``extras``.

``_flash`` (the flash-attention wrapper) and ``sdpa_ref`` are looked up
here by ``attention._sdpa`` at each call, so setting either on this
package swaps it."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .attention import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .attention import _flash, _sdpa, sdpa_ref  # noqa: F401
from . import (activation, attention, common, conv, extras,  # noqa: F401
               loss, norm, pooling)
