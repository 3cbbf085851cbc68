"""paddle_tpu_torch.nn.functional: counterpart of
``paddle_tpu/nn/functional``, file for file: ``activation``, ``common``,
``norm``, ``loss`` and ``attention``. ``conv``, ``pooling`` and
``extras`` wait for a later slice (ROADMAP.md Queue 1).

``_flash`` (the flash-attention wrapper) and ``sdpa_ref`` are looked up
here by ``attention._sdpa`` at each call, so setting either on this
package swaps it."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .attention import *  # noqa: F401,F403
from .attention import _flash, _sdpa, sdpa_ref  # noqa: F401
from . import activation, attention, common, loss, norm  # noqa: F401
