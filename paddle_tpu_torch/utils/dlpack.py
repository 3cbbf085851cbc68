"""DLPack exchange: counterpart of ``paddle_tpu/utils/dlpack.py``, through
``torch.utils.dlpack``. Both directions share memory (no copy)."""
from __future__ import annotations

import torch
import torch.utils.dlpack as _dl

from ..core.tensor import Tensor

__all__ = ["to_dlpack", "from_dlpack"]


def to_dlpack(x):
    """A DLPack capsule over ``x``'s memory."""
    return _dl.to_dlpack(x.detach() if isinstance(x, torch.Tensor) else x)


def from_dlpack(capsule) -> Tensor:
    """A port ``Tensor`` over a DLPack capsule's memory, or over any object
    with ``__dlpack__`` (a numpy or JAX array, a torch tensor)."""
    return Tensor(_dl.from_dlpack(capsule))
