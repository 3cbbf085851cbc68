"""paddle_tpu_torch.vision: counterpart of ``paddle_tpu.vision``.

Holds ``models`` with the ResNet family (``resnet.py``). Waiting for a
later slice (ROADMAP.md Queue 1): the other models (``models/others.py``,
``models/cnn_zoo.py``), ``ops``, ``transforms``, ``datasets`` and the
image backend.
"""
from . import models  # noqa: F401
from .models import *  # noqa: F401,F403
