"""Counterpart of ``paddle_tpu.nn.layer``, cut to what the fleet's MoE
layer, LLaMA and DeepFM are built from: the base ``Layer``, ``Linear``
(Paddle's ``[in, out]`` weight), ``Embedding``, ``GELU``, ``Sequential``
and ``LayerList``. The rest of ``nn/layer/`` waits for a later slice
(ROADMAP.md Queue 1)."""
from .layers import HookRemoveHelper, Layer  # noqa: F401
from .activation import GELU  # noqa: F401
from .common import Embedding, Linear  # noqa: F401
from .container import LayerList, Sequential  # noqa: F401
