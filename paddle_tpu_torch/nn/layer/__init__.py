"""Counterpart of ``paddle_tpu.nn.layer``.

Holds the base ``Layer`` (``layers``), the activations
(``activation``), the common layers (``common``: ``Linear``,
``Embedding``, dropouts, ``Flatten``, upsampling, pads, ...), the norms
(``norm``: ``BatchNorm*``, ``LayerNorm``, ``RMSNorm``, ``GroupNorm``,
...), the losses (``loss``), the containers (``container``:
``Sequential``, ``LayerList``, ``LayerDict``, ``ParameterList``) and the
transformer layers (``transformer``).

Waiting for a later slice (ROADMAP.md Queue 1): ``conv`` (``Conv1D`` ...
``Conv3DTranspose``), ``pooling`` (``AvgPool*``, ``MaxPool*``,
``Adaptive*Pool*``), ``rnn`` (``LSTM``, ``GRU``, ``SimpleRNN`` and their
cells) and ``extras`` (``RNN``, ``BiRNN``, ``BeamSearchDecoder``,
``dynamic_decode``, ``MaxUnPool*``, ``Unflatten``, ``Softmax2D``,
``PairwiseDistance`` and the rest of the losses).
"""
from .layers import HookRemoveHelper, Layer  # noqa: F401
from . import activation, common, container, loss, norm  # noqa: F401
from . import transformer  # noqa: F401
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
