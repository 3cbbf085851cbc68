"""Counterpart of ``paddle_tpu.nn.layer``.

Holds the base ``Layer`` (``layers``), the activations
(``activation``), the common layers (``common``: ``Linear``,
``Embedding``, dropouts, ``Flatten``, upsampling, pads, ...), the
convolutions (``conv``), the norms (``norm``: ``BatchNorm*``,
``LayerNorm``, ``RMSNorm``, ``GroupNorm``, ...), the pools
(``pooling``), the losses (``loss``), the containers (``container``:
``Sequential``, ``LayerList``, ``LayerDict``, ``ParameterList``), the
transformer layers (``transformer``), the recurrent layers (``rnn``:
``LSTM``, ``GRU``, ``SimpleRNN`` and their cells) and the rest
(``extras``: ``RNN``, ``BiRNN``, ``BeamSearchDecoder``,
``dynamic_decode``, ``MaxUnPool*``, ``Unflatten``, ``Softmax2D``,
``PairwiseDistance`` and the other losses).
"""
from .layers import HookRemoveHelper, Layer  # noqa: F401
from . import activation, common, container, conv, loss, norm  # noqa: F401
from . import extras, pooling, rnn, transformer  # noqa: F401
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
