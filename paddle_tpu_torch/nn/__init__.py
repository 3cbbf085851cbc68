"""paddle_tpu_torch.nn: counterpart of ``paddle_tpu.nn``.

Holds ``functional`` (activations, common, norms, losses, attention),
``initializer`` (the 16 names, with ``ParamAttr``), the base ``Layer``,
the activation, common, norm, loss, container and transformer layers of
``nn/layer``, and the gradient clips (``ClipGradByGlobalNorm``,
``ClipGradByNorm``, ``ClipGradByValue``).

Waiting for a later slice (ROADMAP.md Queue 1): the convolutions
(``Conv1D`` ... ``Conv3DTranspose``), the pools (``AvgPool*``,
``MaxPool*``, ``Adaptive*Pool*``), the recurrent layers (``LSTM``,
``GRU``, ``SimpleRNN``, ``LSTMCell``, ``GRUCell``), ``nn/layer/extras``
(``RNN``, ``BiRNN``, ``BeamSearchDecoder``, ``dynamic_decode``,
``MaxUnPool*``, ``Unflatten``, ``Softmax2D``, ``PairwiseDistance``,
``GaussianNLLLoss``, ``HSigmoidLoss``, ``MultiLabelSoftMarginLoss``,
``MultiMarginLoss``, ``PoissonNLLLoss``, ``RNNTLoss``,
``SoftMarginLoss``, ``TripletMarginWithDistanceLoss``, ``RNNCellBase``,
``SimpleRNNCell``), ``nn/utils`` and ``nn/quant``.
"""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .initializer import ParamAttr  # noqa: F401
from .layer.layers import Layer  # noqa: F401
from .layer.common import (  # noqa: F401
    Identity, Linear, Embedding, Dropout, Dropout2D, Dropout3D,
    AlphaDropout, Flatten, Upsample, UpsamplingBilinear2D,
    UpsamplingNearest2D, Pad1D, Pad2D, Pad3D, ZeroPad2D, CosineSimilarity,
    Bilinear, PixelShuffle, PixelUnshuffle, ChannelShuffle, Unfold, Fold,
)
from .layer.container import (  # noqa: F401
    Sequential, LayerList, LayerDict, ParameterList,
)
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, SyncBatchNorm,
    LayerNorm, RMSNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
    GroupNorm, LocalResponseNorm, SpectralNorm,
)
from .layer.activation import (  # noqa: F401
    ReLU, ReLU6, Sigmoid, LogSigmoid, Tanh, Tanhshrink, Silu, Swish, Mish,
    GELU, ELU, SELU, CELU, LeakyReLU, Hardsigmoid, Hardswish, Hardtanh,
    Hardshrink, Softshrink, Softplus, Softsign, ThresholdedReLU,
    LogSoftmax, Maxout, Softmax, PReLU, RReLU,
)
from .layer.loss import (  # noqa: F401
    CrossEntropyLoss, MSELoss, L1Loss, SmoothL1Loss, BCELoss,
    BCEWithLogitsLoss, NLLLoss, KLDivLoss, MarginRankingLoss, CTCLoss,
    HingeEmbeddingLoss, CosineEmbeddingLoss, TripletMarginLoss,
)
from .layer.transformer import (  # noqa: F401
    MultiHeadAttention, TransformerEncoderLayer, TransformerEncoder,
    TransformerDecoderLayer, TransformerDecoder, Transformer,
)
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)
