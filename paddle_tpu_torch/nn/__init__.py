"""paddle_tpu_torch.nn: counterpart of ``paddle_tpu.nn``.

Holds ``functional`` (activations, common, convolutions, norms, pools,
losses, attention and the rest in ``extras``), ``initializer`` (the 16
names, with ``ParamAttr``), the base ``Layer``, every layer of
``nn/layer`` (activation, common, container, conv, norm, pooling, loss,
transformer, rnn and extras: ``RNN``, ``BiRNN``, ``BeamSearchDecoder``,
``dynamic_decode``, ``MaxUnPool*``, the other losses, ...), ``utils``
(weight and spectral norm, ``parameters_to_vector``, the grad clips by
value and norm), ``quant`` (``Stub``, weight-only and llm.int8 linear)
and the gradient clips (``ClipGradByGlobalNorm``, ``ClipGradByNorm``,
``ClipGradByValue``). Every name of the JAX package's ``nn`` is ported.
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
from .layer.conv import (  # noqa: F401
    Conv1D, Conv2D, Conv3D, Conv1DTranspose, Conv2DTranspose,
    Conv3DTranspose,
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
from .layer.pooling import (  # noqa: F401
    AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
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
from .layer.rnn import (  # noqa: F401
    LSTM, GRU, SimpleRNN, LSTMCell, GRUCell,
)
from .layer.extras import (  # noqa: F401
    RNN, BeamSearchDecoder, BiRNN, GaussianNLLLoss, HSigmoidLoss,
    MaxUnPool1D, MaxUnPool2D, MaxUnPool3D, MultiLabelSoftMarginLoss,
    MultiMarginLoss, PairwiseDistance, PoissonNLLLoss, RNNCellBase, RNNTLoss,
    SimpleRNNCell, SoftMarginLoss, Softmax2D, TripletMarginWithDistanceLoss,
    Unflatten, dynamic_decode,
)
from . import quant, utils  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)
