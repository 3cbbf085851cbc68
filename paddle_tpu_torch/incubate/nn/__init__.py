"""Fused transformer layers and functionals: counterpart of
``paddle_tpu/incubate/nn``."""
from . import functional  # noqa: F401
from .layer import (  # noqa: F401
    FusedBiasDropoutResidualLayerNorm,
    FusedFeedForward,
    FusedMultiHeadAttention,
    FusedMultiTransformer,
    FusedTransformerEncoderLayer,
)
from .layer.fused_misc import (  # noqa: F401
    FusedDropoutAdd, FusedEcMoe, FusedLinear,
)

__all__ = [
    "functional",
    "FusedBiasDropoutResidualLayerNorm",
    "FusedFeedForward",
    "FusedMultiHeadAttention",
    "FusedMultiTransformer",
    "FusedTransformerEncoderLayer",
]
