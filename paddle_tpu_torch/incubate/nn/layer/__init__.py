"""Fused layers: counterpart of ``paddle_tpu/incubate/nn/layer``."""
from .fused_misc import FusedDropoutAdd, FusedEcMoe, FusedLinear  # noqa: F401
from .fused_transformer import (  # noqa: F401
    FusedBiasDropoutResidualLayerNorm,
    FusedFeedForward,
    FusedMultiHeadAttention,
    FusedMultiTransformer,
    FusedTransformerEncoderLayer,
)

__all__ = [
    "FusedBiasDropoutResidualLayerNorm",
    "FusedFeedForward",
    "FusedMultiHeadAttention",
    "FusedMultiTransformer",
    "FusedTransformerEncoderLayer",
]
