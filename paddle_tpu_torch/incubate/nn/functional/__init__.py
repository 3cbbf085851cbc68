"""Fused functionals: counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py``. The fused transformer
functionals (``fused_transformer.py``), ``fused_rotary_position_embedding``
and ``masked_multihead_attention`` are plain math in both packages (one op
of the library each); ``fused_linear_cross_entropy`` and its
vocab-parallel form run the port's K5-K7 kernels
(``paddle_tpu/ops/pallas/fused_ce.py``: K5 ``:104``, K6 ``:192``, K7
``:207``)."""
from __future__ import annotations

from ....ops.kernels.fused_ce import fused_linear_cross_entropy as _flce
from ....ops.kernels.fused_ce import fused_linear_cross_entropy_tp as _flce_tp
from .fused_rotary_position_embedding import \
    fused_rotary_position_embedding  # noqa: F401
from .fused_transformer import (  # noqa: F401
    fused_bias_dropout_residual_layer_norm,
    fused_dropout_add,
    fused_feedforward,
    fused_layer_norm,
    fused_linear,
    fused_linear_activation,
    fused_matmul_bias,
    fused_multi_head_attention,
    fused_multi_transformer,
    fused_rms_norm,
)
from .masked_multihead_attention import \
    masked_multihead_attention  # noqa: F401

fused_attention = fused_multi_head_attention

__all__ = [
    "fused_attention",
    "fused_linear_cross_entropy",
    "fused_linear_cross_entropy_tp",
    "fused_bias_dropout_residual_layer_norm",
    "fused_dropout_add",
    "fused_feedforward",
    "fused_layer_norm",
    "fused_linear",
    "fused_linear_activation",
    "fused_matmul_bias",
    "fused_multi_head_attention",
    "fused_multi_transformer",
    "fused_rms_norm",
    "fused_rotary_position_embedding",
    "masked_multihead_attention",
]


def fused_linear_cross_entropy(h, weight, labels, name=None):
    """Per-row cross-entropy of ``softmax(h @ weight)`` against integer
    labels without writing the ``[N, V]`` logits or their cotangent to
    device memory (``__init__.py:28-38``): h ``[N, H]``, weight ``[H, V]``,
    labels ``[N]``; returns fp32 ``[N]``, differentiable in h and weight."""
    return _flce(h, weight, labels)


def fused_linear_cross_entropy_tp(h, weight_shard, labels, axis="mp",
                                  name=None):
    """The vocab-parallel form: this rank's lm-head shard ``[H, V/mp]`` of
    the ``axis`` group (a mesh axis or a ``collective.Group``), the whole
    h ``[N, H]`` and global labels ``[N]``; returns every row's loss, fp32
    ``[N]``, on every rank, differentiable in h and the shard."""
    return _flce_tp(h, weight_shard, labels, axis)
