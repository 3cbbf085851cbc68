"""Fused functionals (counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py``). Only the fused lm-head
plus cross-entropy is ported so far; the other fused functionals wait in
ROADMAP.md Queue 1."""
from __future__ import annotations

from ....ops.kernels.fused_ce import fused_linear_cross_entropy as _flce

__all__ = ["fused_linear_cross_entropy"]


def fused_linear_cross_entropy(h, weight, labels, name=None):
    """Per-row cross-entropy of ``softmax(h @ weight)`` against integer
    labels without writing the ``[N, V]`` logits or their cotangent to
    device memory (``__init__.py:28-38``): h ``[N, H]``, weight ``[H, V]``,
    labels ``[N]``; returns fp32 ``[N]``, differentiable in h and weight."""
    return _flce(h, weight, labels)
