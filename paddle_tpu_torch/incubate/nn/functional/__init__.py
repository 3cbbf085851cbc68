"""Fused functionals (counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py``). Only the fused lm-head
plus cross-entropy is ported so far, with its vocab-parallel form
(``paddle_tpu/ops/pallas/fused_ce.py:292``); the other fused functionals
wait in ROADMAP.md Queue 1."""
from __future__ import annotations

from ....ops.kernels.fused_ce import fused_linear_cross_entropy as _flce
from ....ops.kernels.fused_ce import fused_linear_cross_entropy_tp as _flce_tp

__all__ = ["fused_linear_cross_entropy", "fused_linear_cross_entropy_tp"]


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
