"""Gradient clipping: by value, by each grad's norm, by the global norm.

Counterpart of ``paddle_tpu/nn/clip.py`` (:13-66). A clip is called on
``[(param, grad), ...]`` and returns the pairs with clipped grads (a None
grad passes through):

- ``ClipGradByValue(max, min=-max)``: each element clamped to [min, max];
- ``ClipGradByNorm(clip_norm)``: each grad times ``min(clip_norm /
  max(||g||, 1e-12), 1)``, its norm taken in its dtype;
- ``ClipGradByGlobalNorm(clip_norm)``: every grad times ``clip_norm /
  max(global_norm, clip_norm)``, with ``global_norm = sqrt(sum_g
  sum(g ** 2))``, the squares summed in fp32 per grad and the grads' sums
  added in list order. On the card the sums come from one multi-tensor
  kernel launch (U1, ``ops/kernels/multi_tensor.py``) and the scale stays
  on the device. The reference's eager clip sums a bf16 grad's squares in
  bf16; here, as in its compiled steps, they are summed in fp32.

The optimizers apply a clip before their update; ``Optimizer.step``,
``parallel.TrainStep`` and ``build_hybrid_train_step`` fold the global-norm
scale into the update kernel instead of writing clipped grads.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..ops.kernels.multi_tensor import multi_tensor_sumsq_finite

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


def _scalar_over(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` rounded once (``float / tensor`` in PyTorch is
    ``den.reciprocal() * num``)."""
    return torch.full_like(den, num) / den


class ClipGradBase:
    def _clip(self, params_grads):
        raise NotImplementedError

    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, g if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g)))
            scale = torch.clamp_max(
                _scalar_over(self.clip_norm, torch.clamp_min(norm, 1e-12)),
                1.0)
            out.append((p, g * scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm: float, group_name: str = "default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def scale_from_sumsq(self, total: torch.Tensor) -> torch.Tensor:
        """``clip_norm / max(sqrt(total), clip_norm)`` for the global sum
        of squares ``total`` (0-dim fp32), on its device."""
        return _scalar_over(self.clip_norm,
                            torch.clamp_min(torch.sqrt(total),
                                            self.clip_norm))

    def scale(self, grads) -> Optional[torch.Tensor]:
        """The factor ``clip_norm / max(global_norm, clip_norm)`` (0-dim
        fp32 on the grads' device), or None when there is no grad."""
        grads = [g for g in grads if g is not None]
        if not grads:
            return None
        return self.scale_from_sumsq(multi_tensor_sumsq_finite(grads)[1])

    def _clip(self, params_grads: List[Tuple[torch.Tensor, torch.Tensor]]):
        scale = self.scale([g for _, g in params_grads])
        if scale is None:
            return params_grads
        return [(p, g if g is None else g * scale) for p, g in params_grads]
