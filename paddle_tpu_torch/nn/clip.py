"""Gradient clipping by global norm.

Counterpart of ``paddle_tpu/nn/clip.py::ClipGradByGlobalNorm`` (:52-66):
``scale = clip_norm / max(global_norm, clip_norm)`` with ``global_norm =
sqrt(sum_g sum(g ** 2))``, every grad multiplied by it. The optimizers
apply it before their update; ``build_hybrid_train_step`` honours this
class alone, as the JAX step does (llama.py:888-897).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm: float, group_name: str = "default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def scale(self, grads) -> Optional[torch.Tensor]:
        """The factor ``clip_norm / max(global_norm, clip_norm)`` (0-dim,
        on the grads' device; squares summed in each grad's dtype), or None
        when there is no grad."""
        sq = [torch.sum(torch.square(g)) for g in grads if g is not None]
        if not sq:
            return None
        norm = torch.sqrt(sum(sq))
        return self.clip_norm / torch.clamp_min(norm, self.clip_norm)

    def __call__(self, params_grads: List[Tuple[torch.Tensor, torch.Tensor]]):
        scale = self.scale([g for _, g in params_grads])
        if scale is None:
            return params_grads
        return [(p, g if g is None else g * scale) for p, g in params_grads]
