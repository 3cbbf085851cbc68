"""``RMSNorm`` and the parameter helpers the layers share.

Counterpart of ``paddle_tpu/nn/layer/norm.py::RMSNorm``. The embedding and
the projections LLaMA is built from are the tensor-parallel layers of
``distributed/fleet/meta_parallel/mp_layers.py`` (at mp=1 plain
single-device layers). Weights keep Paddle's ``[in, out]`` layout and the
parameter name ``weight``, so a JAX state dict loads without transposes.
Initialisation follows the JAX package: XavierNormal
(``std = sqrt(2 / (fan_in + fan_out))``, fans from the ``[in, out]``
shape) for projections and the embedding, ones for the norm weights, drawn
from an explicit generator on the parameter's device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from . import functional as F

__all__ = ["RMSNorm", "xavier_normal_"]


def xavier_normal_(w: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """XavierNormal on a 2-D ``[fan_in, fan_out]`` weight, drawn in fp32 on
    the weight's device and cast to its dtype."""
    fi, fo = w.shape
    std = math.sqrt(2.0 / (fi + fo))
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device,
                            dtype=torch.float32) * std)
    return w


def _param(shape, device, dtype) -> nn.Parameter:
    """A trainable parameter. Serving never builds a graph: its entry
    points run under ``torch.inference_mode()``."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = _param([hidden_size], device, dtype)
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)
