"""The parameter helpers the port's layers share, and ``RMSNorm`` (which
lives in ``nn/layer/norm.py``, re-exported here for LLaMA's import).

Weights keep Paddle's ``[in, out]`` layout and the parameter name
``weight``, so a JAX state dict loads without transposes. Initialisation
follows the JAX package: XavierNormal (``std = sqrt(2 / (fan_in +
fan_out))``, fans from the ``[in, out]`` shape) for projections and the
embedding, ones for the norm weights, drawn from an explicit generator on
the parameter's device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.device import resolve_device

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
    """A trainable parameter on ``device`` (default: the card). Serving
    never builds a graph: its entry points run under
    ``torch.inference_mode()``."""
    return nn.Parameter(torch.empty(shape, device=resolve_device(device),
                                    dtype=dtype))


from .layer.norm import RMSNorm  # noqa: E402,F401
