"""``Linear`` in Paddle's layout, and ``Embedding``.

Counterpart of ``paddle_tpu/nn/layer/common.py:18-58``. ``Linear``'s
weight is ``[in_features, out_features]`` (``y = x @ W + b``), drawn
XavierNormal from an explicit generator on the layer's device, the bias
zeros; ``bias_attr=False`` leaves it out. ``Embedding``'s weight is
``[num_embeddings, embedding_dim]`` drawn Normal(0, 1) the same way, its
``padding_idx`` row zeroed. The parameter names are ``weight`` and
``bias``, so a JAX state dict loads by name without transposes.
"""
from __future__ import annotations

import torch

from .. import functional as F
from .layers import Layer
from ..layers import _param, xavier_normal_

__all__ = ["Linear", "Embedding", "normal_"]


class Linear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _param([in_features, out_features], device, dtype)
        init = getattr(weight_attr, "initializer", None)
        if init is not None:
            init(self.weight)
        else:
            xavier_normal_(self.weight, generator)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = _param([out_features], device, dtype)
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


def normal_(w: torch.Tensor, generator, mean: float = 0.0,
            std: float = 1.0) -> torch.Tensor:
    """Normal(mean, std) over ``w``, drawn in fp32 on its device from
    ``generator`` (None: the device's default) and cast to its dtype."""
    with torch.no_grad():
        w.copy_(mean + std * torch.randn(w.shape, generator=generator,
                                         device=w.device,
                                         dtype=torch.float32))
    return w


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = _param([num_embeddings, embedding_dim], device, dtype)
        init = getattr(weight_attr, "initializer", None)
        if init is not None:
            init(self.weight)
        else:
            normal_(self.weight, generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"
