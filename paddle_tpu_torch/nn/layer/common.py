"""``Linear`` in Paddle's layout.

Counterpart of ``paddle_tpu/nn/layer/common.py:18-34``: the weight is
``[in_features, out_features]`` (``y = x @ W + b``), drawn XavierNormal
from an explicit generator on the layer's device, the bias zeros;
``bias_attr=False`` leaves it out. The parameter names are ``weight`` and
``bias``, so a JAX state dict loads by name without transposes.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from ..layers import _param, xavier_normal_

__all__ = ["Linear"]


class Linear(nn.Module):
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
