"""``GELU`` (counterpart of ``paddle_tpu/nn/layer/activation.py:39``)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["GELU"]


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self.approximate)
