"""``Sequential`` and ``LayerList``.

Counterpart of ``paddle_tpu/nn/layer/container.py``: sublayers are named
``"0"``, ``"1"``, ... (or by the names of an ``OrderedDict`` / the
``(name, layer)`` pairs given), so the state-dict keys are the
reference's (``experts.0.0.weight``, ...).
"""
from __future__ import annotations

from collections import OrderedDict

from torch import nn

from .layers import Layer

__all__ = ["Sequential", "LayerList"]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, layer in layers[0].items():
                self.add_module(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_module(layer[0], layer[1])
                else:
                    self.add_module(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer, nn.ModuleList):
    """``nn.ModuleList`` under Paddle's name (``sublayers`` as the
    constructor's parameter), a ``Layer``."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            self.extend(sublayers)
