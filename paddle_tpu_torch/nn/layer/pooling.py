"""Pooling layers: counterpart of ``paddle_tpu/nn/layer/pooling.py``.

Each layer keeps its arguments and calls the functional of the same name
(``nn/functional/pooling.py``); extra keywords (``ceil_mode``,
``exclusive``, ``return_mask``, ``data_format``, ...) pass through.
"""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


class _Pool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, **kw):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kw = kw

    def forward(self, x):
        return getattr(F, self._fn)(x, self.kernel_size, self.stride,
                                    self.padding, **self.kw)


class AvgPool1D(_Pool):
    _fn = "avg_pool1d"


class AvgPool2D(_Pool):
    _fn = "avg_pool2d"


class AvgPool3D(_Pool):
    _fn = "avg_pool3d"


class MaxPool1D(_Pool):
    _fn = "max_pool1d"


class MaxPool2D(_Pool):
    _fn = "max_pool2d"


class MaxPool3D(_Pool):
    _fn = "max_pool3d"


class _AdaptivePool(Layer):
    _fn = None

    def __init__(self, output_size, **kw):
        super().__init__()
        self.output_size = output_size
        self.kw = kw

    def forward(self, x):
        return getattr(F, self._fn)(x, self.output_size, **self.kw)


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = "adaptive_avg_pool1d"


class AdaptiveAvgPool2D(_AdaptivePool):
    _fn = "adaptive_avg_pool2d"


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = "adaptive_avg_pool3d"


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = "adaptive_max_pool1d"


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = "adaptive_max_pool2d"


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = "adaptive_max_pool3d"
