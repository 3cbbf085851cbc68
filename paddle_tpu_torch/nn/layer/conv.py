"""Convolution layers: counterpart of ``paddle_tpu/nn/layer/conv.py``.

``Conv1D`` ... ``Conv3D`` hold a ``[out, in/groups, *k]`` weight, the
transposed ones ``[in, out/groups, *k]``; both draw it KaimingUniform
with ``fan_in = in/groups * prod(k)`` and the bias Uniform(-1/sqrt(fan_in),
1/sqrt(fan_in)), as the JAX layers do, from the device's default
generator, unless ``weight_attr`` / ``bias_attr`` name an initializer;
``bias_attr=False`` leaves the bias out. ``padding_mode`` is accepted
and ignored (zeros), as there. Every layer takes a keyword-only
``device`` (default: the card).
"""
from __future__ import annotations

import numpy as np

from .. import functional as F
from ..initializer import KaimingUniform, Uniform
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, weight_attr, bias_attr,
                 data_format, n, transposed=False, output_padding=0,
                 device=None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, n)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        self.output_padding = output_padding
        self._n = n
        if transposed:
            wshape = [in_channels, out_channels // groups, *self.kernel_size]
        else:
            wshape = [out_channels, in_channels // groups, *self.kernel_size]
        self.weight = self.create_parameter(wshape, attr=weight_attr,
                                            device=device)
        fan_in = in_channels // groups * int(np.prod(self.kernel_size))
        if getattr(weight_attr, "initializer", None) is None:
            KaimingUniform(fan_in=fan_in)(self.weight)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                [out_channels], attr=bias_attr, is_bias=True, device=device)
            if getattr(bias_attr, "initializer", None) is None:
                bound = 1.0 / np.sqrt(fan_in)
                Uniform(-bound, bound)(self.bias)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 1, device=device)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 2, device=device)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 3, device=device)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class _ConvTransposeNd(_ConvNd):
    _fn = None

    def forward(self, x, output_size=None):
        return getattr(F, self._fn)(
            x, self.weight, self.bias, stride=self.stride,
            padding=self.padding, output_padding=self.output_padding,
            groups=self.groups, dilation=self.dilation,
            output_size=output_size, data_format=self.data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _fn = "conv1d_transpose"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 1, transposed=True,
                         output_padding=output_padding, device=device)


class Conv2DTranspose(_ConvTransposeNd):
    _fn = "conv2d_transpose"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 2, transposed=True,
                         output_padding=output_padding, device=device)


class Conv3DTranspose(_ConvTransposeNd):
    _fn = "conv3d_transpose"

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, 3, transposed=True,
                         output_padding=output_padding, device=device)
