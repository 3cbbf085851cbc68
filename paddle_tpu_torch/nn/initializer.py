"""Weight initializers: counterpart of ``paddle_tpu/nn/initializer.py``.

Each initializer is a callable on a parameter that writes its values in
place, drawn in float32 on the parameter's device from that device's
default generator (``core/generator.py``: ``seed`` makes the draws
repeat) and cast to the parameter's dtype. The draws cannot equal the
JAX package's (its keys feed numpy's Philox); the distributions, fans,
gains and bounds are the JAX module's. ``set_global_initializer`` sets
the initializers ``Layer.create_parameter`` uses when none is given.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.generator import default_generator
from ..framework_compat import ParamAttr  # noqa: F401

__all__ = ["Initializer", "Constant", "Assign", "Uniform", "Normal",
           "TruncatedNormal", "XavierUniform", "XavierNormal",
           "KaimingUniform", "KaimingNormal", "Orthogonal", "Dirac",
           "ParamAttr", "Bilinear", "calculate_gain",
           "set_global_initializer"]


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels [out, in, *k] (Paddle's layout)
    rf = int(np.prod(shape[2:]))
    return shape[1] * rf, shape[0] * rf


class Initializer:
    def __call__(self, param):
        raise NotImplementedError


def _gen(param) -> torch.Generator:
    return default_generator(param.device).generator


def _randn(param, shape=None):
    return torch.randn(tuple(param.shape) if shape is None else shape,
                       generator=_gen(param), device=param.device,
                       dtype=torch.float32)


def _uniform(param, low, high):
    u = torch.rand(tuple(param.shape), generator=_gen(param),
                   device=param.device, dtype=torch.float32)
    return low + (high - low) * u


def _put(param, value):
    with torch.no_grad():
        torch.Tensor.copy_(param, torch.as_tensor(value).to(
            device=param.device, dtype=param.dtype).reshape(param.shape))
    return param


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, param):
        with torch.no_grad():
            torch.Tensor.fill_(param, self.value)
        return param


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, param):
        v = self.value if isinstance(self.value, torch.Tensor) \
            else torch.as_tensor(np.asarray(self.value))
        return _put(param, v.detach())


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, param):
        return _put(param, _uniform(param, self.low, self.high))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, param):
        return _put(param, self.mean + self.std * _randn(param))


class TruncatedNormal(Initializer):
    """Normal(mean, std) kept within 2 std: draws beyond are drawn again
    (8 rounds), then clipped."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, param):
        v = _randn(param)
        for _ in range(8):
            bad = v.abs() > 2.0
            if not bool(bad.any()):
                break
            v = torch.where(bad, _randn(param), v)
        return _put(param, self.mean + self.std * v.clamp(-2.0, 2.0))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, param):
        fi, fo = _fan_in_out(param.shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _put(param, _uniform(param, -limit, limit))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, param):
        fi, fo = _fan_in_out(param.shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _put(param, std * _randn(param))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, param):
        fi, _ = _fan_in_out(param.shape)
        fi = self.fan_in or fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return _put(param, _uniform(param, -limit, limit))


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, param):
        fi, _ = _fan_in_out(param.shape)
        fi = self.fan_in or fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return _put(param, gain / math.sqrt(fi) * _randn(param))


class Orthogonal(Initializer):
    """``gain`` times the Q of a Gaussian matrix's QR (signs fixed by R's
    diagonal), the rows of the parameter's ``[rows, prod(rest)]`` view
    orthonormal when rows <= cols, else its columns."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, param):
        shape = tuple(param.shape)
        rows = shape[0]
        cols = int(np.prod(shape[1:]))
        a = _randn(param, (max(rows, cols), min(rows, cols)))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        q = q.T if rows < cols else q
        return _put(param, self.gain * q[:rows, :cols])


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, param):
        shape = tuple(param.shape)
        out_c, in_c = shape[0], shape[1]
        v = np.zeros(shape, np.float32)
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(min(out_c // self.groups, in_c)):
                idx = (g * (out_c // self.groups) + i, i) + tuple(centers)
                v[idx] = 1.0
        return _put(param, torch.from_numpy(v))


class Bilinear(Initializer):
    """The bilinear upsampling kernel, for a transposed convolution's
    ``(C_out, C_in, kH, kW)`` weight."""

    def __call__(self, p):
        shape = tuple(p.shape)
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D conv weight")
        kh, kw = shape[2], shape[3]
        fh, fw = (kh + 1) // 2, (kw + 1) // 2
        cy = (2 * fh - 1 - fh % 2) / (2.0 * fh)
        cx = (2 * fw - 1 - fw % 2) / (2.0 * fw)
        yy, xx = np.mgrid[0:kh, 0:kw]
        filt = (1 - np.abs(yy / fh - cy)) * (1 - np.abs(xx / fw - cx))
        w = np.broadcast_to(filt, shape).astype(np.float32)
        return _put(p, torch.from_numpy(np.ascontiguousarray(w)))


def calculate_gain(nonlinearity, param=None):
    """The recommended gain of an activation."""
    gains = {
        "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0, "conv3d": 1.0,
        "conv_transpose1d": 1.0, "conv_transpose2d": 1.0,
        "conv_transpose3d": 1.0, "sigmoid": 1.0, "tanh": 5.0 / 3,
        "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param if param is not None
                                            else 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    if nonlinearity not in gains:
        raise ValueError(f"unsupported nonlinearity {nonlinearity!r}")
    return gains[nonlinearity]


_global_initializer = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    """The initializers of parameters created later when none is given
    (``Layer.create_parameter``)."""
    _global_initializer["weight"] = weight_init
    _global_initializer["bias"] = bias_init
