"""Activations: counterpart of ``paddle_tpu/nn/functional/activation.py``.

Each runs through ``ops.dispatch.apply`` under the JAX package's op name,
so ``amp.auto_cast`` casts its inputs as the JAX package's does. The
formulas are ``jax.nn``'s: ``leaky_relu`` passes ``x >= 0``, ``softplus``
is ``logaddexp(x, 0)``, ``rrelu`` in training draws its slopes from the
input's device's default generator (or ``key``, a ``torch.Generator``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core import dtype as dtypes
from ...ops.dispatch import apply

__all__ = [
    "relu", "relu6", "relu_", "leaky_relu", "prelu", "elu", "selu", "celu",
    "gelu", "silu", "swish", "mish", "softplus", "softshrink", "hardshrink",
    "tanhshrink", "sigmoid", "hardsigmoid", "hardswish", "hardtanh",
    "log_sigmoid", "maxout", "softmax", "log_softmax", "softsign",
    "thresholded_relu", "tanh", "glu", "rrelu",
]


def _un(opname, fn):
    def op(x, name=None):
        return apply(fn, x, op_name=opname)
    op.__name__ = opname
    return op


def _softplus(v):
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype, device=v.device))


relu = _un("relu", torch.relu)
relu_ = relu
relu6 = _un("relu6", TF.relu6)
sigmoid = _un("sigmoid", torch.sigmoid)
log_sigmoid = _un("log_sigmoid", TF.logsigmoid)
silu = _un("silu", TF.silu)
softsign = _un("softsign", TF.softsign)
tanh = _un("tanh", torch.tanh)
mish = _un("mish", lambda v: v * torch.tanh(_softplus(v)))


def leaky_relu(x, negative_slope=0.01):
    return apply(lambda v: torch.where(v >= 0, v, negative_slope * v), x,
                 op_name="leaky_relu")


def prelu(x, weight, data_format="NCHW"):
    def f(v, w):
        if w.numel() == 1:
            return torch.where(v >= 0, v, w.reshape(()) * v)
        shape = [1] * v.dim()
        ch_axis = 1 if data_format == "NCHW" else v.dim() - 1
        shape[ch_axis] = w.numel()
        return torch.where(v >= 0, v, w.reshape(shape) * v)
    return apply(f, x, weight, op_name="prelu")


def elu(x, alpha=1.0):
    return apply(lambda v: torch.where(
        v > 0, v, alpha * torch.expm1(torch.where(v > 0, 0.0, v))), x,
        op_name="elu")


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return apply(lambda v: scale * torch.where(v > 0, v,
                                               alpha * torch.expm1(v)),
                 x, op_name="selu")


def celu(x, alpha=1.0):
    return apply(lambda v: torch.clamp_min(v, 0.0) + alpha * torch.expm1(
        torch.clamp_max(v, 0.0) / alpha), x, op_name="celu")


def gelu(x, approximate=False):
    """GELU: exact (erf) by default, the tanh form with ``approximate``."""
    return apply(TF.gelu, x, op_name="gelu",
                 approximate="tanh" if approximate else "none")


def swish(x):
    return silu(x)


def softplus(x, beta=1.0, threshold=20.0):
    return apply(lambda v: torch.where(v * beta > threshold, v,
                                       _softplus(v * beta) / beta),
                 x, op_name="softplus")


def softshrink(x, threshold=0.5):
    return apply(lambda v: torch.where(
        v > threshold, v - threshold,
        torch.where(v < -threshold, v + threshold, torch.zeros_like(v))),
        x, op_name="softshrink")


def hardshrink(x, threshold=0.5):
    return apply(lambda v: torch.where(v.abs() > threshold, v,
                                       torch.zeros_like(v)),
                 x, op_name="hardshrink")


def tanhshrink(x):
    return apply(lambda v: v - torch.tanh(v), x, op_name="tanhshrink")


def hardsigmoid(x, slope=1.0 / 6, offset=0.5):
    return apply(lambda v: torch.clamp(v * slope + offset, 0.0, 1.0), x,
                 op_name="hardsigmoid")


def hardswish(x):
    return apply(lambda v: v * torch.clamp(v + 3.0, 0.0, 6.0) / 6.0, x,
                 op_name="hardswish")


def hardtanh(x, min=-1.0, max=1.0):
    return apply(lambda v: torch.clamp(v, min, max), x, op_name="hardtanh")


def thresholded_relu(x, threshold=1.0):
    return apply(lambda v: torch.where(v > threshold, v,
                                       torch.zeros_like(v)),
                 x, op_name="thresholded_relu")


def maxout(x, groups, axis=1):
    def f(v):
        ax = axis % v.dim()
        c = v.shape[ax]
        shape = v.shape[:ax] + (groups, c // groups) + v.shape[ax + 1:]
        return torch.amax(v.reshape(shape), dim=ax)
    return apply(f, x, op_name="maxout")


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis``, in ``dtype`` if given."""
    def f(v):
        return torch.softmax(v if dtype is None else v.to(
            dtypes.convert_dtype(dtype)), dim=axis)
    return apply(f, x, op_name="softmax")


def log_softmax(x, axis=-1, dtype=None):
    def f(v):
        return torch.log_softmax(v if dtype is None else v.to(
            dtypes.convert_dtype(dtype)), dim=axis)
    return apply(f, x, op_name="log_softmax")


def glu(x, axis=-1):
    return apply(lambda v: TF.glu(v, dim=axis), x, op_name="glu")


def rrelu(x, lower=1.0 / 8, upper=1.0 / 3, training=False, name=None,
          key=None):
    """Training: slopes drawn uniform in [lower, upper) per element from
    ``key`` (a ``torch.Generator``) or the device's default generator.
    Otherwise ``leaky_relu`` with their mean."""
    if training:
        def f(v):
            a = lower + (upper - lower) * torch.rand(
                v.shape, generator=key, device=v.device, dtype=v.dtype)
            return torch.where(v >= 0, v, a * v)
        return apply(f, x, op_name="rrelu")
    return leaky_relu(x, (lower + upper) / 2.0)
