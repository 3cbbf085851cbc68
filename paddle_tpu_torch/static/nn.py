"""``paddle.static.nn``: layer functions for static programs.

Counterpart of ``paddle_tpu/static/nn.py``: thin wrappers that make their
parameters (real tensors on the program's device, with the JAX
initializers) and call the ``nn.functional`` op, which the recorder
appends to the Program.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.tensor import Parameter
from ..nn import functional as F
from ..nn import initializer as init
from .framework import _unique_name

__all__ = ["fc", "embedding", "conv2d", "batch_norm"]


def _make_param(shape, dtype, initializer, device):
    p = Parameter(torch.zeros(tuple(int(s) for s in shape),
                              dtype=dtypes.convert_dtype(dtype),
                              device=device), name=_unique_name("sp"))
    initializer(p)
    return p


def fc(x, size, num_flatten_dims=1, activation=None, name=None):
    in_dim = int(np.prod(x.shape[num_flatten_dims:]))
    w = _make_param([in_dim, size], x.dtype, init.XavierNormal(), x.device)
    b = _make_param([size], x.dtype, init.Constant(0.0), x.device)
    if len(x.shape) > num_flatten_dims + 1:
        x = x.reshape([*x.shape[:num_flatten_dims], in_dim])
    out = F.linear(x, w, b)
    if activation:
        out = getattr(F, activation)(out)
    return out


def embedding(input, size, padding_idx=None, name=None):
    w = _make_param(list(size), "float32", init.Normal(std=0.02),
                    input.device)
    return F.embedding(input, w, padding_idx=padding_idx)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, groups=1,
           activation=None, name=None):
    if isinstance(filter_size, int):
        filter_size = (filter_size, filter_size)
    cin = input.shape[1]
    w = _make_param([num_filters, cin // groups, *filter_size], input.dtype,
                    init.KaimingNormal(), input.device)
    b = _make_param([num_filters], input.dtype, init.Constant(0.0),
                    input.device)
    out = F.conv2d(input, w, b, stride=stride, padding=padding, groups=groups)
    if activation:
        out = getattr(F, activation)(out)
    return out


def batch_norm(input, is_test=False, momentum=0.9, epsilon=1e-5, name=None):
    c = input.shape[1]
    dev = input.device
    w = _make_param([c], input.dtype, init.Constant(1.0), dev)
    b = _make_param([c], input.dtype, init.Constant(0.0), dev)
    mean = _make_param([c], input.dtype, init.Constant(0.0), dev)
    var = _make_param([c], input.dtype, init.Constant(1.0), dev)
    mean.stop_gradient = True
    var.stop_gradient = True
    return F.batch_norm(input, mean, var, w, b, training=not is_test,
                        momentum=momentum, epsilon=epsilon)
