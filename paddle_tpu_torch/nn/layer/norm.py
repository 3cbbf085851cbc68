"""Norm layers: counterpart of ``paddle_tpu/nn/layer/norm.py``.

``BatchNorm*`` keep their running statistics in the buffers ``_mean``
and ``_variance`` (the JAX state-dict keys) and move them as Paddle does
(``nn/functional/norm.py``). ``SyncBatchNorm`` normalises over this
process's batch: under the JAX package's SPMD step a batch norm already
sees the global batch, and each port rank is a process that sees its own,
so this is a deliberate difference (ROADMAP.md). ``SpectralNorm`` divides
a weight by its largest singular value, estimated by power iteration
carried in the ``weight_u`` / ``weight_v`` parameters (held as constants
in the gradient, as Paddle's op does). ``RMSNorm`` is the LLaMA norm.
Layers with parameters take a keyword-only ``device`` (default: the
card); ``RMSNorm`` also ``dtype``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...core.device import resolve_device
from ...ops.dispatch import apply
from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "RMSNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "GroupNorm",
           "LocalResponseNorm", "SpectralNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr, device=device)
            Constant(1.0)(self.weight)
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True, device=device)
        dev = resolve_device(device)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  dtype=self._dtype,
                                                  device=dev))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     dtype=self._dtype,
                                                     device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self.momentum, epsilon=self.epsilon,
                            data_format=self.data_format,
                            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """``BatchNorm`` over this process's batch (module docstring)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, None, name, device=device)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                self.normalized_shape, attr=weight_attr, device=device)
            Constant(1.0)(self.weight)
        self.bias = None if bias_attr is False else self.create_parameter(
            self.normalized_shape, attr=bias_attr, is_bias=True,
            device=device)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class RMSNorm(Layer):
    """The LLaMA norm (``F.rms_norm``); its weight is ones, or
    ``weight_attr``'s initializer."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.empty(
            [hidden_size], device=resolve_device(device), dtype=dtype))
        (getattr(weight_attr, "initializer", None) or Constant(1.0))(
            self.weight)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, *, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.data_format = data_format
        if weight_attr is False:
            self.weight, self.bias = None, None
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr, device=device)
            Constant(1.0)(self.weight)
            self.bias = self.create_parameter(
                [num_features], attr=bias_attr, is_bias=True, device=device)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon,
                               data_format=self.data_format)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, device=device)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None, *, device=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, device=device)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.data_format = data_format
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                [num_channels], attr=weight_attr, device=device)
            Constant(1.0)(self.weight)
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True, device=device)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon, self.data_format)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """``forward(weight)``: ``weight / sigma``, sigma the largest singular
    value of ``weight`` moved to ``[shape[dim], -1]``, by ``power_iters``
    rounds of power iteration from the kept ``u`` / ``v`` (started from
    ``numpy.random.RandomState(0)``, as the JAX layer), which each call
    updates."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", *, device=None):
        super().__init__()
        self._dim = int(dim)
        self._power_iters = int(power_iters)
        self._eps = float(eps)
        shape = [int(s) for s in weight_shape]
        h = shape[self._dim]
        w = int(np.prod([s for i, s in enumerate(shape) if i != self._dim]))
        rng = np.random.RandomState(0)
        self.weight_u = self.create_parameter([h], dtype=dtype, device=device)
        self.weight_v = self.create_parameter([w], dtype=dtype, device=device)
        with torch.no_grad():
            self.weight_u.copy_(torch.from_numpy(rng.randn(h).astype(dtype)))
            self.weight_v.copy_(torch.from_numpy(rng.randn(w).astype(dtype)))
        self.weight_u.stop_gradient = True
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        dim, iters, eps = self._dim, self._power_iters, self._eps

        def f(wv, u, v):
            mat = torch.movedim(wv, dim, 0).reshape(wv.shape[dim], -1)

            def norm(a):
                return a / torch.clamp_min(torch.linalg.norm(a), eps)
            for _ in range(iters):
                v = norm(mat.T @ u)
                u = norm(mat @ v)
            u, v = u.detach(), v.detach()
            return wv / (u @ mat @ v), u, v

        w_out, u_new, v_new = apply(f, weight, self.weight_u, self.weight_v,
                                    op_name="spectral_norm")
        with torch.no_grad():
            self.weight_u.copy_(u_new)
            self.weight_v.copy_(v_new)
        return w_out
