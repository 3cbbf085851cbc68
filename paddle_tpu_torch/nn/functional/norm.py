"""Normalizations: counterpart of ``paddle_tpu/nn/functional/norm.py``.

``batch_norm`` in training normalises with the batch's mean and biased
variance and then, outside the graph, moves the running statistics as
Paddle does: ``running = momentum * running + (1 - momentum) * batch``
(Paddle's ``momentum=0.9`` keeps 0.9 of the old value, where torch's
``momentum`` is the share of the new one), the batch variance biased as
the JAX function's ``jnp.var``. ``rms_norm`` is the LLaMA norm: fp32
mean square, ``x * rsqrt(ms + eps)`` cast back to the input dtype, then
times the weight.
"""
from __future__ import annotations

import torch

from ...core.tensor import as_port, plain_views
from ...ops.dispatch import apply

__all__ = ["normalize", "batch_norm", "layer_norm", "instance_norm",
           "group_norm", "local_response_norm", "rms_norm"]


def _affine(out, wb, shape=None):
    if wb:
        out = out * (wb[0] if shape is None else wb[0].reshape(shape))
        if len(wb) > 1:
            out = out + (wb[1] if shape is None else wb[1].reshape(shape))
    return out


def _moments(v, dims, keepdim):
    var, mean = torch.var_mean(v, dim=dims, unbiased=False, keepdim=keepdim)
    return mean, var


def normalize(x, p=2, axis=1, epsilon=1e-12):
    def f(v):
        n = torch.sum(v.abs() ** p, dim=axis, keepdim=True) ** (1.0 / p)
        return v / torch.clamp_min(n, epsilon)
    return apply(f, x, op_name="normalize")


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    use_global = (not training) if use_global_stats is None \
        else use_global_stats
    ch_axis = 1 if data_format.startswith("NC") else -1

    def stats_axes(v):
        return tuple(i for i in range(v.dim()) if i != (ch_axis % v.dim()))

    def bshape(v):
        s = [1] * v.dim()
        s[ch_axis % v.dim()] = -1
        return s

    # the functions compute on plain torch views (the JAX function's raw
    # array math): their operators are not nested ops of the library
    if use_global:
        args = [x, running_mean, running_var]

        def f(*ts):
            v, m, var_, *wb = plain_views(ts)
            inv = torch.rsqrt(var_.to(v.dtype) + epsilon)
            out = (v - m.to(v.dtype).reshape(bshape(v))) * \
                inv.reshape(bshape(v))
            return as_port(_affine(out, wb, bshape(v)))
    else:
        args = [x]

        def f(*ts):
            v, *wb = plain_views(ts)
            m, var_ = _moments(v, stats_axes(v), False)
            out = (v - m.reshape(bshape(v))) * torch.rsqrt(
                var_ + epsilon).reshape(bshape(v))
            return as_port(_affine(out, wb, bshape(v)))

    if weight is not None:
        args.append(weight)
    if bias is not None:
        args.append(bias)
    out = apply(f, *args, op_name="batch_norm")

    if training and running_mean is not None:
        # outside the graph and the op library, as the JAX function moves
        # them with raw array math
        with torch.no_grad():
            v = x.detach().as_subclass(torch.Tensor)
            m, var_ = _moments(v, stats_axes(v), False)
            for run, batch in ((running_mean, m), (running_var, var_)):
                r = run.as_subclass(torch.Tensor)
                r.copy_(momentum * r + (1 - momentum) * batch.to(r.dtype))
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    nd = len(list(normalized_shape))

    def f(v, *wb):
        m, var_ = _moments(v, tuple(range(v.dim() - nd, v.dim())), True)
        return _affine((v - m) * torch.rsqrt(var_ + epsilon), wb)
    args = [x] + [t for t in (weight, bias) if t is not None]
    return apply(f, *args, op_name="layer_norm")


def rms_norm(x, weight=None, epsilon=1e-6, axis=-1):
    """fp32 mean square over ``axis`` (an int or a tuple), ``x * rsqrt(ms
    + eps)`` cast back to the input dtype, *then* times the weight."""
    if weight is not None:
        return apply(_rms_norm, x, weight, epsilon, axis, op_name="rms_norm")
    return apply(_rms_norm, x, None, epsilon, axis, op_name="rms_norm")


def _rms_norm(x, weight, epsilon, axis):
    xf = x.float()
    ms = xf.square().mean(dim=axis, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW"):
    ch_axis = 1 if data_format.startswith("NC") else -1

    def f(v, *wb):
        axes = tuple(range(2, v.dim())) if ch_axis == 1 \
            else tuple(range(1, v.dim() - 1))
        m, var_ = _moments(v, axes, True)
        s = [1] * v.dim()
        s[ch_axis % v.dim()] = -1
        return _affine((v - m) * torch.rsqrt(var_ + eps), wb, s)
    args = [x] + [t for t in (weight, bias) if t is not None]
    return apply(f, *args, op_name="instance_norm")


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    g = int(num_groups)

    def f(v, *wb):
        if data_format.startswith("NC"):
            n, c = v.shape[0], v.shape[1]
            rest = v.shape[2:]
            vv = v.reshape(n, g, c // g, *rest)
            m, var_ = _moments(vv, tuple(range(2, vv.dim())), True)
            out = ((vv - m) * torch.rsqrt(var_ + epsilon)).reshape(v.shape)
            return _affine(out, wb, [1, c] + [1] * len(rest))
        n, c = v.shape[0], v.shape[-1]
        rest = v.shape[1:-1]
        vv = v.reshape(n, *rest, g, c // g)
        axes = tuple(range(1, vv.dim() - 2)) + (vv.dim() - 1,)
        m, var_ = _moments(vv, axes, True)
        out = ((vv - m) * torch.rsqrt(var_ + epsilon)).reshape(v.shape)
        return _affine(out, wb, [1] * (v.dim() - 1) + [c])
    args = [x] + [t for t in (weight, bias) if t is not None]
    return apply(f, *args, op_name="group_norm")


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    def f(v):
        ch = 1 if data_format.startswith("NC") else v.dim() - 1
        sq = v.square()
        half = size // 2
        pads = [0, 0] * v.dim()
        # torch's pad lists the last dim first
        pads[2 * (v.dim() - 1 - ch)] = half
        pads[2 * (v.dim() - 1 - ch) + 1] = size - half - 1
        padded = torch.nn.functional.pad(sq, pads)
        acc = torch.zeros_like(v)
        for i in range(size):
            acc = acc + padded.narrow(ch, i, v.shape[ch])
        return v / torch.pow(k + alpha * acc / size, beta)
    return apply(f, x, op_name="local_response_norm")
