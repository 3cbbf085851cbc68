"""paddle_tpu_torch.nn.utils: counterpart of ``paddle_tpu/nn/utils``.

``weight_norm`` / ``remove_weight_norm`` reparameterise a layer's weight
as ``g * v / ||v||`` (the parameters ``<name>_g`` and ``<name>_v``, the
weight recomputed by a forward pre-hook, differentiable through both).
``spectral_norm`` divides the weight (kept as ``<name>_orig``) by its
largest singular value, estimated by power iteration carried in the
buffers ``<name>_u`` / ``<name>_v``; their start is drawn from
``np.random.RandomState(0)``, as in the JAX package, and the estimate is
a constant to the gradient, as there. ``parameters_to_vector``,
``vector_to_parameters``, ``clip_grad_norm_`` and ``clip_grad_value_``
act on the parameters' values and grads in place.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import Parameter, Tensor
from ...ops.dispatch import apply

__all__ = [
    "weight_norm", "remove_weight_norm", "spectral_norm",
    "parameters_to_vector", "vector_to_parameters", "clip_grad_norm_",
    "clip_grad_value_",
]


def _norm_except(w, dim):
    if dim is None:
        return torch.sqrt(torch.sum(torch.square(w)))
    axes = tuple(i for i in range(w.dim()) if i != dim)
    return torch.sqrt(torch.sum(torch.square(w), dim=axes, keepdim=True))


def _plain(t):
    return t.detach().as_subclass(torch.Tensor)


def _swap_parameter(layer, old, new_params):
    """Drop parameter ``old`` of ``layer`` and register ``new_params``
    (name -> Parameter) after the others."""
    layer._parameters.pop(old, None)
    for name, p in new_params.items():
        layer.add_parameter(name, p)


def weight_norm(layer, name="weight", dim=0):
    """Reparameterise ``layer.<name>`` as ``g * v / ||v||`` (the norm over
    every axis but ``dim``; all of them when ``dim`` is None)."""
    w = _plain(getattr(layer, name))
    gp = Parameter(_norm_except(w, dim).clone())
    vp = Parameter(w.clone())
    _swap_parameter(layer, name, {name + "_g": gp, name + "_v": vp})

    def _recompute(lyr, inputs):
        new_w = apply(lambda gv, vv: torch.div(
            torch.mul(gv, vv), torch.clamp_min(_norm_except(vv, dim), 1e-12)),
            gp, vp, op_name="weight_norm")
        object.__setattr__(lyr, name, new_w)
        return None

    handle = layer.register_forward_pre_hook(_recompute)
    layer._weight_norm_hook = (handle, name, dim)
    _recompute(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    handle, nm, dim = layer._weight_norm_hook
    handle.remove()
    g, v = _plain(getattr(layer, nm + "_g")), _plain(getattr(layer, nm + "_v"))
    w = Parameter(g * v / torch.clamp_min(_norm_except(v, dim), 1e-12))
    for extra in (nm + "_g", nm + "_v"):
        layer._parameters.pop(extra, None)
    layer.__dict__.pop(nm, None)          # the hook's computed weight
    layer.add_parameter(nm, w)
    del layer._weight_norm_hook
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Divide ``layer.<name>`` by its largest singular value (over the
    weight with ``dim``, default 0, first), estimated by
    ``n_power_iterations`` of power iteration a forward."""
    w = _plain(getattr(layer, name))
    if dim is None:
        dim = 0
    rows = w.shape[dim]
    cols = w.numel() // rows
    rng = np.random.RandomState(0)
    u0 = rng.randn(rows).astype(np.float32)
    v0 = rng.randn(cols).astype(np.float32)
    layer.register_buffer(name + "_u", Tensor(torch.from_numpy(
        u0 / np.linalg.norm(u0)).to(w.device)))
    layer.register_buffer(name + "_v", Tensor(torch.from_numpy(
        v0 / np.linalg.norm(v0)).to(w.device)))
    orig = Parameter(w.clone())
    _swap_parameter(layer, name, {name + "_orig": orig})

    def _recompute(lyr, inputs):
        ub, vb = getattr(lyr, name + "_u"), getattr(lyr, name + "_v")
        with torch.no_grad():
            u, v = _plain(ub), _plain(vb)
            wm = torch.movedim(_plain(orig), dim, 0).reshape(rows, -1)
            for _ in range(n_power_iterations):
                v = wm.t() @ u
                v = v / torch.clamp_min(torch.linalg.norm(v), eps)
                u = wm @ v
                u = u / torch.clamp_min(torch.linalg.norm(u), eps)
            torch.Tensor.copy_(ub, u)
            torch.Tensor.copy_(vb, v)
            sigma = u @ wm @ v
        new_w = apply(lambda ov: torch.div(ov, sigma), orig,
                      op_name="spectral_norm")
        object.__setattr__(lyr, name, new_w)
        return None

    handle = layer.register_forward_pre_hook(_recompute)
    layer._spectral_norm_hook = (handle, name)
    _recompute(layer, None)
    return layer


def parameters_to_vector(parameters, name=None):
    from ...ops.manip import concat, reshape
    return concat([reshape(p, [-1]) for p in parameters], axis=0)


def vector_to_parameters(vec, parameters, name=None):
    off = 0
    flat = _plain(vec)
    with torch.no_grad():
        for p in parameters:
            n = int(np.prod(p.shape)) or 1
            torch.Tensor.copy_(p, flat[off:off + n].reshape(p.shape)
                               .to(p.dtype))
            off += n


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every grad in place so their global ``norm_type`` norm is at
    most ``max_norm``; returns the norm before the clip."""
    params = [p for p in (parameters if isinstance(parameters, (list, tuple))
                          else [parameters]) if p.grad is not None]
    if not params:
        return Tensor(torch.zeros(()))
    grads = [_plain(p.grad) for p in params]
    if norm_type == float("inf"):
        total = torch.max(torch.stack([g.abs().max() for g in grads]))
    else:
        total = torch.sum(torch.stack([torch.sum(g.abs() ** norm_type)
                                       for g in grads])) ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("non-finite grad norm in clip_grad_norm_")
    scale = torch.clamp_max(max_norm / (total + 1e-6), 1.0)
    with torch.no_grad():
        for p, g in zip(params, grads):
            torch.Tensor.copy_(p.grad, g * scale)
    return Tensor(total)


def clip_grad_value_(parameters, clip_value):
    params = parameters if isinstance(parameters, (list, tuple)) \
        else [parameters]
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                torch.Tensor.clamp_(p.grad, -clip_value, clip_value)
