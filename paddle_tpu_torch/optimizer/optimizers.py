"""The rule optimizers: SGD, Momentum, Adam, AdamW, Adamax, Adagrad,
Adadelta, RMSProp, Lamb and Lars.

Counterpart of ``paddle_tpu/optimizer/optimizers.py`` (:10-252), each rule
in the reference's op order and dtype rounding: a Python scalar enters an
op as the JAX rule's weakly typed scalar does (rounded to the tensor's
dtype). The learning rate and the step count are read as 0-dim tensors on the
parameter's device (``parallel.TrainStep`` passes them so; a number is written
into one): ``lr.astype(val.dtype)`` is the fp32 lr cast to the dtype, and
powers of the step count are float32 ``torch.pow`` on the device, so a step
captured in a CUDA graph reads each replay's values. Every division by such a
scalar divides by the 0-dim tensor, rounded once on every device. Adam's and
AdamW's rule (:63-76), not ``torch.optim.AdamW``'s, which orders the decay
differently: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, ``upd = (m
/ (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``, plus ``wd * val`` for AdamW
(Adam adds ``wd * val`` to the grad instead), and ``val - lr * upd``: one
multi-tensor kernel launch (U2) for every parameter on the card; the others are
plain per-tensor PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.multi_tensor import (adam_rule, adam_scalars,
                                        device_scalar, multi_tensor_adam,
                                        pow_from_step)
from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "Adadelta", "RMSProp", "Lamb", "Lars"]


def _lr(lr, val) -> torch.Tensor:
    """``lr.astype(val.dtype)``: the float32 lr rounded to val's dtype, a
    0-dim tensor on val's device."""
    return device_scalar(lr, torch.float32, val.device).to(val.dtype)


def _lr32(lr, val) -> torch.Tensor:
    return device_scalar(lr, torch.float32, val.device)


def _t(state, val) -> torch.Tensor:
    """The step count as a float32 0-dim tensor on val's device."""
    return device_scalar(state["__step__"], torch.int32,
                         val.device).to(torch.float32)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update_rule(self, val, grad, state, lr, wd):
        if wd:
            grad = grad + wd * val
        return val - _lr(lr, val) * grad, state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0,
                 use_multi_tensor=False, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p, memory_format=torch
                                             .contiguous_format)}

    def _update_rule(self, val, grad, state, lr, wd):
        if wd:
            grad = grad + wd * val
        mu = self._momentum
        v = mu * state["velocity"] + grad
        upd = grad + mu * v if self._nesterov else v
        return val - _lr(lr, val) * upd, {"velocity": v}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment1": torch.zeros_like(p, memory_format=torch
                                            .contiguous_format),
                "moment2": torch.zeros_like(p, memory_format=torch
                                            .contiguous_format)}

    def _decoupled(self) -> bool:
        return False

    def _update_rule(self, val, grad, state, lr, wd):
        sc = adam_scalars(val.dtype, lr, self._beta1, self._beta2, self._eps,
                          wd, state["__step__"], self._decoupled(),
                          device=val.device)
        new, m, v = adam_rule(val, grad, state["moment1"], state["moment2"],
                              sc)
        return new, {"moment1": m, "moment2": v}

    def _multi_update(self, params, grads, states, lr, step, *,
                      grad_scale=None, clip_scale=None, finite=None):
        """Every parameter in one multi-tensor kernel launch on the card
        (U2, once per dtype and 80 parameters), or its plain version on
        the CPU."""
        multi_tensor_adam(
            params, grads, [s["moment1"] for s in states],
            [s["moment2"] for s in states], lr=lr, beta1=self._beta1,
            beta2=self._beta2, epsilon=self._eps, weight_decay=self._wd(),
            decoupled=self._decoupled(), step=step, inv_scale=grad_scale,
            clip_scale=clip_scale, finite=finite)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, name=name,
                         multi_precision=multi_precision)
        # stored as the reference stores it (optimizers.py:86), unread there
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled(self) -> bool:
        return True


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": torch.zeros_like(p),
                "inf_norm": torch.zeros_like(p)}

    def _update_rule(self, val, grad, state, lr, wd):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        t = _t(state, val)
        if wd:
            grad = grad + wd * val
        m = b1 * state["moment"] + (1 - b1) * grad
        u = torch.maximum(b2 * state["inf_norm"], torch.abs(grad))
        step = (_lr32(lr, val) / (1 - pow_from_step(b1, t))).to(val.dtype)
        return val - step * m / (u + eps), {"moment": m, "inf_norm": u}


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(p, self._init_acc)}

    def _update_rule(self, val, grad, state, lr, wd):
        if wd:
            grad = grad + wd * val
        acc = state["moment"] + torch.square(grad)
        new = val - _lr(lr, val) * grad / (torch.sqrt(acc) + self._eps)
        return new, {"moment": acc}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def _init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p),
                "avg_squared_update": torch.zeros_like(p)}

    def _update_rule(self, val, grad, state, lr, wd):
        if wd:
            grad = grad + wd * val
        rho, eps = self._rho, self._eps
        asg = rho * state["avg_squared_grad"] + (1 - rho) * torch.square(grad)
        upd = grad * torch.sqrt(state["avg_squared_update"] + eps) \
            / torch.sqrt(asg + eps)
        asu = rho * state["avg_squared_update"] + (1 - rho) \
            * torch.square(upd)
        return val - _lr(lr, val) * upd, {"avg_squared_grad": asg,
                                          "avg_squared_update": asu}


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, p):
        s = {"mean_square": torch.zeros_like(p),
             "momentum_acc": torch.zeros_like(p)}
        if self._centered:
            s["mean_grad"] = torch.zeros_like(p)
        return s

    def _update_rule(self, val, grad, state, lr, wd):
        if wd:
            grad = grad + wd * val
        rho, eps = self._rho, self._eps
        ms = rho * state["mean_square"] + (1 - rho) * torch.square(grad)
        new_state = {"mean_square": ms}
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * grad
            denom = torch.sqrt(ms - torch.square(mg) + eps)
        else:
            mg = None
            denom = torch.sqrt(ms + eps)
        mom = self._momentum * state["momentum_acc"] \
            + _lr(lr, val) * grad / denom
        new_state["momentum_acc"] = mom
        if mg is not None:
            new_state["mean_grad"] = mg
        return val - mom, new_state


def _norm(x):
    return torch.sqrt(torch.sum(torch.square(x)))


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, always_adapt=False, name=None, **kw):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        excluded = bool(self._exclude_fn(p)) if self._exclude_fn else False
        return {"moment1": torch.zeros_like(p),
                "moment2": torch.zeros_like(p),
                "wd_scale": torch.tensor(0.0 if excluded else 1.0,
                                         dtype=torch.float32,
                                         device=p.device)}

    def _update_rule(self, val, grad, state, lr, wd):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        wd_scale = state.get("wd_scale")
        if wd_scale is None:
            wd_scale = torch.ones((), dtype=torch.float32, device=val.device)
        wd = wd * wd_scale
        t = _t(state, val)
        m = b1 * state["moment1"] + (1 - b1) * grad
        v = b2 * state["moment2"] + (1 - b2) * torch.square(grad)
        mhat = m / (1 - pow_from_step(b1, t)).to(val.dtype)
        vhat = v / (1 - pow_from_step(b2, t)).to(val.dtype)
        r = mhat / (torch.sqrt(vhat) + eps) + wd * val
        w_norm, r_norm = _norm(val), _norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return val - _lr(lr, val) * trust * r, \
            {"moment1": m, "moment2": v, "wd_scale": wd_scale}


class Lars(Optimizer):
    """LARS momentum (optimizers.py:192-252): the layer-local learning rate
    ``lr * lars_coeff * ||w|| / (||g|| + wd * ||w|| + eps)`` scales each
    tensor's momentum update."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=0.0, parameters=None,
                 grad_clip=None, exclude_from_weight_decay=None, name=None,
                 **kw):
        super().__init__(learning_rate, parameters, lars_weight_decay,
                         grad_clip, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._epsilon = epsilon
        self._exclude = tuple(exclude_from_weight_decay or ())

    def _init_state(self, p):
        name = getattr(p, "name", "") or ""
        excluded = any(tag in name for tag in self._exclude)
        return {"velocity": torch.zeros_like(p),
                "wd_scale": torch.tensor(0.0 if excluded else 1.0,
                                         dtype=torch.float32,
                                         device=p.device)}

    def _update_rule(self, val, grad, state, lr, wd):
        mu, coeff, eps = self._momentum, self._lars_coeff, self._epsilon
        wd = wd * state["wd_scale"]
        w_norm = _norm(val.float())
        g_norm = _norm(grad.float())
        denom = g_norm + wd * w_norm + eps
        lr32 = _lr32(lr, val)
        coeff32 = torch.full((), float(np.float32(coeff)),
                             dtype=torch.float32, device=val.device)
        local_lr = torch.where(denom > 0, (lr32 * coeff32) * w_norm / denom,
                               lr32.expand_as(denom))
        v = mu * state["velocity"] + local_lr.to(val.dtype) * (
            grad + wd.to(val.dtype) * val)
        return val - v, {"velocity": v, "wd_scale": state["wd_scale"]}
