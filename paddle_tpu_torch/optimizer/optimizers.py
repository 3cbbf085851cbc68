"""Adam and AdamW.

Counterpart of ``paddle_tpu/optimizer/optimizers.py`` (:47-90), with its
exact rule (:63-76), not ``torch.optim.AdamW``'s, which orders the decay
differently: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``mhat = m / (1 - b1^t)``, ``vhat = v / (1 - b2^t)``, ``upd = mhat /
(sqrt(vhat) + eps)``, plus ``wd * val`` for AdamW (Adam adds ``wd * val``
to the grad instead), and ``val - lr * upd``. The bias corrections are
taken in float32, as the JAX rule takes them.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


def _as_dtype(x: np.float32, dtype: torch.dtype) -> float:
    """The float32 scalar x rounded to dtype, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, p: torch.Tensor) -> dict:
        return {"moment1": torch.zeros_like(p, memory_format=torch
                                            .contiguous_format),
                "moment2": torch.zeros_like(p, memory_format=torch
                                            .contiguous_format)}

    def _decoupled(self) -> bool:
        return False

    def _update_rule(self, val, grad, state, lr, wd):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        t = np.float32(state["__step__"])
        if wd and not self._decoupled():
            grad = grad + wd * val
        m = b1 * state["moment1"] + (1 - b1) * grad
        v = b2 * state["moment2"] + (1 - b2) * torch.square(grad)
        # Host scalars: a tensor copied to the card would sync the stream.
        bc1 = _as_dtype(1 - np.float32(b1) ** t, val.dtype)
        bc2 = _as_dtype(1 - np.float32(b2) ** t, val.dtype)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if wd and self._decoupled():
            upd = upd + wd * val
        return val - lr * upd, {"moment1": m, "moment2": v}


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, name=name,
                         multi_precision=multi_precision)

    def _decoupled(self) -> bool:
        return True
