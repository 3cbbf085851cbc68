"""GradScaler with dynamic loss scaling.

Counterpart of ``paddle_tpu/amp/grad_scaler.py`` (:16-106): scale the loss,
unscale the grads at step time, skip the step and shrink the scale when a
grad holds inf or nan, grow it after N good steps. ``enable=False`` makes
every call a passthrough. The eager check (``_unscale_and_check``) takes
one pass over every grad for the finite flag (one multi-tensor kernel
launch on the card, U1) and reads the flag on the host once, as the
reference reads its per-grad flags; the grads are then unscaled in place.
``parallel.TrainStep`` runs the same scaling on the device with no host
read.
"""
from __future__ import annotations

import torch

from ..ops.kernels.multi_tensor import multi_tensor_sumsq_finite

__all__ = ["AmpScaler", "GradScaler"]


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._cache_founds = {}

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def _unscale_and_check(self, optimizer) -> bool:
        """Whether any grad of the optimizer's parameters holds inf or nan
        (judged on the scaled grads, as the reference judges them); every
        grad is then multiplied by ``1 / scale`` in place."""
        grads = [p.grad for p in optimizer._params if p.grad is not None]
        found = False
        if grads:
            found = not bool(multi_tensor_sumsq_finite(grads)[2])
            with torch.no_grad():
                torch._foreach_mul_(grads, 1.0 / self._scale)
        self._found_inf = found
        return found

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscale_and_check(optimizer):
            optimizer.step()

    def update(self):
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def unscale_(self, optimizer):
        if self._enable:
            self._unscale_and_check(optimizer)

    def get_loss_scaling(self) -> torch.Tensor:
        """The current scale as a 0-dim fp32 tensor (a host value: it lives
        on the CPU)."""
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self) -> dict:
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "use_dynamic_loss_scaling": self._dynamic}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)


class GradScaler(AmpScaler):
    pass
