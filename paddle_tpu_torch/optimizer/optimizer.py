"""Optimizer base.

Counterpart of ``paddle_tpu/optimizer/optimizer.py`` (:20-195). Each
optimizer defines a per-tensor update rule ``_update_rule(val, grad,
state, lr, wd) -> (new_val, new_state)`` over plain tensors, with the step
count in ``state["__step__"]`` (counted from 1); ``step()`` runs it over
every parameter that has a grad, after the grad clip, and writes the new
values into the parameters in place (the JAX package donates the buffers
to a jitted update instead). ``build_hybrid_train_step`` reuses the same
rule. The update is elementwise PyTorch, as XLA fuses it there: it is not
a Pallas kernel in the JAX package and not a CUDA kernel here.

The learning rate is a float (``get_lr``/``set_lr``); LR schedulers
(``optimizer/lr.py``) wait for a later slice and raise.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..core.errors import NotInThisSlice

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided (dygraph-style)")
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float)):
            raise NotInThisSlice("learning-rate schedulers (optimizer/lr.py)",
                                 f"learning_rate={learning_rate!r}")
        self._lr = float(learning_rate)
        self._params: List[torch.Tensor] = list(parameters)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._states: Dict[int, dict] = {}
        self._global_step = 0

    # ---- lr ----
    def get_lr(self) -> float:
        return self._lr

    def set_lr(self, value) -> None:
        self._lr = float(value)

    # ---- subclass interface ----
    def _init_state(self, p: torch.Tensor) -> dict:
        return {}

    def _update_rule(self, val, grad, state: dict, lr: float, wd: float):
        """Returns (new_val, new_state); ``state["__step__"]`` is the step
        count, from 1."""
        raise NotImplementedError

    def _wd(self) -> float:
        """The decay the rule applies: 0.0 for None or a callable
        (optimizer.py:90-91)."""
        wd = self._weight_decay
        return 0.0 if wd is None or callable(wd) else float(wd)

    def apply_update(self, p: torch.Tensor, grad: torch.Tensor, state: dict,
                     lr: float, step: int) -> dict:
        """One rule application to ``p`` in place; returns the new state."""
        s = dict(state)
        s["__step__"] = step
        with torch.no_grad():
            new, ns = self._update_rule(p.detach(), grad.to(p.dtype), s, lr,
                                        self._wd())
            p.copy_(new)
        ns.pop("__step__", None)
        return ns

    # ---- step ----
    def _gather(self):
        pgs = [(p, p.grad) for p in self._params if p.requires_grad]
        if self._grad_clip is not None:
            with_g = [(p, g) for p, g in pgs if g is not None]
            clipped = {id(p): g for p, g in self._grad_clip(with_g)}
            pgs = [(p, clipped.get(id(p), g)) for p, g in pgs]
        return [(p, g) for p, g in pgs if g is not None]

    def step(self) -> None:
        """Update every parameter that has a grad (after ``loss.backward()``)."""
        pgs = self._gather()
        if not pgs:
            return
        self._global_step += 1
        lr = self.get_lr()
        for p, g in pgs:
            st = self._states.get(id(p))
            if st is None:
                st = self._init_state(p)
            self._states[id(p)] = self.apply_update(p, g, st, lr,
                                                    self._global_step)

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._params:
            p.grad = None

    clear_gradients = clear_grad

    # ---- state dict ----
    def state_dict(self) -> dict:
        sd = {"global_step": self._global_step}
        for i, p in enumerate(pp for pp in self._params if pp.requires_grad):
            for k, v in (self._states.get(id(p)) or {}).items():
                sd[f"{i}_{k}"] = v
        return sd

    def set_state_dict(self, state_dict: dict) -> None:
        self._global_step = int(state_dict.get("global_step", 0))
        trainables = [p for p in self._params if p.requires_grad]
        for i, p in enumerate(trainables):
            prefix = f"{i}_"
            st = {k[len(prefix):]: torch.as_tensor(v, device=p.device)
                  for k, v in state_dict.items()
                  if isinstance(k, str) and k.startswith(prefix)}
            if st:
                self._states[id(p)] = st
