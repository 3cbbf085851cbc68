"""Optimizer base.

Counterpart of ``paddle_tpu/optimizer/optimizer.py`` (:20-195). Each
optimizer defines a per-tensor update rule ``_update_rule(val, grad,
state, lr, wd) -> (new_val, new_state)`` over plain tensors, with the step
count in ``state["__step__"]`` (counted from 1). The JAX package gathers
every parameter and runs the rule over all of them in one jitted update
with donated buffers (``_build_jit``, :81-97); the port's counterpart is
``_multi_update``: one update over every parameter that has a grad, in
place, the moments keeping their identity. The base class applies
``_update_rule`` tensor by tensor; ``Adam`` and ``AdamW`` override it with
one multi-tensor kernel launch on the card (U2, ``ops/kernels/
multi_tensor.py``). ``step()``, ``amp.GradScaler``,
``parallel.TrainStep`` and ``models.build_hybrid_train_step`` all update
through it. ``functional_update()`` keeps the reference's pure form.

``learning_rate`` is a float or an ``optimizer.lr.LRScheduler``, read by
``get_lr()`` at every step. ``_multi_update`` takes the step's learning
rate and count as numbers or as 0-dim device tensors and hands the rules
0-dim tensors on the parameters' device (fp32 and int32), so that a
captured train step, which writes those tensors before each replay, never
bakes one step's values in. ``parameters`` is a list of tensors or of
parameter groups (dicts with ``"params"``), which are flattened as the
reference flattens them (:28-31).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..nn.clip import ClipGradByGlobalNorm
from ..ops.kernels.multi_tensor import device_scalar
from .lr import LRScheduler

__all__ = ["Optimizer", "step_scalars"]


def step_scalars(lr, step, device):
    """The step's learning rate (fp32) and count (int32) as 0-dim tensors
    on ``device``: tensors are moved, numbers written by a fill there."""
    return (device_scalar(lr, torch.float32, device),
            device_scalar(step, torch.int32, device))


def _tree_map(fn, *trees):
    """fn over the tensor leaves of nested dicts, lists and tuples."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided (dygraph-style)")
        self._lr = learning_rate
        parameters = list(parameters)
        self._param_groups = None
        if parameters and isinstance(parameters[0], dict):
            self._param_groups = parameters
            parameters = [p for g in parameters for p in g["params"]]
        self._params: List[torch.Tensor] = [
            p for p in parameters if isinstance(p, torch.Tensor)]
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._states: Dict[int, dict] = {}
        self._global_step = 0

    # ---- lr ----
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value) -> None:
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    @property
    def _learning_rate(self):
        return self._lr

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

    def _multi_update(self, params, grads, states, lr, step, *,
                      grad_scale=None, clip_scale=None, finite=None) -> None:
        """One update of every parameter in ``params`` with its grad and
        state dict, in place (the moments keep their identity). Each grad
        is cast to its parameter's dtype, then multiplied by the 0-dim
        device tensors ``grad_scale`` (an inverse loss scale) and
        ``clip_scale`` when given, each rounded to that dtype; with a 0-dim
        ``finite`` flag of 0 nothing changes. This base form applies
        ``_update_rule`` tensor by tensor."""
        wd = self._wd()
        keep = None if finite is None else finite.bool()
        if params:
            lr, step = step_scalars(lr, step, params[0].device)
        with torch.no_grad():
            for p, g, st in zip(params, grads, states):
                g = g.to(p.dtype)
                if grad_scale is not None:
                    g = g * grad_scale.to(g.dtype)
                if clip_scale is not None:
                    g = g * clip_scale.to(g.dtype)
                s = dict(st)
                s["__step__"] = step
                new, ns = self._update_rule(p.detach(), g, s, lr, wd)
                ns.pop("__step__", None)
                if keep is not None:
                    new = torch.where(keep, new, p)
                    ns = {k: torch.where(keep, v, st[k]) if k in st else v
                          for k, v in ns.items()}
                p.copy_(new)
                for k, v in ns.items():
                    if k in st and isinstance(st[k], torch.Tensor):
                        st[k].copy_(v)
                    else:
                        st[k] = v

    # ---- step ----
    def _gather(self):
        """(params, grads) of every trainable parameter with a grad, after
        a clip other than the global-norm one, and that clip's scale (a
        0-dim tensor, or None): ``_multi_update`` folds it in."""
        pgs = [(p, p.grad) for p in self._params
               if p.requires_grad and p.grad is not None]
        clip, scale = self._grad_clip, None
        if isinstance(clip, ClipGradByGlobalNorm):
            scale = clip.scale([g for _, g in pgs]) if pgs else None
        elif clip is not None:
            clipped = {id(p): g for p, g in clip(pgs)}
            pgs = [(p, clipped.get(id(p), g)) for p, g in pgs]
        pgs = [(p, g) for p, g in pgs if g is not None]
        return [p for p, _ in pgs], [g for _, g in pgs], scale

    def _state_of(self, p: torch.Tensor) -> dict:
        st = self._states.get(id(p))
        if st is None:
            st = self._states[id(p)] = self._init_state(p)
        return st

    @property
    def accumulators_built(self) -> bool:
        return bool(self._states)

    def step(self) -> None:
        """Update every parameter that has a grad (after ``loss.backward()``)
        in one ``_multi_update``."""
        params, grads, clip_scale = self._gather()
        if not params:
            return
        self._global_step += 1
        self._multi_update(params, grads, [self._state_of(p) for p in params],
                           self.get_lr(), self._global_step,
                           clip_scale=clip_scale)

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._params:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Under static mode, record backward and this optimizer's update
        into the current Program (``static.Executor`` runs them); else
        ``loss.backward()``, ``step()`` and ``clear_grad()``
        (optimizer.py:129-140)."""
        from ..static import framework as sfw
        if sfw.in_static_mode() and isinstance(loss, sfw.Variable):
            sfw.append_backward_and_update(loss, self)
            return
        loss.backward()
        self.step()
        self.clear_grad()

    # ---- state dict ----
    def state_dict(self) -> dict:
        sd = {"global_step": self._global_step}
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        for i, p in enumerate(pp for pp in self._params if pp.requires_grad):
            for k, v in (self._states.get(id(p)) or {}).items():
                sd[f"{i}_{k}"] = v
        return sd

    def set_state_dict(self, state_dict: dict) -> None:
        self._global_step = int(state_dict.get("global_step", 0))
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state_dict:
            self._lr.set_state_dict(state_dict["LR_Scheduler"])
        trainables = [p for p in self._params if p.requires_grad]
        for i, p in enumerate(trainables):
            prefix = f"{i}_"
            st = {k[len(prefix):]: torch.as_tensor(v, device=p.device)
                  for k, v in state_dict.items()
                  if isinstance(k, str) and k.startswith(prefix)}
            if st:
                self._states[id(p)] = st

    # ---- functional access ----
    def functional_update(self):
        """``(init_fn, update_fn)`` over this optimizer's rule, out of place
        (optimizer.py:168-195): ``init_fn(param_tree)`` gives a tree of
        state dicts, ``update_fn(param_tree, grad_tree, state_tree, lr,
        step)`` the new params and states. Trees are nested dicts, lists
        and tuples of tensors."""
        rule, init, wd = self._update_rule, self._init_state, self._wd()

        def init_fn(param_tree):
            return _tree_map(init, param_tree)

        def update_fn(param_tree, grad_tree, state_tree, lr, step):
            def upd(v, g, s):
                s = dict(s)
                s["__step__"] = step
                nv, ns = rule(v, g.to(v.dtype), s, lr, wd)
                ns.pop("__step__", None)
                return nv, ns
            with torch.no_grad():
                outs = [upd(v, g, s) for v, g, s in zip(
                    _leaves(param_tree), _leaves(grad_tree),
                    _state_leaves(param_tree, state_tree))]
            it_v, it_s = iter([o[0] for o in outs]), iter([o[1] for o in outs])
            return (_tree_map(lambda _: next(it_v), param_tree),
                    _tree_map(lambda _: next(it_s), param_tree))
        return init_fn, update_fn


def _state_leaves(param_tree, state_tree) -> list:
    """The state dicts of state_tree at param_tree's leaves (the
    reference's ``flatten_up_to``)."""
    if isinstance(param_tree, dict):
        return [s for k in param_tree
                for s in _state_leaves(param_tree[k], state_tree[k])]
    if isinstance(param_tree, (list, tuple)):
        return [s for p, st in zip(param_tree, state_tree)
                for s in _state_leaves(p, st)]
    return [state_tree]
