"""Static-graph Executor: a recorded Program replayed with real tensors.

Counterpart of ``paddle_tpu/static/executor.py``. The JAX Executor replays
the Program under ``jax.jit`` and caches one executable per (program
version, feed shapes and dtypes, fetch list, scope) (:133-138). Here the
same key holds one replay function, run through
``jit.capture.lower_step``: its first call is the eager warm-up, and on
the card the whole run (forward, backward, clip, the optimizer's update)
is then one CUDA graph, replayed for every later run of that key. Feeds
are copied into the graph's inputs; the learning rate and the step count
are device tensors written before each run; a host sync in the warm-up
bails the entry out to eager, with its reason counted
(``jit.capture.capture_info``). On the CPU each run is eager.

- A ``BackwardRecord`` (``Optimizer.minimize``): the forward before it is
  replayed with autograd on, ``torch.autograd.grad`` takes the loss's
  grads, the optimizer's clip applies (a global-norm clip folds into the
  update as a scale), and ``_multi_update`` updates the parameters and
  moments in place (U2 for Adam/AdamW on the card).
- A ``GradientRecord`` (``append_backward`` / ``gradients``): the grads
  are published as ``<name>@GRAD`` fetches, with no update.
- A Scope maps each captured name to the captured tensor itself, so the
  scope and the eager tensors are one (the JAX Executor copies the new
  values back into the eager tensors after each run, :168-171).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.device import resolve_device
from ..core.tensor import Tensor, as_torch
from .framework import (BackwardRecord, CompiledProgram, GradientRecord,
                        Program, Variable, default_main_program)

__all__ = ["Scope", "global_scope", "scope_guard", "Executor"]


class Scope:
    """name -> tensor for persistable variables (parameters, buffers,
    constants), the optimizer states by name and the step count."""

    def __init__(self):
        self.vars: Dict[str, torch.Tensor] = {}
        self.opt_states: Dict[str, dict] = {}
        self.step: int = 0

    def find_var(self, name):
        return self.vars.get(name)

    def var_names(self):
        return list(self.vars)


_global_scope = Scope()
_scope_stack: List[Scope] = []


def global_scope() -> Scope:
    return _scope_stack[-1] if _scope_stack else _global_scope


class scope_guard:
    def __init__(self, scope: Scope):
        self.scope = scope

    def __enter__(self):
        _scope_stack.append(self.scope)
        return self.scope

    def __exit__(self, *a):
        _scope_stack.pop()
        return False


def _cast(args, dt):
    return [a.to(dt) if isinstance(a, torch.Tensor) and a.is_floating_point()
            and a.dtype != dt else a for a in args]


def _last_uses(ops: Sequence[Any], keep) -> List[List[str]]:
    """Per op, the variable names no later op reads (freed after it), of
    those not in ``keep``."""
    last: Dict[str, int] = {}
    for i, op in enumerate(ops):
        for m in op.args:
            if m[0] == "var":
                last[m[1]] = i
        for n in op.out_names:
            if n is not None:
                last.setdefault(n, i)
    out: List[List[str]] = [[] for _ in ops]
    for n, i in last.items():
        if n not in keep:
            out[i].append(n)
    return out


def _replay(ops: Sequence[Any], params: Dict[str, Any], feeds: Dict[str, Any],
            env: Optional[Dict[str, Any]] = None, free=None) -> Dict[str, Any]:
    """Run recorded Operators in order over real tensors; ``free`` (from
    ``_last_uses``) drops each intermediate after its last reader."""
    env = {} if env is None else env

    def resolve(m):
        kind, v = m
        if kind == "var":
            if v in env:
                return env[v]
            if v in feeds:
                return feeds[v]
            if v in params:
                return params[v]
            raise KeyError(f"static variable {v!r} has no value "
                           f"(missing from feed?)")
        if kind == "param":
            return params[v]
        return v

    for i, op in enumerate(ops):
        args, kwargs = pytree.tree_unflatten([resolve(m) for m in op.args],
                                             op.spec)
        if op.amp is not None:
            args = _cast(args, op.amp)
        out = op.fn(*args, **kwargs)
        for nm, r in zip(op.out_names, pytree.tree_leaves(out)
                         if op.multi else [out]):
            if nm is not None:
                env[nm] = r
        if free is not None:
            for n in free[i]:
                env.pop(n, None)
    return env


def _place_device(place) -> torch.device:
    """The device an Executor runs on: its place, else the default device
    (``cuda`` unless ``set_device`` chose another)."""
    if place is None:
        return resolve_device(None)
    from ..framework_compat import CPUPlace, CUDAPlace
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    if isinstance(place, CUDAPlace):
        return resolve_device(f"cuda:{place._id}")
    return resolve_device(place)


class _Entry:
    """One cache entry: the replay function, its dispatcher (the lowered
    step, made on the entry's first run) and its device scalars."""

    __slots__ = ("fn", "bw", "names", "step", "lr_t", "step_t")

    def __init__(self, fn, bw, names, device):
        self.fn = fn
        self.bw = bw
        self.names = names
        self.step = None
        self.lr_t = torch.zeros((), dtype=torch.float32, device=device)
        self.step_t = torch.zeros((), dtype=torch.int32, device=device)


class Executor:
    """``paddle.static.Executor(place)``: runs on ``place`` (``CPUPlace()``
    for the CPU), else on the default device."""

    def __init__(self, place=None):
        self.place = place
        self._device = _place_device(place)
        self._cache: Dict[tuple, _Entry] = {}

    # -- public API ---------------------------------------------------------
    def run(self, program: Optional[Program] = None, feed: Optional[dict] = None,
            fetch_list=None, scope: Optional[Scope] = None, return_numpy=True):
        if isinstance(program, CompiledProgram):
            program = program.program
        # loaded inference programs (static.io) carry their own runner
        if program is not None and hasattr(program, "_infer_run"):
            outs = program._infer_run(feed or {})
            return [_to_numpy(o) for o in outs] if return_numpy \
                else [Tensor(o) for o in outs]

        program = program or default_main_program()
        feed = feed or {}
        fetch_list = fetch_list or []
        scope = scope or global_scope()
        self._seed_scope(program, scope)
        if not program.ops and not fetch_list:
            return []                   # startup program: the scope is seeded

        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list if isinstance(fetch_list,
                                                          (list, tuple))
                                 else [fetch_list])]
        feeds = {k: as_torch(v, device=self._device) for k, v in feed.items()}
        feed_key = tuple(sorted((k, tuple(a.shape), str(a.dtype))
                                for k, a in feeds.items()))
        key = (id(program), program._version, feed_key, tuple(fetch_names),
               id(scope))
        entry = self._cache.get(key)
        if entry is None:
            entry = self._compile(program, scope, fetch_names,
                                  sorted(feeds))
            self._cache[key] = entry
        bw = entry.bw
        if isinstance(bw, BackwardRecord):
            scope.step += 1
            entry.lr_t.fill_(bw.optimizer.get_lr())
            entry.step_t.fill_(scope.step)
        params = [scope.vars[n] for n in entry.names[0]]
        states = [scope.opt_states[n] for n in entry.names[1]]
        args = (params, states, [feeds[k] for k in entry.names[2]],
                entry.lr_t, entry.step_t)
        if entry.step is None:
            from ..jit.capture import lower_step
            entry.step, _ = lower_step(entry.fn, args, inplace=(0, 1, 3, 4),
                                       name=f"static.Executor/{id(program)}")
            fetches = entry.step.first_result
        else:
            fetches = entry.step(*args)
        if isinstance(bw, BackwardRecord):
            from ..optimizer.lr import LRScheduler
            if isinstance(bw.optimizer._lr, LRScheduler):
                bw.optimizer._lr.step()
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return [Tensor(f.detach().clone()) for f in fetches]

    def close(self):
        self._cache.clear()

    def cache_info(self) -> dict:
        """Per entry: ``graphs`` (1 when its run is one CUDA graph) and the
        lowered step's counters and bailout reason."""
        out = []
        for e in self._cache.values():
            st = e.step
            out.append({} if st is None else {
                "graphs": st.graphs(), "reason": st.bailout_reason(),
                **st.cache_info()})
        return {"entries": len(self._cache), "steps": out}

    # -- internals ----------------------------------------------------------
    def _seed_scope(self, program: Program, scope: Scope) -> None:
        for name, t in program.captured.items():
            scope.vars.setdefault(name, t)
        for op in program.ops:
            if isinstance(op, BackwardRecord):
                for n in op.param_names:
                    if n not in scope.opt_states:
                        scope.opt_states[n] = dict(
                            op.optimizer._init_state(program.captured[n]))

    def _compile(self, program: Program, scope: Scope, fetch_names,
                 feed_names) -> _Entry:
        ops = list(program.ops)
        bw_idx = next((i for i, o in enumerate(ops)
                       if isinstance(o, (BackwardRecord, GradientRecord))),
                      None)
        if bw_idx is not None and any(
                isinstance(o, (BackwardRecord, GradientRecord))
                for o in ops[bw_idx + 1:]):
            raise NotImplementedError("one backward record per Program")
        bw = ops[bw_idx] if bw_idx is not None else None
        param_names = list(program.captured)
        fwd_ops = ops if bw is None else ops[:bw_idx]
        tail_ops = [] if bw is None else ops[bw_idx + 1:]
        keep = set(fetch_names) | {m[1] for o in tail_ops for m in o.args
                                   if m[0] == "var"}
        if bw is not None:
            keep.add(bw.loss_name)
        free = _last_uses(fwd_ops, keep)
        state_names = list(bw.param_names) \
            if isinstance(bw, BackwardRecord) else []

        def fetch_from(env, pvals):
            out = []
            for n in fetch_names:
                if n in env:
                    v = env[n]
                elif n in pvals:
                    v = pvals[n]
                else:
                    raise KeyError(f"fetch target {n!r} not produced by "
                                   f"program")
                out.append(v.detach() if isinstance(v, torch.Tensor) else v)
            return tuple(out)

        if bw is None:
            def fn(params, states, feeds, lr_t, step_t):
                pvals = dict(zip(param_names, params))
                fvals = dict(zip(feed_names, feeds))
                with torch.no_grad():
                    env = _replay(ops, pvals, fvals, free=free)
                return fetch_from(env, pvals)
        elif isinstance(bw, GradientRecord):
            wrt = list(bw.wrt_names)

            def fn(params, states, feeds, lr_t, step_t):
                pvals = dict(zip(param_names, params))
                fvals = dict(zip(feed_names, feeds))
                with torch.enable_grad():
                    for n in wrt:
                        d = pvals if n in pvals else fvals
                        d[n] = d[n].detach().requires_grad_(True)
                    env = _replay(fwd_ops, pvals, fvals, free=free)
                    xs = [pvals[n] if n in pvals else fvals[n] for n in wrt]
                    gs = torch.autograd.grad(env[bw.loss_name], xs,
                                             allow_unused=True)
                for n, x, g in zip(wrt, xs, gs):
                    env[n + "@GRAD"] = torch.zeros_like(x) if g is None \
                        else g
                if tail_ops:
                    with torch.no_grad():
                        env = _replay(tail_ops, pvals, fvals, env=env)
                return fetch_from(env, pvals)
        else:
            opt = bw.optimizer

            def fn(params, states, feeds, lr_t, step_t):
                pvals = dict(zip(param_names, params))
                fvals = dict(zip(feed_names, feeds))
                train = [pvals[n] for n in bw.param_names]
                with torch.enable_grad():
                    env = _replay(fwd_ops, pvals, fvals, free=free)
                    gs = torch.autograd.grad(env[bw.loss_name], train,
                                             allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(train, gs)]
                params_u, grads_u, scale = _clip(opt, train, grads)
                idx = {id(p): i for i, p in enumerate(train)}
                opt._multi_update(params_u, grads_u,
                                  [states[idx[id(p)]] for p in params_u],
                                  lr_t, step_t, clip_scale=scale)
                if tail_ops:
                    with torch.no_grad():
                        env = _replay(tail_ops, pvals, fvals, env=env)
                return fetch_from(env, pvals)

        return _Entry(fn, bw, (param_names, state_names, feed_names),
                      self._device)


def _clip(opt, params, grads):
    """The optimizer's clip, as ``Optimizer._gather`` applies it: a
    global-norm clip as a scale folded into the update, any other clip on
    the (param, grad) pairs."""
    from ..nn.clip import ClipGradByGlobalNorm
    clip = opt._grad_clip
    if isinstance(clip, ClipGradByGlobalNorm):
        return params, grads, clip.scale(grads)
    if clip is not None:
        pairs = [(p, g) for p, g in clip(list(zip(params, grads)))
                 if g is not None]
        return [p for p, _ in pairs], [g for _, g in pairs], None
    return params, grads, None


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().as_subclass(torch.Tensor)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    return np.asarray(v)
