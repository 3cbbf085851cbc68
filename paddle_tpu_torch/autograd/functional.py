"""Functional autograd: ``jvp``, ``vjp``, ``jacobian``, ``hessian``,
``vhp`` and the lazily built ``Jacobian``/``Hessian`` matrices.

Counterpart of ``paddle_tpu/autograd/functional.py`` (which lifts the
function to jax transforms) over ``torch.autograd.functional``, with the
JAX functions' defaults and result structure: a tangent or cotangent left
out is all ones; a single input gives a single result, a list or tuple of
inputs a tuple.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.autograd.functional as AF

__all__ = ["jvp", "vjp", "jacobian", "hessian", "Jacobian", "Hessian",
           "vhp"]


def _as_tuple(xs):
    return tuple(xs) if isinstance(xs, (list, tuple)) else (xs,)


def _wrap(v):
    from ..core.tensor import _wrap as w
    return w(v)


def _ones(xs):
    return tuple(torch.ones_like(x) for x in _as_tuple(xs))


def _inputs(xs):
    t = tuple(x.detach() for x in _as_tuple(xs))
    return t if isinstance(xs, (list, tuple)) else t[0]


def _tangents(xs, v):
    vv = _ones(xs) if v is None else _as_tuple(v)
    return tuple(vv) if isinstance(xs, (list, tuple)) else vv[0]


def jvp(func: Callable, xs, v=None):
    """``(func(xs), J v)``, v defaulting to ones."""
    out, t = AF.jvp(func, _inputs(xs), _tangents(xs, v))
    return _wrap(out), _wrap(t)


def vjp(func: Callable, xs, v=None):
    """``(func(xs), vᵀ J)``, v defaulting to ones over the outputs."""
    ins = _inputs(xs)
    out = func(*_as_tuple(ins))
    if v is None:
        cot = tuple(torch.ones_like(o) for o in out) \
            if isinstance(out, (tuple, list)) else torch.ones_like(out)
    else:
        cot = tuple(_as_tuple(v)) if isinstance(out, (tuple, list)) \
            else _as_tuple(v)[0]
    out, g = AF.vjp(func, ins, cot)
    return _wrap(out), _wrap(g)


def jacobian(func: Callable, xs, create_graph: bool = False):
    """Dense Jacobian: ``out_shape + in_shape`` for one input and one
    output; a tuple over inputs and/or outputs otherwise."""
    return _wrap(AF.jacobian(func, _inputs(xs), create_graph=create_graph))


def _scalar(func):
    def f(*a):
        out = func(*a)
        out = out[0] if isinstance(out, (tuple, list)) else out
        return out.reshape(())
    return f


def hessian(func: Callable, xs, create_graph: bool = False):
    """Dense Hessian of a scalar-output ``func``."""
    return _wrap(AF.hessian(_scalar(func), _inputs(xs),
                            create_graph=create_graph))


def vhp(func: Callable, xs, v=None):
    """``(func(xs), vᵀ H)`` of a scalar-output ``func``."""
    out, h = AF.vhp(_scalar(func), _inputs(xs), _tangents(xs, v))
    return _wrap(out), _wrap(h)


class Jacobian:
    """The Jacobian flattened to ``[out_numel, in_numel]`` over all
    outputs and inputs, built on first access."""

    def __init__(self, func: Callable, xs, is_batched: bool = False):
        self._func = func
        self._xs = xs
        self._is_batched = is_batched
        self._mat = None

    def _materialize(self):
        if self._mat is None:
            xs = _as_tuple(self._xs)
            jac = AF.jacobian(self._func, tuple(x.detach() for x in xs))
            per_out = jac if isinstance(jac[0], tuple) else (jac,)
            rows = []
            for per_arg in per_out:
                o_size = per_arg[0].numel() // xs[0].numel()
                rows.append(torch.cat([j.reshape(o_size, -1)
                                       for j in per_arg], dim=1))
            self._mat = _wrap(torch.cat(rows, dim=0))
        return self._mat

    @property
    def shape(self):
        return list(self._materialize().shape)

    def __getitem__(self, idx):
        return self._materialize()[idx]

    def numpy(self):
        return self._materialize().numpy()


class Hessian(Jacobian):
    """The Hessian of a scalar ``func`` flattened to 2-D over all inputs
    (the full block matrix for several)."""

    def _materialize(self):
        if self._mat is None:
            xs = _as_tuple(self._xs)
            blocks = AF.hessian(_scalar(self._func),
                                tuple(x.detach() for x in xs))
            rows = [torch.cat([blocks[i][j].reshape(xs[i].numel(),
                                                    xs[j].numel())
                               for j in range(len(xs))], dim=1)
                    for i in range(len(xs))]
            self._mat = _wrap(torch.cat(rows, dim=0))
        return self._mat
