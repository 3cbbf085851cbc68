"""to_static: a function or a Layer run as CUDA graphs on the card.

Counterpart of ``paddle_tpu/jit/api.py``. The JAX ``to_static`` traces the
Python function per input signature and compiles it with XLA (forward and
backward). Here the same function runs eagerly, where XLA's role is
played by ``jit.capture.GraphedCall``:

- on the CPU (and with ``enable_to_static(False)``) the function runs
  eagerly, with its tensor ``if``/``while`` converted (``dy2static``:
  a concrete predicate runs the branch as plain Python);
- on the card, per signature (the JAX key, api.py:107-111: the call's
  tree, its Python leaves, ``training``, the amp key, shapes and dtypes;
  plus devices, strides, ``requires_grad`` and the parameters'
  addresses), a call that needs grads becomes a forward and a backward
  CUDA graph joined to autograd, a call that needs none one graph; a host
  sync in the warm-up (a tensor ``if``) bails the signature out to eager
  with its reason counted. Dropout draws from torch's default CUDA
  generator, which a graph replay advances, so each replay draws a new
  mask;
- under ``torch.export`` (``jit.save`` of a to_static Layer) it runs the
  converted function, whose tensor ``if`` becomes ``torch.cond``.
"""
from __future__ import annotations

import itertools
import sys
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from ..nn.layer.layers import Layer

__all__ = ["to_static", "StaticFunction", "not_to_static", "ignore_module",
           "InputSpec", "enable_to_static", "set_verbosity",
           "set_code_level"]


class InputSpec:
    """``paddle.static.InputSpec``: a shape (None / -1 for a dynamic
    dim), a dtype and a name."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


_SF_SEQ = itertools.count()


def _tracing(leaves) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return any(isinstance(x, torch.Tensor) and is_fake(x) for x in leaves)


class StaticFunction:
    """Wraps a function or ``Layer.forward``; one ``GraphedCall`` holds its
    graphs per call signature (module docstring)."""

    def __init__(self, function: Callable, layer: Optional[Layer] = None,
                 input_spec=None, build_strategy=None, full_graph=True):
        self._fn = function
        self._layer = layer
        self._input_spec = input_spec
        self.__name__ = getattr(function, "__name__", "static_fn")
        self._lint_name = f"to_static/{self.__name__}#{next(_SF_SEQ)}"
        self._graphs = {}          # id(layer) -> GraphedCall

    @property
    def concrete_programs(self):
        """The tier of each layer this function ran on (signatures,
        graphs and counters in ``cache_info()``)."""
        return list(self._graphs.values())

    def cache_info(self) -> dict:
        out = {}
        for g in self._graphs.values():
            for k, v in g.cache_info().items():
                out[k] = out.get(k, 0) + v
        out["graphs"] = sum(g.graphs() for g in self._graphs.values())
        out["bailout_reason"] = next(
            (g.bailout_reason() for g in self._graphs.values()
             if g.bailout_reason()), "")
        return out

    def __call__(self, *args, **kwargs):
        return self._call_impl(None, *args, **kwargs)

    def _tier(self, layer):
        key = id(layer)
        g = self._graphs.get(key)
        if g is None:
            from .capture import GraphedCall
            fn = self._fn
            call = (lambda *a, **k: fn(layer, *a, **k)) if layer is not None \
                else fn
            g = self._graphs[key] = GraphedCall(call, module=layer,
                                                name=self._lint_name)
        return g

    def _call_impl(self, bound_self, *args, **kwargs):
        layer = self._layer if self._layer is not None else (
            bound_self if isinstance(bound_self, Layer) else None)
        owner = layer if layer is not None else bound_self

        def eager():
            if owner is not None:
                return self._fn(owner, *args, **kwargs)
            return self._fn(*args, **kwargs)

        if not _to_static_enabled:
            return eager()
        leaves = pytree.tree_leaves((args, kwargs))
        if _tracing(leaves):
            return eager()
        if owner is not None and layer is None:
            return eager()           # a method of a non-Layer object
        from ..amp.auto_cast import amp_cache_key
        training = layer.training if layer is not None else True
        statics = tuple(repr(x) for x in leaves
                        if not isinstance(x, torch.Tensor))
        g = self._tier(layer)
        before = g.counts["lowerings"] + g.counts["bailouts"]
        out = g(*args, extra=(training, amp_cache_key(), statics), **kwargs)
        if _verbosity > 0 and g.counts["lowerings"] + g.counts[
                "bailouts"] != before:
            print(f"[to_static] {self.__name__}: new signature "
                  f"{[tuple(x.shape) for x in leaves if isinstance(x, torch.Tensor)]}"
                  f" ({g.bailout_reason() or 'captured'})", file=sys.stderr)
        return out


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=True, **kwargs):
    """Decorator/wrapper: a Layer (its ``forward``) or a function."""

    def decorate(obj):
        from .dy2static import convert_control_flow
        if isinstance(obj, Layer):
            fwd = type(obj).forward
            if not getattr(fwd, "_not_to_static", False):
                fwd = convert_control_flow(fwd)
            sf = StaticFunction(fwd, layer=obj, input_spec=input_spec)
            obj.forward = lambda *a, **k: sf._call_impl(None, *a, **k)
            obj._static_function = sf
            return obj
        fn = obj if getattr(obj, "_not_to_static", False) \
            else convert_control_flow(obj)
        sf = StaticFunction(fn, input_spec=input_spec)

        def wrapper(*a, **k):
            # also callable as a method stored on a class
            if a and isinstance(a[0], Layer):
                return sf._call_impl(a[0], *a[1:], **k)
            return sf._call_impl(None, *a, **k)
        wrapper.__name__ = getattr(obj, "__name__", "static_fn")
        wrapper._static_function = sf
        return wrapper

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    return None


_to_static_enabled = True


def enable_to_static(enable: bool):
    """Turn to_static on or off everywhere: off, a StaticFunction runs the
    original eager function."""
    global _to_static_enabled
    _to_static_enabled = bool(enable)


_verbosity = 0
_code_level = 0


def set_verbosity(level: int = 0, also_to_stdout: bool = False):
    """At > 0, each new call signature (and whether it was captured or
    bailed out) prints to stderr."""
    global _verbosity
    _verbosity = int(level)


def set_code_level(level: int = 100, also_to_stdout: bool = False):
    """Kept for the API: the port has no transformed code to dump (a
    signature's record is its tier's ``cache_info()``)."""
    global _code_level
    _code_level = int(level)
