"""Tensor: the user-facing array type.

Counterpart of ``paddle_tpu/core/tensor.py``. The JAX class wraps a
``jax.Array`` and keeps its own grad tape; here ``Tensor`` is a
``torch.Tensor`` subclass, so every port function takes it unchanged and
torch's autograd engine is the tape. It carries the JAX class's public
attributes: ``stop_gradient`` (the inverse of ``requires_grad``; True by
default, False for ``Parameter``), ``place``, ``numpy``, ``item``,
``astype``, ``clear_grad``, ``detach``/``detach_``, ``register_hook``,
``retain_grads``, ``set_value``/``copy_`` and ``gradient``; ``.grad`` is a
port ``Tensor`` too. Ops on a ``Tensor`` give ``Tensor``s; where torch
defines a method, the method keeps torch's meaning (the port's modules
and torch's own Python code call them), and the op library's functions
carry Paddle's (ROADMAP.md "Deliberate differences").

``Parameter`` is also an ``nn.Parameter``: ``nn.Module`` registers it, and
the optimizers and kernels take it as they take any parameter.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from . import dtype as dtypes
from .device import resolve_device

__all__ = ["Tensor", "Parameter", "is_tensor", "as_torch"]

_NP_OK = (np.bool_, np.uint8, np.int8, np.int16, np.int32, np.int64,
          np.float16, np.float32, np.float64, np.complex64, np.complex128)


def as_torch(value, dtype=None, device=None) -> torch.Tensor:
    """``value`` (a tensor, numpy array, Python number or nested list) as a
    torch tensor of ``dtype`` on ``device``; a tensor keeps its device when
    none is named."""
    dt = dtypes.convert_dtype(dtype)
    if isinstance(value, torch.Tensor):
        t = value
    else:
        arr = np.asarray(value)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
            dt = dt or torch.bfloat16
        elif arr.dtype.type not in _NP_OK:
            arr = arr.astype(np.float64 if arr.dtype.kind == "f" else
                             np.int64)
        if not arr.flags.c_contiguous:
            arr = np.ascontiguousarray(arr)   # (>= 1-d: only for arrays)
        t = torch.from_numpy(arr)
    if device is not None or dt is not None:
        t = t.to(device=device, dtype=dt)
    return t


class Tensor(torch.Tensor):
    __array_priority__ = 100

    def __new__(cls, value=None, stop_gradient: bool = True,
                name: Optional[str] = None, *, place=None):
        if value is None:
            value = []
        dev = resolve_device(place) if (
            place is not None or not isinstance(value, torch.Tensor)) \
            else None
        t = as_torch(value, device=dev).detach()
        grad = not stop_gradient and (t.is_floating_point()
                                      or t.is_complex())
        out = torch.Tensor._make_subclass(cls, t, grad)
        if name is not None:
            out.__dict__["_pt_name"] = name
        return out

    def __init__(self, value=None, stop_gradient: bool = True,
                 name: Optional[str] = None, *, place=None):
        pass

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        # every result of an op on a port Tensor is a port Tensor (a
        # Parameter's results too), torch's grad getter included; an op
        # that touches a static Variable is the Variable's to record
        for t in types:
            if getattr(t, "_pt_symbolic", False):
                return NotImplemented
        with torch._C.DisableTorchFunctionSubclass():
            ret = func(*args, **(kwargs or {}))
        return _wrap(ret)

    # ---- Paddle attributes ----
    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, v: bool):
        if self.is_leaf:
            if self.is_floating_point() or self.is_complex() or v:
                self.requires_grad_(not v)
        elif v:
            self.detach_()

    @property
    def name(self):
        return self.__dict__.get("_pt_name")

    @name.setter
    def name(self, v):
        self.__dict__["_pt_name"] = v

    @property
    def persistable(self) -> bool:
        return self.__dict__.get("_pt_persistable", False)

    @persistable.setter
    def persistable(self, v: bool):
        self.__dict__["_pt_persistable"] = bool(v)

    @property
    def place(self) -> str:
        return str(self.device)

    @property
    def value(self):
        return self

    @property
    def size(self):
        """Paddle's ``x.size`` is the element count; torch's ``x.size()``
        and ``x.size(dim)`` still work (the count is callable)."""
        return _Numel(self)

    @property
    def grad(self):
        g = torch._C.TensorBase.grad.__get__(self)
        return g if g is None or isinstance(g, Tensor) \
            else g.as_subclass(Tensor)

    @grad.setter
    def grad(self, g):
        torch._C.TensorBase.grad.__set__(self, g)

    @grad.deleter
    def grad(self):
        torch._C.TensorBase.grad.__set__(self, None)

    def numpy(self) -> np.ndarray:
        """A host copy as numpy (bfloat16 comes back as float32: numpy has
        no bfloat16 without ``ml_dtypes``). A host sync on the card, which
        the capture tier's sync guard refuses inside a captured step."""
        t = torch.Tensor.cpu(self).detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return torch.Tensor.numpy(t.as_subclass(torch.Tensor)).copy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def gradient(self):
        g = self.grad
        return None if g is None else g.numpy()

    def astype(self, dtype):
        from ..ops import math
        return math.cast(self, dtype)

    def clear_grad(self, set_to_zero: bool = False):
        if set_to_zero and self.grad is not None:
            with torch.no_grad():
                self.grad.zero_()
        else:
            self.grad = None

    clear_gradient = clear_grad

    def retain_grads(self):
        if not self.is_leaf:
            torch.Tensor.retain_grad(self)
        return self

    def register_hook(self, hook):
        """``hook(grad) -> grad | None`` on the gradient flowing into this
        tensor; the hook gets a port Tensor. Returns torch's handle (the
        JAX method returns the hook)."""
        def h(g):
            r = hook(g if isinstance(g, Tensor) else g.as_subclass(Tensor))
            return None if r is None else torch.Tensor.as_subclass(
                r, torch.Tensor)
        return torch.Tensor.register_hook(self, h)

    def backward(self, grad_tensor=None, retain_graph: bool = False,
                 create_graph: bool = False, inputs=None):
        from ..autograd.backward import backward as _backward
        _backward([self], None if grad_tensor is None else [grad_tensor],
                  retain_graph=retain_graph, create_graph=create_graph,
                  inputs=inputs)

    def detach_(self):
        if self.is_leaf:
            self.requires_grad_(False)
            return self
        return torch.Tensor.detach_(self)

    def set_value(self, new_value):
        """Write ``new_value`` (a tensor, array or number) into this tensor
        in place, cast to its dtype."""
        v = as_torch(new_value, dtype=self.dtype, device=self.device)
        with torch.no_grad():
            torch.Tensor.copy_(self, v.reshape(self.shape)
                               if v.numel() == self.numel() else v)
        return self

    def copy_(self, other, non_blocking: bool = False):
        if not isinstance(other, torch.Tensor):
            return self.set_value(other)
        return torch.Tensor.copy_(self, other, non_blocking)

    def block_until_ready(self):
        if self.is_cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return self

    def __hash__(self):
        return id(self)

    def __repr__(self, *, tensor_contents=None):
        grad_info = "" if self.stop_gradient else ", stop_gradient=False"
        body = np.array2string(self.numpy(), prefix="       ")
        return (f"Tensor(shape={list(self.shape)}, dtype="
                f"{dtypes.dtype_name(self.dtype)}, place={self.place}"
                f"{grad_info},\n       {body})")

    def __reduce_ex__(self, proto):
        return (_rebuild, (type(self), torch.Tensor.cpu(self).detach()
                           .as_subclass(torch.Tensor), str(self.device),
                           self.stop_gradient, self.name))


class _Numel(int):
    """An element count that, called, is ``torch.Tensor.size``."""

    def __new__(cls, t):
        n = super().__new__(cls, torch.Tensor.numel(t))
        n._t = t
        return n

    def __call__(self, *dim):
        return torch.Tensor.size(self._t, *dim)


_PLAIN = frozenset([bool, int, float, str, torch.Size, torch.dtype,
                    torch.device])


def _rebuild(cls, data, device, stop_gradient, name):
    if cls is Parameter:
        p = Parameter(data.to(device), name=name,
                      trainable=not stop_gradient)
        return p
    return cls(data.to(device), stop_gradient=stop_gradient, name=name)


def _wrap(ret):
    if ret is None or type(ret) in _PLAIN:
        return ret
    if isinstance(ret, torch.Tensor):
        # only a plain result becomes a port Tensor: a FakeTensor or a
        # functional tensor of a torch.export trace stays what it is (its
        # TensorImpl already belongs to that Python object)
        return ret.as_subclass(Tensor) if type(ret) is torch.Tensor \
            else ret
    if isinstance(ret, (tuple, list)):
        items = [_wrap(r) for r in ret]
        if hasattr(ret, "_fields"):                  # torch's namedtuples
            return type(ret)(*items)
        try:
            return type(ret)(items)
        except TypeError:
            return tuple(items)
    return ret


class Parameter(Tensor, nn.Parameter):
    """Trainable tensor (Paddle's Parameter): ``stop_gradient`` False
    unless ``trainable=False``; also an ``nn.Parameter``."""

    def __new__(cls, value=None, name=None, trainable: bool = True, *,
                place=None):
        dev = resolve_device(place) if (
            place is not None or not isinstance(value, torch.Tensor)) \
            else None
        t = as_torch([] if value is None else value, device=dev).detach()
        grad = trainable and (t.is_floating_point() or t.is_complex())
        out = torch.Tensor._make_subclass(cls, t, grad)
        out.__dict__.update(_pt_name=name, _pt_persistable=True,
                            trainable=trainable,
                            optimize_attr={"learning_rate": 1.0},
                            regularizer=None, is_distributed=False)
        return out

    def __init__(self, value=None, name=None, trainable: bool = True, *,
                 place=None):
        pass

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = Parameter(torch.Tensor.clone(self).detach()
                        .as_subclass(torch.Tensor), name=self.name,
                        trainable=self.trainable)
        out.stop_gradient = self.stop_gradient
        memo[id(self)] = out
        return out

    def __repr__(self, *, tensor_contents=None):
        return "Parameter containing:\n" + Tensor.__repr__(self)


def as_port(t):
    """``t`` as a port ``Tensor`` where it is a plain tensor; a tensor of
    a trace (FakeTensor, functional tensor) or a port Tensor as it is."""
    return t.as_subclass(Tensor) if type(t) is torch.Tensor else t


def plain_views(ts):
    """Plain ``torch.Tensor`` views of ``ts`` (autograd flows through
    them): inside a function the dispatch runs, their Python operators are
    torch's own, not nested ops of the library. A tensor that is not a
    port Tensor (a plain one, or a FakeTensor of a trace) is taken as it
    is."""
    return [t.as_subclass(torch.Tensor) if isinstance(t, Tensor) else t
            for t in ts]


def is_tensor(x) -> bool:
    return isinstance(x, Tensor)
