"""Install the ``Tensor`` methods and operators from the op tables.

Counterpart of ``paddle_tpu/ops/_method_patch.py`` (``_install``): the
arithmetic, comparison and bitwise operators run the op library's
functions (the JAX package's promotion rules, the amp cast, the dispatch
hooks), and every public op that ``Tensor`` has no method of that name
for becomes one. As in the JAX package, a name the class already has is
not replaced: on the port's ``Tensor`` that means torch's methods
(``sum``, ``transpose``, ``split``, ...) keep torch's meaning, which the
port's own modules and torch's Python code rely on; the op library's
functions carry Paddle's (ROADMAP.md "Deliberate differences").
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from . import breadth, creation, linalg, manip, math
from . import random as random_ops
from .dispatch import apply

_SKIP = {"to_tensor", "as_tensor", "arange", "linspace", "logspace", "eye",
         "meshgrid", "zeros", "ones", "full", "empty", "tril_indices",
         "triu_indices", "scatter_nd", "complex",
         "rand", "randn", "randint", "randperm", "standard_normal",
         "uniform", "normal", "gumbel_softmax"}


def _rev(torch_fn, opname, inexact=False):
    """``other <op> self`` for a Python scalar or array ``other``."""
    def op(s, o):
        def f(v):
            a, b = math._promoted(o, v, inexact)
            return torch_fn(a, b)
        return apply(f, s, op_name=opname)
    return op


def _install():
    T = Tensor
    T.__add__ = lambda s, o: math.add(s, o)
    T.__radd__ = lambda s, o: math.add(o, s)
    T.__sub__ = lambda s, o: math.subtract(s, o)
    T.__rsub__ = _rev(torch.sub, "rsub")
    T.__mul__ = lambda s, o: math.multiply(s, o)
    T.__rmul__ = lambda s, o: math.multiply(o, s)
    T.__truediv__ = lambda s, o: math.divide(s, o)
    T.__rtruediv__ = _rev(torch.div, "rdiv", inexact=True)
    T.__floordiv__ = lambda s, o: math.floor_divide(s, o)
    T.__rfloordiv__ = _rev(math._floor_divide, "rfloordiv")
    T.__mod__ = lambda s, o: math.mod(s, o)
    T.__rmod__ = _rev(torch.remainder, "rmod")
    T.__pow__ = lambda s, o: math.pow(s, o)
    T.__rpow__ = _rev(torch.pow, "rpow")
    T.__neg__ = lambda s: math.neg(s)
    T.__pos__ = lambda s: s
    T.__abs__ = lambda s: math.abs(s)
    T.__matmul__ = lambda s, o: math.matmul(s, o)
    T.__rmatmul__ = lambda s, o: apply(
        lambda a, b: math._matmul(a, b, False, False), o, s,
        op_name="rmatmul")
    T.__invert__ = lambda s: math.bitwise_not(s)
    T.__and__ = lambda s, o: math.bitwise_and(s, o)
    T.__or__ = lambda s, o: math.bitwise_or(s, o)
    T.__xor__ = lambda s, o: math.bitwise_xor(s, o)
    T.__eq__ = lambda s, o: math.equal(s, o)
    T.__ne__ = lambda s, o: math.not_equal(s, o)
    T.__lt__ = lambda s, o: math.less_than(s, o)
    T.__le__ = lambda s, o: math.less_equal(s, o)
    T.__gt__ = lambda s, o: math.greater_than(s, o)
    T.__ge__ = lambda s, o: math.greater_equal(s, o)

    for mod in (math, manip, creation, linalg, breadth, random_ops):
        for name in getattr(mod, "__all__", []):
            if name in _SKIP or hasattr(T, name):
                continue
            fn = getattr(mod, name)
            if callable(fn):
                setattr(T, name, fn)

    T.cast = lambda s, d: math.cast(s, d)
    T.scale = lambda s, *a, **k: math.scale(s, *a, **k)
    T.rank = lambda s: s.dim()
    T.is_tensor = lambda s: True
    T.element_size = lambda s: s.dtype.itemsize


_install()
