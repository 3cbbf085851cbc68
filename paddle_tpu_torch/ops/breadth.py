"""The op library's breadth: stacking and structure, the scatter views,
predicates and sign, bit shifts, ``pdist``, ``reduce_as``, ``rearrange``,
and the in-place ``*_`` family.

Counterpart of ``paddle_tpu/ops/breadth.py``. Each op runs through
``dispatch.apply`` under the JAX package's op name.

The in-place variants (``_INPLACE_BASES``, plus ``where_`` whose target
is ``x``) compute the out-of-place op and then write the result into the
tensor, as the JAX package rebinds its value and tape
(``Tensor._inplace_assign``):

- Where the result keeps the tensor's dtype and shape, the write is a
  true in-place copy (torch's ``copy_``): the tensor keeps its storage
  (``data_ptr``) and autograd records the write, so gradients flow
  through it to what the tensor was computed from. When a graph is being
  recorded the op reads a copy of the tensor's old value, so the write
  does not invalidate what the op saved for its backward. A leaf that
  requires grad is refused, as the JAX package refuses one.
- Where the dtype or shape changes (``cast_``, the comparisons and
  ``logical_*_``, which give bool; ``divide_`` and the float functions of
  an integer tensor; ``squeeze_`` / ``unsqueeze_``), torch cannot change
  a tensor in place: the tensor is rebound to the result (``.data``), as
  ``reshape_`` does, with the result's values but without its history. A
  rebind whose result needs a gradient raises instead of dropping it.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.device import resolve_device
from ..core.tensor import Tensor, as_torch
from .dispatch import apply

__all__ = []


def _export(fn, name=None):
    name = name or fn.__name__
    globals()[name] = fn
    __all__.append(name)
    return fn


def _t(x):
    if isinstance(x, torch.Tensor):
        return x
    return Tensor(as_torch(x, device=resolve_device(None)))


def _multi(f, xs, op_name):
    return apply(lambda *vs: f(vs), *[_t(x) for x in xs], op_name=op_name)


def _inexact(v):
    return v.to(dtypes.to_inexact(v.dtype))


# ---- stacking / structure ----

def _atleast(nd):
    f = {1: torch.atleast_1d, 2: torch.atleast_2d, 3: torch.atleast_3d}[nd]

    def fn(*inputs):
        outs = [apply(f, _t(x), op_name=f"atleast_{nd}d") for x in inputs]
        return outs[0] if len(outs) == 1 else outs
    fn.__name__ = f"atleast_{nd}d"
    return fn


_export(_atleast(1))
_export(_atleast(2))
_export(_atleast(3))


def _same(vs):
    dt = dtypes.result_type(*vs)
    return [v.to(dt) for v in vs]


@_export
def hstack(x, name=None):
    return _multi(lambda vs: torch.hstack(_same(vs)), x, "hstack")


@_export
def vstack(x, name=None):
    return _multi(lambda vs: torch.vstack(_same(vs)), x, "vstack")


@_export
def dstack(x, name=None):
    return _multi(lambda vs: torch.dstack(_same(vs)), x, "dstack")


@_export
def column_stack(x, name=None):
    return _multi(lambda vs: torch.column_stack(_same(vs)), x,
                  "column_stack")


@_export
def row_stack(x, name=None):
    return _multi(lambda vs: torch.vstack(_same(vs)), x, "row_stack")


@_export
def block_diag(inputs, name=None):
    return _multi(lambda vs: torch.block_diag(
        *[torch.atleast_2d(v) for v in _same(vs)]), inputs, "block_diag")


@_export
def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    return apply(lambda v: torch.diag_embed(v, offset, dim1, dim2), input,
                 op_name="diag_embed")


@_export
def combinations(x, r=2, with_replacement=False, name=None):
    n = int(x.shape[0])
    it = itertools.combinations_with_replacement(range(n), r) \
        if with_replacement else itertools.combinations(range(n), r)
    idx = np.asarray(list(it), np.int64).reshape(-1, r)

    def f(v):
        return v[torch.as_tensor(idx, device=v.device)]
    return apply(f, x, op_name="combinations")


@_export
def cartesian_prod(x, name=None):
    def f(vs):
        grids = torch.meshgrid(*_same(vs), indexing="ij")
        return torch.stack([g.reshape(-1) for g in grids], dim=-1)
    return _multi(f, x, "cartesian_prod")


# ---- scatter views ----

@_export
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    def f(v, s):
        v2 = torch.movedim(v, (axis1, axis2), (-2, -1)).clone()
        h, w = v2.shape[-2], v2.shape[-1]
        n = min(h + min(offset, 0), w - max(offset, 0))
        idx = torch.arange(n, device=v.device)
        v2[..., idx + max(-offset, 0), idx + max(offset, 0)] = s.to(v.dtype)
        return torch.movedim(v2, (-2, -1), (axis1, axis2))
    return apply(f, x, y, op_name="diagonal_scatter")


@_export
def select_scatter(x, values, axis, index, name=None):
    def f(v, s):
        out = v.clone()
        idx = [slice(None)] * v.dim()
        idx[axis] = index
        out[tuple(idx)] = s.to(v.dtype)
        return out
    return apply(f, x, values, op_name="select_scatter")


@_export
def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    def f(v, s):
        out = v.clone()
        idx = [slice(None)] * v.dim()
        for a, st, en, sr in zip(axes, starts, ends, strides):
            idx[int(a)] = slice(int(st), int(en), int(sr))
        out[tuple(idx)] = s.to(v.dtype)
        return out
    return apply(f, x, value, op_name="slice_scatter")


# ---- predicates / sign ----

@_export
def signbit(x, name=None):
    return apply(torch.signbit, x, op_name="signbit")


@_export
def isposinf(x, name=None):
    return apply(torch.isposinf, x, op_name="isposinf")


@_export
def isneginf(x, name=None):
    return apply(torch.isneginf, x, op_name="isneginf")


@_export
def isreal(x, name=None):
    return apply(torch.isreal, x, op_name="isreal")


@_export
def positive(x, name=None):
    return apply(lambda v: v.clone(), x, op_name="positive")


@_export
def negative(x, name=None):
    return apply(torch.negative, x, op_name="negative")


# ---- bitwise shifts ----

def _shift_args(a, b):
    from .math import _promoted
    return _promoted(a, b, False)


@_export
def bitwise_left_shift(x, y, is_arithmetic=True, name=None):
    return apply(lambda a, b: torch.bitwise_left_shift(*_shift_args(a, b)),
                 x, y, op_name="bitwise_left_shift")


@_export
def bitwise_right_shift(x, y, is_arithmetic=True, name=None):
    """Arithmetic (sign-filling) or, with ``is_arithmetic=False``, logical
    (zero-filling) shifts of signed integers; unsigned ones shift
    logically either way."""
    def f(a, b):
        v, s = _shift_args(a, b)
        out = torch.bitwise_right_shift(v, s)
        if is_arithmetic or not v.dtype.is_signed:
            return out
        bits = v.element_size() * 8
        one = torch.ones((), dtype=v.dtype, device=v.device)
        mask = torch.bitwise_left_shift(one, bits - s.clamp(1, bits)) - 1
        return torch.where(s == 0, v, out & mask)
    return apply(f, x, y, op_name="bitwise_right_shift")


@_export
def bitwise_invert(x, name=None):
    return apply(torch.bitwise_not, x, op_name="bitwise_invert")


# ---- math ----

@_export
def sinc(x, name=None):
    return apply(lambda v: torch.sinc(_inexact(v)), x, op_name="sinc")


@_export
def cbrt(x, name=None):
    def f(v):
        v = _inexact(v)
        return torch.sign(v) * torch.abs(v).pow(1.0 / 3.0)
    return apply(f, x, op_name="cbrt")


@_export
def sigmoid(x, name=None):
    return apply(lambda v: torch.sigmoid(_inexact(v)), x, op_name="sigmoid")


@_export
def pdist(x, p=2.0, name=None):
    i, j = np.triu_indices(int(x.shape[0]), k=1)

    def f(v):
        d = v[torch.as_tensor(i, device=v.device)] - \
            v[torch.as_tensor(j, device=v.device)]
        if p == 2.0:
            return torch.sqrt(torch.sum(d * d, dim=-1))
        if p == 0:
            return torch.sum(d != 0, dim=-1).to(v.dtype)
        if np.isinf(p):
            return torch.amax(torch.abs(d), dim=-1)
        return torch.sum(torch.abs(d) ** p, dim=-1) ** (1.0 / p)
    return apply(f, x, op_name="pdist")


@_export
def reduce_as(x, target, name=None):
    """Sum-reduce ``x`` to ``target``'s shape."""
    def f(v, t):
        extra = v.dim() - t.dim()
        if extra:
            v = torch.sum(v, dim=tuple(range(extra)))
        keep = tuple(i for i in range(v.dim())
                     if t.shape[i] == 1 and v.shape[i] != 1)
        if keep:
            v = torch.sum(v, dim=keep, keepdim=True)
        return v
    return apply(f, x, target, op_name="reduce_as")


@_export
def rearrange(tensor, pattern, **axes_lengths):
    def f(v):
        import einops
        return einops.rearrange(v, pattern, **axes_lengths)
    return apply(f, tensor, op_name="rearrange")


@_export
def reverse(x, axis, name=None):
    from .manip import flip
    return flip(x, axis)


# ---- the in-place family (module docstring) ----

def _needs_graph(*vals) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad for v in vals)


def _rebind(x, out):
    if out.dtype == x.dtype and out.shape == x.shape:
        if x.is_leaf and x.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                "a leaf Tensor with stop_gradient=False cannot be the "
                "target of an inplace op; operate out-of-place or set "
                "stop_gradient=True first")
        torch.Tensor.copy_(x, out)
        return x
    if out.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"an inplace op changing {x.dtype}{list(x.shape)} into "
            f"{out.dtype}{list(out.shape)} cannot keep the gradient's "
            f"history; use the out-of-place op")
    if x.is_leaf and x.requires_grad:
        x.requires_grad_(False)
    with torch.no_grad():
        x.data = out.detach()
    return x


def _make_inplace(base_fn, name):
    def ip(x, *args, **kwargs):
        src = x.clone() if _needs_graph(x, *args, *kwargs.values()) else x
        return _rebind(x, base_fn(src, *args, **kwargs))
    ip.__name__ = name
    ip.__doc__ = f"Inplace version of ``{base_fn.__name__}``."
    return ip


_INPLACE_ALIASES = {"remainder": "mod", "floor_mod": "mod", "mod": "mod"}

_INPLACE_BASES = [
    "abs", "acos", "add", "addmm", "atan", "bitwise_and", "bitwise_invert",
    "bitwise_not", "bitwise_or", "bitwise_xor", "cast", "ceil", "clip",
    "cos", "cumprod", "cumsum", "digamma", "divide", "equal", "erf",
    "erfinv", "exp", "expm1", "fill_diagonal", "fill_diagonal_tensor",
    "floor", "floor_divide", "floor_mod", "frac", "gcd", "greater_equal",
    "greater_than", "i0", "index_add", "index_put", "lcm", "ldexp", "lerp",
    "less_equal", "less_than", "lgamma", "log", "log10", "log1p", "log2",
    "logical_and", "logical_not", "logical_or", "logical_xor", "logit",
    "mod", "multiply", "nan_to_num", "neg", "not_equal", "polygamma",
    "pow", "put_along_axis", "reciprocal", "remainder", "renorm", "round",
    "rsqrt", "scale", "scatter", "sigmoid", "sin", "sinh", "sqrt", "square",
    "squeeze", "subtract", "tan", "tanh", "tril", "triu", "trunc",
    "unsqueeze",
]


def where_(condition, x, y, name=None):
    """``where(condition, x, y)`` written into ``x`` (the target is ``x``,
    not the condition)."""
    from .manip import where
    src = x.clone() if _needs_graph(x, y) else x
    return _rebind(x, where(condition, src, y))


_export(where_)


def _install_inplace():
    from . import creation, linalg, manip, math
    sources = [globals(), *(vars(m) for m in (math, manip, creation, linalg))]

    def lookup(base):
        target = _INPLACE_ALIASES.get(base, base)
        for src in sources:
            if target in src and callable(src[target]) and \
                    not isinstance(src[target], type):
                return src[target]
        return None

    made = []
    for base in _INPLACE_BASES:
        name = base + "_"
        if name in globals():
            continue
        fn = lookup(base)
        if fn is None:
            continue
        _export(_make_inplace(fn, name), name)
        made.append(name)
    return made


_install_inplace()
