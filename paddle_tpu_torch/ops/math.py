"""Elementwise math, reductions, comparisons and casts.

Counterpart of ``paddle_tpu/ops/math.py``. Every op runs through
``dispatch.apply`` under its JAX op name, so ``amp.auto_cast``, the
nan/inf check and the operator stats see it. Result dtypes follow the JAX
package (x64 on), not torch's defaults: a Python float with an integer
tensor gives float64, a float-valued function of int64 gives float64 (of a
narrower integer, float32), ``sum``/``prod`` widen integers to int64,
``cumsum`` keeps them (``core.dtype.result_type`` / ``to_inexact``).
"""
from __future__ import annotations

import builtins
import math as _m

import numpy as np
import torch

from ..core import dtype as dtypes
from ._static_shape import static_int, static_int_list
from .dispatch import apply

__all__ = []

_T = torch.Tensor


def _export(name, fn):
    globals()[name] = fn
    __all__.append(name)
    return fn


def _dev(*xs):
    for x in xs:
        if isinstance(x, _T):
            return x.device
    return None


def _to(x, dt, dev=None):
    """``x`` as dtype ``dt``: a tensor is cast, a Python scalar stays a
    scalar (torch then keeps the tensor's dtype) unless ``dev`` asks for
    a tensor (for the torch functions that take none)."""
    if isinstance(x, _T):
        return x if x.dtype == dt else x.to(dt)
    if dev is not None:
        return torch.full((), x, dtype=dt, device=dev)
    return x


def _promoted(a, b, inexact=False, scalars=False):
    """``a`` and ``b`` cast to their JAX result dtype (made inexact with
    ``inexact``). A Python scalar ``b`` stays a scalar where the torch
    function takes one (``scalars``); any other becomes a 0-d tensor on
    the other operand's device."""
    if isinstance(a, _T):
        # the common cases first: the same dtype, or a scalar that keeps
        # the tensor's (a float with a float tensor, an int with any but
        # bool)
        fa = a.is_floating_point()
        if isinstance(b, _T):
            if a.dtype == b.dtype and (fa or not inexact):
                return a, b
        elif scalars and (fa or not inexact) and (
                (type(b) is float and fa) or
                (type(b) is int and a.dtype != torch.bool)):
            return a, b
    dt = dtypes.result_type(a, b)
    if inexact:
        dt = dtypes.to_inexact(dt)
    dev = _dev(a, b) or torch.device("cpu")
    keep_b = scalars and not isinstance(b, (_T, np.ndarray, np.generic))
    a = _to(_np(a, dev), dt, dev)
    b = _to(_np(b, dev), dt, None if keep_b else dev)
    return a, b


def _np(x, dev):
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(x), device=dev)
    return x


# ---------- binary elementwise with JAX promotion ----------

def _binop(opname, torch_fn, inexact=False, scalars=False):
    def f(a, b):
        a, b = _promoted(a, b, inexact, scalars)
        return torch_fn(a, b)
    f.__name__ = opname

    def op(x, y, name=None):
        return apply(f, x, y, op_name=opname)
    op.__name__ = opname
    return _export(opname, op)


add = _binop("add", torch.add, scalars=True)
subtract = _binop("subtract", torch.sub, scalars=True)
multiply = _binop("multiply", torch.mul, scalars=True)
divide = _binop("divide", torch.div, inexact=True, scalars=True)
mod = _binop("mod", torch.remainder, scalars=True)
remainder = _export("remainder", mod)
floor_mod = _export("floor_mod", mod)
def _floor_divide(a, b):
    """Integers: torch's floor division. Floats: ``jnp.floor_divide``'s
    divmod, ``(a - fmod(a, b)) / b`` corrected toward -inf, so a division
    by 0.0 gives nan as there (torch's gives +-inf)."""
    if not a.is_floating_point():
        return torch.floor_divide(a, b)
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    sb = torch.sign(b) if isinstance(b, torch.Tensor) else float(
        (b > 0) - (b < 0))
    fix = (mod != 0) & (sb != torch.sign(mod))
    return torch.round(torch.where(fix, div - 1, div))


floor_divide = _binop("floor_divide", _floor_divide, scalars=True)
pow = _binop("pow", torch.pow, scalars=True)
maximum = _binop("maximum", torch.maximum)
minimum = _binop("minimum", torch.minimum)
fmax = _binop("fmax", torch.fmax)
fmin = _binop("fmin", torch.fmin)
atan2 = _binop("atan2", torch.atan2, inexact=True)
hypot = _binop("hypot", torch.hypot, inexact=True)
logaddexp = _binop("logaddexp", torch.logaddexp, inexact=True)
nextafter = _binop("nextafter", torch.nextafter, inexact=True)
copysign = _binop("copysign", torch.copysign, inexact=True)
heaviside = _binop("heaviside", torch.heaviside, inexact=True)
gcd = _binop("gcd", torch.gcd)
lcm = _binop("lcm", torch.lcm)
inner = _binop("inner", torch.inner)
outer = _binop("outer", lambda a, b: torch.outer(a.reshape(-1),
                                                   b.reshape(-1)))
kron = _binop("kron", torch.kron)


def _cross(a, b, axis):
    a, b = _promoted(a, b)
    return torch.linalg.cross(a, b, dim=-1 if axis is None else axis)


cross = _export("cross", lambda x, y, axis=None: apply(
    _cross, x, y, axis, op_name="cross"))


def divide_no_nan(x, y):
    def f(a, b):
        a, b = _promoted(a, b, inexact=True, scalars=False)
        return torch.where(b == 0, torch.zeros_like(a * b), a / b)
    return apply(f, x, y, op_name="divide_no_nan")


_export("divide_no_nan", divide_no_nan)


# ---------- unary elementwise ----------

def _unop(opname, torch_fn, inexact=False):
    if inexact:
        def f(v):
            return torch_fn(v.to(dtypes.to_inexact(v.dtype)))
    else:
        f = torch_fn

    def op(x, name=None):
        return apply(f, x, op_name=opname)
    op.__name__ = opname
    return _export(opname, op)


def _imag(v):
    """0 for a real input, and a grad of 0 through it (the JAX op's)."""
    if v.is_complex():
        return torch.imag(v)
    if v.dtype in (torch.float32, torch.float64):
        return torch.imag(torch.complex(v, torch.zeros_like(v)))
    return torch.zeros_like(v)


def _angle(v):
    return torch.angle(v.to(dtypes.to_inexact(v.dtype)))


abs = _unop("abs", torch.abs)
neg = _unop("neg", torch.neg)
exp = _unop("exp", torch.exp, True)
expm1 = _unop("expm1", torch.expm1, True)
log = _unop("log", torch.log, True)
log2 = _unop("log2", torch.log2, True)
log10 = _unop("log10", torch.log10, True)
log1p = _unop("log1p", torch.log1p, True)
sqrt = _unop("sqrt", torch.sqrt, True)
rsqrt = _unop("rsqrt", torch.rsqrt, True)
square = _unop("square", torch.square)
reciprocal = _unop("reciprocal", torch.reciprocal, True)
sin = _unop("sin", torch.sin, True)
cos = _unop("cos", torch.cos, True)
tan = _unop("tan", torch.tan, True)
asin = _unop("asin", torch.asin, True)
acos = _unop("acos", torch.acos, True)
atan = _unop("atan", torch.atan, True)
sinh = _unop("sinh", torch.sinh, True)
cosh = _unop("cosh", torch.cosh, True)
tanh = _unop("tanh", torch.tanh, True)
asinh = _unop("asinh", torch.asinh, True)
acosh = _unop("acosh", torch.acosh, True)
atanh = _unop("atanh", torch.atanh, True)
erf = _unop("erf", torch.erf, True)
erfinv = _unop("erfinv", torch.erfinv, True)
floor = _unop("floor", torch.floor)
ceil = _unop("ceil", torch.ceil)
round = _unop("round", torch.round)


def trunc(input, name=None):
    return apply(torch.trunc, input, op_name="trunc")


_export("trunc", trunc)
frac = _unop("frac", lambda v: v - torch.trunc(v))
sign = _unop("sign", torch.sign)
sgn = _export("sgn", sign)
angle = _unop("angle", _angle)
conj = _unop("conj", lambda v: torch.conj(v).resolve_conj())
real = _unop("real", lambda v: torch.real(v).clone())
imag = _unop("imag", _imag)
digamma = _unop("digamma", torch.digamma, True)
lgamma = _unop("lgamma", torch.lgamma, True)
i0 = _unop("i0", torch.special.i0, True)
i0e = _unop("i0e", torch.special.i0e, True)
i1 = _unop("i1", torch.special.i1, True)
i1e = _unop("i1e", torch.special.i1e, True)
isnan = _unop("isnan", torch.isnan)
isinf = _unop("isinf", torch.isinf)
isfinite = _unop("isfinite", torch.isfinite)


def logit(x, eps=None, name=None):
    def f(v):
        v = v.to(dtypes.to_inexact(v.dtype))
        if eps is not None:
            v = torch.clamp(v, eps, 1.0 - eps)
        return torch.log(v / (1 - v))
    return apply(f, x, op_name="logit")


_export("logit", logit)
deg2rad = _unop("deg2rad", torch.deg2rad, True)
rad2deg = _unop("rad2deg", torch.rad2deg, True)


def clip(x, min=None, max=None):
    return apply(lambda v, lo, hi: torch.clamp(v, lo, hi), x, min, max,
                 op_name="clip")


_export("clip", clip)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return apply(lambda v: torch.nan_to_num(v, nan=nan, posinf=posinf,
                                            neginf=neginf),
                 x, op_name="nan_to_num")


_export("nan_to_num", nan_to_num)


def lerp(x, y, weight):
    if isinstance(weight, _T):
        return apply(lambda a, b, w: a + w * (b - a), x, y, weight,
                     op_name="lerp")
    return apply(lambda a, b: a + weight * (b - a), x, y, op_name="lerp")


_export("lerp", lerp)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    def f(v):
        return v * scale + bias if bias_after_scale else (v + bias) * scale
    return apply(f, x, op_name="scale")


_export("scale", scale)


def increment(x, value=1.0):
    """``x += value`` in place (a value update, as the JAX op's)."""
    out = apply(lambda v: v + value, x, op_name="increment")
    with torch.no_grad():
        x.copy_(out)
    return x


_export("increment", increment)


def stanh(x, scale_a=0.67, scale_b=1.7159):
    return apply(lambda v: scale_b * torch.tanh(scale_a * v), x,
                 op_name="stanh")


_export("stanh", stanh)


# ---------- matmul family ----------

def _matmul(a, b, transpose_x, transpose_y):
    a, b = _promoted(a, b, scalars=False)
    if transpose_x and a.dim() >= 2:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() >= 2:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return apply(_matmul, x, y, transpose_x, transpose_y, op_name="matmul")


_export("matmul", matmul)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


_export("mm", mm)


def bmm(x, y):
    return matmul(x, y)


_export("bmm", bmm)


def dot(x, y):
    return apply(lambda a, b: (a * b).sum(-1), x, y, op_name="dot")


_export("dot", dot)


def addmm(input, x, y, beta=1.0, alpha=1.0):
    return apply(lambda i, a, b: beta * i + alpha * torch.matmul(a, b),
                 input, x, y, op_name="addmm")


_export("addmm", addmm)


def mv(x, vec):
    return matmul(x, vec)


_export("mv", mv)


def t(input, name=None):
    return apply(lambda v: v.transpose(-1, -2) if v.dim() >= 2 else v,
                 input, op_name="t")


_export("t", t)


def trace(x, offset=0, axis1=0, axis2=1):
    return apply(lambda v: torch.diagonal(v, offset, axis1, axis2).sum(-1),
                 x, op_name="trace")


_export("trace", trace)


def diagonal(x, offset=0, axis1=0, axis2=1):
    return apply(lambda v: torch.diagonal(v, offset, axis1, axis2), x,
                 op_name="diagonal")


_export("diagonal", diagonal)


def einsum(equation, *operands):
    def f(*vs):
        dt = dtypes.result_type(*vs)
        return torch.einsum(equation, *[v.to(dt) for v in vs])
    return apply(f, *operands, op_name="einsum")


_export("einsum", einsum)


# ---------- reductions ----------

def _axis_arg(axis):
    if axis is None:
        return None
    if isinstance(axis, _T):
        return static_int(axis, "axis") if axis.dim() == 0 \
            else tuple(static_int_list(axis, "axis"))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(v, ax):
    """``ax`` as a tuple of dims (all of them for None)."""
    if ax is None:
        return tuple(range(v.dim()))
    return ax if isinstance(ax, tuple) else (ax,)


def _over(fn, v, ax, keepdim):
    """``fn(v2, -1)`` for a function of one dim, over the dims ``ax``
    moved last and flattened."""
    dims = tuple(d % builtins.max(v.dim(), 1) for d in _dims(v, ax))
    if v.dim() == 0:
        return fn(v.reshape(1), -1).reshape(())
    rest = [d for d in range(v.dim()) if d not in dims]
    vv = v.permute(*rest, *dims).reshape(*[v.shape[d] for d in rest], -1)
    out = fn(vv, -1)
    if keepdim:
        shape = [1 if d in dims else v.shape[d] for d in range(v.dim())]
        out = out.reshape(shape)
    return out


def _reduce(opname, fn, inexact=False):
    def op(x, axis=None, keepdim=False, name=None):
        ax = _axis_arg(axis)

        def f(v):
            if inexact:
                v = v.to(dtypes.to_inexact(v.dtype))
            return fn(v, ax, keepdim)
        return apply(f, x, op_name=opname)
    op.__name__ = opname
    return _export(opname, op)


mean = _reduce("mean", lambda v, ax, k: torch.mean(v, _dims(v, ax), k),
               inexact=True)
max = _reduce("max", lambda v, ax, k: torch.amax(v, _dims(v, ax), k))
min = _reduce("min", lambda v, ax, k: torch.amin(v, _dims(v, ax), k))
amax = _reduce("amax", lambda v, ax, k: torch.amax(v, _dims(v, ax), k))
amin = _reduce("amin", lambda v, ax, k: torch.amin(v, _dims(v, ax), k))


def _reduce_dtype(opname, fn, dtype_pos_after_keepdim=False):
    """sum/nansum/prod with the reference's ``dtype`` (the input is cast
    before reducing): sum/nansum (x, axis, dtype, keepdim), prod (x, axis,
    keepdim, dtype). Integers and bool reduce to int64."""
    def core(x, axis, dtype, keepdim):
        ax = _axis_arg(axis)
        dt = dtypes.convert_dtype(dtype) if dtype is not None else None

        def f(v):
            v = v.to(dt) if dt is not None else v.to(dtypes.sum_dtype(v.dtype))
            return fn(v, ax, keepdim)
        return apply(f, x, op_name=opname)

    if dtype_pos_after_keepdim:
        def op(x, axis=None, keepdim=False, dtype=None, name=None):
            return core(x, axis, dtype, keepdim)
    else:
        def op(x, axis=None, dtype=None, keepdim=False, name=None):
            return core(x, axis, dtype, keepdim)
    op.__name__ = opname
    return _export(opname, op)


sum = _reduce_dtype("sum", lambda v, ax, k: torch.sum(v, _dims(v, ax), k))
nansum = _reduce_dtype("nansum",
                       lambda v, ax, k: torch.nansum(v, _dims(v, ax), k))
prod = _reduce_dtype(
    "prod", lambda v, ax, k: _over(lambda t, d: torch.prod(t, d), v, ax, k),
    dtype_pos_after_keepdim=True)
nanmean = _reduce("nanmean",
                  lambda v, ax, k: torch.nanmean(v, _dims(v, ax), k),
                  inexact=True)
logsumexp = _reduce("logsumexp",
                    lambda v, ax, k: torch.logsumexp(v, _dims(v, ax), k),
                    inexact=True)
all = _reduce("all", lambda v, ax, k: torch.all(v, _dims(v, ax), k))
any = _reduce("any", lambda v, ax, k: torch.any(v, _dims(v, ax), k))


def std(x, axis=None, unbiased=True, keepdim=False):
    ax = _axis_arg(axis)
    return apply(lambda v: torch.std(v.to(dtypes.to_inexact(v.dtype)),
                                     _dims(v, ax), correction=int(unbiased),
                                     keepdim=keepdim), x, op_name="std")


_export("std", std)


def var(x, axis=None, unbiased=True, keepdim=False):
    ax = _axis_arg(axis)
    return apply(lambda v: torch.var(v.to(dtypes.to_inexact(v.dtype)),
                                     _dims(v, ax), correction=int(unbiased),
                                     keepdim=keepdim), x, op_name="var")


_export("var", var)


def _quant(v, q, ax, keepdim, nan):
    v = v.to(dtypes.to_inexact(v.dtype))
    fn = torch.nanquantile if nan else torch.quantile
    qt = torch.as_tensor(q, dtype=v.dtype, device=v.device)
    out = _over(lambda t, d: fn(t, qt, dim=d), v, ax, keepdim) \
        if qt.dim() == 0 else torch.stack(
            [_over(lambda t, d: fn(t, qq, dim=d), v, ax, keepdim)
             for qq in qt.reshape(-1)]).reshape(*qt.shape, *(
                 _over(lambda t, d: fn(t, qt.reshape(-1)[0], dim=d), v, ax,
                       keepdim).shape))
    return out


def median(x, axis=None, keepdim=False):
    """The mean of the two middle values for an even count (the JAX
    median; torch's ``median`` takes the lower one)."""
    ax = _axis_arg(axis)
    return apply(lambda v: _quant(v, 0.5, ax, keepdim, False), x,
                 op_name="median")


_export("median", median)


def quantile(x, q, axis=None, keepdim=False):
    ax = _axis_arg(axis)
    return apply(lambda v: _quant(v, q, ax, keepdim, False), x,
                 op_name="quantile")


_export("quantile", quantile)


def argmax(x, axis=None, keepdim=False, dtype="int64"):
    ax = _axis_arg(axis)
    dt = dtypes.convert_dtype(dtype)
    return apply(lambda v: torch.argmax(v, ax, keepdim).to(dt), x,
                 op_name="argmax")


_export("argmax", argmax)


def argmin(x, axis=None, keepdim=False, dtype="int64"):
    ax = _axis_arg(axis)
    dt = dtypes.convert_dtype(dtype)
    return apply(lambda v: torch.argmin(v, ax, keepdim).to(dt), x,
                 op_name="argmin")


_export("argmin", argmin)


def count_nonzero(x, axis=None, keepdim=False):
    ax = _axis_arg(axis)
    return apply(lambda v: torch.sum(v != 0, _dims(v, ax), keepdim,
                                     dtype=torch.int64),
                 x, op_name="count_nonzero")


_export("count_nonzero", count_nonzero)


def _cum_dtype(v):
    return torch.int64 if v.dtype == torch.bool else v.dtype


def cumsum(x, axis=None, dtype=None):
    def f(v):
        vv = v.reshape(-1) if axis is None else v
        out = torch.cumsum(vv, 0 if axis is None else axis)
        return out.to(dtypes.convert_dtype(dtype) if dtype
                      else _cum_dtype(v))
    return apply(f, x, op_name="cumsum")


_export("cumsum", cumsum)


def cumprod(x, dim=None, dtype=None):
    def f(v):
        vv = v.reshape(-1) if dim is None else v
        out = torch.cumprod(vv, 0 if dim is None else dim)
        return out.to(dtypes.convert_dtype(dtype) if dtype
                      else _cum_dtype(v))
    return apply(f, x, op_name="cumprod")


_export("cumprod", cumprod)


def _cumext(v, axis, take_max):
    vv = v.reshape(-1) if axis is None else v
    ax = 0 if axis is None else axis % vv.dim()
    fn = torch.cummax if take_max else torch.cummin
    vals = fn(vv, ax).values
    idx = torch.arange(vv.shape[ax], device=vv.device).reshape(
        [-1 if i == ax else 1 for i in range(vv.dim())]).expand(vv.shape)
    new = (vv >= vals) if take_max else (vv <= vals)
    ind = torch.cummax(torch.where(new, idx, torch.full_like(idx, -1)),
                       ax).values
    return vals, ind.to(torch.int64)


def cummax(x, axis=None):
    out = apply(lambda v: _cumext(v, axis, True), x, op_name="cummax")
    return out[0], out[1]


_export("cummax", cummax)


def cummin(x, axis=None):
    out = apply(lambda v: _cumext(v, axis, False), x, op_name="cummin")
    return out[0], out[1]


_export("cummin", cummin)


# ---------- comparison / logic ----------

def _cmp(opname, torch_fn):
    def f(a, b):
        a, b = _promoted(a, b, scalars=False)
        return torch_fn(a, b)

    def op(x, y, name=None):
        return apply(f, x, y, op_name=opname)
    op.__name__ = opname
    return _export(opname, op)


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)


def _logicop(opname, torch_fn, unary=False):
    """logical_*/bitwise_* carry the reference's optional ``out`` tensor
    between the operands and ``name``."""
    def f2(a, b):
        a, b = _promoted(a, b, scalars=False)
        return torch_fn(a, b)
    if unary:
        def op(x, out=None, name=None):
            res = apply(torch_fn, x, op_name=opname)
            if out is not None:
                with torch.no_grad():
                    out.copy_(res)
                return out
            return res
    else:
        def op(x, y, out=None, name=None):
            res = apply(f2, x, y, op_name=opname)
            if out is not None:
                with torch.no_grad():
                    out.copy_(res)
                return out
            return res
    op.__name__ = opname
    return _export(opname, op)


logical_and = _logicop("logical_and", torch.logical_and)
logical_or = _logicop("logical_or", torch.logical_or)
logical_xor = _logicop("logical_xor", torch.logical_xor)
logical_not = _logicop("logical_not", torch.logical_not, unary=True)
bitwise_and = _logicop("bitwise_and", torch.bitwise_and)
bitwise_or = _logicop("bitwise_or", torch.bitwise_or)
bitwise_xor = _logicop("bitwise_xor", torch.bitwise_xor)
bitwise_not = _logicop("bitwise_not", torch.bitwise_not, unary=True)
left_shift = _cmp("left_shift", torch.bitwise_left_shift)
right_shift = _cmp("right_shift", torch.bitwise_right_shift)


def equal_all(x, y):
    def f(a, b):
        if tuple(a.shape) != tuple(b.shape):
            return torch.zeros((), dtype=torch.bool, device=a.device)
        return torch.eq(a, b).all()
    return apply(f, x, y, op_name="equal_all")


_export("equal_all", equal_all)


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    def f(a, b):
        a, b = _promoted(a, b, scalars=False)
        return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)
    return apply(f, x, y, op_name="isclose")


_export("isclose", isclose)


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    def f(a, b):
        a, b = _promoted(a, b, scalars=False)
        return torch.isclose(a, b, rtol=rtol, atol=atol,
                             equal_nan=equal_nan).all()
    return apply(f, x, y, op_name="allclose")


_export("allclose", allclose)


# ---------- casting ----------

def cast(x, dtype):
    dt = dtypes.convert_dtype(dtype)
    return apply(lambda v: v.to(dt), x, op_name="cast")


_export("cast", cast)


def astype(x, dtype):
    return cast(x, dtype)


_export("astype", astype)


# ---------- the rest of python/paddle/tensor/math.py ----------

def logcumsumexp(x, axis=None, dtype=None):
    def f(v):
        vv = v if axis is not None else v.reshape(-1)
        ax = axis if axis is not None else 0
        m = torch.amax(vv, ax, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        return torch.log(torch.cumsum(torch.exp(vv - m), ax)) + m
    return apply(f, x, op_name="logcumsumexp")


_export("logcumsumexp", logcumsumexp)


def diff(x, n=1, axis=-1, prepend=None, append=None):
    args = [a for a in (prepend, append) if a is not None]

    def f(v, *rest):
        it = iter(rest)
        pre = next(it) if prepend is not None else None
        app = next(it) if append is not None else None
        return torch.diff(v, n=n, dim=axis, prepend=pre, append=app)
    return apply(f, x, *args, op_name="diff")


_export("diff", diff)


def trapezoid(y, x=None, dx=None, axis=-1):
    if x is not None:
        return apply(lambda yy, xx: torch.trapezoid(yy, xx, dim=axis), y, x,
                     op_name="trapezoid")
    d = 1.0 if dx is None else dx
    return apply(lambda yy: torch.trapezoid(yy, dx=d, dim=axis), y,
                 op_name="trapezoid")


_export("trapezoid", trapezoid)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1):
    if x is not None:
        return apply(lambda yy, xx: torch.cumulative_trapezoid(
            yy, xx, dim=axis), y, x, op_name="cumulative_trapezoid")
    d = 1.0 if dx is None else dx
    return apply(lambda yy: torch.cumulative_trapezoid(yy, dx=d, dim=axis),
                 y, op_name="cumulative_trapezoid")


_export("cumulative_trapezoid", cumulative_trapezoid)


def frexp(x):
    def f(v):
        m, e = torch.frexp(v)
        return m, e.to(torch.int32)
    return apply(f, x, op_name="frexp")


_export("frexp", frexp)


def ldexp(x, y):
    def f(a, b):
        a = a.to(dtypes.to_inexact(a.dtype))
        return a * torch.pow(2.0, b.to(torch.int32)).to(a.dtype)
    return apply(f, x, y, op_name="ldexp")


_export("ldexp", ldexp)


def polygamma(x, n=1):
    return apply(lambda v: torch.polygamma(n, v.to(dtypes.to_inexact(
        v.dtype))), x, op_name="polygamma")


_export("polygamma", polygamma)


def gammaln(x):
    return apply(lambda v: torch.lgamma(v.to(dtypes.to_inexact(v.dtype))), x,
                 op_name="gammaln")


_export("gammaln", gammaln)


def gammainc(x, y):
    """Regularised lower incomplete gamma P(x, y)."""
    def f(a, b):
        a, b = _promoted(a, b, inexact=True, scalars=False)
        return torch.special.gammainc(a, b)
    return apply(f, x, y, op_name="gammainc")


_export("gammainc", gammainc)


def gammaincc(x, y):
    def f(a, b):
        a, b = _promoted(a, b, inexact=True, scalars=False)
        return torch.special.gammaincc(a, b)
    return apply(f, x, y, op_name="gammaincc")


_export("gammaincc", gammaincc)


def renorm(x, p, axis, max_norm):
    """Renormalise the slices along ``axis`` to at most ``max_norm`` in
    p-norm."""
    def f(v):
        a = axis % v.dim()
        red = tuple(i for i in range(v.dim()) if i != a)
        norms = torch.sum(torch.abs(v) ** p, red, keepdim=True) ** (1.0 / p)
        s = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                        torch.ones_like(norms))
        return v * s
    return apply(f, x, op_name="renorm")


_export("renorm", renorm)


def add_n(inputs):
    if isinstance(inputs, _T):
        inputs = [inputs]

    def f(*vs):
        out = vs[0]
        for v in vs[1:]:
            out = out + v
        return out
    return apply(f, *inputs, op_name="add_n")


_export("add_n", add_n)


def rank(input):
    return apply(lambda v: torch.full((), v.dim(), dtype=torch.int32,
                                      device=v.device), input, op_name="rank")


_export("rank", rank)


def shape(input):
    return apply(lambda v: torch.tensor(list(v.shape), dtype=torch.int32,
                                        device=v.device), input,
                 op_name="shape")


_export("shape", shape)


def is_complex(x):
    return builtins.bool(x.is_complex())


_export("is_complex", is_complex)


def is_floating_point(x):
    return builtins.bool(x.is_floating_point())


_export("is_floating_point", is_floating_point)


def is_integer(x):
    return dtypes.is_integer(x.dtype)


_export("is_integer", is_integer)


def is_empty(x):
    return apply(lambda v: torch.full((), v.numel() == 0, dtype=torch.bool,
                                      device=v.device), x, op_name="is_empty")


_export("is_empty", is_empty)


def inverse(x):
    return apply(torch.linalg.inv, x, op_name="inverse")


_export("inverse", inverse)


def dist(x, y, p=2.0):
    def f(a, b):
        d = (a - b).reshape(-1)
        if p == 0:
            return torch.sum(d != 0).to(a.dtype)
        if _m.isinf(p):
            return torch.amax(torch.abs(d)) if p > 0 \
                else torch.amin(torch.abs(d))
        return torch.sum(torch.abs(d) ** p) ** (1.0 / p)
    return apply(f, x, y, op_name="dist")


_export("dist", dist)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary"):
    """Pairwise p-distance between row sets ``[..., P, M]`` and ``[..., R,
    M]``; p=0 counts differing coordinates."""
    def f(a, b):
        d = a[..., :, None, :] - b[..., None, :, :]
        if p == 0:
            return torch.sum(d != 0, -1).to(a.dtype)
        if p == 2.0:
            return torch.sqrt(torch.sum(d * d, -1) + 0.0)
        if _m.isinf(p):
            return torch.amax(torch.abs(d), -1)
        return torch.sum(torch.abs(d) ** p, -1) ** (1.0 / p)
    return apply(f, x, y, op_name="cdist")


_export("cdist", cdist)


def multiplex(inputs, index):
    """Row-wise select among candidate tensors."""
    def f(idx, *cands):
        stacked = torch.stack(cands, 0)             # [C, B, ...]
        sel = idx.reshape(-1).to(torch.int64)
        rows = torch.arange(stacked.shape[1], device=stacked.device)
        return stacked[sel, rows]
    return apply(f, index, *inputs, op_name="multiplex")


_export("multiplex", multiplex)


def nanmedian(x, axis=None, keepdim=False):
    return apply(lambda v: _quant(v, 0.5, _axis_arg(axis), keepdim, True),
                 x, op_name="nanmedian")


_export("nanmedian", nanmedian)


def nanquantile(x, q, axis=None, keepdim=False):
    return apply(lambda v: _quant(v, q, _axis_arg(axis), keepdim, True),
                 x, op_name="nanquantile")


_export("nanquantile", nanquantile)


def isin(x, test_x, assume_unique=False, invert=False):
    return apply(lambda a, b: torch.isin(a, b, invert=invert), x, test_x,
                 op_name="isin")


_export("isin", isin)


def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return apply(lambda v, seq: torch.searchsorted(
        seq, v, right=right, out_int32=out_int32), x, sorted_sequence,
        op_name="bucketize")


_export("bucketize", bucketize)


def digitize(x, bins, right=False):
    """numpy's digitize over increasing ``bins`` (int32, as jnp's)."""
    return apply(lambda v, b: torch.searchsorted(
        b, v, right=not right).to(torch.int32), x, bins, op_name="digitize")


_export("digitize", digitize)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None):
    def f(v, *w):
        dev = v.device
        h, edges = torch.histogramdd(
            v.cpu(), bins=bins, range=None if ranges is None
            else [float(r) for r in ranges], density=density,
            weight=w[0].cpu() if w else None)
        if not w and not density:
            h = h.to(torch.int64)
        return (h.to(dev), *[e.to(dev) for e in edges])
    if weights is not None:
        return apply(f, x, weights, op_name="histogramdd")
    return apply(f, x, op_name="histogramdd")


_export("histogramdd", histogramdd)


def vander(x, n=None, increasing=False):
    def f(v):
        k = torch.arange(v.shape[-1] if n is None else n, device=v.device)
        if not increasing:
            k = k.flip(0)
        return torch.pow(v.unsqueeze(-1), k.to(v.dtype))
    return apply(f, x, op_name="vander")


_export("vander", vander)


def tensordot(x, y, axes=2):
    ax = axes
    if isinstance(ax, (list, tuple)):
        ax = [list(a) if isinstance(a, (list, tuple)) else [a] for a in ax]

    def f(a, b):
        a, b = _promoted(a, b, scalars=False)
        return torch.tensordot(a, b, dims=ax)
    return apply(f, x, y, op_name="tensordot")


_export("tensordot", tensordot)
