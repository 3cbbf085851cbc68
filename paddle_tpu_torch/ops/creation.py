"""Tensor creation ops (counterpart of ``paddle_tpu/ops/creation.py``).

Every op that makes a tensor from nothing (``to_tensor``, ``zeros``,
``arange``, ...) puts it on ``resolve_device(place)``: the card unless
``place`` (keyword-only, port-only) or ``set_device`` names the CPU; the
JAX ``to_tensor`` has one logical device and ignores its ``place``. The
``*_like`` ops keep their input's device. dtypes as the JAX package's:
Python floats become the default float, Python ints int64, numpy arrays
keep theirs.
"""
from __future__ import annotations

import math as _m

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.device import resolve_device
from ..core.tensor import Parameter, Tensor, as_torch
from ._static_shape import static_int, static_int_list, static_scalar
from .dispatch import apply

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "arange", "linspace",
    "logspace", "eye", "zeros_like", "ones_like", "full_like", "empty_like",
    "tril", "triu", "diag", "diagflat", "meshgrid", "assign", "clone",
    "tril_indices", "triu_indices", "complex", "as_tensor",
]


def _norm_shape(shape):
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    if isinstance(shape, torch.Tensor) and shape.dim() == 0:
        return (static_int(shape, "shape"),)
    return tuple(static_int_list(shape, "shape"))


def _dt(dtype):
    return dtypes.convert_dtype(dtype) if dtype is not None \
        else dtypes.get_default_dtype()


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new ``Tensor`` of ``data`` on ``place`` (default: the card)."""
    dev = resolve_device(place)
    dt = dtypes.convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        return Tensor(data.detach().to(device=dev, dtype=dt),
                      stop_gradient=stop_gradient)
    arr = np.asarray(data)
    if dt is None and not isinstance(data, (np.ndarray, np.generic)):
        # Paddle's defaults: Python floats -> the default float dtype
        if arr.dtype == np.float64:
            dt = dtypes.get_default_dtype()
        elif arr.dtype == np.int32:
            arr = arr.astype(np.int64)
    return Tensor(as_torch(arr, dtype=dt, device=dev),
                  stop_gradient=stop_gradient)


as_tensor = to_tensor


def zeros(shape, dtype=None, *, place=None):
    return Tensor(torch.zeros(_norm_shape(shape), dtype=_dt(dtype),
                              device=resolve_device(place)))


def ones(shape, dtype=None, *, place=None):
    return Tensor(torch.ones(_norm_shape(shape), dtype=_dt(dtype),
                             device=resolve_device(place)))


def full(shape, fill_value, dtype=None, *, place=None):
    dev = resolve_device(place)
    dt = dtypes.convert_dtype(dtype) if dtype else dtypes.get_default_dtype()
    if isinstance(fill_value, torch.Tensor):
        return Tensor(fill_value.to(device=dev, dtype=dt).expand(
            _norm_shape(shape)).clone())
    return Tensor(torch.full(_norm_shape(shape), fill_value, dtype=dt,
                             device=dev))


def empty(shape, dtype=None, *, place=None):
    return zeros(shape, dtype, place=place)


def _scalar(v, what: str = "size"):
    return static_scalar(v, what) if isinstance(v, torch.Tensor) else v


def arange(start=0, end=None, step=1, dtype=None, *, place=None):
    start, end, step = (_scalar(start, "arange start"),
                        _scalar(end, "arange end"),
                        _scalar(step, "arange step"))
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = (torch.int64 if all(isinstance(x, (int, np.integer))
                                    for x in (start, end, step))
                 else dtypes.get_default_dtype())
    else:
        dtype = dtypes.convert_dtype(dtype)
    n = max(int(_m.ceil((end - start) / step)), 0)
    dev = resolve_device(place)
    if dtype.is_floating_point:
        # start + i * step in float64, then cast (jnp.arange's values)
        out = start + torch.arange(n, dtype=torch.float64, device=dev) * step
        return Tensor(out.to(dtype))
    return Tensor(torch.arange(start, end, step, dtype=dtype, device=dev))


def linspace(start, stop, num, dtype=None, *, place=None):
    dt = dtypes.convert_dtype(dtype) if dtype else dtypes.get_default_dtype()
    return Tensor(torch.linspace(float(_scalar(start, "linspace start")),
                                 float(_scalar(stop, "linspace stop")),
                                 int(num), dtype=torch.float64,
                                 device=resolve_device(place)).to(dt))


def logspace(start, stop, num, base=10.0, dtype=None, *, place=None):
    dt = dtypes.convert_dtype(dtype) if dtype else dtypes.get_default_dtype()
    return Tensor(torch.logspace(float(start), float(stop), int(num),
                                 base=float(base), dtype=torch.float64,
                                 device=resolve_device(place)).to(dt))


def eye(num_rows, num_columns=None, dtype=None, *, place=None):
    dt = dtypes.convert_dtype(dtype) if dtype else dtypes.get_default_dtype()
    return Tensor(torch.eye(int(num_rows), int(num_rows) if num_columns is None
                            else int(num_columns), dtype=dt,
                            device=resolve_device(place)))


def _like(x):
    return x if isinstance(x, torch.Tensor) else as_torch(x)


def zeros_like(x, dtype=None):
    return Tensor(torch.zeros_like(_like(x), dtype=dtypes.convert_dtype(
        dtype) if dtype else None))


def ones_like(x, dtype=None):
    return Tensor(torch.ones_like(_like(x), dtype=dtypes.convert_dtype(
        dtype) if dtype else None))


def full_like(x, fill_value, dtype=None):
    return Tensor(torch.full_like(_like(x), fill_value,
                                  dtype=dtypes.convert_dtype(dtype)
                                  if dtype else None))


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def tril(x, diagonal=0):
    return apply(lambda v: torch.tril(v, int(diagonal)), x, op_name="tril")


def triu(x, diagonal=0):
    return apply(lambda v: torch.triu(v, int(diagonal)), x, op_name="triu")


def diag(x, offset=0, padding_value=0):
    def f(v):
        d = torch.diag(v, int(offset))
        if v.dim() == 1 and padding_value != 0:
            mask = torch.diag(torch.ones(v.shape[0], dtype=torch.bool,
                                         device=v.device), int(offset))
            d = torch.where(mask, d, torch.full((), padding_value,
                                                dtype=v.dtype,
                                                device=v.device))
        return d
    return apply(f, x, op_name="diag")


def diagflat(x, offset=0):
    return apply(lambda v: torch.diagflat(v, int(offset)), x,
                 op_name="diagflat")


def meshgrid(*args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    vals = [_like(a) for a in args]
    return [Tensor(o) if not isinstance(o, Tensor) else o
            for o in torch.meshgrid(*vals, indexing="ij")]


def assign(x, output=None):
    v = _like(x)
    if output is not None:
        with torch.no_grad():
            output.copy_(v.to(output.device))
        return output
    return apply(torch.clone, x if isinstance(x, Tensor) else Tensor(v),
                 op_name="assign")


def clone(x):
    return apply(torch.clone, x, op_name="clone")


def _index_pairs(fn, row, col, offset, place):
    col = row if col is None else col
    r, c = fn(int(row), int(offset), int(col))
    return Tensor(torch.from_numpy(np.stack([r, c]).astype(np.int64)).to(
        resolve_device(place)))


def tril_indices(row, col=None, offset=0, *, place=None):
    return _index_pairs(np.tril_indices, row, col, offset, place)


def triu_indices(row, col=None, offset=0, *, place=None):
    return _index_pairs(np.triu_indices, row, col, offset, place)


def complex(real, imag):
    return apply(torch.complex, real, imag, op_name="complex")


# ---------- static-world creation helpers and TensorArray ----------

def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None,
                  *, place=None):
    return full(shape, value, dtype=dtype, place=place)


def create_tensor(dtype, name=None, persistable=False, *, place=None):
    return Tensor(torch.zeros((0,), dtype=dtypes.convert_dtype(dtype),
                              device=resolve_device(place)))


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None, *, place=None):
    p = Parameter(torch.full(_norm_shape(shape), value,
                             dtype=dtypes.convert_dtype(dtype),
                             device=resolve_device(place)), name=name)
    p.persistable = persistable
    return p


def _fans(shape):
    if len(shape) < 2:
        return shape[0] if shape else 1, shape[0] if shape else 1
    rf = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[0] * rf, shape[1] * rf


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None, *, place=None):
    """A ``Parameter`` on ``place`` (default: the card): zeros for a bias,
    else XavierNormal (std sqrt(2 / (fan_in + fan_out)) over Paddle's
    ``[in, out]`` layout) from the device's default generator, unless
    ``default_initializer`` (a callable on the parameter) is given."""
    from ..core.generator import default_generator
    shp = _norm_shape(shape)
    dev = resolve_device(place)
    p = Parameter(torch.zeros(shp, dtype=dtypes.convert_dtype(dtype),
                              device=dev), name=name)
    init = default_initializer or getattr(attr, "initializer", None)
    if init is not None:
        init(p)
    elif not is_bias:
        fi, fo = _fans(shp)
        with torch.no_grad():
            p.copy_(torch.randn(shp, generator=default_generator(dev)
                                .generator, device=dev,
                                dtype=torch.float32)
                    * _m.sqrt(2.0 / (fi + fo)))
    return p


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None, *,
             place=None):
    from . import random as _random
    out = _random.randn(_norm_shape(shape), place=place)
    dt = dtypes.convert_dtype(dtype) if dtype else out.dtype
    return (out * std + mean).to(dt)


def create_array(dtype="float32", initialized_list=None):
    """TensorArray: a Python list of Tensors."""
    arr = list(initialized_list) if initialized_list is not None else []
    return [a if isinstance(a, Tensor) else to_tensor(a) for a in arr]


def array_length(array):
    dev = array[0].device if array else resolve_device(None)
    return Tensor(torch.full((), len(array), dtype=torch.int64, device=dev))


def _idx_of(i):
    return int(i)


def array_read(array, i):
    return array[_idx_of(i)]


def array_write(x, i, array=None):
    if array is None:
        array = []
    i = _idx_of(i)
    if i < len(array):
        array[i] = x
    else:
        while len(array) < i:
            array.append(zeros_like(x))
        array.append(x)
    return array


def tensor_array_to_tensor(array, axis=0, use_stack=False, name=None):
    from . import manip as _manip
    out = _manip.stack(array, axis=axis) if use_stack \
        else _manip.concat(array, axis=axis)
    sizes = [1 if use_stack else a.shape[axis] for a in array]
    return out, Tensor(torch.tensor(sizes, dtype=torch.int64,
                                    device=out.device))


__all__ += ["fill_constant", "create_tensor", "create_global_var",
            "create_parameter", "gaussian", "create_array", "array_length",
            "array_read", "array_write", "tensor_array_to_tensor"]
