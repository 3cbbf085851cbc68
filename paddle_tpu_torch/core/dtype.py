"""Dtype registry.

Counterpart of ``paddle_tpu/core/dtype.py``: the dtype names are
``torch.dtype``s, and strings are accepted everywhere. The JAX package
runs with x64 on, so its promotion rules (a Python float with an integer
tensor gives float64, ``mean`` of int64 gives float64, ...) are written
down here once, for the op library to follow rather than torch's.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "set_default_dtype", "get_default_dtype", "convert_dtype",
           "dtype_name", "is_floating", "is_complex", "is_integer",
           "is_differentiable"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "float32": float32, "float64": float64,
    "complex64": complex64, "complex128": complex128,
    "fp16": float16, "bf16": bfloat16, "fp32": float32, "fp64": float64,
}
_NP2DTYPE = {np.dtype(k): v for k, v in _STR2DTYPE.items()
             if k not in ("bfloat16", "fp16", "bf16", "fp32", "fp64")}

_default_dtype = torch.float32


def set_default_dtype(d):
    global _default_dtype
    _default_dtype = convert_dtype(d)


def get_default_dtype():
    return _default_dtype


def convert_dtype(d):
    """Normalise a string, numpy dtype, numpy scalar type or torch.dtype to
    a torch.dtype (None stays None)."""
    if d is None or isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        if d not in _STR2DTYPE:
            raise TypeError(f"unsupported dtype string: {d!r}")
        return _STR2DTYPE[d]
    if d is bool:
        return bool_
    if d is int:
        return int64
    if d is float:
        return float64
    try:
        nd = np.dtype(d)
    except TypeError as e:
        raise TypeError(f"unsupported dtype: {d!r}") from e
    if nd.name == "bfloat16":
        return bfloat16
    if nd not in _NP2DTYPE:
        raise TypeError(f"unsupported dtype: {d!r}")
    return _NP2DTYPE[nd]


def dtype_name(d) -> str:
    """The dtype's name as numpy spells it: ``float32``, ``bool``, ..."""
    return str(convert_dtype(d)).replace("torch.", "")


def is_floating(d) -> bool:
    return convert_dtype(d).is_floating_point


def is_complex(d) -> bool:
    return convert_dtype(d).is_complex


def is_integer(d) -> bool:
    d = convert_dtype(d)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


def is_differentiable(d) -> bool:
    return is_floating(d) or is_complex(d)


def to_inexact(d: torch.dtype) -> torch.dtype:
    """The dtype a float-valued function of ``d`` returns under the JAX
    package's rules: floats and complexes stay, int64 gives float64, the
    narrower integers and bool give float32."""
    if d.is_floating_point or d.is_complex:
        return d
    return float64 if d == int64 else float32


def sum_dtype(d: torch.dtype) -> torch.dtype:
    """The dtype ``sum``/``prod`` return for ``d``: integers and bool
    widen to int64 (as the JAX package, and numpy, do)."""
    return int64 if (d == bool_ or is_integer(d)) else d


def result_type(*xs) -> torch.dtype:
    """The JAX package's result dtype of an elementwise op over tensors
    and Python scalars. Tensors (0-d ones too) promote as torch promotes
    two tensors; a Python scalar is weak: a bool changes nothing, an int
    lifts bool to int64, a float lifts bool and integers to float64 (x64),
    a complex lifts reals to complex128."""
    dt = None
    weak = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            dt = x.dtype if dt is None else torch.promote_types(dt, x.dtype)
        elif isinstance(x, np.ndarray) or isinstance(x, np.generic):
            nd = convert_dtype(x.dtype)
            dt = nd if dt is None else torch.promote_types(dt, nd)
        elif x is not None:
            weak.append(x)
    if dt is None:
        dt = torch.tensor(weak[0]).dtype if weak else _default_dtype
        if dt == torch.float32:
            dt = _default_dtype
        weak = weak[1:]
    for w in weak:
        if isinstance(w, bool):
            continue
        if isinstance(w, int):
            if dt == bool_:
                dt = int64
        elif isinstance(w, float):
            if not (dt.is_floating_point or dt.is_complex):
                dt = float64
        elif isinstance(w, complex):
            if not dt.is_complex:
                dt = complex64 if dt in (float32, float16, bfloat16) \
                    else complex128
    return dt
