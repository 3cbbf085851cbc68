"""``save`` / ``load`` (counterpart of ``paddle_tpu/framework_io.py``).

Tensors are pickled as numpy arrays (bfloat16 as float32 with its dtype
noted, numpy having none) inside nested dicts, lists and tuples, so a
state dict or an optimizer state round-trips; ``load`` puts tensors on
``place`` (default: the card) as port ``Tensor``s or ``Parameter``s, or
returns the arrays with ``return_numpy``.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .core import dtype as dtypes
from .core.tensor import Parameter, Tensor

__all__ = ["save", "load"]


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return {"__tensor__": True,
                "data": (t.float() if t.dtype == torch.bfloat16 else t)
                .numpy(), "dtype": dtypes.dtype_name(t.dtype),
                "stop_gradient": not obj.requires_grad,
                "param": isinstance(obj, torch.nn.Parameter)}
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy=False, place=None):
    if isinstance(obj, dict):
        if obj.get("__tensor__") is True:
            if return_numpy:
                return obj["data"]
            data = torch.from_numpy(np.asarray(obj["data"])).to(
                dtypes.convert_dtype(obj.get("dtype", obj["data"].dtype)))
            if obj.get("param"):
                p = Parameter(data, place=place)
                p.stop_gradient = obj.get("stop_gradient", False)
                return p
            return Tensor(data, stop_gradient=obj.get("stop_gradient", True),
                          place=place)
        return {k: _unpack(v, return_numpy, place) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy, place) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, return_numpy=False, *, place=None, **configs):
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _unpack(obj, return_numpy, place)
