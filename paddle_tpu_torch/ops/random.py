"""Random sampling ops (counterpart of ``paddle_tpu/ops/random.py``).

Each op draws from ``key`` (a ``torch.Generator``) or, without one, from
the default generator of its device (``core.generator``), the one
``seed`` seeds; a creation op's device is ``resolve_device(place)``. The
values cannot equal the JAX key streams: tests hold shapes, dtypes,
moments and reproducibility under ``seed``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.device import resolve_device
from ..core.generator import default_generator
from ._static_shape import static_int, static_int_list
from ..core.tensor import Tensor
from .dispatch import apply

__all__ = [
    "rand", "randn", "randint", "randint_like", "uniform", "normal",
    "standard_normal", "poisson", "bernoulli", "multinomial", "randperm",
    "exponential_", "uniform_", "normal_", "gumbel_softmax",
]


def _shape(shape):
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    if isinstance(shape, torch.Tensor) and shape.dim() == 0:
        return (static_int(shape, "shape"),)
    return tuple(static_int_list(shape, "shape"))


def _dt(dtype):
    return dtypes.convert_dtype(dtype) if dtype is not None \
        else dtypes.get_default_dtype()


def _gen(key, dev):
    return key if key is not None else default_generator(dev).generator


def _draw(fn, shape, dtype, key, place, **kw):
    dev = resolve_device(place)
    dt = _dt(dtype)
    wide = dt if dt in (torch.float32, torch.float64) else torch.float32
    out = fn(_shape(shape), generator=_gen(key, dev), device=dev, dtype=wide,
             **kw)
    return Tensor(out.to(dt))


def rand(shape, dtype=None, name=None, key=None, *, place=None):
    return _draw(torch.rand, shape, dtype, key, place)


def randn(shape, dtype=None, name=None, key=None, *, place=None):
    return _draw(torch.randn, shape, dtype, key, place)


standard_normal = randn


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None,
            key=None, *, place=None):
    if high is None:
        low, high = 0, low
    dev = resolve_device(place)
    return Tensor(torch.randint(int(low), int(high), _shape(shape),
                                generator=_gen(key, dev), device=dev,
                                dtype=dtypes.convert_dtype(dtype)))


def randint_like(x, low=0, high=None, dtype=None):
    return randint(low, high, x.shape, dtype or x.dtype, place=x.device)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None,
            key=None, *, place=None):
    u = _draw(torch.rand, shape, "float64" if _dt(dtype) == torch.float64
              else "float32", key, place)
    return Tensor((u * (float(max) - float(min)) + float(min)).to(_dt(dtype)))


def normal(mean=0.0, std=1.0, shape=None, name=None, key=None, *,
           place=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        ref = mean if isinstance(mean, torch.Tensor) else std
        out_shape = torch.broadcast_shapes(tuple(np.shape(mean)) if not
                                           isinstance(mean, torch.Tensor)
                                           else tuple(mean.shape),
                                           tuple(np.shape(std)) if not
                                           isinstance(std, torch.Tensor)
                                           else tuple(std.shape))
        eps = torch.randn(out_shape, generator=_gen(key, ref.device),
                          device=ref.device,
                          dtype=dtypes.get_default_dtype())
        return Tensor(mean + std * eps)
    eps = _draw(torch.randn, shape, None, key, place)
    return Tensor(mean + std * eps)


def poisson(x, name=None, key=None):
    return Tensor(torch.poisson(x, generator=_gen(key, x.device)).to(x.dtype))


def bernoulli(x, name=None, key=None):
    return Tensor(torch.bernoulli(x, generator=_gen(key, x.device))
                  .to(x.dtype))


def multinomial(x, num_samples=1, replacement=False, name=None, key=None):
    return Tensor(torch.multinomial(x, int(num_samples), replacement,
                                    generator=_gen(key, x.device)))


def randperm(n, dtype="int64", name=None, key=None, *, place=None):
    dev = resolve_device(place)
    return Tensor(torch.randperm(int(n), generator=_gen(key, dev),
                                 device=dev).to(dtypes.convert_dtype(dtype)))


def uniform_(x, min=-1.0, max=1.0):
    with torch.no_grad():
        x.uniform_(min, max, generator=_gen(None, x.device))
    return x


def normal_(x, mean=0.0, std=1.0):
    with torch.no_grad():
        x.normal_(mean, std, generator=_gen(None, x.device))
    return x


def exponential_(x, lam=1.0, name=None, key=None):
    with torch.no_grad():
        x.exponential_(lam, generator=_gen(key, x.device))
    return x


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, key=None):
    g = -torch.log(-torch.log(torch.rand(
        x.shape, generator=_gen(key, x.device), device=x.device,
        dtype=torch.float32).clamp_min(torch.finfo(torch.float32).tiny))
        .clamp_min(torch.finfo(torch.float32).tiny))

    def f(v):
        y = torch.softmax((v + g.to(v.dtype)) / temperature, dim=axis)
        if hard:
            idx = torch.argmax(y, dim=axis, keepdim=True)
            oh = torch.zeros_like(y).scatter(axis, idx, 1.0)
            y = oh + y - y.detach()
        return y
    return apply(f, x, op_name="gumbel_softmax")
