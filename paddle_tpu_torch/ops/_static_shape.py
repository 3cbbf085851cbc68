"""Trace-time constants for shape, axis and size arguments.

Counterpart of ``paddle_tpu/ops/_static_shape.py``. The Paddle API takes
tensors for shapes, axes, split sizes and top-k counts; an op turns them
into Python numbers here, in one place, with the two cases explicit:

- a concrete tensor (on the CPU or the card) syncs, by contract: turning
  it into a Python int is what a shape argument means;
- a tensor without values (a static ``Variable`` on the meta device, or a
  FakeTensor of a ``torch.export`` trace) cannot become a Python number:
  these helpers raise a ``TypeError`` naming the argument, instead of the
  meta device's or the tracer's own error three layers down.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["static_scalar", "static_int", "static_int_list"]


def _concrete(v, what: str):
    """``v`` if it has values; a meta or fake tensor raises."""
    if isinstance(v, torch.Tensor):
        from torch._subclasses.fake_tensor import is_fake
        if getattr(v, "_pt_symbolic", False) or v.device.type == "meta" \
                or is_fake(v):
            raise TypeError(
                f"{what} must be a trace-time constant, got a tensor "
                f"without values of shape {list(v.shape)}; pass a python "
                f"int (or a concrete tensor): a data-dependent {what} "
                f"cannot become a static shape")
    return v


def static_scalar(v, what: str = "size"):
    """A Python scalar (int stays int, float stays float) from a number or
    a concrete 0-d tensor: the arange/linspace start/stop/step contract."""
    if isinstance(v, (bool, int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    v = _concrete(v, what)
    if isinstance(v, torch.Tensor):
        return v.item()
    return np.asarray(v).item()


def static_int(v, what: str = "size") -> int:
    """A Python int from a number or a concrete 0-d tensor (axis, k,
    dim...)."""
    return int(static_scalar(v, what))


def static_int_list(xs, what: str = "shape") -> list:
    """A list of Python ints from an int-vector tensor or a sequence whose
    elements may themselves be 0-d tensors (Paddle shape lists)."""
    if isinstance(xs, torch.Tensor):
        return [int(x) for x in _concrete(xs, what).reshape(-1).tolist()]
    if hasattr(xs, "ndim"):
        return [int(x) for x in np.asarray(xs).reshape(-1)]
    return [static_int(x, what) for x in xs]
