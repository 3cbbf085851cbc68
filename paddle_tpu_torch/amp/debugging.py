"""Numeric debugging: counterpart of ``paddle_tpu/amp/debugging.py``.

``check_numerics(tensor)`` counts one tensor's nan, inf and zero
elements; ``enable_tensor_checker()`` / ``disable_tensor_checker()`` set
``FLAGS_check_nan_inf``, which makes every op of the dispatch raise on the
first nan/inf it outputs; ``collect_operator_stats()`` counts the ops
dispatched inside it, and (port-only) the dtypes of their outputs.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor, as_torch
from ..ops import dispatch
from ..utils import flags

__all__ = ["DebugMode", "enable_tensor_checker", "disable_tensor_checker",
           "check_numerics", "collect_operator_stats"]


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


def enable_tensor_checker(checker_config=None):
    flags.set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    flags.set_flags({"FLAGS_check_nan_inf": False})


def check_numerics(tensor, op_type: str = "tensor", var_name: str = "",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """``(num_nan, num_inf, num_zero)`` as 0-d int64 tensors; raises on a
    nan or inf with ``CHECK_NAN_INF_AND_ABORT``."""
    val = tensor if isinstance(tensor, torch.Tensor) else as_torch(tensor)
    num_zero = (val == 0).sum()
    if not val.is_floating_point():
        z = torch.zeros((), dtype=torch.int64, device=val.device)
        return Tensor(z), Tensor(z), Tensor(num_zero)
    num_nan = torch.isnan(val).sum()
    num_inf = torch.isinf(val).sum()
    if debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT and \
            int(num_nan) + int(num_inf) > 0:
        raise FloatingPointError(
            f"{op_type} {var_name or ''}: found {int(num_nan)} nan, "
            f"{int(num_inf)} inf in tensor of shape {list(val.shape)}")
    return Tensor(num_nan), Tensor(num_inf), Tensor(num_zero)


def collect_operator_stats():
    """Context manager: ``stats[name]`` counts the ops dispatched inside
    it; ``dtypes[name]`` maps each output dtype's name to its count."""
    return _OpStats()


class _OpStats:
    def __init__(self):
        self.stats = {}
        self.dtypes = {}

    def __enter__(self):
        self._prev = dispatch._profile_cb
        self._prev_stats = dispatch._stats_cb

        def cb(name, t0, t1):
            self.stats[name] = self.stats.get(name, 0) + 1
            if self._prev is not None:
                self._prev(name, t0, t1)

        def stats(name, out):
            o = out[0] if isinstance(out, (tuple, list)) and out else out
            if isinstance(o, torch.Tensor):
                d = self.dtypes.setdefault(name, {})
                k = str(o.dtype).replace("torch.", "")
                d[k] = d.get(k, 0) + 1
            if self._prev_stats is not None:
                self._prev_stats(name, out)
        dispatch.set_profile_cb(cb)
        dispatch.set_stats_recorder(stats)
        return self

    def __exit__(self, *exc):
        dispatch.set_profile_cb(self._prev)
        dispatch.set_stats_recorder(self._prev_stats)
        return False
