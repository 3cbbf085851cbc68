"""Op dispatch: the amp cast, the nan/inf check and the hooks every op of
the library runs through.

Counterpart of ``paddle_tpu/ops/dispatch.py``. ``apply(fn, *args,
op_name=..., **static_kwargs)`` runs the torch function ``fn`` after the
cast ``amp.auto_cast`` chooses for ``op_name`` (``amp_dtype_for``); a
failure is re-raised naming the op and its inputs' dtypes and shapes.
With amp, the nan/inf check and every hook off it is one direct call.

What the JAX module also holds, and where it went:

- ``GradNode`` and the vjp tape: torch's autograd engine records every
  op (``grad_fn``), so ``apply`` records nothing itself.
- ``set_static_recorder``: ``static.enable_static()`` installs the
  Program recorder here; ``apply`` consults it first, before its fast
  path, the amp cast and every hook, as the JAX ``apply`` does.
- ``set_capture_recorder``: the capture tier (``jit/capture.py``) keeps
  its own record of a captured step (a ``TorchDispatchMode`` over the
  warm-up), so no hook is needed here.
- ``cache_info`` and the compiled-op cache: eager torch ops launch
  kernels directly; there is no per-op executable to memoise.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from ..amp.auto_cast import amp_dtype_for as _amp_dtype_for
from ..amp.auto_cast import amp_state as _amp_state_of

__all__ = ["apply", "defprim", "set_profile_cb", "set_coverage_recorder",
           "set_nan_check", "set_stats_recorder", "set_static_recorder"]

_amp_state = _amp_state_of()

# observability hooks: _profile_cb(name, t0_ns, t1_ns) around every op,
# _coverage_cb(name) before it, _stats_cb(name, out) after it; _nan_check
# from FLAGS_check_nan_inf scans every floating output
_profile_cb = None
_coverage_cb = None
_stats_cb = None
_nan_check = False
# static mode: _static_recorder(fn, args, kwargs, name, amp_dtype) appends
# an op touching a Variable to the current Program (NotImplemented: eager)
_static_recorder = None
_quiet = True          # all of the above off: apply is one direct call

_WRAP = (TypeError, ValueError, IndexError, RuntimeError)


def _recompute_quiet():
    global _quiet
    _quiet = (_profile_cb is None and _coverage_cb is None
              and _stats_cb is None and not _nan_check
              and _static_recorder is None)


def set_static_recorder(fn):
    """``fn(op_fn, args, static_kwargs, name, amp_dtype)`` before every op
    (``static.enable_static`` installs the Program recorder); it returns
    the op's symbolic result, or NotImplemented to run the op eagerly."""
    global _static_recorder
    _static_recorder = fn
    _recompute_quiet()


def set_profile_cb(cb):
    global _profile_cb
    _profile_cb = cb
    _recompute_quiet()


def set_coverage_recorder(cb):
    global _coverage_cb
    _coverage_cb = cb
    _recompute_quiet()


def set_stats_recorder(cb):
    """``cb(name, out)`` after every op (``amp.debugging``'s operator
    stats read the output dtypes through it)."""
    global _stats_cb
    _stats_cb = cb
    _recompute_quiet()


def set_nan_check(on: bool):
    global _nan_check
    _nan_check = bool(on)
    _recompute_quiet()


def _outs(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def _scan_nan_inf(out, name):
    for o in _outs(out):
        if not isinstance(o, torch.Tensor) or not o.is_floating_point():
            continue
        bad = o.numel() - int(torch.isfinite(o).sum())
        if bad:
            raise FloatingPointError(
                f"Operator {name!r} produced {bad} nan/inf element(s) "
                f"in output of shape {list(o.shape)} "
                f"(FLAGS_check_nan_inf is enabled)")


def _sig(v):
    try:
        if isinstance(v, torch.Tensor):
            return f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}"
        return repr(v)[:40]
    except Exception:  # noqa: BLE001 — diagnostics must never raise
        return "<unprintable>"


def _op_error(name, vals, exc):
    """Re-raise an op's failure naming the op and its inputs, the
    original chained (the JAX package's enforce-style message)."""
    ins = ", ".join(_sig(v) for v in vals)
    msg = (f"(InvalidArgument) operator {name!r} failed on inputs ({ins}): "
           f"{exc}")
    try:
        wrapped = type(exc)(msg)
    except Exception:  # noqa: BLE001 — exc type with a custom constructor
        wrapped = ValueError(msg)
    raise wrapped from exc


def _cast(args, dt):
    return [a.to(dt) if isinstance(a, torch.Tensor) and a.is_floating_point()
            and a.dtype != dt else a for a in args]


def apply(fn: Callable, *args, op_name: str | None = None, **static_kwargs):
    """``fn(*args, **static_kwargs)`` under the amp cast for ``op_name``
    (of its positional floating tensors), the hooks and the nan/inf
    check."""
    if _quiet and not _amp_state.enabled:
        try:
            return fn(*args, **static_kwargs)
        except _WRAP as e:
            if type(e) not in _WRAP:
                raise
            _op_error(op_name or getattr(fn, "__name__", "op"), args, e)
    name = op_name or getattr(fn, "__name__", "op")
    if _static_recorder is not None:
        dt = _amp_dtype_for(name) if _amp_state.enabled else None
        out = _static_recorder(fn, args, static_kwargs, name, dt)
        if out is not NotImplemented:
            return out
    if _coverage_cb is not None:
        _coverage_cb(name)
    if _amp_state.enabled:
        dt = _amp_dtype_for(name)
        if dt is not None:
            args = _cast(args, dt)
    prof = _profile_cb
    if prof is not None:
        t0 = time.perf_counter_ns()
    try:
        out = fn(*args, **static_kwargs)
    except _WRAP as e:
        if type(e) not in _WRAP:
            raise
        _op_error(name, args, e)
    if prof is not None:
        prof(name, t0, time.perf_counter_ns())
    if _stats_cb is not None:
        _stats_cb(name, out)
    if _nan_check:
        _scan_nan_inf(out, name)
    return out


def defprim(fn: Callable, op_name: str | None = None):
    """Lift a torch function into an op of the library."""
    name = op_name or getattr(fn, "__name__", "op")

    def op(*args, **kwargs):
        return apply(fn, *args, op_name=name, **kwargs)

    op.__name__ = name
    return op


# seed the nan/inf check from FLAGS_check_nan_inf (env or default)
from ..utils import flags as _flags  # noqa: E402
set_nan_check(bool(_flags.flag("FLAGS_check_nan_inf")))
