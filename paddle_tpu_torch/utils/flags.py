"""Global flag registry (``set_flags`` / ``get_flags``).

Counterpart of ``paddle_tpu/utils/flags.py``: a process-global registry
seeded from ``FLAGS_*`` environment variables; each flag's default fixes
its type. ``FLAGS_check_nan_inf`` switches the op dispatch's nan/inf
scan. The JAX package keeps the values in its native registry; the
port's native runtime has none, so they live here.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

__all__ = ["define_flag", "set_flags", "get_flags", "flag"]

_lock = threading.Lock()
_TYPES: Dict[str, type] = {}
_VALUES: Dict[str, str] = {}


def _parse(name: str, raw: str):
    ty = _TYPES.get(name, str)
    if ty is bool:
        return raw.lower() in ("1", "true", "yes")
    return ty(raw)


def define_flag(name: str, default, help_: str = ""):
    env = os.environ.get(name)
    raw = env if env is not None else str(default)
    with _lock:
        _TYPES[name] = type(default)
        _VALUES[name] = raw
    return _parse(name, raw)


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        if k not in _TYPES:
            raise KeyError(f"unknown flag {k!r}")
        with _lock:
            _VALUES[k] = str(v)
        _notify(k)


def _notify(name: str):
    """Push side-effectful flags into their fast-path globals."""
    if name == "FLAGS_check_nan_inf":
        from ..ops import dispatch
        dispatch.set_nan_check(flag(name))


def get_flags(names):
    if isinstance(names, str):
        names = [names]
    out = {}
    for n in names:
        if n not in _TYPES:
            raise KeyError(f"unknown flag {n!r}")
        out[n] = _parse(n, _VALUES[n])
    return out


def flag(name: str):
    raw = _VALUES.get(name)
    return None if raw is None else _parse(name, raw)


define_flag("FLAGS_check_nan_inf", False,
            "scan outputs for nan/inf after each op")
define_flag("FLAGS_use_bf16_matmul", True,
            "prefer bf16 matmul accumulation under AMP")
define_flag("FLAGS_allocator_strategy", "auto_growth",
            "torch's caching allocator")
define_flag("FLAGS_log_level", "info", "framework log level")
define_flag("FLAGS_host_trace_level", 1, "host tracer verbosity (profiler)")
define_flag("FLAGS_benchmark", False, "per-iteration timing logs")
