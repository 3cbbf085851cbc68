"""Paddle's ``utils`` helpers: counterpart of
``paddle_tpu/utils/compat.py`` (the deprecation decorator, the version
gate and the lazy import)."""
from __future__ import annotations

import functools
import importlib
import warnings

__all__ = ["deprecated", "require_version", "try_import"]


def deprecated(update_to="", since="", reason="", level=0):
    """Mark an API deprecated: a call warns (``DeprecationWarning``;
    levels 0 and 1) or raises RuntimeError (level 2); the docstring says
    so."""

    def decorator(func):
        msg = f"API '{func.__module__}.{func.__name__}' is deprecated"
        if since:
            msg += f" since {since}"
        if update_to:
            msg += f"; use '{update_to}' instead"
        if reason:
            msg += f" ({reason})"

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            if level == 2:
                raise RuntimeError(msg)
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return func(*args, **kwargs)

        wrapper.__doc__ = (func.__doc__ or "") + f"\n\n.. deprecated:: {msg}"
        return wrapper
    return decorator


def _ver_tuple(v: str):
    parts = []
    for p in v.split("."):
        try:
            parts.append(int(p))
        except ValueError:
            break
    return tuple(parts)


def require_version(min_version: str, max_version: str | None = None):
    """Raise unless the package's ``__version__`` lies in ``[min_version,
    max_version]``."""
    from .. import __version__ as cur  # noqa: PLC0415
    cv = _ver_tuple(cur)
    if cv < _ver_tuple(min_version):
        raise Exception(
            f"installed version {cur} < required minimum {min_version}")
    if max_version is not None and cv > _ver_tuple(max_version):
        raise Exception(
            f"installed version {cur} > allowed maximum {max_version}")


def try_import(module_name: str, err_msg: str | None = None):
    """Import ``module_name``, raising ImportError with ``err_msg`` (or a
    message naming the module) when it is not installed."""
    try:
        return importlib.import_module(module_name)
    except ImportError as e:
        raise ImportError(
            err_msg or f"{module_name} is required but not installed") from e
