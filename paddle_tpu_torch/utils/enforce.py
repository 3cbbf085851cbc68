"""Error enforcement: counterpart of ``paddle_tpu/utils/enforce.py``
(Paddle's ``PADDLE_ENFORCE_*``)."""
from __future__ import annotations

import traceback

__all__ = ["EnforceNotMet", "enforce"]


class EnforceNotMet(RuntimeError):
    """A failed ``enforce``; the message ends with the Python stack that
    led to it."""

    def __init__(self, msg: str):
        stack = "".join(traceback.format_stack()[:-2][-6:])
        super().__init__(f"{msg}\n\n[operator stack]\n{stack}")


def enforce(cond, msg: str = "enforce failed", *fmt_args):
    """Raise ``EnforceNotMet(msg % fmt_args)`` unless ``cond``."""
    if not cond:
        raise EnforceNotMet(msg % fmt_args if fmt_args else msg)
    return True
