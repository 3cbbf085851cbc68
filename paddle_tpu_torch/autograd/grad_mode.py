"""Grad-recording switches (counterpart of
``paddle_tpu/autograd/grad_mode.py``) mapped onto torch's grad mode, so
``no_grad`` here and ``torch.no_grad`` are one switch."""
from __future__ import annotations

import torch

__all__ = ["no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled"]


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(flag: bool):
    """Switch grad recording on or off in this thread (a plain call, as
    the JAX function is)."""
    torch._C._set_grad_enabled(bool(flag))


class no_grad(torch.no_grad):  # noqa: N801 — Paddle's name
    """Context manager and decorator: no graph is recorded inside."""


class enable_grad(torch.enable_grad):  # noqa: N801 — Paddle's name
    """Context manager and decorator: graphs are recorded inside."""
