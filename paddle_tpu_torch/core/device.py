"""Device selection.

Counterpart of ``paddle_tpu/core/device.py``. The port's entry points run
on the card: with no device named they resolve to ``cuda``, and when CUDA
is absent they raise rather than carry on quietly on the CPU. A caller
that wants the CPU (the parity tests) names it: ``device="cpu"``.

The JAX module's TPU names, and what each is here:

- ``device_count(platform=None)``: the visible cards (``"gpu"`` or
  ``"cuda"`` too; 0 without CUDA); ``"cpu"`` counts torch's one CPU
  device; ``"tpu"`` counts none.
- ``is_compiled_with_tpu()`` and ``is_tpu_backend()``: False, always.
- ``current_jax_device()``: the ``torch.device`` entry points resolve to
  (``resolve_device(None)``).
- ``portable_trace``: a context manager that does nothing. The JAX one
  makes ops skip their Pallas kernels during an ONNX export; the port
  chooses a kernel by the tensor's device, not by a backend switch.
"""
from __future__ import annotations

import threading
from typing import Optional, Union

import torch

__all__ = ["get_device", "set_device", "resolve_device", "device_count",
           "is_compiled_with_tpu", "is_tpu_backend", "current_jax_device",
           "portable_trace"]

_state = threading.local()

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch.device an entry point runs on: ``device`` if given, else
    the one ``set_device`` chose, else ``cuda``. Raises RuntimeError for a
    CUDA device when CUDA is not available."""
    if device is None:
        device = getattr(_state, "device", None) or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def set_device(device: DeviceLike) -> torch.device:
    """set_device('cuda') / 'cuda:1' / 'cpu': the default of later entry
    points in this thread."""
    dev = resolve_device(device)
    _state.device = dev
    return dev


def get_device() -> str:
    """The default device as a string (``cuda:0``, ``cpu``)."""
    dev = resolve_device(None)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def device_count(platform: Optional[str] = None) -> int:
    """Visible cards (``None``, ``"gpu"``, ``"cuda"``), 1 for ``"cpu"``,
    0 for any other platform."""
    if platform in (None, "gpu", "cuda"):
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1 if platform == "cpu" else 0


def is_compiled_with_tpu() -> bool:
    return False


def is_tpu_backend() -> bool:
    return False


def current_jax_device() -> torch.device:
    """The device entry points run on (the JAX name kept)."""
    return resolve_device(None)


class portable_trace:
    """A no-op context manager (module docstring)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
