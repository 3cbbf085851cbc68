"""paddle_tpu_torch.device: the device and allocator counters, streams and
events.

Counterpart of ``paddle_tpu/device/__init__.py``. The counters are
``torch.cuda``'s own, under the field names the JAX package reads from
XLA's allocator (``memory_stats``: ``bytes_in_use``,
``peak_bytes_in_use``, ``bytes_limit``, ``bytes_reserved``,
``peak_bytes_reserved``, ``num_allocs``). On a CPU device every function
answers as the JAX one does on a backend without counters: ``{}`` and 0.

``Stream``, ``Event``, ``current_stream`` and ``stream_guard`` are real
CUDA streams and events (``torch.cuda.Stream`` / ``Event`` /
``torch.cuda.stream``), where the JAX classes are no-op stand-ins (XLA
orders a device's work itself): work queued inside ``stream_guard(s)``
runs on ``s``, ``wait_stream`` orders two streams, and
``Event.elapsed_time`` (Paddle's method, which the JAX class lacks) times
the work between two events. A stream lives on a card: asking for one on
the CPU raises, as every port entry point does without a card.
"""
from __future__ import annotations

import torch

from ..core.device import (  # noqa: F401
    current_jax_device, device_count, get_device, is_compiled_with_tpu,
    resolve_device, set_device,
)

__all__ = [
    "get_device", "set_device", "device_count", "is_compiled_with_tpu",
    "synchronize", "memory_stats", "memory_allocated", "max_memory_allocated",
    "memory_reserved", "max_memory_reserved", "empty_cache",
    "get_all_device_type", "get_available_device",
    "get_available_custom_device", "cuda", "Stream", "Event",
    "current_stream", "stream_guard",
]


def _resolve(device=None) -> torch.device:
    """A ``torch.device`` from None (the default device), a card index, a
    string (``"gpu:0"``, ``"cuda:1"``, ``"cpu"``) or a device."""
    if isinstance(device, Stream):
        return device.device
    if isinstance(device, int):
        return resolve_device(f"cuda:{device}")
    if isinstance(device, str) and device.startswith("gpu"):
        device = "cuda" + device[3:]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device=None):
    """Block until the card's queued work has finished (a no-op on the
    CPU)."""
    d = _resolve(device)
    if d.type == "cuda":
        torch.cuda.synchronize(d)


def memory_stats(device=None) -> dict:
    """The caching allocator's counters under XLA's names; ``{}`` on the
    CPU. ``bytes_limit`` is the card's memory, ``num_allocs`` the
    allocations made so far."""
    d = _resolve(device)
    if d.type != "cuda":
        return {}
    raw = torch.cuda.memory_stats(d)
    return {
        "bytes_in_use": int(torch.cuda.memory_allocated(d)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(d)),
        "bytes_limit": int(torch.cuda.mem_get_info(d)[1]),
        "bytes_reserved": int(torch.cuda.memory_reserved(d)),
        "peak_bytes_reserved": int(torch.cuda.max_memory_reserved(d)),
        "num_allocs": int(raw.get("allocation.all.allocated", 0)),
    }


def memory_allocated(device=None) -> int:
    return int(memory_stats(device).get("bytes_in_use", 0))


def max_memory_allocated(device=None) -> int:
    return int(memory_stats(device).get("peak_bytes_in_use", 0))


def memory_reserved(device=None) -> int:
    s = memory_stats(device)
    return int(s.get("bytes_reserved", s.get("bytes_in_use", 0)))


def max_memory_reserved(device=None) -> int:
    s = memory_stats(device)
    return int(s.get("peak_bytes_reserved", s.get("peak_bytes_in_use", 0)))


def empty_cache():
    """Hand the caching allocator's unused blocks back to CUDA."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def get_all_device_type():
    """The default backend's platform: ``["gpu"]`` with a card, else
    ``["cpu"]`` (the JAX function lists ``jax.devices()``' platforms)."""
    return ["gpu"] if device_count() else ["cpu"]


def get_available_device():
    n = device_count()
    return [f"gpu:{i}" for i in range(n)] if n else ["cpu:0"]


def get_available_custom_device():
    return []


class Stream:
    """A CUDA stream on ``device`` (Paddle's priority 1 is high, 2
    normal). Raises on a CPU device."""

    def __init__(self, device=None, priority=2):
        self.device = _resolve(device)
        if self.device.type != "cuda":
            raise RuntimeError(f"a Stream lives on a card, not on "
                               f"{self.device}")
        self.priority = priority
        self.stream = torch.cuda.Stream(
            self.device, priority=-1 if priority == 1 else 0)

    @classmethod
    def _of(cls, stream: "torch.cuda.Stream") -> "Stream":
        s = cls.__new__(cls)
        s.device, s.priority, s.stream = stream.device, 2, stream
        return s

    def synchronize(self):
        self.stream.synchronize()

    def wait_stream(self, other):
        """Work queued on this stream from now waits for what ``other``
        has queued so far."""
        self.stream.wait_stream(other.stream)

    def record_event(self, event=None):
        ev = event or Event()
        ev.record(self)
        return ev

    def wait_event(self, event):
        self.stream.wait_event(event.event)

    def __eq__(self, other):
        return isinstance(other, Stream) and self.stream == other.stream

    def __hash__(self):
        return hash(self.stream)


class Event:
    """A CUDA event; ``enable_timing=True`` lets ``elapsed_time`` read the
    milliseconds between two recorded events."""

    def __init__(self, enable_timing=False, blocking=False,
                 interprocess=False):
        self.event = torch.cuda.Event(enable_timing=enable_timing,
                                      blocking=blocking,
                                      interprocess=interprocess)

    def record(self, stream=None):
        self.event.record((stream or current_stream()).stream)

    def query(self):
        return self.event.query()

    def synchronize(self):
        self.event.synchronize()

    def elapsed_time(self, end_event) -> float:
        return self.event.elapsed_time(end_event.event)


def current_stream(device=None) -> Stream:
    """The stream work is queued on now (``stream_guard``'s, else the
    card's default)."""
    d = _resolve(device)
    if d.type != "cuda":
        raise RuntimeError(f"a Stream lives on a card, not on {d}")
    return Stream._of(torch.cuda.current_stream(d))


class stream_guard:
    """Queue the work inside on ``stream``."""

    def __init__(self, stream):
        self.stream = stream

    def __enter__(self):
        self._ctx = torch.cuda.stream(self.stream.stream)
        self._ctx.__enter__()
        return self.stream

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        return False


class cuda:
    """``paddle.device.cuda``: the counters of the card, and its
    properties."""
    memory_allocated = staticmethod(memory_allocated)
    max_memory_allocated = staticmethod(max_memory_allocated)
    memory_reserved = staticmethod(memory_reserved)
    max_memory_reserved = staticmethod(max_memory_reserved)
    empty_cache = staticmethod(empty_cache)
    synchronize = staticmethod(synchronize)
    device_count = staticmethod(lambda: device_count())

    @staticmethod
    def get_device_properties(device=None):
        """``name``, ``total_memory``, ``major``/``minor`` and
        ``multi_processor_count`` of the card (the CPU: ``"cpu"``, 0, 0, 0,
        1)."""
        d = _resolve(device)
        if d.type == "cuda":
            p = torch.cuda.get_device_properties(d)
            vals = (p.name, int(p.total_memory), p.major, p.minor,
                    p.multi_processor_count)
        else:
            vals = ("cpu", 0, 0, 0, 1)

        class _Props:  # noqa: N801
            (name, total_memory, major, minor,
             multi_processor_count) = vals
        return _Props()
