"""Step capture: one CUDA graph per call signature of a serving step.

Counterpart of the step tier of ``paddle_tpu/jit/capture.py`` (:68-500).
The JAX tier records a step once per input signature and lowers it to one
executable; here the same contract is a ``torch.cuda.CUDAGraph``: the first
call of a signature runs eagerly (the warm-up, PyTorch's rule before a
capture) and records the graph, later calls of that signature replay it.
A replay costs one launch however many kernels the step holds, so a decode
step's host time drops to its copies and the graph launch.

Tiering contract (capture.py:22-28): a captured step first, eager
otherwise, with the reason counted. Eager on the card still launches the
hand-written kernels and cuBLAS on the card; it is never the plain version
and never the CPU.

- **Signature.** Every tensor leaf's shape, stride, dtype and device, and
  every Python leaf's value (an ``int`` offset makes one signature per
  value: pass a tensor). Tensors of the ``inplace`` arguments (the KV
  caches) are read and written where they lie: the graph holds their
  addresses, so their ``data_ptr`` joins the signature and a moved cache
  is a new signature, never a replay on stale addresses. Every other
  tensor is copied (``copy_``) into the graph's static input before a
  replay.
- **Outputs** of a replay are the graph's static buffers, valid until the
  next call of the same wrapper: read them (``.cpu()``) first.
- **Host syncs bail out.** The warm-up runs under a guard that raises on
  ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``, ``nonzero`` and the
  Python conversions, and, on the card, under
  ``torch.cuda.set_sync_debug_mode("error")`` (which also catches a host
  to device copy of a Python number). A step that syncs poisons its
  signature: the call and its successors run eagerly, counted in
  ``bailouts`` and ``fallback_calls``, and ``bailout_reason()`` says why.
- **Kernel launch counters** (``.launches`` on the kernel wrappers in
  ``ops.kernels``) are host counters, and a replay runs no Python: the
  counts a capture adds are taken back and added again at every replay.
- **Memory.** All graphs of one wrapper share one memory pool
  (``torch.cuda.graph_pool_handle()``): the engine replays them one at a
  time and reads each output before the next call.
- **On the CPU** there is no graph: the step runs eagerly and counts
  ``eager_calls``. ``set_capture_backend`` substitutes another backend
  (the tests drive the signature, LRU and counter logic through one).

Steps run under ``torch.inference_mode()``: a captured step is a serving
step, not a training one.

Env knobs:
- ``PT_STEP_CAPTURE``      (default 1)  0 turns the tier off (eager)
- ``PT_STEP_CAPTURE_SIZE`` (default 16) signature LRU bound per wrapper
"""
from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from typing import Callable, Optional

import torch
from torch.overrides import TorchFunctionMode

from ..utils.deadline import env_int

__all__ = ["capture_step", "CapturedStep", "CudaGraphBackend", "HostSync",
           "capture_info", "capture_clear", "set_step_capture_enabled",
           "step_capture_enabled", "set_capture_backend"]

_enabled = os.environ.get("PT_STEP_CAPTURE", "1").strip().lower() \
    not in ("0", "false", "off")
_default_size = env_int("PT_STEP_CAPTURE_SIZE", 16)


def set_step_capture_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def step_capture_enabled() -> bool:
    return _enabled


class HostSync(RuntimeError):
    """A step asked for a host synchronisation while it was being prepared
    for capture; a graph cannot hold one."""


class _SyncGuard(TorchFunctionMode):
    """Raise HostSync on the tensor methods that copy a value to the host."""

    _NAMES = ("item", "tolist", "cpu", "numpy", "nonzero", "__bool__",
              "__int__", "__float__", "__index__")
    _SYNCS = frozenset([getattr(torch.Tensor, n) for n in _NAMES]
                       + [torch.nonzero])

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self._SYNCS:
            raise HostSync(f"host sync ({getattr(func, '__name__', func)}) "
                           f"inside a captured step")
        return func(*args, **(kwargs or {}))


class CudaGraphBackend:
    """The card's backend: warm-up on the capture stream, then
    ``torch.cuda.graph`` into one pool shared by the wrapper's graphs."""

    def __init__(self):
        self._stream = None
        self._pool = None

    def _ready(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream()
            self._pool = torch.cuda.graph_pool_handle()

    def warmup(self, fn, args, kwargs):
        self._ready()
        cur = torch.cuda.current_stream()
        self._stream.wait_stream(cur)
        prev = torch.cuda.get_sync_debug_mode()
        try:
            with torch.cuda.stream(self._stream):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return fn(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
        finally:
            cur.wait_stream(self._stream)

    def capture(self, fn, args, kwargs):
        self._ready()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            out = fn(*args, **kwargs)
        return graph, out

    def replay(self, graph) -> None:
        graph.replay()

    def pool_bytes(self) -> Optional[int]:
        """Bytes the allocator holds in this backend's pool (its segments in
        ``torch.cuda.memory_snapshot()``), None where unreadable."""
        if self._pool is None:
            return 0
        try:
            pool = tuple(self._pool)
            return sum(int(s["total_size"])
                       for s in torch.cuda.memory_snapshot()
                       if tuple(s.get("segment_pool_id", ())) == pool)
        except (KeyError, TypeError, RuntimeError):
            return None


# a backend substituted for every wrapper (tests); None = the default
_backend_override = None


def set_capture_backend(backend) -> None:
    """Use ``backend`` (an object with ``warmup``, ``capture``, ``replay``
    and ``pool_bytes``) for every wrapper's new graphs, on any device;
    ``None`` restores the default (CUDA graphs on the card, eager on the
    CPU)."""
    global _backend_override
    _backend_override = backend


def _kernel_counters() -> list:
    """The kernel wrappers that count their launches in ``.launches``."""
    from ..ops.kernels import (decode_attention, flash_attention, fused_ce,
                               multi_tensor)
    out = []
    for mod in (decode_attention, flash_attention, fused_ce, multi_tensor):
        for name in dir(mod):
            f = getattr(mod, name)
            if callable(f) and hasattr(f, "launches"):
                out.append(f)
    return out


# ---------------------------------------------------------------------------
# global counters (the metrics collector reads these)
# ---------------------------------------------------------------------------

_COUNTS = ("lowerings", "hits", "bailouts", "fallback_calls", "eager_calls")


class _Totals:
    def __init__(self):
        self.counts = dict.fromkeys(_COUNTS, 0)
        self.last_bailout = ""


_TOTALS = _Totals()
_LOCK = threading.Lock()
_WRAPPERS: "weakref.WeakSet[CapturedStep]" = weakref.WeakSet()


def _count(step: "CapturedStep", key: str) -> None:
    with _LOCK:
        step.counts[key] += 1
        _TOTALS.counts[key] += 1


def capture_info() -> dict:
    """Counters of every wrapper together, the live graphs and their pools'
    size in MiB (None where the allocator does not say)."""
    wrappers = list(_WRAPPERS)
    pools = [w.pool_bytes() for w in wrappers]
    with _LOCK:
        out = {"enabled": _enabled, **_TOTALS.counts,
               "last_bailout": _TOTALS.last_bailout}
    out["graphs"] = sum(w.graphs() for w in wrappers)
    out["pool_mib"] = None if any(p is None for p in pools) \
        else sum(pools) / 2 ** 20
    return out


def capture_clear() -> None:
    """Reset the global counters (graphs live on their wrappers)."""
    with _LOCK:
        _TOTALS.__init__()


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

class _Entry:
    __slots__ = ("graph", "out", "statics", "deltas", "poisoned", "reason")

    def __init__(self):
        self.graph = None
        self.out = None
        self.statics = ()     # (leaf position, static input tensor)
        self.deltas = ()      # (kernel wrapper, launches per replay)
        self.poisoned = False
        self.reason = ""


def _flatten(x, out: list) -> None:
    """Leaves of nested lists, tuples and dicts (dicts in key order)."""
    if isinstance(x, (list, tuple)):
        for y in x:
            _flatten(y, out)
    elif isinstance(x, dict):
        for k in sorted(x):
            _flatten(x[k], out)
    else:
        out.append(x)


def _map(f, x):
    if isinstance(x, list):
        return [_map(f, y) for y in x]
    if isinstance(x, tuple):
        return tuple(_map(f, y) for y in x)
    if isinstance(x, dict):
        return {k: _map(f, v) for k, v in x.items()}
    return f(x)


def _flat_call(args, kwargs):
    """The call's leaves (positional arguments in order, then keyword
    arguments by name) and, per argument, its leaf count (and name)."""
    leaves, spans = [], []
    for a in args:
        n = len(leaves)
        _flatten(a, leaves)
        spans.append(len(leaves) - n)
    for k in sorted(kwargs):
        n = len(leaves)
        _flatten(kwargs[k], leaves)
        spans.append((k, len(leaves) - n))
    return leaves, tuple(spans)


def _leaf_key(leaf, inplace: bool):
    if isinstance(leaf, torch.Tensor):
        return ("T", tuple(leaf.shape), leaf.stride(), leaf.dtype,
                leaf.device, leaf.data_ptr() if inplace else None)
    try:
        hash(leaf)
    except TypeError:
        return None
    return ("S", type(leaf), leaf)


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


class CapturedStep:
    """A step function with one CUDA graph per call signature.

    Call it exactly like ``fn``. ``inplace`` names the positional
    arguments whose tensors the step reads and writes where they lie (its
    KV caches); they are held by address, never copied."""

    def __init__(self, fn: Callable, inplace=(), maxsize=None,
                 name: Optional[str] = None):
        self._fn = fn
        self._inplace = frozenset(int(i) for i in inplace)
        self._maxsize = int(maxsize or _default_size)
        self._cache: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._lock = threading.Lock()
        self._backend = None
        self.counts = dict.fromkeys(_COUNTS, 0)
        self.__name__ = name or getattr(fn, "__name__", "step")
        _WRAPPERS.add(self)

    # ---- observability ----
    def cache_info(self) -> dict:
        with _LOCK:
            counts = dict(self.counts)
        return {"signatures": len(self._cache), **counts}

    def bailout_reason(self) -> str:
        """Reason of the first poisoned signature, '' when none."""
        with self._lock:
            for e in self._cache.values():
                if e.poisoned and e.reason:
                    return e.reason
        return ""

    def graphs(self) -> int:
        with self._lock:
            return sum(e.graph is not None for e in self._cache.values())

    def pool_bytes(self) -> Optional[int]:
        b = self._backend
        return 0 if b is None else b.pool_bytes()

    # ---- the tier ----
    def __call__(self, *args, **kwargs):
        with torch.inference_mode():
            leaves, spans = _flat_call(args, kwargs)
            backend = self._backend_for(leaves)
            if backend is None:
                _count(self, "eager_calls")
                return self._fn(*args, **kwargs)
            sig = self._signature(leaves, spans)
            if sig is None:
                return self._fallback(args, kwargs)
            with self._lock:
                entry = self._cache.get(sig)
                if entry is not None:
                    self._cache.move_to_end(sig)
            if entry is None:
                return self._first_call(sig, backend, args, kwargs)
            if entry.poisoned:
                return self._fallback(args, kwargs)
            _count(self, "hits")
            return self._replay(entry, backend, leaves)

    def _backend_for(self, leaves):
        if not _enabled:
            return None
        if _backend_override is not None:
            return _backend_override
        t = next((x for x in leaves if isinstance(x, torch.Tensor)), None)
        if t is None or t.device.type != "cuda":
            return None
        if self._backend is None:
            self._backend = CudaGraphBackend()
        return self._backend

    def _signature(self, leaves, spans):
        parts = [spans]
        i = 0
        for pos, span in enumerate(spans):
            inplace = pos in self._inplace and not isinstance(span, tuple)
            n = span[1] if isinstance(span, tuple) else span
            for leaf in leaves[i:i + n]:
                k = _leaf_key(leaf, inplace)
                if k is None:
                    return None
                parts.append(k)
            i += n
        return tuple(parts)

    def _fallback(self, args, kwargs):
        _count(self, "fallback_calls")
        return self._fn(*args, **kwargs)

    def _poison(self, sig, entry: _Entry, exc: BaseException) -> None:
        entry.poisoned = True
        entry.graph = entry.out = None
        entry.statics = entry.deltas = ()
        entry.reason = f"{type(exc).__name__}: {exc}"[:200]
        self._put(sig, entry)
        _count(self, "bailouts")
        with _LOCK:
            _TOTALS.last_bailout = f"{self.__name__}: {entry.reason}"

    def _put(self, sig, entry: _Entry) -> None:
        with self._lock:
            self._cache[sig] = entry
            self._cache.move_to_end(sig)
            while len(self._cache) > self._maxsize:
                self._cache.popitem(last=False)

    def _first_call(self, sig, backend, args, kwargs):
        """The warm-up is this call's result; the graph is recorded after
        it and replayed from the next call of the signature on."""
        if self._backend is None:
            self._backend = backend
        entry = _Entry()
        try:
            with _SyncGuard():
                out = backend.warmup(self._fn, args, kwargs)
        except RuntimeError as e:   # HostSync, or the card's sync check
            self._poison(sig, entry, e)
            return self._fallback(args, kwargs)
        try:
            self._capture(entry, backend, args, kwargs)
        except RuntimeError as e:
            self._poison(sig, entry, e)
            return out
        self._put(sig, entry)
        _count(self, "lowerings")
        return out

    def _capture(self, entry: _Entry, backend, args, kwargs) -> None:
        s_args = tuple(a if i in self._inplace else _map(_clone, a)
                       for i, a in enumerate(args))
        s_kwargs = _map(_clone, kwargs)
        s_leaves, _ = _flat_call(s_args, s_kwargs)
        leaves, _ = _flat_call(args, kwargs)
        counters = _kernel_counters()
        before = [c.launches for c in counters]
        try:
            graph, out = backend.capture(self._fn, s_args, s_kwargs)
        finally:
            # a capture records launches, it does not run them
            deltas = [(c, c.launches - b) for c, b in zip(counters, before)]
            for c, b in zip(counters, before):
                c.launches = b
        entry.graph, entry.out = graph, out
        entry.statics = tuple(
            (p, s) for p, (s, x) in enumerate(zip(s_leaves, leaves))
            if isinstance(s, torch.Tensor) and s is not x)
        entry.deltas = tuple((c, d) for c, d in deltas if d)

    def _replay(self, entry: _Entry, backend, leaves):
        for p, static in entry.statics:
            src = leaves[p]
            if src.data_ptr() != static.data_ptr():
                static.copy_(src)
        backend.replay(entry.graph)
        for c, d in entry.deltas:
            c.launches += d
        return entry.out


def capture_step(fn: Optional[Callable] = None, *, inplace=(),
                 maxsize: Optional[int] = None, name: Optional[str] = None):
    """Wrap a serving step for capture-once, replay-after execution (usable
    as a decorator). ``inplace``: positional argument indices whose tensors
    the step updates where they lie (held by address)."""
    def wrap(f):
        return CapturedStep(f, inplace=inplace, maxsize=maxsize, name=name)
    if fn is not None:
        return wrap(fn)
    return wrap
