"""Step capture: one CUDA graph per call signature of a serving step,
and one CUDA graph of a whole train step (``lower_step``).

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
  value: pass a tensor), and ``amp.auto_cast``'s regime
  (``amp_cache_key``). Tensors of the ``inplace`` arguments (the KV
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

``capture_step`` steps run under ``torch.inference_mode()``: such a
captured step is a serving step, not a training one.

``lower_step(fn, example_args, inplace=(), name=None, *, hazards=())`` is
the training tier (counterpart of capture.py:270-368, which
``TrainStep`` builds through). The JAX function traces ``fn`` once over
the example arguments without running it; an eager PyTorch step is only
seen by running it, so here the example call IS the step's first call:

- **warm-up**: ``fn(*example_args)`` runs eagerly, with autograd on, on
  the capture stream under the sync guard, while a ``TorchDispatchMode``
  records every op it dispatches, the kernel launches and the comms
  records (``jit.program.StepRecord``). Its result is the dispatcher's
  ``first_result``.
- **capture**: the same call recorded as ONE ``torch.cuda.CUDAGraph``
  (forward, backward, clip, update); later calls of that signature replay
  it. ``inplace`` names the positional arguments held by address (a train
  step's parameters, optimizer state, health scalars, learning rate and
  step count: the caller writes the new lr and step into those tensors
  before a call); every other tensor is copied into a static input. A
  replay repeats the kernels' launch counts and the comms records the
  capture held back.
- **another signature** (the arguments' shapes, dtypes and devices, the
  inplace addresses, Python values; and the comms regime, autocast and
  grad mode the call runs under) runs eagerly, counted in
  ``fallback_calls`` (the JAX plain-jit path), and the lint's
  ``recompile-hazard`` records it.
- **a failure** (a host sync in the warm-up, a capture error) is a
  bailout with its reason in ``capture_info()``; the program is None and
  the step runs eagerly from then on, on the card: never on the CPU or a
  plain kernel. ``hazards`` are reasons the caller knows a CUDA graph
  cannot hold the step (a gloo collective goes through the host); a
  backend that records graphs refuses them before the warm-up, counted
  the same way (a backend that re-runs the step, as the tests' does,
  ignores them unless it sets ``holds_graphs``).

It returns ``(dispatcher, program)``: the program is a
``jit.program.CapturedProgram`` (record, ``jit.passes.PassReport``,
shapes, donated positions), None after a bailout or with the tier off;
the lint (``jit.passes.lint``) files its findings under ``name``.

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
from torch.utils._python_dispatch import TorchDispatchMode

from ..utils.deadline import env_int

__all__ = ["capture_step", "CapturedStep", "CudaGraphBackend", "HostSync",
           "capture_info", "capture_clear", "set_step_capture_enabled",
           "step_capture_enabled", "set_capture_backend", "lower_step",
           "LoweredStep", "GraphedCall"]

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

    holds_graphs = True

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


class _GraphHolder:
    """What a serving wrapper and a lowered train step share: the backend
    choice, the call signature and a replay. Needs ``_inplace`` and
    ``_backend``."""

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
        parts = [spans, _amp_key()]
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

    def _replay(self, entry: _Entry, backend, leaves):
        for p, static in entry.statics:
            src = leaves[p]
            if src.data_ptr() != static.data_ptr():
                static.copy_(src)
        backend.replay(entry.graph)
        for c, d in entry.deltas:
            c.launches += d
        return entry.out


class CapturedStep(_GraphHolder):
    """A step function with one CUDA graph per call signature.

    Call it exactly like ``fn``. ``inplace`` names the positional
    arguments whose tensors the step reads and writes where they lie (its
    KV caches); they are held by address, never copied. Calls run under
    ``torch.inference_mode()`` (a serving step), or ``torch.no_grad()``
    with ``inference=False`` (``to_static``'s calls that need no grad,
    whose outputs may meet autograd later)."""

    def __init__(self, fn: Callable, inplace=(), maxsize=None,
                 name: Optional[str] = None, *, inference: bool = True):
        self._fn = fn
        self._inplace = frozenset(int(i) for i in inplace)
        self._inference = bool(inference)
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
        with torch.inference_mode() if self._inference else torch.no_grad():
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


# ---------------------------------------------------------------------------
# the training tier: one CUDA graph of a whole step
# ---------------------------------------------------------------------------

class _Recorder(TorchDispatchMode):
    """Logs every op a warm-up dispatches into a ``StepRecord``: its name,
    a ``torch.distributed`` collective issued outside ``comms``, and an
    in-place write to a tensor whose storage is one of ``copied`` (the
    arguments a replay copies)."""

    def __init__(self, record, copied):
        super().__init__()
        self.record = record
        self.copied = copied

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        rec = self.record
        rec.ops.append(name)
        if func.namespace == "c10d":
            from ..distributed.comms.api import issuing
            if not issuing():
                rec.unscheduled.append(name)
        if self.copied and func._schema.is_mutable:
            for i, a in enumerate(func._schema.arguments):
                if a.alias_info is None or not a.alias_info.is_write:
                    continue
                v = args[i] if i < len(args) else kwargs.get(a.name)
                if isinstance(v, torch.Tensor) and \
                        v.untyped_storage().data_ptr() in self.copied:
                    rec.copied_writes.append(name)
        return func(*args, **kwargs)


def _amp_key():
    """``amp.auto_cast``'s regime (``amp_cache_key``): a step captured
    under one cast regime must not serve a call under another."""
    from ..amp.auto_cast import amp_cache_key
    return amp_cache_key()


def _regime() -> tuple:
    """What a captured train step depends on beyond its arguments: the
    comms regime (a step captured exact must not serve a quantized call),
    autocast and grad mode (the JAX tier keys its lowering on amp and
    comms the same way)."""
    from ..distributed.comms.api import comms_cache_key
    return (comms_cache_key(), torch.is_grad_enabled(),
            torch.is_autocast_enabled("cuda"),
            torch.is_autocast_enabled("cpu"))


def _storages(leaves) -> set:
    return {x.untyped_storage().data_ptr() for x in leaves
            if isinstance(x, torch.Tensor) and x.numel()}


class LoweredStep(_GraphHolder):
    """The dispatcher ``lower_step`` returns: call it as ``fn``. One CUDA
    graph for the example's signature, eager for any other."""

    def __init__(self, fn: Callable, example_args, inplace=(),
                 name: Optional[str] = None, hazards=()):
        self._fn = fn
        self._inplace = frozenset(int(i) for i in inplace)
        self._hazards = tuple(h for h in hazards if h)
        self.__name__ = name or getattr(fn, "__name__", "step")
        self.counts = dict.fromkeys(_COUNTS, 0)
        self._backend = None
        self._entry: Optional[_Entry] = None
        self._sig = None
        self._comm_ops: tuple = ()
        self._other_sigs: set = set()
        self.program = None
        self.reason = ""
        from .program import StepRecord
        self.record = StepRecord()
        _WRAPPERS.add(self)
        self.first_result = self._lower(tuple(example_args))

    # ---- observability (capture_info reads these) ----
    def cache_info(self) -> dict:
        with _LOCK:
            counts = dict(self.counts)
        return {"signatures": 1 + len(self._other_sigs), **counts}

    def bailout_reason(self) -> str:
        return self.reason

    def graphs(self) -> int:
        return int(self._entry is not None)

    def pool_bytes(self) -> Optional[int]:
        b = self._backend
        return 0 if b is None else b.pool_bytes()

    # ---- the first call ----
    def _bail(self, reason: str) -> None:
        self.reason = reason[:200]
        self._entry = None
        _count(self, "bailouts")
        with _LOCK:
            _TOTALS.last_bailout = f"{self.__name__}: {self.reason}"

    def _full_signature(self, leaves, spans):
        sig = self._signature(leaves, spans)
        return None if sig is None else (sig, _regime())

    def _lower(self, args):
        leaves, spans = _flat_call(args, {})
        backend = self._backend_for(leaves)
        if backend is None:
            _count(self, "eager_calls")
            return self._fn(*args)
        self._backend = backend
        self._sig = self._full_signature(leaves, spans)
        if self._sig is None:
            self._bail("an argument is neither a tensor nor hashable")
            return self._fallback(args)
        if self._hazards and getattr(backend, "holds_graphs", False):
            self._bail("; ".join(self._hazards))
            return self._fallback(args)
        from ..distributed.comms import observed_records
        copied = _storages(leaves) - _storages(
            [x for i, a in enumerate(args) if i in self._inplace
             for x in _flat_call((a,), {})[0]])
        counters = _kernel_counters()
        before = [c.launches for c in counters]
        try:
            with observed_records() as seen, _SyncGuard(), \
                    _Recorder(self.record, copied):
                out = backend.warmup(self._fn, args, {})
        except RuntimeError as e:   # HostSync, or the card's sync check
            self.record.host_syncs.append(f"{type(e).__name__}: {e}"[:200])
            self._bail(f"{type(e).__name__}: {e}")
            self._lint()
            return self._fallback(args)
        self.record.kernels = {
            c.__name__: c.launches - b for c, b in zip(counters, before)
            if c.launches != b}
        self.record.comm_ops = list(seen)
        try:
            self._capture(backend, args)
        except RuntimeError as e:
            self._bail(f"{type(e).__name__}: {e}")
            self._lint()
            return out
        self.program = self._program(args, leaves, spans, out)
        _count(self, "lowerings")
        self._lint()
        return out

    def _capture(self, backend, args) -> None:
        from ..distributed.comms import held_records
        entry = _Entry()
        s_args = tuple(a if i in self._inplace else _map(_clone, a)
                       for i, a in enumerate(args))
        s_leaves, _ = _flat_call(s_args, {})
        leaves, _ = _flat_call(args, {})
        counters = _kernel_counters()
        before = [c.launches for c in counters]
        try:
            with held_records() as held:
                graph, out = backend.capture(self._fn, s_args, {})
        finally:
            deltas = [(c, c.launches - b) for c, b in zip(counters, before)]
            for c, b in zip(counters, before):
                c.launches = b
        entry.graph, entry.out = graph, out
        entry.statics = tuple(
            (p, st) for p, (st, x) in enumerate(zip(s_leaves, leaves))
            if isinstance(st, torch.Tensor) and st is not x)
        entry.deltas = tuple((c, d) for c, d in deltas if d)
        self._comm_ops = tuple(held)
        self._entry = entry

    def _program(self, args, leaves, spans, out):
        from .passes import PassReport
        from .program import CapturedProgram
        donated, i = [], 0
        for pos, n in enumerate(spans):
            if pos in self._inplace:
                donated += [j for j in range(i, i + n)
                            if isinstance(leaves[j], torch.Tensor)]
            i += n
        report = PassReport(
            comm_tagged=len(self.record.comm_ops),
            donated_args=tuple(donated), eqns_before=len(self.record.ops),
            eqns_after=len(self.record.ops), passes_run=["comm"])
        outs, _ = _flat_call((out,), {})
        prog = CapturedProgram(
            self.__name__, self.record, report,
            in_shapes=tuple(tuple(x.shape) for x in leaves
                            if isinstance(x, torch.Tensor)),
            out_shapes=tuple(tuple(x.shape) for x in outs
                             if isinstance(x, torch.Tensor)),
            donate=tuple(donated))
        prog.pool_bytes = self.pool_bytes()
        return prog

    def _lint(self) -> None:
        from .passes import lint
        if lint.lint_enabled():
            lint.record_lint(self.__name__, self.program or self.record)

    # ---- later calls ----
    def _fallback(self, args):
        _count(self, "fallback_calls")
        return self._fn(*args)

    def __call__(self, *args):
        leaves, spans = _flat_call(args, {})
        entry = self._entry
        sig = self._full_signature(leaves, spans) \
            if self._backend is not None else None
        if entry is not None and sig == self._sig:
            _count(self, "hits")
            out = self._replay(entry, self._backend, leaves)
            if self._comm_ops:
                from ..distributed.comms import replay_records
                replay_records(self._comm_ops)
            return out
        if self._backend is None:
            _count(self, "eager_calls")
            return self._fn(*args)
        if sig != self._sig and sig not in self._other_sigs:
            self._other_sigs.add(sig)
            self.record.signatures += 1
            self._lint()
        return self._fallback(args)

    def release(self) -> None:
        """Drop the graph (its pool goes with the last reference); later
        calls run eagerly."""
        self._entry = None


def lower_step(fn: Callable, example_args, inplace=(),
               name: Optional[str] = None, *, hazards=()):
    """Run ``fn(*example_args)`` as the step's first call (the eager
    warm-up), capture it as one CUDA graph, and return ``(dispatcher,
    program)``: ``dispatcher(*args)`` replays the graph for the example's
    signature and runs ``fn`` eagerly for any other;
    ``dispatcher.first_result`` is the warm-up's result. ``program`` is a
    ``jit.program.CapturedProgram``, or None when the tier is off, the
    tensors are on the CPU (no override backend) or the capture bailed
    out (``dispatcher.reason``, ``capture_info()``). ``inplace``: the
    positional arguments held by address; ``hazards``: reasons a CUDA
    graph cannot hold this step, which a graph backend refuses."""
    step = LoweredStep(fn, example_args, inplace=inplace, name=name,
                       hazards=hazards)
    return step, step.program


# ---------------------------------------------------------------------------
# to_static's tier: a call as CUDA graphs, joined to autograd
# ---------------------------------------------------------------------------

class _Call(torch.nn.Module):
    """``fn(*args)`` with its tensor arguments as positional inputs and its
    output's tensors as a tuple (what ``make_graphed_callables`` takes);
    ``module`` is registered so its parameters are the graphs' inputs.
    Each forward notes the kernel launches it made."""

    def __init__(self, fn, module, args, kwargs):
        super().__init__()
        self.inner = module
        self._fn = fn
        self._template = (args, kwargs)
        self.out_spec = None
        self.fwd_deltas = {}

    def rebuild(self, tensors):
        from torch.utils import _pytree as pytree
        args, kwargs = self._template
        leaves, spec = pytree.tree_flatten((args, kwargs))
        tpos = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
        for i, t in zip(tpos, tensors):
            leaves[i] = t
        return pytree.tree_unflatten(leaves, spec)

    def forward(self, *tensors):
        from torch.utils import _pytree as pytree
        counters = _kernel_counters()
        before = [c.launches for c in counters]
        args, kwargs = self.rebuild(tensors)
        out = self._fn(*args, **kwargs)
        self.fwd_deltas = {c: c.launches - b for c, b in zip(counters, before)
                           if c.launches != b}
        leaves, self.out_spec = pytree.tree_flatten(out)
        if not all(isinstance(x, torch.Tensor) for x in leaves):
            raise TypeError("a graphed to_static call must return tensors")
        return tuple(leaves)


def _tensor_leaves(args, kwargs) -> list:
    from torch.utils import _pytree as pytree
    return [x for x in pytree.tree_leaves((args, kwargs))
            if isinstance(x, torch.Tensor)]


class _GradEntry:
    __slots__ = ("graphed", "call", "fwd", "bwd", "pending", "grad_ptrs")

    def __init__(self, graphed, call, fwd, bwd):
        self.graphed, self.call = graphed, call
        self.fwd, self.bwd = fwd, bwd
        self.pending = None           # weakref to a replay's autograd node
        self.grad_ptrs = frozenset()  # the backward graph's grad buffers

    def in_flight(self) -> bool:
        """A replay whose backward has not run, while its graph is alive:
        the forward graph's buffers hold what that backward reads."""
        return self.pending is not None and self.pending() is not None


class GraphedCall(CapturedStep):
    """``to_static``'s tier on the card, on the signature, LRU and bailout
    machinery of ``CapturedStep``.

    Per call signature (the arguments' shapes, strides, dtypes and
    devices, Python values, the amp regime, plus ``extra``: the caller's
    key, and here the grad mode and the ``module``'s parameter addresses
    and ``requires_grad``), the first call is an eager warm-up under the
    sync guard; a host sync there (a Python ``if`` on a device tensor)
    poisons the signature, which then runs eagerly, counted in
    ``bailouts`` with its reason. Otherwise:

    - a call that needs no grad becomes one CUDA graph (``CapturedStep``
      with ``inference=False``), replayed from the next call on;
    - a call that needs grads becomes a forward graph and a backward graph
      joined to autograd (``torch.cuda.make_graphed_callables`` over the
      call, with the module's parameters as inputs, so their grads
      accumulate into ``.grad``), replayed from the next call on. A
      replay adds the kernel launches of the forward graph, and those of
      the backward graph when autograd runs it. From a replay until its
      backward has run (or its autograd graph is gone) the signature is in
      flight: a second call of it runs eagerly, counted in ``in_flight``
      and ``fallback_calls``, since a replay would overwrite the
      activations that the pending backward reads. A ``.grad`` that an
      earlier backward left in the backward graph's own buffer is copied
      out before the next replay overwrites it.

    A call returns copies of the graphs' outputs, never their buffers.
    Without a CUDA tensor, or with the tier off, every call is eager."""

    def __init__(self, fn: Callable, module=None, maxsize=None,
                 name: Optional[str] = None):
        super().__init__(fn, maxsize=maxsize, name=name, inference=False)
        self._module = module
        self._in_flight = 0

    def cache_info(self) -> dict:
        info = super().cache_info()
        with _LOCK:
            info["in_flight"] = self._in_flight
        return info

    def graphs(self) -> int:
        with self._lock:
            return sum((e.graph is not None) * (2 if isinstance(
                e.graph, _GradEntry) else 1) for e in self._cache.values())

    def _params(self):
        return [] if self._module is None else list(
            self._module.parameters())

    def __call__(self, *args, extra=(), **kwargs):
        leaves, spans = _flat_call(args, kwargs)
        params = self._params()
        backend = self._backend_for(leaves + params)
        if not isinstance(backend, CudaGraphBackend):
            _count(self, "eager_calls")
            return self._fn(*args, **kwargs)
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in params + [
                x for x in leaves if isinstance(x, torch.Tensor)])
        sig = self._signature(leaves, spans)
        if sig is None:
            return self._fallback(args, kwargs)
        sig = (sig, tuple(extra), grad,
               tuple((p.data_ptr(), p.requires_grad) for p in params))
        with self._lock:
            entry = self._cache.get(sig)
            if entry is not None:
                self._cache.move_to_end(sig)
        if entry is None:
            return self._warm(sig, backend, grad, args, kwargs, leaves,
                              spans)
        if entry.poisoned:
            return self._fallback(args, kwargs)
        if grad and entry.graph.in_flight():
            with _LOCK:
                self._in_flight += 1
            return self._fallback(args, kwargs)
        _count(self, "hits")
        if grad:
            return self._replay_grad(entry.graph, args, kwargs)
        with torch.no_grad():
            return _map(_clone, self._replay(entry, backend, leaves))

    def _warm(self, sig, backend, grad, args, kwargs, leaves, spans):
        """The eager warm-up (this call's result), then the graphs."""
        entry = _Entry()
        try:
            with _SyncGuard(), (torch.enable_grad() if grad
                                else torch.no_grad()):
                out = backend.warmup(self._fn, args, kwargs)
        except RuntimeError as e:   # HostSync, or the card's sync check
            self._poison(sig, entry, e)
            return self._fallback(args, kwargs)
        try:
            if grad:
                entry.graph = self._build_grad(args, kwargs)
            else:
                with torch.no_grad():
                    self._capture(entry, backend, args, kwargs)
        except RuntimeError as e:
            self._poison(sig, entry, e)
            return out
        self._put(sig, entry)
        _count(self, "lowerings")
        return out

    def _build_grad(self, args, kwargs) -> _GradEntry:
        call = _Call(self._fn, self._module, args, kwargs)
        samples = tuple(
            x.detach().clone().requires_grad_(x.requires_grad)
            for x in _tensor_leaves(args, kwargs))
        counters = _kernel_counters()
        before = [c.launches for c in counters]
        warmups = 3
        try:
            graphed = torch.cuda.make_graphed_callables(
                call, samples, num_warmup_iters=warmups)
            fwd = dict(call.fwd_deltas)
            total = {c: c.launches - b for c, b in zip(counters, before)}
        finally:
            for c, b in zip(counters, before):   # a build is not a call
                c.launches = b
        # each warm-up and the capture ran the forward and the backward
        bwd = {c: n // (warmups + 1) - fwd.get(c, 0)
               for c, n in total.items() if n}
        return _GradEntry(graphed, call, fwd, {c: n for c, n in bwd.items()
                                               if n})

    def _replay_grad(self, ge: _GradEntry, args, kwargs):
        from torch.utils import _pytree as pytree
        inputs = _tensor_leaves(args, kwargs)
        if ge.grad_ptrs:
            # autograd may have kept a grad buffer of the backward graph as
            # a leaf's .grad (accumulation without clear_grad); the two
            # graphs share one pool, so the replays would overwrite it
            for t in self._params() + inputs:
                g = t.grad if t.requires_grad and t.is_leaf else None
                if g is not None and g.data_ptr() in ge.grad_ptrs:
                    t.grad = g.clone()
        outs = ge.graphed(*inputs)
        for c, d in ge.fwd.items():
            c.launches += d
        node = next((o.grad_fn for o in outs if o.grad_fn is not None), None)
        if node is not None:
            ge.pending = weakref.ref(node)

            def after(grad_inputs, _grad_outputs):
                ge.pending = None
                ge.grad_ptrs = frozenset(
                    g.data_ptr() for g in grad_inputs if g is not None)
                for c, d in ge.bwd.items():
                    c.launches += d

            node.register_hook(after)
        return pytree.tree_unflatten([o.clone() for o in outs],
                                     ge.call.out_spec)
