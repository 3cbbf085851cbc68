"""Trace spans: one bounded ring of timed records under the serving path.

Counterpart of ``paddle_tpu/observability/trace.py``:

- ``span()`` / ``event()`` record one timed span (a context manager) or one
  instant event into a thread-safe bounded ring of monotonic-ns records.
  Sites carry free-form attrs, the correlation ids (``rid`` for a serving
  request, ``step`` for a captured step) that link records across layers:
  a gateway request to the engine's prefill, decode and verify spans and
  the scheduler's join and evict events.
- Tracing is off by default (``PT_TRACE=0``): a disabled ``span()``
  returns one shared no-op context manager after a bool check and
  ``event()`` returns at once.
- ``export_trace()`` writes the ring as Chrome trace-event JSON (Perfetto,
  chrome://tracing): spans as ``ph: "X"``, instants as ``ph: "i"``, the
  attrs under ``args``.
- The flight recorder: every typed ``DeadlineExceeded`` construction
  snapshots the last K ring records into ``last_incident()`` (the hook is
  installed by ``observability/__init__``), so a timeout carries its own
  timeline.

Env knobs:
- ``PT_TRACE``                (default 0)    1 enables span recording
- ``PT_TRACE_RING``           (default 4096) ring capacity (records)
- ``PT_TRACE_INCIDENT_SPANS`` (default 64)   last-K records per incident
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Optional

from ..utils.deadline import env_int

__all__ = ["span", "event", "enabled", "enable", "trace_clear",
           "trace_records", "trace_info", "export_trace", "set_ring_size",
           "record_incident", "last_incident", "incidents",
           "clear_incidents"]

_enabled = os.environ.get("PT_TRACE", "0").strip().lower() \
    not in ("0", "", "false", "off")
_ids = itertools.count(1)
_tls = threading.local()   # per-thread open-span stack (parent linkage)


class _LockedRing:
    """Bounded ring of records under its own lock. ``pushed`` counts every
    record ever pushed: the ring bounds retention, not the count."""

    def __init__(self, maxlen: int):
        self._d: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.dropped = 0
        self.pushed = 0

    def push(self, rec) -> None:
        with self._lock:
            if len(self._d) == self._d.maxlen:
                self.dropped += 1
            self.pushed += 1
            self._d.append(rec)

    def snapshot(self) -> list:
        with self._lock:
            return list(self._d)

    def tail(self, k: int) -> list:
        with self._lock:
            return list(self._d)[-k:]

    def last(self):
        with self._lock:
            return self._d[-1] if self._d else None

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self.dropped = 0
            self.pushed = 0

    def resize(self, maxlen: int) -> None:
        with self._lock:
            self._d = deque(maxlen=max(1, int(maxlen)))
            self.dropped = 0
            self.pushed = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    @property
    def maxlen(self) -> int:
        with self._lock:
            return self._d.maxlen


_RING = _LockedRing(env_int("PT_TRACE_RING", 4096))
_INCIDENT_K = env_int("PT_TRACE_INCIDENT_SPANS", 64)
_INCIDENTS = _LockedRing(8)


def enabled() -> bool:
    return _enabled


def enable(on: bool = True) -> None:
    """Turn span recording on/off at runtime (the PT_TRACE override; the
    ring and the incidents are kept either way)."""
    global _enabled
    _enabled = bool(on)


def set_ring_size(n: int) -> None:
    """Re-arm the ring at a new bound (drops its contents)."""
    _RING.resize(n)


def trace_clear() -> None:
    _RING.clear()


class _Span:
    """One open span; ``with span(...) as sp: sp.set(rid=...)`` attaches
    attrs found mid-span (a request id that exists only after submit)."""

    __slots__ = ("name", "cat", "attrs", "sid", "parent", "_t0")

    def __init__(self, name: str, cat: str, attrs: dict):
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.sid = next(_ids)
        self.parent: Optional[int] = None
        self._t0 = 0

    def set(self, **attrs) -> "_Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        if stack:
            self.parent = stack[-1]
        stack.append(self.sid)
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        end = time.monotonic_ns()
        stack = getattr(_tls, "stack", ())
        if stack and stack[-1] == self.sid:
            stack.pop()
        _RING.push({"name": self.name, "cat": self.cat, "ts": self._t0,
                    "dur": end - self._t0, "tid": threading.get_ident(),
                    "id": self.sid, "parent": self.parent,
                    "args": self.attrs})
        return False


class _NullSpan:
    """The disabled path: one shared, reusable no-op context manager."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def span(name: str, cat: str = "span", **attrs):
    """Context manager recording one timed span named after its site
    (``engine.decode_step``, ...); a no-op singleton when tracing is off."""
    if not _enabled:
        return _NULL
    return _Span(name, cat, attrs)


def event(name: str, cat: str = "event", **attrs) -> None:
    """Record one instant event (a scheduler join, a pool exhaustion, an
    armed chaos fault)."""
    if not _enabled:
        return
    stack = getattr(_tls, "stack", ())
    _RING.push({"name": name, "cat": cat, "ts": time.monotonic_ns(),
                "dur": None, "tid": threading.get_ident(), "id": next(_ids),
                "parent": stack[-1] if stack else None, "args": attrs})


def trace_records() -> list:
    """Snapshot of the ring, oldest first."""
    return _RING.snapshot()


def trace_info() -> dict:
    """Ring counters; ``incidents`` is cumulative (the incident ring keeps
    the last 8, the count keeps climbing)."""
    return {"enabled": _enabled, "records": len(_RING),
            "capacity": _RING.maxlen, "dropped": _RING.dropped,
            "incidents": _INCIDENTS.pushed}


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------

def _jsonable(x):
    """Attrs come from live code (numpy ints, tuples): the export must not
    fail on them."""
    try:
        json.dumps(x)
        return x
    except (TypeError, ValueError):
        if isinstance(x, (list, tuple)):
            return [_jsonable(v) for v in x]
        if isinstance(x, dict):
            return {str(k): _jsonable(v) for k, v in x.items()}
        try:
            return int(x)
        except (TypeError, ValueError):
            return str(x)


def _chrome_events(records: list) -> list:
    pid = os.getpid()
    out = []
    for r in records:
        args = {str(k): _jsonable(v) for k, v in r["args"].items()}
        args["span_id"] = r["id"]
        if r["parent"] is not None:
            args["parent_id"] = r["parent"]
        ev = {"name": r["name"], "cat": r["cat"], "pid": pid,
              "tid": r["tid"], "ts": r["ts"] / 1000.0, "args": args}
        if r["dur"] is None:
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = r["dur"] / 1000.0
        out.append(ev)
    return out


def export_trace(path: str) -> str:
    """Write the ring as Chrome trace-event JSON; returns ``path``. ``ts``
    is monotonic ns in the format's microseconds."""
    events = _chrome_events(trace_records())
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path


# ---------------------------------------------------------------------------
# flight recorder: the last K records per typed deadline error
# ---------------------------------------------------------------------------

def record_incident(exc: BaseException) -> None:
    """Snapshot the last K ring records against one typed error (the
    ``utils.deadline`` incident hook). Never raises: a recorder failure
    inside an error path would mask the real error."""
    try:
        _INCIDENTS.push({
            "error": type(exc).__name__,
            "what": getattr(exc, "what", None) or str(exc),
            "timeout": getattr(exc, "timeout", None),
            "ts": time.monotonic_ns(),
            "spans": _RING.tail(_INCIDENT_K),
        })
    except Exception:  # noqa: BLE001 — never mask the raising error
        pass


def last_incident() -> Optional[dict]:
    """The most recent incident with its span timeline, or None."""
    return _INCIDENTS.last()


def incidents() -> list:
    return _INCIDENTS.snapshot()


def clear_incidents() -> None:
    _INCIDENTS.clear()
