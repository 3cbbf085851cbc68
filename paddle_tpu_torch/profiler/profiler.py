"""The profiler: counterpart of ``paddle_tpu/profiler/profiler.py``.

``Profiler`` drives the per-step state machine of ``make_scheduler``
(CLOSED / READY / RECORD / RECORD_AND_RETURN). While it records, every op
of the dispatch is timed through ``ops.dispatch.set_profile_cb`` and the
user's ``RecordEvent`` spans land in the same buffer; when a record window
closes, ``on_trace_ready`` (``export_chrome_tracing``, ``export_protobuf``)
gets the profiler.

Events go into a Python buffer, as the JAX module's ``_PyTraceBuffer``
does when its native tracer is absent: the port's host runtime has no
tracer. An op span is host time, the dispatch and the launch of the op's
kernels, not the kernels' time on the card, which runs behind the host:
the meaning the JAX host tracer's spans have too. ``RecordEvent`` spans
are host time as well. With the profiler closed the dispatch hook is off
(``ops.dispatch._quiet``), so an op costs what it does unprofiled.
"""
from __future__ import annotations

import enum
import json
import os
import struct
import threading
import time
from typing import Callable, Iterable, Optional

__all__ = ["ProfilerState", "ProfilerTarget", "make_scheduler",
           "export_chrome_tracing", "export_protobuf",
           "load_profiler_result", "RecordEvent", "Profiler", "SortedKeys",
           "SummaryView"]


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 2
    TPU = 3


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Step-indexed schedule: ``skip_first`` CLOSED steps, then cycles of
    [``closed`` CLOSED, ``ready`` READY, ``record`` RECORD (the last one
    RECORD_AND_RETURN)], ``repeat`` times (0: forever)."""
    if closed < 0 or ready < 0 or record <= 0:
        raise ValueError("make_scheduler: closed/ready must be >=0, "
                         "record >=1")
    period = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def _default_schedule(_: int) -> ProfilerState:
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """``on_trace_ready`` callback writing a chrome://tracing JSON file
    into ``dir_name``."""
    os.makedirs(dir_name, exist_ok=True)

    def handler(prof: "Profiler"):
        name = worker_name or f"host_{os.uname().nodename}_pid{os.getpid()}"
        path = os.path.join(dir_name, f"{name}_time_{int(time.time()*1000)}"
                            ".paddle_trace.json")
        prof.export(path)

    return handler


def load_profiler_result(path: str):
    with open(path) as f:
        return json.load(f)


class _PyTraceBuffer:
    """The event buffer (complete events, ``ph: "X"``, times in µs)."""

    def __init__(self):
        self.events = []
        self.enabled = False
        self._lock = threading.Lock()

    def record(self, name, cat, ts_ns, dur_ns, tid):
        if self.enabled:
            with self._lock:
                self.events.append(
                    {"ph": "X", "pid": 0, "tid": tid, "ts": ts_ns / 1000.0,
                     "dur": dur_ns / 1000.0, "name": name, "cat": cat})

    def dump(self):
        with self._lock:
            return list(self.events)

    def clear(self):
        with self._lock:
            self.events.clear()


_py_buffer = _PyTraceBuffer()


def _tracer_record(name: str, cat: str, ts_ns: int, dur_ns: int):
    _py_buffer.record(name, cat, ts_ns, dur_ns,
                      threading.get_ident() % 2 ** 31)


class RecordEvent:
    """A user span (host time), recorded while a profiler records."""

    def __init__(self, name: str, event_type: str = "UserDefined"):
        self.name = name
        self.event_type = event_type
        self._t0 = None

    def begin(self):
        self._t0 = time.perf_counter_ns()

    def end(self):
        if self._t0 is not None:
            _tracer_record(self.name, self.event_type, self._t0,
                           time.perf_counter_ns() - self._t0)
            self._t0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class Profiler:
    def __init__(self, *, targets: Optional[Iterable] = None,
                 scheduler=None, on_trace_ready: Optional[Callable] = None,
                 timer_only: bool = False, record_shapes: bool = False,
                 profile_memory: bool = False, with_flops: bool = False):
        if scheduler is None:
            self._schedule = _default_schedule
        elif callable(scheduler):
            self._schedule = scheduler
        elif isinstance(scheduler, (tuple, list)) and len(scheduler) == 2:
            start, end = scheduler
            self._schedule = make_scheduler(closed=max(start, 0), ready=0,
                                            record=end - start, repeat=1)
        else:
            raise TypeError(f"bad scheduler {scheduler!r}")
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self.step_num = 0
        self._state = ProfilerState.CLOSED
        self._events = []
        self._recording = False

    # -- lifecycle --
    def start(self):
        from .timer import benchmark
        benchmark().begin()
        if self._timer_only:
            return
        _py_buffer.clear()
        self._transition(self._schedule(self.step_num))

    def step(self, num_samples: Optional[int] = None):
        from .timer import benchmark
        benchmark().step(num_samples)
        self.step_num += 1
        if self._timer_only:
            return
        self._transition(self._schedule(self.step_num))

    def stop(self):
        from .timer import benchmark
        benchmark().end()
        if self._timer_only:
            return
        if self._recording:
            self._collect()
            if self._on_trace_ready:
                self._on_trace_ready(self)
        self._set_recording(False)
        self._state = ProfilerState.CLOSED

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- state machine --
    def _transition(self, new: ProfilerState):
        was = self._recording
        want = new in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        if want and not was:
            self._set_recording(True)
        window_closed = (was and not want) or \
            (self._state == ProfilerState.RECORD_AND_RETURN and
             new != ProfilerState.RECORD)
        if window_closed:
            self._collect()
            self._set_recording(want)
            if self._on_trace_ready:
                self._on_trace_ready(self)
        self._state = new

    def _set_recording(self, on: bool):
        from ..ops import dispatch
        self._recording = on
        _py_buffer.enabled = on
        if on:
            def cb(name, t0, t1):
                _tracer_record(name, "op", t0, t1 - t0)
            dispatch.set_profile_cb(cb)
        else:
            dispatch.set_profile_cb(None)

    def _collect(self):
        self._events.extend(_py_buffer.dump())
        _py_buffer.clear()

    # -- results --
    def events(self):
        return list(self._events)

    def export(self, path: str, format: str = "json"):
        with open(path, "w") as f:
            json.dump({"traceEvents": self._events,
                       "displayTimeUnit": "ms"}, f)

    def summary(self, sorted_by: str = "total", op_detail: bool = True,
                thread_sep: bool = False, time_unit: str = "ms"):
        from .statistic import summary as _summary
        return _summary(self._events, sorted_by=sorted_by,
                        time_unit=time_unit)


class SortedKeys:
    """Summary-sort keys (Paddle's ``SortedKeys``)."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView:
    """Summary-view selector (Paddle's ``SummaryView``)."""
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    """``on_trace_ready`` factory writing the events in the JAX package's
    binary container: ``b"PTPF\\x01"``, the payload's length as a
    little-endian u64, then the chrome-trace JSON."""
    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"worker_{os.getpid()}"
        path = os.path.join(dir_name, f"{name}_{int(time.time())}.pb")
        data = json.dumps({"traceEvents": prof.events(),
                           "displayTimeUnit": "ms"}).encode()
        with open(path, "wb") as f:
            f.write(b"PTPF\x01" + struct.pack("<Q", len(data)) + data)
        return path
    return handler
