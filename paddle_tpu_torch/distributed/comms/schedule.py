"""Comm schedules: every collective is an accounted operation.

Counterpart of ``paddle_tpu/distributed/comms/schedule.py``:

- ``CommOp``: one issued collective: its owner (which subsystem asked),
  its site (the key the aggregate sums under), kind, axis, shape and
  dtype, the bytes it moves **logically** (what the full-precision
  collective would move per rank) and on the **wire** (smaller when the
  quantized context is on), the wire dtype, the deadline budget and the
  overlap slot. One field is new here: ``staged_bytes``, the bytes a gloo
  group copied between the card and the host to carry the op (both
  directions). It is 0 on NCCL and for CPU tensors.
- ``CommSchedule``: the ops of one step; ``step_schedule()`` scopes one,
  and without a scope ops land on the process-wide schedule (a window of
  the last 4096).
- ``comm_info()``: the per-site aggregate, which survives step scopes.

The JAX package records a collective once per trace; here every eager
call records, so the counts are per call. Each rank keeps its own record.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["CommOp", "CommSchedule", "current_schedule", "step_schedule",
           "record", "comm_info", "comm_clear"]


@dataclass
class CommOp:
    """One issued collective, in schedule order."""
    owner: str                 # who asked: "trainer.grad_sync", ...
    site: str                  # owner/kind/axis
    kind: str                  # all_reduce | all_gather | all_to_all | ...
    axis: Optional[str]        # mesh axis ("local": nothing on a wire)
    shape: tuple
    dtype: str
    bytes_logical: int
    bytes_wire: int
    quantized: Optional[str] = None   # "int8" / "fp8" or None
    deadline_s: Optional[float] = None
    slot: Optional[int] = None
    seq: int = 0
    staged_bytes: int = 0             # card <-> host copies of a gloo op
    ms: float = 0.0                   # host time of the issue, wait included

    @property
    def compression(self) -> float:
        return self.bytes_logical / max(self.bytes_wire, 1)


@dataclass
class CommSchedule:
    """The ordered CommOps of one step (or of the process: ``maxlen``
    bounds that window; the per-site aggregate stays complete)."""
    label: str = "global"
    ops: List[CommOp] = field(default_factory=list)
    maxlen: Optional[int] = None
    _seq: int = 0

    def add(self, op: CommOp) -> CommOp:
        op.seq = self._seq
        self._seq += 1
        self.ops.append(op)
        if self.maxlen is not None and len(self.ops) > self.maxlen:
            del self.ops[:len(self.ops) - self.maxlen]
        return op

    def bytes_logical(self) -> int:
        return sum(o.bytes_logical for o in self.ops)

    def bytes_wire(self) -> int:
        return sum(o.bytes_wire for o in self.ops)

    def bytes_staged(self) -> int:
        return sum(o.staged_bytes for o in self.ops)


_LOCK = threading.Lock()
_tls = threading.local()
_SITES: dict = {}
_GLOBAL = CommSchedule("global", maxlen=4096)


def current_schedule() -> CommSchedule:
    sched = getattr(_tls, "schedule", None)
    return sched if sched is not None else _GLOBAL


@contextmanager
def step_schedule(label: str = "step"):
    """Scope a fresh CommSchedule; collectives issued inside land on it."""
    prev = getattr(_tls, "schedule", None)
    sched = CommSchedule(label)
    _tls.schedule = sched
    try:
        yield sched
    finally:
        _tls.schedule = prev


def record(op: CommOp) -> CommOp:
    """Add one issued collective to the current schedule and the per-site
    aggregate, and emit a ``comm.op`` trace event."""
    with _LOCK:
        current_schedule().add(op)
        s = _SITES.setdefault(op.site, {
            "count": 0, "bytes_logical": 0, "bytes_wire": 0,
            "staged_bytes": 0, "ms": 0.0, "kind": op.kind,
            "owner": op.owner, "quantized": None, "slots": set()})
        s["count"] += 1
        s["bytes_logical"] += op.bytes_logical
        s["bytes_wire"] += op.bytes_wire
        s["staged_bytes"] += op.staged_bytes
        s["ms"] += op.ms
        if op.quantized:
            s["quantized"] = op.quantized
        if op.slot is not None:
            s["slots"].add(op.slot)
    from ...observability import trace
    trace.event("comm.op", cat="comm", site=op.site, kind=op.kind,
                owner=op.owner, bytes_logical=op.bytes_logical,
                bytes_wire=op.bytes_wire, staged_bytes=op.staged_bytes,
                slot=op.slot, quantized=op.quantized)
    return op


def comm_info() -> dict:
    """Per-site aggregate: count, logical / wire / staged bytes, the
    compression ratio, host ms, wire dtype and slots."""
    with _LOCK:
        sites = {
            site: {
                "count": s["count"],
                "bytes_logical": s["bytes_logical"],
                "bytes_wire": s["bytes_wire"],
                "staged_bytes": s["staged_bytes"],
                "ms": s["ms"],
                "compression": round(
                    s["bytes_logical"] / max(s["bytes_wire"], 1), 3),
                "kind": s["kind"],
                "owner": s["owner"],
                "quantized": s["quantized"],
                "slots": sorted(s["slots"]),
            }
            for site, s in sorted(_SITES.items())
        }
    return {
        "sites": sites,
        "total_logical": sum(s["bytes_logical"] for s in sites.values()),
        "total_wire": sum(s["bytes_wire"] for s in sites.values()),
        "total_staged": sum(s["staged_bytes"] for s in sites.values()),
        "collectives": sum(s["count"] for s in sites.values()),
    }


def comm_clear() -> None:
    """Reset the aggregate and the process-wide schedule."""
    with _LOCK:
        _SITES.clear()
        _GLOBAL.ops.clear()
