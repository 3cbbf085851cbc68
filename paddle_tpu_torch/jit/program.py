"""The record of a captured train step.

Counterpart of ``paddle_tpu/static/graft_program.py:24`` (``GraftProgram``:
a captured step's jaxpr, its op record and its pass report). A captured
step here is one CUDA graph of the kernels its eager warm-up launched, so
its record is what that warm-up did, observed as it ran:

- ``ops``: every ATen (and c10d) op the warm-up dispatched, forward,
  backward and update, in order (a ``TorchDispatchMode``); ``num_ops``
  stands for the JAX program's ``num_eqns``;
- ``kernels``: the launches of the hand-written kernels (the wrappers'
  ``.launches`` counters), which a replay repeats;
- ``comm_ops``: the collectives ``distributed.comms`` recorded
  (``CommOp``s), which a replay repeats;
- what the lint reads (``jit/passes/lint.py``): collectives issued
  outside comms, in-place writes to arguments the graph copies, host
  syncs the guard caught, and the signatures the step was called with.

``describe()`` renders it as the JAX ``describe()`` renders a program:
a head line, the pass line, then the body (here the op counts, the
kernels and the collectives by site).
"""
from __future__ import annotations

from collections import Counter
from typing import List, Optional, Tuple

__all__ = ["CapturedProgram", "StepRecord"]


class StepRecord:
    """What one warm-up of a step did (filled in as it runs)."""

    def __init__(self):
        self.ops: List[str] = []
        self.kernels: dict = {}
        self.comm_ops: list = []
        self.unscheduled: List[str] = []
        self.copied_writes: List[str] = []
        self.host_syncs: List[str] = []
        self.signatures = 1


class CapturedProgram:
    """One captured step: its warm-up's record, the pass report, its
    inputs' and outputs' shapes, the flat positions held by address
    (``donate``) and the bytes of the graph's memory pool."""

    def __init__(self, name: str, record: StepRecord, pass_report,
                 in_shapes: Tuple = (), out_shapes: Tuple = (),
                 donate: Tuple[int, ...] = ()):
        self.name = name
        self.record = record
        self.pass_report = pass_report
        self.in_shapes = tuple(in_shapes)
        self.out_shapes = tuple(out_shapes)
        self.donate = tuple(donate)
        self.pool_bytes: Optional[int] = None

    @property
    def op_names(self) -> List[str]:
        return list(self.record.ops)

    @property
    def num_ops(self) -> int:
        return len(self.record.ops)

    def op_counts(self) -> dict:
        return dict(Counter(self.record.ops))

    def kernel_launches(self) -> dict:
        """Launches of each hand-written kernel in one run of the step."""
        return dict(self.record.kernels)

    def comm_sites(self) -> dict:
        """Collectives of one run of the step, counted by comms site."""
        return dict(Counter(op.site for op in self.record.comm_ops))

    def describe(self, max_lines: Optional[int] = 40) -> str:
        rep = self.pass_report
        head = (f"CapturedProgram {self.name}: {self.num_ops} dispatched ops "
                f"-> one CUDA graph, "
                f"{sum(self.record.kernels.values())} hand-written kernel "
                f"launches, {len(self.record.comm_ops)} collectives, "
                f"donate={list(self.donate)}")
        lines = [head]
        if rep is not None:
            lines.append(
                f"passes: inlined={rep.inlined_calls} cse={rep.cse_folded} "
                f"consts_deduped={rep.consts_deduped} dve={rep.dve_removed} "
                f"comm_tagged={rep.comm_tagged} "
                f"({rep.eqns_before}->{rep.eqns_after} ops)")
        if self.pool_bytes is not None:
            lines.append(f"graph pool: {self.pool_bytes} bytes")
        body = [f"  kernel {k}: {v}" for k, v in
                sorted(self.record.kernels.items())]
        body += [f"  comm {k}: {v}" for k, v in
                 sorted(self.comm_sites().items())]
        body += [f"  {k}: {v}" for k, v in
                 sorted(self.op_counts().items(), key=lambda kv: -kv[1])]
        if max_lines is not None and len(body) > max_lines:
            body = body[:max_lines] + [
                f"  ... ({len(body) - max_lines} more)"]
        return "\n".join(lines + body)

    def __repr__(self):
        return (f"<CapturedProgram {self.name} ops={self.num_ops} "
                f"kernels={sum(self.record.kernels.values())} "
                f"collectives={len(self.record.comm_ops)} "
                f"donate={list(self.donate)}>")
