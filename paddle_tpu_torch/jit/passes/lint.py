"""Analyze-only lint of a captured step: the hazards a CUDA graph of it
would hide.

Counterpart of ``paddle_tpu/jit/passes/lint.py``. The JAX rules read the
closed jaxpr a step lowers to; these read what the step's eager warm-up
did (``jit.capture``'s record of it: the ops it dispatched, the
collectives, the in-place writes, the host syncs the guard caught, the
signatures the step was called with). The rules, by the JAX names:

- ``recompile-hazard``: the step was called with more than one signature
  (shapes, dtypes, devices, Python values). Only the first is a graph;
  every other call runs eagerly (the JAX rule flags weakly typed inputs,
  the way a Python scalar makes value-equal calls lower twice).
- ``donation-miss``: the step wrote in place to a tensor argument that is
  not ``inplace``. A replay copies such an argument into the graph's
  static input first, so the write lands on that copy and the caller's
  tensor never changes (the JAX rule flags donated inputs that alias no
  output and donatable ones left undonated: the buffers a step holds
  twice; a graph holds every tensor by address and has no such copies).
- ``unscheduled-collective``: a ``torch.distributed`` collective issued
  outside ``distributed.comms`` (no CommOp record, no deadline, invisible
  to ``comm_summary``). The JAX rule's second check, a full-precision
  reduction on the axis of a quantized leg, is not ported: the port's
  records name each leg, and ``comms.grad_sync`` keeps a grad smaller
  than one block a rank exact beside the quantized ones by design.
- ``dead-compute``: no counterpart. An eager step runs every op its
  Python asks for, and the graph replays each of them; there is no
  program whose unreachable equations could be found before it runs. The
  rule never fires here.
- ``host-callback``: a host sync inside the step (``.item()``,
  ``.cpu()``, a synchronising CUDA call), which the warm-up's guard
  caught: the step cannot be a graph, and every eager run of it stalls
  the stream.

Records land in a bounded registry that ``profiler.lint_summary()``
renders. ``PT_STEP_CAPTURE_LINT=0`` turns the per-capture hook off
(``analyze`` keeps working for explicit callers).
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import List, Optional

__all__ = ["RULES", "analyze", "lint_records", "record_lint",
           "clear_lint_records", "lint_enabled", "comm_tagged_of"]

RULES = ("recompile-hazard", "donation-miss", "unscheduled-collective",
         "dead-compute", "host-callback")

_MAX_RECORDS = 64


def lint_enabled() -> bool:
    return os.environ.get("PT_STEP_CAPTURE_LINT", "1").lower() \
        not in ("0", "false")


def comm_tagged_of(report) -> int:
    """The collective count of one capture's PassReport (0 with none)."""
    return 0 if report is None else int(report.comm_tagged)


def _finding(rule: str, detail: str, message: str) -> dict:
    return {"rule": rule, "detail": detail, "message": message}


def analyze(program, *, donated=(), comm_tagged: Optional[int] = None,
            name: str = "step") -> List[dict]:
    """Every rule over one step's record (a ``jit.program.CapturedProgram``
    or the ``StepRecord`` of a warm-up that bailed out); the finding dicts
    (rule / detail / message). ``donated`` and ``comm_tagged`` are taken
    from the record; they are the JAX function's parameters."""
    del donated, comm_tagged, name
    rec = getattr(program, "record", program)
    findings: List[dict] = []
    if rec.signatures > 1:
        findings.append(_finding(
            "recompile-hazard", f"signatures={rec.signatures}",
            f"the step was called with {rec.signatures} signatures; only "
            f"the first is a CUDA graph and every other call runs eagerly: "
            f"keep shapes, dtypes and Python arguments fixed (pass a "
            f"changing number as a tensor)"))
    if rec.copied_writes:
        what = ", ".join(sorted(set(rec.copied_writes)))
        findings.append(_finding(
            "donation-miss", f"copied_writes={len(rec.copied_writes)}",
            f"the step writes in place to an argument that is not inplace "
            f"({what}): a replay writes the graph's copy of it and the "
            f"caller's tensor never changes; name the argument in inplace"))
    if rec.unscheduled:
        what = ", ".join(sorted(set(rec.unscheduled)))
        findings.append(_finding(
            "unscheduled-collective", f"untagged={len(rec.unscheduled)}",
            f"{len(rec.unscheduled)} torch.distributed collective(s) "
            f"({what}) issued outside distributed.comms: no CommOp "
            f"record, no deadline, invisible to comm_summary"))
    if rec.host_syncs:
        findings.append(_finding(
            "host-callback", f"host_syncs={len(rec.host_syncs)}",
            f"host sync inside the step ({rec.host_syncs[0]}): it cannot "
            f"be a CUDA graph, and every run of it stalls the stream"))
    return findings


class _Records:
    """The per-step registry: one entry a step name, the newest wins,
    bounded."""

    def __init__(self):
        self.lock = threading.Lock()
        self.items: "OrderedDict[str, dict]" = OrderedDict()


_RECORDS = _Records()


def record_lint(name: str, program, *, donated=(),
                comm_tagged: Optional[int] = None) -> List[dict]:
    """The capture hook: analyze one step's record and file it under the
    step's name. Never raises (observability must not break a capture);
    returns the findings."""
    try:
        findings = analyze(program, donated=donated, comm_tagged=comm_tagged,
                           name=name)
        rec = getattr(program, "record", program)
        with _RECORDS.lock:
            _RECORDS.items[name] = {
                "eqns": len(rec.ops), "findings": findings,
                "rules_hit": sorted({f["rule"] for f in findings})}
            _RECORDS.items.move_to_end(name)
            while len(_RECORDS.items) > _MAX_RECORDS:
                _RECORDS.items.popitem(last=False)
        return findings
    except Exception:  # noqa: BLE001 - lint may never break a capture
        return []


def lint_records() -> dict:
    """``{step name: {eqns, findings, rules_hit}}`` of recent captures
    (``eqns``: the ops the warm-up dispatched)."""
    with _RECORDS.lock:
        return dict(_RECORDS.items)


def clear_lint_records() -> None:
    with _RECORDS.lock:
        _RECORDS.items.clear()
