"""A captured step's record viewed as a static Program.

Counterpart of ``paddle_tpu/static/graft_program.py`` (``GraftProgram``).
The port's captured step is ``jit.program.CapturedProgram`` (its warm-up's
op record, kernel launches, collectives and pass report); ``GraftProgram``
gives it the static world's view: ``as_program()`` re-materialises the op
record as a ``static.framework.Program`` for inspection only (its
Operators carry names, not callables: execution belongs to the CUDA
graph), and ``op_counts()`` / ``describe()`` read it.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["GraftProgram"]


class GraftProgram:
    """A ``jit.program.CapturedProgram`` seen as the JAX ``GraftProgram``:
    ``num_eqns`` (ops recorded), ``op_counts``, ``as_program``,
    ``describe``."""

    def __init__(self, captured):
        self.captured = captured
        self.op_names = list(captured.record.ops)
        self.pass_report = captured.pass_report
        self.donate = tuple(captured.donate)

    @property
    def num_eqns(self) -> int:
        return len(self.op_names)

    def op_counts(self) -> dict:
        return self.captured.op_counts()

    def as_program(self):
        """The op record as a ``static.framework.Program`` (inspection
        only)."""
        from .framework import Operator, Program
        prog = Program()
        block = prog.global_block()
        for i, name in enumerate(self.op_names):
            block.append_op(Operator(None, (), {}, [f"{name}_{i}"], name))
        return prog

    def describe(self, max_lines: Optional[int] = 40) -> str:
        return self.captured.describe(max_lines)

    def __repr__(self):
        return (f"<GraftProgram ops={len(self.op_names)} "
                f"donate={list(self.donate)}>")
