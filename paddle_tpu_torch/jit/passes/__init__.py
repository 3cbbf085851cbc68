"""What the capture tier reports about a captured train step.

Counterpart of ``paddle_tpu/jit/passes/__init__.py``. The JAX tier records
a step as a jaxpr and runs a pass pipeline over it before one lowering:
``fusion`` (inline nested compiled regions), ``cse`` (fold duplicate
equations and constants), ``dve`` (drop dead equations), ``comm`` (tag
every collective and hoist the independent ones), with donation
inference beside it. The port records a step as the ops its eager
warm-up dispatched and captures the kernels they launch in one CUDA
graph; a graph replays those kernels as they were recorded and rewrites
no program. Each pass's disposition:

- ``fusion``: no counterpart. There are no nested compiled regions to
  inline: a CUDA graph is already one launch of the whole step. The
  kernels that fuse work are written by hand (U1, U2, K1-K7).
  ``inlined_calls`` stays 0.
- ``cse`` and ``dve``: no counterpart. An eager step runs what its Python
  asks for; there is no graph IR to fold or prune before the capture, and
  the capture keeps every launch. ``cse_folded``, ``consts_deduped``,
  ``dve_removed`` and ``dve_consts_dropped`` stay 0, and ``eqns_before``
  equals ``eqns_after`` (both the number of ops the warm-up dispatched).
- ``comm``: the tagging half is kept. ``comm_tagged`` counts the
  collectives ``distributed.comms`` recorded inside the captured step
  (its warm-up), the same count the JAX pass tags. The hoisting half has
  no counterpart: a graph keeps the collectives where the step issued
  them, on the streams they were issued on. ``comm_hoisted`` and
  ``comm_slots`` stay 0.
- ``donation``: replaced by ``inplace``. A graph holds every tensor it
  touches by address, so the arguments named ``inplace`` (the parameters,
  optimizer state, health scalars, learning rate and step count of a
  train step) are read and written where they lie, and every other
  tensor argument is copied into the graph's static input before a
  replay. ``donated_args`` lists the flat positions of the ``inplace``
  arguments' tensors. ``lint.py``'s ``donation-miss`` checks the case
  that matters here.
- ``ops/_op_cache.py``, the JAX package's per-op executable cache under
  the capture tier, has no counterpart: an eager PyTorch op dispatches to
  its compiled kernel directly, with nothing to trace or cache, and the
  tier under a captured step is plain eager execution.

``PT_STEP_CAPTURE_PASSES`` has no effect here: there is no pipeline to
select from.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

__all__ = ["PassReport"]


@dataclass
class PassReport:
    """What the capture tier recorded about one captured step (the JAX
    fields; those with no meaning here stay 0, see the module's text)."""
    inlined_calls: int = 0
    cse_folded: int = 0
    consts_deduped: int = 0
    dve_removed: int = 0
    dve_consts_dropped: int = 0
    comm_tagged: int = 0        # collectives comms recorded in the step
    comm_hoisted: int = 0
    comm_slots: int = 0
    donated_args: Tuple[int, ...] = ()   # flat positions held by address
    eqns_before: int = 0        # ops the warm-up dispatched
    eqns_after: int = 0
    passes_run: List[str] = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "inlined_calls": self.inlined_calls,
            "cse_folded": self.cse_folded,
            "consts_deduped": self.consts_deduped,
            "dve_removed": self.dve_removed,
            "dve_consts_dropped": self.dve_consts_dropped,
            "comm_tagged": self.comm_tagged,
            "comm_hoisted": self.comm_hoisted,
            "comm_slots": self.comm_slots,
            "donated_args": list(self.donated_args),
            "eqns_before": self.eqns_before,
            "eqns_after": self.eqns_after,
            "passes_run": list(self.passes_run),
        }
