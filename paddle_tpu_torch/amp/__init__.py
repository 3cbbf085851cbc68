"""AMP: dynamic loss scaling (``GradScaler`` / ``AmpScaler``).

Counterpart of ``paddle_tpu/amp/``'s scaler alone. ``auto_cast``,
``decorate``, the white and black lists and ``amp.debugging`` hook the op
dispatch, which the port has not got yet: they wait for the slice that
ports it (ROADMAP.md Queue 1).
"""
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

__all__ = ["AmpScaler", "GradScaler"]
