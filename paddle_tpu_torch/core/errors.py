"""Errors shared across the port."""
from __future__ import annotations

__all__ = ["NotInThisSlice"]


class NotInThisSlice(NotImplementedError):
    """A feature the port does not have yet. Raised where it is asked for
    (at construction or call), never ignored; ROADMAP.md Queue 1 lists the
    slice that brings it."""

    def __init__(self, feature: str, knob: str):
        self.feature = feature
        super().__init__(
            f"{feature} ({knob}) is not ported to paddle_tpu_torch yet: it "
            f"waits for a later slice listed in ROADMAP.md Queue 1")
