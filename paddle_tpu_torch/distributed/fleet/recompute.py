"""Recompute (activation checkpointing).

Counterpart of ``paddle_tpu/distributed/fleet/recompute.py`` (after
Paddle's ``fleet/recompute/recompute.py:69`` and ``recompute_hybrid.py``).
``recompute(function, *args, **kwargs)`` keeps only the inputs and runs
``function`` again in the backward (``torch.utils.checkpoint``, the
non-reentrant form whatever ``use_reentrant`` says: the reentrant form
gives the parameters no grad when no input requires one, and the JAX
function ignores the flag too). With ``preserve_rng_state`` (the default)
the recomputed forward replays the default generators' states and the
states of ``get_rng_state_tracker()``, so dropout inside
``rng_state(...)`` draws the same mask twice.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext

from torch.utils.checkpoint import checkpoint

from .meta_parallel.random_state import get_rng_state_tracker

__all__ = ["recompute", "recompute_sequential", "recompute_hybrid"]


def _tracker_context():
    """(forward context, recompute context): the recompute one runs with
    the tracker's states as they were when the forward began."""
    tracker = get_rng_state_tracker()
    saved = tracker.get_states_tracker()

    @contextmanager
    def replay():
        now = tracker.get_states_tracker()
        tracker.set_states_tracker(saved)
        try:
            yield
        finally:
            tracker.set_states_tracker(now)
    return nullcontext(), replay()


def recompute(function, *args, **kwargs):
    preserve_rng_state = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", True)
    ctx = {"context_fn": _tracker_context} if preserve_rng_state else {}
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **ctx, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """``functions`` (a list or a ``Sequential``) cut into
    ``ctx["segments"]`` segments, each recomputed on its own."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    funcs = list(functions)
    seg_size = max(len(funcs) // max(segments, 1), 1)
    out = args[0] if len(args) == 1 else args

    def run_segment(fs):
        def seg(x):
            for f in fs:
                x = f(x)
            return x
        return seg
    i = 0
    while i < len(funcs):
        out = recompute(run_segment(funcs[i:i + seg_size]), out)
        i += seg_size
    return out


def recompute_hybrid(ctx, function, *args, **kwargs):
    return recompute(function, *args, **kwargs)
