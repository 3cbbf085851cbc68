"""Named random states across the parallel axes.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/random_state.py``
(after Paddle's ``fleet/layers/mpu/random.py:34`` ``RNGStatesTracker``):
a registry of named ``core.generator.Generator`` s, so that e.g. dropout
inside the tensor-parallel layers draws the same mask on every mp rank.

``rng_state(name)`` swaps the named generator's state into torch's default
generator of its device for the block (the generator every random op
without an explicit one draws from); on exit the named generator keeps the
advanced state and the default gets its own back. The JAX function routes
``next_key()`` off the named generator instead.

Seeds are the JAX function's: ``model_parallel_random_seed(seed)`` adds
``model_parallel_rng`` at ``seed + 1`` and ``global_seed`` at ``seed`` on
every rank, and reseeds the default generator. Paddle offsets the mp
stream by the mp rank; the reference does not, so neither does the port.
"""
from __future__ import annotations

from contextlib import contextmanager

from ....core import generator as gen

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed"]


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed, *, device=None):
        """A generator ``name`` seeded with ``seed`` on ``device`` (default:
        the card)."""
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        self.states_[name] = gen.Generator(seed, name=name, device=device)

    def get_states_tracker(self):
        return {n: g.get_state() for n, g in self.states_.items()}

    def set_states_tracker(self, states):
        for n, s in states.items():
            if n in self.states_:
                self.states_[n].set_state(s)

    @contextmanager
    def rng_state(self, name="model_parallel_rng"):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        g = self.states_[name]
        default = gen.default_generator(g.device).generator
        saved = default.get_state()
        default.set_state(g.generator.get_state())
        try:
            yield
        finally:
            g.generator.set_state(default.get_state())
            default.set_state(saved)


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed=None, *, device=None):
    """Reset the tracker with ``model_parallel_rng`` (``seed + 1``) and
    ``global_seed`` (``seed``) on ``device`` (default: the card), and seed
    the device's default generator with ``seed``."""
    import numpy as np
    seed = seed if seed is not None else int(np.random.randint(0, 2 ** 31))
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add("model_parallel_rng", seed + 1, device=device)
    _RNG_STATE_TRACKER.add("global_seed", seed, device=device)
    gen.seed(seed, device)
