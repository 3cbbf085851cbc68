"""Random state: named generators, each a ``torch.Generator`` on an
explicit device.

Counterpart of ``paddle_tpu/core/generator.py``. The JAX package folds
keys off one global threefry state; here a ``Generator`` wraps a
``torch.Generator`` on the device it was made for, and
``default_generator(device)`` wraps torch's own default generator of that
device, the one every random op without an explicit generator (dropout)
draws from and the one ``seed`` seeds. The two packages draw different
numbers from the same seed: parity tests make their inputs with numpy and
carry weights across with ``models.llama.load_paddle_tpu_state``.
"""
from __future__ import annotations

import threading

import torch

from .device import DeviceLike, resolve_device

__all__ = ["Generator", "default_generator", "seed"]

_lock = threading.Lock()
_defaults: dict = {}


def _torch_default(dev: torch.device) -> torch.Generator:
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        return torch.cuda.default_generators[idx]
    return torch.default_generator


class Generator:
    """``Generator(seed=0, name="default", *, device=None)``: a named,
    seedable random state on ``device`` (default: the card).
    ``generator`` is the ``torch.Generator`` to pass to random ops;
    ``get_state`` / ``set_state`` carry the seed and the torch state (the
    JAX class carries the seed and a fold-in offset)."""

    def __init__(self, seed: int = 0, name: str = "default", *,
                 device: DeviceLike = None,
                 generator: torch.Generator | None = None):
        self.name = name
        self.device = resolve_device(device) if generator is None \
            else generator.device
        self.generator = generator if generator is not None \
            else torch.Generator(device=self.device)
        if generator is None:
            self.manual_seed(seed)
        else:
            self._seed = int(generator.initial_seed())

    def manual_seed(self, seed: int):
        with _lock:
            self._seed = int(seed)
            self.generator.manual_seed(self._seed)
        return self

    def initial_seed(self) -> int:
        return self._seed

    def next_key(self) -> torch.Generator:
        """A fresh ``torch.Generator`` on this device, seeded from this
        generator's stream: deterministic given (seed, call index)."""
        with _lock:
            s = int(torch.randint(0, 2 ** 62, (1,), generator=self.generator,
                                  device=self.device).item())
        return torch.Generator(device=self.device).manual_seed(s)

    def get_state(self):
        return {"seed": self._seed, "state": self.generator.get_state()}

    def set_state(self, state):
        with _lock:
            self._seed = int(state["seed"])
            self.generator.set_state(state["state"])


def default_generator(device: DeviceLike = None) -> Generator:
    """The ``Generator`` over torch's default generator of ``device``
    (default: the card): the one ``seed`` seeds and dropout draws from."""
    dev = resolve_device(device)
    tg = _torch_default(dev)
    with _lock:
        g = _defaults.get(id(tg))
        if g is None:
            g = _defaults[id(tg)] = Generator(generator=tg, name="default")
    return g


def seed(s: int, device: DeviceLike = None) -> torch.Generator:
    """Reseed the default generator of ``device`` (default: the card) with
    ``s`` and return its ``torch.Generator`` (Paddle's ``paddle.seed``)."""
    return default_generator(device).manual_seed(s).generator
