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

``next_key()`` is what a random op of the JAX package draws a key with;
the port has no JAX key, so it hands back a ``torch.Generator`` seeded by a
draw from the default generator (see its docstring). ``key_override``
routes it off an explicit base for a ``with`` block.
"""
from __future__ import annotations

import threading

import torch

from .device import DeviceLike, resolve_device

__all__ = ["Generator", "default_generator", "seed", "next_key",
           "key_override"]

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


# key_override's base and counter, per thread (as the JAX module's)
_trace = threading.local()
_MASK64 = (1 << 64) - 1


def _fold_in(base: int, n: int) -> int:
    """A 62-bit seed from ``(base, n)``: splitmix64 of the pair, so
    consecutive counters give unrelated streams."""
    z = (int(base) * 0x9E3779B97F4A7C15 + int(n) + 0x632BE59BD9B4E019) \
        & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 2


def _base_seed(key) -> int:
    if isinstance(key, torch.Generator):
        return int(key.initial_seed())
    if isinstance(key, torch.Tensor):
        return int(key.reshape(-1)[0].item())
    return int(key)


class key_override:
    """``with key_override(base):`` makes every ``next_key()`` of this
    thread inside the block draw off ``base`` (an int, a 0-dim integer
    tensor or a ``torch.Generator``, e.g. one ``next_key`` returned),
    counting from 0 at the block's start, and leaves the default
    generator untouched; the previous base and count come back on exit,
    also when blocks nest or one object is entered twice."""

    def __init__(self, key):
        self._key = key
        self._prev = []

    def __enter__(self):
        self._prev.append((getattr(_trace, "key", None),
                           getattr(_trace, "ctr", 0)))
        _trace.key = self._key
        _trace.ctr = 0
        return self

    def __exit__(self, *exc):
        _trace.key, _trace.ctr = self._prev.pop()
        return False


def next_key(*, device: DeviceLike = None) -> torch.Generator:
    """The port's counterpart of a fresh PRNG key: a ``torch.Generator``
    on ``device`` (default: the card) to pass as ``generator=`` to a
    random op. Outside ``key_override`` its seed is a draw from the
    default generator of that device, which advances that generator's
    state (``Generator.next_key``): deterministic given ``seed(s)`` and the
    call index. Inside it, the seed folds the block's base with a counter
    (1, 2, ... from the block's start). The JAX function returns a
    threefry key instead; the two packages' draws differ."""
    base = getattr(_trace, "key", None)
    if base is not None:
        _trace.ctr = getattr(_trace, "ctr", 0) + 1
        dev = resolve_device(device)
        return torch.Generator(device=dev).manual_seed(
            _fold_in(_base_seed(base), _trace.ctr))
    return default_generator(device).next_key()
