"""Top-level framework names: counterpart of
``paddle_tpu/framework_compat.py``. Places, ``ParamAttr``,
``finfo``/``iinfo``, the rng-state getters and setters,
``set_grad_enabled``, ``LazyGuard``, ``flops``, ``batch``, ``bool``,
``set_printoptions``, ``check_shape`` and ``disable_signal_handler``. The
places are kept for source compatibility: the creation ops take ``place``
as a device string (``"cpu"``, ``"cuda:0"``).

``LazyGuard`` builds layers on the ``meta`` device (no memory, no
initialiser draws) and ``Layer.lazy_init`` (or the layer's first forward)
builds them for real; the JAX one keeps zeros placeholders and runs their
initialisers later. ``flops`` counts with ``torch.utils.flop_counter``
where the JAX one asks XLA's cost analysis: both count ``2 m n k`` a
matrix product; XLA also counts elementwise work, which torch's counter
does not.
"""
from __future__ import annotations

import builtins
import contextlib

import numpy as np
import torch

from .core import dtype as _dt
from .core.generator import default_generator

__all__ = ["dtype", "iinfo", "finfo", "get_rng_state", "set_rng_state",
           "get_cuda_rng_state", "set_cuda_rng_state", "ParamAttr", "Place",
           "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "set_grad_enabled", "LazyGuard", "flops", "batch", "bool",
           "set_printoptions", "check_shape", "disable_signal_handler"]

dtype = torch.dtype
bool = torch.bool  # noqa: A001 (Paddle exposes ``paddle.bool``)


def iinfo(d):
    """Integer dtype limits (min, max, bits, dtype)."""
    return torch.iinfo(_dt.convert_dtype(d))


def finfo(d):
    """Float dtype limits (eps, min, max, tiny, bits, ...); bfloat16
    included."""
    return torch.finfo(_dt.convert_dtype(d))


def get_rng_state(device=None):
    """``[state]`` of the default generator of ``device`` (default: the
    card)."""
    return [default_generator(device).get_state()]


def set_rng_state(state_list, device=None):
    states = state_list if isinstance(state_list, (list, tuple)) \
        else [state_list]
    default_generator(device).set_state(states[0])


def get_cuda_rng_state():
    return get_rng_state("cuda")


def set_cuda_rng_state(state_list):
    set_rng_state(state_list, "cuda")


class ParamAttr:
    """Parameter construction attributes: name, initializer, learning-rate
    scale, regularizer, trainability (read by ``Layer.create_parameter``
    and the layers' ``weight_attr``)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip


class Place:
    def __init__(self, device_id=0):
        self._id = int(device_id)

    def __repr__(self):
        return f"{type(self).__name__}({self._id})"

    def __eq__(self, other):
        return type(self) is type(other) and self._id == other._id

    def __hash__(self):
        return hash((type(self).__name__, self._id))


class CPUPlace(Place):
    def __init__(self):
        super().__init__(0)


class CUDAPlace(Place):
    """Card ``device_id``."""


class CUDAPinnedPlace(Place):
    def __init__(self):
        super().__init__(0)


class TPUPlace(Place):
    """Accepted for source compatibility (the port has no TPU)."""


@contextlib.contextmanager
def set_grad_enabled(mode):
    """Grad recording on or off inside the block."""
    with torch.set_grad_enabled(builtins.bool(mode)):
        yield


class LazyGuard:
    """``with LazyGuard():`` layers built in the block are placeholders on
    the ``meta`` device (no memory, no initialiser draws);
    ``layer.lazy_init()``, or the layer's first forward, builds them for
    real from the arguments they were built with. Blocks nest; the guard
    holds for this thread."""

    def __enter__(self):
        from .core import device as _dev
        _dev._state.lazy = getattr(_dev._state, "lazy", 0) + 1
        return self

    def __exit__(self, *exc):
        from .core import device as _dev
        _dev._state.lazy -= 1
        return False


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Forward FLOPs of ``net`` on a zeros input of ``input_size``, as
    ``torch.utils.flop_counter`` counts them (``2 m n k`` a matrix product,
    the convolutions and attention by their formulas). A layer built
    under ``LazyGuard`` is materialised first."""
    from torch.utils.flop_counter import FlopCounterMode

    from .core.device import resolve_device
    from .core.tensor import Tensor
    if hasattr(net, "lazy_init"):
        net.lazy_init()
    dev = next((p.device for p in net.parameters()), None) \
        or resolve_device(None)
    x = Tensor(torch.zeros(tuple(int(s) for s in input_size), device=dev))
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        net(x)
    total = int(counter.get_total_flops())
    if print_detail:
        print(f"Total Flops: {total} (torch.utils.flop_counter)")
    return total


def batch(reader, batch_size, drop_last=False):
    """A batch reader over a sample reader: lists of ``batch_size``
    samples, the last shorter one kept unless ``drop_last``."""

    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """How tensors print (``torch.set_printoptions``; a port Tensor
    prints through torch)."""
    kw = {k: v for k, v in (("precision", precision),
                            ("threshold", threshold),
                            ("edgeitems", edgeitems),
                            ("linewidth", linewidth),
                            ("sci_mode", sci_mode)) if v is not None}
    torch.set_printoptions(**kw)


def disable_signal_handler():
    """Paddle releases its C++ fault signal handlers here; the port
    installs none, so there is nothing to release."""


def check_shape(shape):
    """Validate a shape argument: an int, a list or tuple of ints (or
    tensors), or a 1-D tensor; -1 is allowed. TypeError or ValueError
    otherwise."""
    if isinstance(shape, torch.Tensor):
        if shape.ndim != 1:
            raise ValueError("shape Tensor must be 1-D")
        return
    if isinstance(shape, (list, tuple)):
        for s in shape:
            if isinstance(s, torch.Tensor):
                continue
            if not isinstance(s, (int, np.integer)):
                raise TypeError(f"shape element {s!r} is not an int")
        return
    if not isinstance(shape, (int, np.integer)):
        raise TypeError(f"unsupported shape {shape!r}")
