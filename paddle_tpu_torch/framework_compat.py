"""Top-level framework names (counterpart of
``paddle_tpu/framework_compat.py``, the part this slice ports): places,
``ParamAttr``, ``finfo``/``iinfo``, the rng-state getters and setters and
``set_grad_enabled``. The places are kept for source compatibility: the
creation ops take ``place`` as a device string (``"cpu"``, ``"cuda:0"``)."""
from __future__ import annotations

import contextlib

import torch

from .core import dtype as _dt
from .core.generator import default_generator

__all__ = ["dtype", "iinfo", "finfo", "get_rng_state", "set_rng_state",
           "get_cuda_rng_state", "set_cuda_rng_state", "ParamAttr", "Place",
           "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "set_grad_enabled"]

dtype = torch.dtype


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
    with torch.set_grad_enabled(bool(mode)):
        yield
