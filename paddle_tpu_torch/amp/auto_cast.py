"""auto_cast: op-level automatic mixed precision.

Counterpart of ``paddle_tpu/amp/auto_cast.py``: the port's own copy of
the JAX package's white and black lists (not ``torch.autocast``'s),
consulted by ``ops.dispatch.apply`` for every op it runs. O1 casts the
floating inputs of white-listed ops to the amp dtype and those of
black-listed ops to float32; ``decorate(level="O2")`` also casts a
model's parameters, norm layers aside.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from ..core import dtype as dtypes

__all__ = ["WHITE_LIST", "BLACK_LIST", "white_list", "black_list",
           "amp_state", "amp_cache_key", "amp_dtype_for", "auto_cast",
           "amp_guard", "is_float16_supported", "is_bfloat16_supported",
           "decorate"]

# ops that run well in low precision on the tensor cores (matmul/conv)
WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "einsum", "bmm", "mm", "mv",
    "addmm", "sdpa", "lstm", "gru", "rnn_tanh", "rnn_relu",
}
# ops that must stay fp32 for numerics
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "cross_entropy", "softmax_with_cross_entropy", "nll_loss",
    "bce_with_logits", "binary_cross_entropy", "mse_loss", "l1_loss",
    "kl_div", "ctc_loss", "softmax", "log_softmax", "logsumexp", "norm",
    "mean", "sum", "cumsum", "layer_norm", "rms_norm", "batch_norm",
    "group_norm", "instance_norm",
}


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = dtypes.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_state() -> _AmpState:
    return _state


def amp_cache_key():
    """Hashable token of what a captured step bakes in of the amp regime
    (the capture tier keys its signatures on it)."""
    if not _state.enabled:
        return False
    return (True, dtypes.dtype_name(_state.dtype),
            tuple(sorted(_state.custom_white)),
            tuple(sorted(_state.custom_black)))


def amp_dtype_for(op_name: str):
    """The dtype ``op_name``'s floating inputs are cast to under the
    current regime, or None: float32 for black-listed ops (custom ones
    first), the amp dtype for white-listed ones."""
    if not _state.enabled:
        return None
    name = op_name.lower()
    if name in _state.custom_black or name in BLACK_LIST:
        return dtypes.float32
    if name in _state.custom_white or name in WHITE_LIST:
        return _state.dtype
    return None


@contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    prev = (_state.enabled, _state.dtype, _state.level,
            _state.custom_white, _state.custom_black)
    _state.enabled = enable
    _state.dtype = dtypes.convert_dtype(dtype)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white, _state.custom_black) = prev


amp_guard = auto_cast


def is_float16_supported(device=None):
    """fp16 computes on the card (and on the CPU)."""
    return True


def is_bfloat16_supported(device=None):
    """The H100 computes bf16 natively; the CPU emulates it."""
    return True


def _norm_types():
    from ..nn.layers import RMSNorm
    return (RMSNorm,)


def decorate(models, optimizers=None, level="O1", dtype="float16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2: cast the floating parameters of ``models`` to ``dtype`` in
    place, except those of norm layers and ``excluded_layers`` (types or
    instances); O1 leaves them (auto_cast acts per op)."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level not in ("O1", "O2"):
        raise ValueError(f"level must be O1 or O2, got {level!r}")
    if level == "O2":
        norm_types = _norm_types()
        excluded = []
        if excluded_layers is not None:
            excluded = ([excluded_layers]
                        if not isinstance(excluded_layers, (list, tuple))
                        else list(excluded_layers))
        ex_types = tuple(e for e in excluded if isinstance(e, type))
        ex_insts = [e for e in excluded if not isinstance(e, type)]
        dt = dtypes.convert_dtype(dtype)
        for m in model_list:
            for sub in m.modules():
                if isinstance(sub, norm_types) or isinstance(sub, ex_types) \
                        or any(sub is e for e in ex_insts):
                    continue
                for p in sub._parameters.values():
                    if p is not None and p.is_floating_point():
                        with torch.no_grad():
                            p.data = p.data.to(dt)
    if save_dtype is not None:
        for m in model_list:
            m._amp_save_dtype = dtypes.convert_dtype(save_dtype)
    models_out = model_list[0] if single_model else model_list
    if optimizers is None:
        return models_out
    return models_out, optimizers
