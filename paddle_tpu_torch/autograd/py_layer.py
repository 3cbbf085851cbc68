"""PyLayer: user-defined autograd ops, as a ``torch.autograd.Function``.

Counterpart of ``paddle_tpu/autograd/py_layer.py``. The user's static
``forward(ctx, *args, **kwargs)`` runs with grad recording off; the
user's ``backward(ctx, *grads)`` returns one grad per tensor input (None
for one that needs none), which is mapped onto torch's one-per-argument
contract. ``ctx.save_for_backward`` saves through torch, so
``saved_tensors_hooks`` apply to it.
"""
from __future__ import annotations

import torch

__all__ = ["PyLayer", "PyLayerContext"]


class PyLayerContext:
    def __init__(self):
        self._ctx = None
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._ctx.save_for_backward(*tensors)

    @property
    def saved_tensor(self):
        return self.saved_tensors()

    def saved_tensors(self):
        from ..core.tensor import _wrap
        return _wrap(tuple(self._ctx.saved_tensors))


def _function_of(cls):
    fn = cls.__dict__.get("_pt_function")
    if fn is not None:
        return fn

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, pctx, kwargs, *args):
            pctx._ctx = ctx
            ctx.pctx = pctx
            ctx.tensor_pos = [i for i, a in enumerate(args)
                              if isinstance(a, torch.Tensor)]
            ctx.n_args = len(args)
            out = cls.forward(pctx, *args, **kwargs)
            ctx.set_materialize_grads(pctx.materialize_grads)
            return out

        @staticmethod
        def backward(ctx, *grads):
            from ..core.tensor import _wrap
            got = cls.backward(ctx.pctx, *_wrap(tuple(grads)))
            if not isinstance(got, (tuple, list)):
                got = (got,)
            full = [None] * ctx.n_args
            for pos, g in zip(ctx.tensor_pos, got):
                full[pos] = g
            return (None, None, *full)

    _Fn.__name__ = cls.__name__
    cls._pt_function = _Fn
    return _Fn


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        from ..core.tensor import _wrap
        return _wrap(_function_of(cls).apply(PyLayerContext(), kwargs,
                                             *args))
