"""``saved_tensors_hooks`` over ``torch.autograd.graph.saved_tensors_hooks``.

Counterpart of ``paddle_tpu/autograd/saved_tensors_hooks.py``. The JAX
package packs only what ``PyLayerContext.save_for_backward`` saves; torch
applies the pair to every tensor any op saves for backward while the
context is open, ``PyLayer``'s saves included. ``pack_hook`` gets a port
``Tensor``.
"""
from __future__ import annotations

import torch

__all__ = ["saved_tensors_hooks", "current_hooks"]

_active: list = []


def current_hooks():
    """The innermost open ``(pack_hook, unpack_hook)``, or None."""
    return _active[-1] if _active else None


class saved_tensors_hooks(torch.autograd.graph.saved_tensors_hooks):  # noqa: N801
    def __init__(self, pack_hook, unpack_hook):
        from ..core.tensor import Tensor
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook

        def pack(t):
            return pack_hook(t if isinstance(t, Tensor)
                             else t.as_subclass(Tensor))
        super().__init__(pack, unpack_hook)

    def __enter__(self):
        _active.append((self.pack_hook, self.unpack_hook))
        return super().__enter__()

    def __exit__(self, *exc):
        _active.pop()
        return super().__exit__(*exc)
