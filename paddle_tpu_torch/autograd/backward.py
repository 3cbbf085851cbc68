"""``backward`` and ``grad`` over ``torch.autograd``.

Counterpart of ``paddle_tpu/autograd/backward.py``: the JAX package walks
its own tape; here torch's engine does. What the JAX functions add on
top is kept: a root without a given gradient is seeded with ones when it
has one element whatever its shape (torch seeds only those), and a root
of any other size without one raises; ``grad`` leaves the inputs'
``.grad`` as it found it.
"""
from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["backward", "grad"]


def _seeds(roots, grad_tensors):
    if grad_tensors is None:
        grad_tensors = [None] * len(roots)
    out = []
    for t, g in zip(roots, grad_tensors):
        if g is None:
            if t.numel() != 1:
                raise RuntimeError("grad must be provided for non-scalar "
                                   "tensor in backward()")
            g = torch.ones_like(t)
        elif not isinstance(g, torch.Tensor):
            g = torch.as_tensor(g, dtype=t.dtype, device=t.device)
        out.append(g)
    return out


def backward(tensors: List[torch.Tensor],
             grad_tensors: Optional[List[Optional[torch.Tensor]]] = None,
             retain_graph: bool = False, create_graph: bool = False, *,
             inputs=None):
    """Accumulate d(tensors)/d(leaf) into every leaf's ``.grad`` (and into
    the non-leaves that ``retain_grads``). A root that is itself a leaf
    takes its seed as its grad, as the JAX tape does."""
    roots = [t for t in tensors if isinstance(t, torch.Tensor)]
    seeds = _seeds(roots, grad_tensors)
    live = [(t, g) for t, g in zip(roots, seeds) if t.requires_grad]
    if not live:
        return
    for t, g in live:
        if t.grad_fn is None:           # a leaf root: its seed is its grad
            with torch.no_grad():
                t.grad = g.detach().clone() if t.grad is None \
                    else t.grad + g
    graph = [(t, g) for t, g in live if t.grad_fn is not None]
    if graph:
        torch.autograd.backward([t for t, _ in graph],
                                [g for _, g in graph],
                                retain_graph=retain_graph or create_graph,
                                create_graph=create_graph, inputs=inputs)


def grad(outputs, inputs, grad_outputs=None, retain_graph=False,
         create_graph=False, allow_unused=False):
    """d(outputs)/d(inputs) as a list, one per input (None for an unused
    input with ``allow_unused``; without it, an unused input raises).
    With ``create_graph`` the grads are themselves differentiable."""
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    seeds = _seeds(outputs, grad_outputs)
    try:
        got = torch.autograd.grad(outputs, inputs, seeds,
                                  retain_graph=retain_graph or create_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
    except RuntimeError as e:
        if "does not require grad" in str(e) and not allow_unused:
            raise RuntimeError("an input tensor received no gradient; pass "
                               "allow_unused=True to permit this") from e
        raise
    if not allow_unused and any(g is None for g in got):
        raise RuntimeError("an input tensor received no gradient; pass "
                           "allow_unused=True to permit this")
    from ..core.tensor import Tensor
    return [None if g is None else
            (g if isinstance(g, Tensor) else g.as_subclass(Tensor))
            for g in got]
