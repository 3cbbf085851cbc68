"""Data parallelism: ``DataParallel`` and this rank's share of a global
batch.

Counterpart of ``paddle_tpu/distributed/parallel.py``. The JAX functions
lay the global batch out over the ``dp`` axis and let XLA insert the
gradient reduction; here each rank is a process:

- ``shard_batch`` (:20): each rank holds the global batch (or the same
  stream of it) and keeps its own block.
- ``DataParallel`` (:37-60): each rank feeds its own rows; at the end of
  every backward the grads of the wrapped model are averaged over dp (the
  sum over the ranks divided by their count, Paddle's reducer) by one
  ``comms.grad_sync`` (exact, or the quantized two-shot inside
  ``comms.quantized()``), queued on the autograd engine when the first
  grad lands, so ``loss.backward(); opt.step()`` trains as Paddle's
  DataParallel does.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..parallel import mesh as mesh_mod

__all__ = ["shard_batch", "DataParallel"]


def shard_batch(x, axis: str = "dp", dim: int = 0, mesh=None):
    """Rank ``i``'s block of ``x`` along ``dim``, where ``i`` is its
    coordinate on ``axis``: rows ``[i n / k, (i + 1) n / k)`` for an extent
    ``k`` that divides ``n``. With no mesh, no such axis or an extent of 1,
    ``x`` itself. ``x`` is a tensor or an array; nested dicts, lists and
    tuples are taken leaf by leaf."""
    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    if isinstance(x, dict):
        return {k: shard_batch(v, axis, dim, mesh) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(shard_batch(v, axis, dim, mesh) for v in x)
    k = mesh_mod.mesh_axis_size(axis, mesh)
    if k == 1 or not isinstance(x, (torch.Tensor, np.ndarray)):
        return x
    n = x.shape[dim]
    if n % k:
        raise ValueError(f"dim {dim} of size {n} does not split over "
                         f"{axis}={k}")
    i = mesh_mod.axis_index(axis, mesh)
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(i * n // k, (i + 1) * n // k)
    return x[tuple(idx)]


class DataParallel(nn.Module):
    """``DataParallel(layers, strategy=None, comm_buffer_size=25,
    last_comm_buffer_size=1, find_unused_parameters=False, group=None)``:
    the grads of ``layers`` averaged over dp (or over ``group``, a
    ``collective.Group``) after each backward. The buffer sizes are
    Paddle's bucketing knobs; the sync buckets by
    ``comms.api.BUCKET_BYTES``. A parameter that got no grad in a
    backward is synced as zeros, so every rank runs the same
    collective."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self._group = group
        self._queued = False
        for p in self._params():
            p.register_post_accumulate_grad_hook(self._on_grad)

    def _params(self):
        return [p for p in self._layers.parameters() if p.requires_grad]

    def _axis(self):
        return self._group if self._group is not None else "dp"

    def _on_grad(self, _p) -> None:
        if not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self.apply_collective_grads)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, state_dict, *a, **k):
        return self._layers.load_state_dict(state_dict, *a, **k)

    def scale_loss(self, loss):
        return loss     # the sync averages the grads

    def apply_collective_grads(self) -> None:
        """Average every parameter's grad over dp, in place (the end of
        each backward runs it)."""
        from . import comms
        self._queued = False
        params = self._params()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if comms.link(self._axis()).n == 1:
            return
        synced = comms.grad_sync(grads, axis=self._axis(),
                                 owner="data_parallel.grad_sync", op="avg")
        with torch.no_grad():
            for p, g in zip(params, synced):
                p.grad = g.view_as(p)
