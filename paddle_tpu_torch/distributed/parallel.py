"""This rank's share of a global batch.

Counterpart of ``paddle_tpu/distributed/parallel.py``'s ``shard_batch``
(:20). The JAX function lays the global batch out over the ``dp`` axis and
every device reads its block; here each rank is a process, holds the
global batch (or the same stream of it) and keeps its own block.
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel import mesh as mesh_mod

__all__ = ["shard_batch"]


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
