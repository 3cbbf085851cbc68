"""Sharded embedding tables: hash-bucketed rows over a named mesh axis.

Counterpart of ``paddle_tpu/distributed/embedding/sharded.py``. The
layout contract is the JAX module's: the table is one logical
``[num_buckets, dim]`` array, row-sharded as contiguous blocks over
``shard_axis``, shard ``d`` owning rows ``[d * rows_local, (d+1) *
rows_local)``. The JAX package keeps that logical array and GSPMD shards
it. Here a rank is a process, and it holds only its block: a tensor whose
``dist_layout`` (``checkpoint.set_layout``) names the global shape and
the ``(shard_axis, None)`` spec. ``ShardedEmbedding`` decides once, at
construction, whether the table is sharded on the mesh it is given: a
live ``shard_axis`` of extent ``n > 1`` that divides ``num_buckets``.
Otherwise every rank holds the whole table and a lookup is the dense
gather (its gradient is then synced like any dense parameter's).
``layer.shards`` records the choice.

``hash_bucket`` is the JAX function bit for bit: the id's low 32 bits as
an unsigned integer, times 2654435761 modulo 2**32, ``u ^ (u >> 16)``,
then modulo ``num_buckets``; here in int64 arithmetic masked to 32 bits
(the product is split in two 16-bit halves, so nothing overflows).

The lookup on a sharded table (every shape static, no host sync, so a
train step holding it can be one CUDA graph):

1. flatten this rank's ids and bucket them, then a **static-size
   unique** with ``jnp.unique(size=L, fill_value=0)``'s semantics: the
   sorted distinct rows padded with 0, and the inverse map (a sort, a
   first-occurrence mask and a scatter; ``torch.unique`` returns a
   data-dependent size and syncs the host);
2. pack the uniques into per-owner capacity buckets (``[n, capacity]``;
   the default capacity is the full flattened count, which never drops)
   and exchange them with one ``comms.wire_all_to_all`` (int32, exact,
   site ``<owner>.ids``); an empty slot carries -1 (the JAX buffer holds
   0, and the slot is never read back either way);
3. gather the requested rows from this rank's block;
4. return them with ``comms.wire_exchange`` (site ``<owner>.rows``:
   int8/fp8 inside ``comms.quantized()``, exact outside it), whose
   backward pushes the deduplicated row gradients back over the same wire
   (``<owner>.rows.grad``).

A unique that overflows its owner's capacity reads the zero embedding, as
in the JAX module. The owner applies the returned row gradients to its
block with ``index_add_``, one call per sending rank in rank order: within
one sender's block every real row is distinct, and the empty slots go to
a scratch row that is dropped, so no row takes two additions in one call
and the sums are the same on the card (atomic adds) and the CPU. A row's
gradient is then ``((g_0 + g_1) + ...)`` over the sending ranks, each
``g_r`` that rank's own sum over its duplicates (the deduplicating
gather's backward). The dense gather sums every occurrence in one pass,
so the two agree to rounding, not bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...parallel import mesh as mesh_mod

__all__ = ["ShardedEmbedding", "hash_bucket", "sharded_lookup",
           "table_param_spec", "unique_static"]

# Knuth's multiplicative hash constant (2654435761 = 2^32 / phi)
_HASH_MULT = 2654435761
_MASK32 = 0xFFFFFFFF


def hash_bucket(ids, num_buckets: int, hashed: bool = True) -> torch.Tensor:
    """Map raw ids to table rows in ``[0, num_buckets)`` (int32), as the
    JAX function's uint32 arithmetic does. ``hashed=False`` is the
    identity modulo ``num_buckets``."""
    ids = torch.as_tensor(ids)
    u = ids.to(torch.int64) & _MASK32
    if hashed:
        lo = u * (_HASH_MULT & 0xFFFF)
        hi = ((u * (_HASH_MULT >> 16)) & 0xFFFF) << 16
        u = (lo + hi) & _MASK32
        u = u ^ (u >> 16)
    return (u % int(num_buckets)).to(torch.int32)


def unique_static(flat: torch.Tensor):
    """``(uniques [L], inverse [L])`` of a 1-D tensor with
    ``jnp.unique(flat, size=L, fill_value=0, return_inverse=True)``'s
    semantics: the distinct values in ascending order, then zeros; every
    size static and nothing read on the host."""
    L = flat.shape[0]
    s, order = torch.sort(flat, stable=True)
    first = torch.ones(L, dtype=torch.bool, device=flat.device)
    first[1:] = s[1:] != s[:-1]
    pos = torch.cumsum(first, 0) - 1
    dump = torch.full_like(pos, L)
    uids = torch.zeros(L + 1, dtype=flat.dtype, device=flat.device)
    uids.scatter_(0, torch.where(first, pos, dump), s)
    inv = torch.empty_like(pos).scatter_(0, order, pos)
    return uids[:L], inv


class _RowGather(torch.autograd.Function):
    """Rows ``lidx [n, cap]`` of the local block ``w``; the backward adds
    the cotangent rows into the block, one ``index_add_`` per sending rank
    in rank order, the slots ``valid`` marks empty sent to a dropped
    scratch row."""

    @staticmethod
    def forward(ctx, w, lidx, valid):
        ctx.save_for_backward(lidx, valid)
        ctx.rows = w.shape[0]
        return w[lidx]

    @staticmethod
    def backward(ctx, g):
        lidx, valid = ctx.saved_tensors
        rows = ctx.rows
        out = torch.zeros((rows + 1,) + tuple(g.shape[2:]), dtype=g.dtype,
                          device=g.device)
        dest = torch.where(valid, lidx, torch.full_like(lidx, rows))
        for j in range(g.shape[0]):
            out.index_add_(0, dest[j], g[j])
        return out[:rows], None, None


def _exchange_lookup(ids, w, *, axis: str, n: int, num_buckets: int,
                     hashed: bool, capacity: Optional[int], owner: str,
                     mesh):
    """This rank's ids ``[B_local, ...]`` and table block ``w
    [num_buckets / n, dim]`` -> embeddings ``[B_local, ..., dim]``."""
    from .. import comms

    rows_local, dim = int(w.shape[0]), int(w.shape[1])
    dev = w.device
    flat = hash_bucket(ids, num_buckets, hashed).reshape(-1).to(torch.int64)
    L = flat.shape[0]
    cap = int(capacity) if capacity else L

    # 1. static-size unique
    uids, inv = unique_static(flat)
    owner_of = torch.clamp(uids // rows_local, 0, n - 1)

    # 2. per-owner capacity buckets: stable sort by owner, the position in
    #    the owner's group from its first occurrence
    order = torch.argsort(owner_of, stable=True)
    so = owner_of[order]
    su = uids[order]
    group_start = torch.searchsorted(so, so, side="left")
    pos = torch.arange(L, device=dev) - group_start
    kept = pos < cap
    slot = so * cap + torch.clamp(pos, max=cap - 1)
    send = torch.full((n * cap + 1,), -1, dtype=torch.int32, device=dev)
    send.scatter_(0, torch.where(kept, slot, torch.full_like(slot, n * cap)),
                  su.to(torch.int32))
    recv = comms.wire_all_to_all(send[:n * cap].view(n, cap), axis,
                                 owner=f"{owner}.ids", mesh=mesh)

    # 3. gather from this rank's block (an empty slot reads row 0 and is
    #    never read back)
    start = mesh.axis_index(axis) * rows_local
    valid = recv >= 0
    lidx = torch.clamp(recv.to(torch.int64) - start, 0, rows_local - 1)
    served = _RowGather.apply(w, lidx, valid)                # [n, cap, dim]

    # 4. the rows back over the (possibly quantized) wire
    got = comms.wire_exchange(served, axis, f"{owner}.rows", mesh=mesh)

    # each unique's slot, then each lookup's unique: two gathers, whose
    # backward is the deduplicating scatter-add
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(L, device=dev))
    slot_u = slot[rank]
    keep_u = kept[rank]
    emb_u = torch.nn.functional.embedding(slot_u, got.reshape(n * cap, dim))
    emb_u = torch.where(keep_u[:, None], emb_u, torch.zeros_like(emb_u))
    out = torch.nn.functional.embedding(inv, emb_u)
    return out.reshape(tuple(ids.shape) + (dim,))


def _exchange_ok(mesh, axis: str, num_buckets: int) -> int:
    """Shard count when the table row-shards over ``axis`` of ``mesh``,
    else 1 (the JAX module also asks that the batch divide; here each rank
    passes its own equal share)."""
    if mesh is None or axis not in getattr(mesh, "axis_names", ()):
        return 1
    n = int(mesh.shape[axis])
    if n <= 1 or num_buckets % n != 0:
        return 1
    return n


def _row_layout(weight, axis: str):
    """``(num_buckets, n)`` when ``weight`` is this rank's block of a table
    row-sharded over ``axis`` (its ``dist_layout``), else None."""
    lay = getattr(weight, "dist_layout", None)
    if lay is None or not lay.spec or lay.spec[0] != axis:
        return None
    rows = int(lay.shape[0])
    n = rows // int(weight.shape[0])
    return (rows, n) if n > 1 else None


def sharded_lookup(ids, weight, *, shard_axis: str = "dp",
                   hash_ids: bool = False, capacity: Optional[int] = None,
                   owner: str = "embedding", mesh=None) -> torch.Tensor:
    """Look ids up in a (possibly row-sharded) embedding table.

    ``weight`` is this rank's block when its ``dist_layout`` shards dim 0
    over ``shard_axis`` (``ShardedEmbedding`` tags it so): then this is the
    unique -> id all_to_all -> gather -> wire-return exchange over that
    axis of ``mesh`` (default: the installed one), and every rank of the
    axis must call it with the same number of ids. Otherwise it is the
    dense gather, bitwise ``nn.Embedding``'s."""
    ids = torch.as_tensor(ids)
    sharded = _row_layout(weight, shard_axis)
    if sharded is None:
        rows = hash_bucket(ids, int(weight.shape[0]), hash_ids)
        return torch.nn.functional.embedding(
            rows.to(device=weight.device, dtype=torch.int64), weight)
    num_buckets, n = sharded
    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    if mesh is None or mesh.shape.get(shard_axis, 1) != n:
        raise ValueError(f"sharded_lookup: the table is split {n} ways over "
                         f"{shard_axis!r}, the mesh is {mesh}")
    return _exchange_lookup(ids.to(weight.device), weight, axis=shard_axis,
                            n=n, num_buckets=num_buckets, hashed=hash_ids,
                            capacity=capacity, owner=owner, mesh=mesh)


def table_param_spec(num_buckets: int, dim: int, *, src_axis=None,
                     dst_axis=None, dtype="float32"):
    """The reshard planner's view of a row-sharded table: a
    ``distributed.reshard.ParamSpec`` whose dim-0 spec names the mesh axis
    on each side (None: replicated). Contiguous row blocks are what the
    brick planner cuts, so a table's scale event plans and executes
    through ``plan_reshard`` / ``redistribute`` with no translation."""
    from ..reshard import ParamSpec
    return ParamSpec((int(num_buckets), int(dim)), dtype,
                     src=(src_axis, None), dst=(dst_axis, None))


class ShardedEmbedding(nn.Module):
    """``nn.Embedding`` whose table row-shards over a mesh axis.

    The same draws as ``nn.layer.Embedding`` (Normal(0, 1) from
    ``generator`` on ``device``, or ``weight_attr.initializer``), of the
    whole table, so a seeded build's rows are the dense layer's on every
    mesh; then, when the table shards (``shards > 1``), this rank keeps
    its block, tagged with its ``dist_layout``. The weight carries
    ``_sharding = (shard_axis, None)`` as the JAX layer's does, and
    ``row_sharded`` (the axis, or None), which ``TrainStep`` reads: a
    row-sharded parameter's grad is complete on its owner (the exchange's
    backward put it there), so it is left out of the dp grad sync and of
    ZeRO. ``mesh`` defaults to the installed one, ``device`` to the
    card."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 shard_axis: str = "dp", hash_ids: bool = False,
                 capacity: Optional[int] = None, weight_attr=None,
                 name=None, *, device=None, dtype=torch.float32,
                 generator=None, mesh=None):
        super().__init__()
        from ...core.device import resolve_device
        from ...nn.layer.common import normal_
        from ..checkpoint import set_layout
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.shard_axis = shard_axis
        self.hash_ids = bool(hash_ids)
        self.capacity = capacity
        self.mesh = mesh if mesh is not None else mesh_mod.get_mesh()
        dev = resolve_device(device)
        full = torch.empty(self.num_embeddings, self.embedding_dim,
                           device=dev, dtype=dtype)
        init = getattr(weight_attr, "initializer", None)
        if init is not None:
            init(full)
        else:
            normal_(full, generator)
        self.shards = _exchange_ok(self.mesh, shard_axis,
                                   self.num_embeddings)
        if self.shards > 1:
            rows = self.num_embeddings // self.shards
            r = self.mesh.coords[shard_axis]
            full = full[r * rows:(r + 1) * rows].clone()
        self.weight = nn.Parameter(full)
        self.weight._sharding = (shard_axis, None)
        self.weight.row_sharded = shard_axis if self.shards > 1 else None
        if self.shards > 1:
            set_layout(self.weight, (self.num_embeddings, self.embedding_dim),
                       (shard_axis, None), self.mesh)

    def forward(self, x):
        return sharded_lookup(x, self.weight, shard_axis=self.shard_axis,
                              hash_ids=self.hash_ids, capacity=self.capacity,
                              mesh=self.mesh)

    def extra_repr(self):
        return (f"{self.num_embeddings}, {self.embedding_dim}, "
                f"shard_axis={self.shard_axis!r}, hash_ids={self.hash_ids}, "
                f"shards={self.shards}")
