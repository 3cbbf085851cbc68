"""Tensor-parallel (Megatron) layers and the sequence-parallel ops.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py``
(after Paddle's ``fleet/layers/mpu/mp_layers.py`` and
``fleet/utils/sequence_parallel_utils.py``). The JAX layers declare a
partition spec on the weight and let GSPMD insert the collectives; here,
as in Paddle, each rank of the ``mp`` axis holds its shard of the weight,
and the collectives are explicit ``torch.autograd.Function``s, each with
its conjugate in ``backward``:

================================  ===============  ===============
op                                forward          backward
================================  ===============  ===============
``copy_to_mp`` (Paddle's          identity         all-reduce
``c_identity``)
``reduce_from_mp``                all-reduce       identity
``ScatterOp`` (seq dim)           take own slice   all-gather
``GatherOp`` (seq dim), and       all-gather       take own slice
``gather_from_mp`` (last dim)
``AllGatherOp`` (seq dim)         all-gather       reduce-scatter
``ReduceScatterOp`` (seq dim)     reduce-scatter   all-gather
================================  ===============  ===============

Constructor defaults are the JAX layers' (a bias; a row-parallel input
sliced unless ``input_is_parallel``); the arguments after the two sizes
are the port's (``device``, ``dtype``, ``generator``, then the flags and
``mesh``). Weights keep Paddle's ``[in, out]`` layout. ``ColumnParallelLinear``
holds output columns ``[r out/mp, (r+1) out/mp)`` of rank r,
``RowParallelLinear`` input rows, ``VocabParallelEmbedding`` vocab rows.
Each sharded parameter carries ``split_axis`` (the dim split over mp) and
``is_distributed``; a replicated one has ``split_axis = None``. A layer
with a generator draws the FULL weight (XavierNormal, as the mp=1 layer
would) and keeps its slice, so a model built on any mp degree from one
seed holds the same weights. These collectives are exact: they never ride
the quantized wire (the JAX package's are GSPMD-inserted, never
quantized).

``ParallelCrossEntropy`` takes vocab-sharded logits and returns the
per-row loss (``reduction='none'``), with ``ignore_index`` rows at 0: the
max, the sum of exponentials and the label's logit are all-reduced over
mp (Paddle's ``c_softmax_with_cross_entropy``).

Sequence parallelism (Megatron-SP): activations between blocks are
sharded along the sequence over mp. ``ColumnSequenceParallelLinear``
all-gathers its input (``AllGatherOp``: its backward reduce-scatters the
summed input grads), ``RowSequenceParallelLinear`` reduce-scatters its
output. Parameters that act on sequence shards (the norms) see only their
shard's grads: ``mark_as_sequence_parallel_parameter`` tags them and
``register_sequence_parallel_allreduce_hooks`` all-reduces their grads
over mp after each backward (the JAX function is a no-op: XLA inserts
that reduction).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ....nn import functional as F
from ....nn.layers import _param, xavier_normal_
from ....parallel import mesh as mesh_mod
from ... import comms

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "ScatterOp",
           "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "mark_as_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks", "copy_to_mp",
           "reduce_from_mp", "gather_from_mp", "mp_degree", "MP_AXIS"]

MP_AXIS = "mp"


def mp_degree(mesh=None) -> "tuple[int, int]":
    """(mp extent, this rank's mp coordinate) on the mesh."""
    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    return (mesh_mod.mesh_axis_size(MP_AXIS, mesh),
            mesh_mod.axis_index(MP_AXIS, mesh))


# ---------------------------------------------------------------------------
# the collectives, differentiable
# ---------------------------------------------------------------------------

def _all_reduce(x, mesh, owner):
    return comms.wire_all_reduce(x.contiguous(), MP_AXIS, "sum", owner=owner,
                                 exact=True, mesh=mesh)


def _all_gather(x, dim, mesh, owner):
    parts = comms.wire_all_gather(x.contiguous(), MP_AXIS, owner=owner,
                                  exact=True, mesh=mesh)
    return torch.cat(parts.unbind(0), dim=dim)


def _slice(x, dim, mesh):
    n, r = mp_degree(mesh)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over mp={n}")
    return x.chunk(n, dim=dim)[r].contiguous()


def _reduce_scatter(x, dim, mesh, owner):
    moved = x.movedim(dim, 0).contiguous()
    out = comms.wire_reduce_scatter(moved, MP_AXIS, "sum", owner=owner,
                                    mesh=mesh)
    return out.movedim(0, dim).contiguous()


class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, "mp_layers.copy_to_mp.grad"), None


class _ReduceFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh, "mp_layers.reduce_from_mp")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _slice(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.mesh,
                           "mp_layers.scatter.grad"), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _all_gather(x, dim, mesh, "mp_layers.gather")

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.mesh), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _all_gather(x, dim, mesh, "mp_layers.all_gather")

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.mesh,
                               "mp_layers.all_gather.grad"), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _reduce_scatter(x, dim, mesh, "mp_layers.reduce_scatter")

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.mesh,
                           "mp_layers.reduce_scatter.grad"), None, None


def copy_to_mp(x, mesh=None):
    """Identity forward, all-reduce of the grad over mp."""
    return _CopyToMP.apply(x, mesh) if mp_degree(mesh)[0] > 1 else x


def reduce_from_mp(x, mesh=None):
    """All-reduce over mp forward, identity backward."""
    return _ReduceFromMP.apply(x, mesh) if mp_degree(mesh)[0] > 1 else x


def gather_from_mp(x, dim: int = -1, mesh=None):
    """All-gather along ``dim`` over mp; the grad keeps its own slice."""
    return _Gather.apply(x, dim % x.dim(), mesh) \
        if mp_degree(mesh)[0] > 1 else x


class ScatterOp:
    """This rank's slice of ``x`` along ``axis`` (the sequence); the grad
    is all-gathered."""

    @staticmethod
    def apply(x, axis: int = 1, mesh=None):
        return _Scatter.apply(x, axis % x.dim(), mesh) \
            if mp_degree(mesh)[0] > 1 else x


class GatherOp:
    """All-gather along ``axis``; the grad keeps its own slice."""

    @staticmethod
    def apply(x, axis: int = 1, mesh=None):
        return _Gather.apply(x, axis % x.dim(), mesh) \
            if mp_degree(mesh)[0] > 1 else x


class AllGatherOp:
    """All-gather along ``axis``; the grad is reduce-scattered (the
    partial input grads of the column shards summed)."""

    @staticmethod
    def apply(x, axis: int = 1, mesh=None):
        return _AllGather.apply(x, axis % x.dim(), mesh) \
            if mp_degree(mesh)[0] > 1 else x


class ReduceScatterOp:
    """Reduce-scatter along ``axis``; the grad is all-gathered."""

    @staticmethod
    def apply(x, axis: int = 1, mesh=None):
        return _ReduceScatter.apply(x, axis % x.dim(), mesh) \
            if mp_degree(mesh)[0] > 1 else x


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _shard_param(full_shape, split: Optional[int], n: int, r: int, device,
                 dtype, generator, init: str = "xavier") -> nn.Parameter:
    """A parameter holding rank r's slice (along ``split``) of a full
    weight drawn as the mp=1 layer draws it."""
    if split is not None and full_shape[split] % n:
        raise ValueError(f"dim {split} of {tuple(full_shape)} does not "
                         f"split over mp={n}")
    shape = list(full_shape)
    if split is not None:
        shape[split] //= n
    p = _param(shape, device, dtype)
    with torch.no_grad():
        if init == "zeros":
            p.zero_()
        elif n == 1 or split is None:
            xavier_normal_(p, generator)
        else:
            full = xavier_normal_(torch.empty(full_shape, device=p.device,
                                              dtype=torch.float32),
                                  generator)
            p.copy_(full.chunk(n, dim=split)[r])
    p.split_axis = split if n > 1 else None
    p.is_distributed = split is not None and n > 1
    return p


class VocabParallelEmbedding(nn.Module):
    """Embedding with the vocab rows split over mp; ids outside the rank's
    range look up zeros, and the rows are all-reduced."""

    def __init__(self, num_embeddings: int, embedding_dim: int, device=None,
                 dtype=torch.float32, generator=None, mesh=None):
        super().__init__()
        self.mesh = mesh
        n, r = mp_degree(mesh)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.per_rank = num_embeddings // n
        self.vocab_start = r * self.per_rank
        self.weight = _shard_param([num_embeddings, embedding_dim], 0, n, r,
                                   device, dtype, generator)

    def forward(self, x, weight=None):
        w = self.weight if weight is None else weight
        if mp_degree(self.mesh)[0] == 1:
            return F.embedding(x, w)
        outside = (x < self.vocab_start) | \
            (x >= self.vocab_start + self.per_rank)
        local = torch.where(outside, torch.zeros_like(x),
                            x - self.vocab_start)
        out = F.embedding(local, w)
        out = out.masked_fill(outside[..., None], 0.0)
        return reduce_from_mp(out, self.mesh)


class ColumnParallelLinear(nn.Module):
    """``y = x W (+ b)`` with W's output columns split over mp. The input
    is copied to mp (its grad all-reduced); with ``gather_output`` the
    output columns are all-gathered, else each rank keeps its own."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=torch.float32, generator=None, has_bias: bool = True,
                 gather_output: bool = True, mesh=None):
        super().__init__()
        self.mesh = mesh
        n, r = mp_degree(mesh)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.weight = _shard_param([in_features, out_features], 1, n, r,
                                   device, dtype, generator)
        self.bias = _shard_param([out_features], 0, n, r, device, dtype,
                                 None, init="zeros") if has_bias else None

    def local(self, x, weight=None):
        """This rank's columns, no collective (the caller copied x)."""
        w = self.weight if weight is None else weight
        out = F.linear(x, w)
        return out if self.bias is None else out + self.bias

    def forward(self, x):
        out = self.local(copy_to_mp(x, self.mesh))
        return gather_from_mp(out, -1, self.mesh) if self.gather_output \
            else out


class RowParallelLinear(nn.Module):
    """``y = x W (+ b)`` with W's input rows split over mp: each rank's
    partial product is all-reduced, then the (replicated) bias added. With
    ``input_is_parallel=False`` the input is first sliced along its last
    dim."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=torch.float32, generator=None, has_bias: bool = True,
                 input_is_parallel: bool = False, mesh=None):
        super().__init__()
        self.mesh = mesh
        n, r = mp_degree(mesh)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = _shard_param([in_features, out_features], 0, n, r,
                                   device, dtype, generator)
        self.bias = _shard_param([out_features], None, n, r, device, dtype,
                                 None, init="zeros") if has_bias else None

    def local(self, x, weight=None):
        """This rank's partial product, not yet reduced."""
        w = self.weight if weight is None else weight
        return F.linear(x, w)

    def _finish(self, out):
        return out if self.bias is None else out + self.bias

    def forward(self, x):
        if not self.input_is_parallel and mp_degree(self.mesh)[0] > 1:
            x = ScatterOp.apply(x, -1, self.mesh)
        return self._finish(reduce_from_mp(self.local(x), self.mesh))


class _ParallelCE(torch.autograd.Function):
    """Per-row CE of vocab-sharded logits (Paddle's
    ``c_softmax_with_cross_entropy``): fp32 softmax pieces all-reduced over
    mp; the grad ``(softmax - onehot) g`` stays local."""

    @staticmethod
    def forward(ctx, logits, label, ignore_index, mesh):
        n, r = mp_degree(mesh)
        V = logits.shape[-1]
        x = logits.float()
        m = x.amax(dim=-1)
        m = comms.wire_all_reduce(m.contiguous(), MP_AXIS, "max",
                                  owner="mp_layers.parallel_ce", exact=True,
                                  mesh=mesh)
        e = torch.exp(x - m[..., None])
        lab = label.long() - r * V
        inside = (lab >= 0) & (lab < V)
        at = x.gather(-1, lab.clamp(0, V - 1)[..., None])[..., 0]
        at = torch.where(inside, at, torch.zeros_like(at))
        s = torch.stack([e.sum(dim=-1), at])
        s = comms.wire_all_reduce(s.contiguous(), MP_AXIS, "sum",
                                  owner="mp_layers.parallel_ce", exact=True,
                                  mesh=mesh)
        valid = label != ignore_index
        loss = torch.where(valid, m + torch.log(s[0]) - s[1],
                           torch.zeros_like(m))
        ctx.save_for_backward(e, s[0], lab, inside, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, z, lab, inside, valid = ctx.saved_tensors
        V = e.shape[-1]
        p = e / z[..., None]
        p.scatter_add_(-1, lab.clamp(0, V - 1)[..., None],
                       -inside.to(p.dtype)[..., None])
        grad = p * (g.float() * valid.to(p.dtype))[..., None]
        return grad.to(ctx.dtype), None, None, None


class ParallelCrossEntropy(nn.Module):
    """Per-row CE over mp-sharded logits (``reduction='none'``); rows whose
    label is ``ignore_index`` give 0."""

    def __init__(self, mesh=None, ignore_index: int = -100):
        super().__init__()
        self.mesh = mesh
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if mp_degree(self.mesh)[0] == 1:
            return F.cross_entropy(input, label, reduction="none",
                                   ignore_index=self.ignore_index)
        return _ParallelCE.apply(input, label, self.ignore_index, self.mesh)


# ---------------------------------------------------------------------------
# sequence parallel
# ---------------------------------------------------------------------------

def mark_as_sequence_parallel_parameter(param) -> None:
    param.sequence_parallel = True


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               fuse=False, mesh=None):
    """All-reduce over mp, after each backward, the grads of the
    parameters marked sequence-parallel (one flattened all-reduce, in a
    post-accumulate-grad hook on the last of them to receive its grad).
    Returns the model."""
    params = [p for p in model.parameters()
              if getattr(p, "sequence_parallel", False) and p.requires_grad]
    if not params or mp_degree(mesh)[0] == 1:
        return model
    pending = {"left": len(params)}

    def hook(_p):
        pending["left"] -= 1
        if pending["left"]:
            return
        pending["left"] = len(params)
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        red = _all_reduce(flat, mesh, "mp_layers.sequence_parallel.grad")
        with torch.no_grad():
            for p, piece in zip(params, red.split([p.numel()
                                                   for p in params])):
                p.grad.copy_(piece.view_as(p.grad))

    for p in params:
        p.register_post_accumulate_grad_hook(hook)
    return model


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """Column-parallel linear on a sequence-sharded input: the input is
    all-gathered along the sequence (its grad reduce-scattered)."""

    def __init__(self, in_features, out_features, device=None,
                 dtype=torch.float32, generator=None, has_bias=True,
                 gather_output=False, mesh=None):
        super().__init__(in_features, out_features, device, dtype, generator,
                         has_bias, gather_output, mesh)

    def forward(self, x):
        out = self.local(AllGatherOp.apply(x, 1, self.mesh))
        return gather_from_mp(out, -1, self.mesh) if self.gather_output \
            else out


class RowSequenceParallelLinear(RowParallelLinear):
    """Row-parallel linear whose partial products are reduce-scattered
    along the sequence instead of all-reduced."""

    def __init__(self, in_features, out_features, device=None,
                 dtype=torch.float32, generator=None, has_bias=True,
                 input_is_parallel=True, mesh=None):
        super().__init__(in_features, out_features, device, dtype, generator,
                         has_bias, input_is_parallel, mesh)

    def forward(self, x):
        return self._finish(ReduceScatterOp.apply(self.local(x), 1,
                                                  self.mesh))
