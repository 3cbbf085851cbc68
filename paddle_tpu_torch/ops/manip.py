"""Shape, layout and indexing ops.

Counterpart of ``paddle_tpu/ops/manip.py``, each op through
``dispatch.apply`` under its JAX name. The ops whose output shape depends
on the values (``unique``, ``unique_consecutive``, ``histogram``,
``bincount`` without weights) compute on the host with numpy, as the JAX
package's do, and put the result back on the input's device.
``as_strided`` raises, as the JAX op does.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.tensor import Tensor
from ._static_shape import static_int, static_int_list
from .dispatch import apply

__all__ = []

_T = torch.Tensor
_slice = builtins.slice


def _export(fn, name=None):
    name = name or fn.__name__
    globals()[name] = fn
    __all__.append(name)
    return fn


def _static_ints(x):
    if isinstance(x, _T):
        return static_int(x, "shape") if x.dim() == 0 \
            else static_int_list(x, "shape")
    if isinstance(x, (int, np.integer)):
        return int(x)
    return static_int_list(x, "shape")


def _host(x) -> np.ndarray:
    t = x.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _on(arr, like) -> Tensor:
    return Tensor(torch.from_numpy(np.ascontiguousarray(arr)).to(like.device))


def _same(v, *others):
    dt = dtypes.result_type(v, *others)
    return [o.to(dt) if isinstance(o, _T) else o for o in (v, *others)]


@_export
def reshape(x, shape):
    shape = _static_ints(shape)
    return apply(lambda v: torch.reshape(v, shape if isinstance(shape, list)
                                         else [shape]), x, op_name="reshape")


def _inplace(x, out):
    """``x`` takes ``out``'s shape and values (Paddle's ``x.op_()``); a
    tensor that records a graph keeps its values but not the new shape's
    history."""
    with torch.no_grad():
        x.data = out.detach()
    return x


@_export
def reshape_(x, shape):
    return _inplace(x, reshape(x, shape))


@_export
def flatten_(x, start_axis=0, stop_axis=-1):
    return _inplace(x, flatten(x, start_axis, stop_axis))


@_export
def flatten(x, start_axis=0, stop_axis=-1):
    def f(v):
        if v.dim() == 0:
            return v.reshape(1)
        return torch.flatten(v, start_axis, stop_axis)
    return apply(f, x, op_name="flatten")


@_export
def transpose(x, perm):
    perm = _static_ints(perm)
    return apply(lambda v: v.permute(*perm), x, op_name="transpose")


@_export
def moveaxis(x, source, destination):
    return apply(lambda v: torch.movedim(v, source, destination), x,
                 op_name="moveaxis")


@_export
def swapaxes(x, axis1, axis2):
    return apply(lambda v: torch.swapaxes(v, axis1, axis2), x,
                 op_name="swapaxes")


@_export
def squeeze(x, axis=None):
    def f(v):
        if axis is None:
            return torch.squeeze(v)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = tuple(a % v.dim() for a in axes if v.shape[a % v.dim()] == 1)
        return torch.squeeze(v, axes) if axes else v
    return apply(f, x, op_name="squeeze")


@_export
def unsqueeze(x, axis):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = _static_ints(axes)

    def f(v):
        out = v
        for a in sorted(axes):
            out = torch.unsqueeze(out, a)
        return out
    return apply(f, x, op_name="unsqueeze")


@_export
def concat(x, axis=0):
    tensors = list(x)
    ax = int(axis)
    return apply(lambda *vs: torch.cat(_same(*vs), dim=ax), *tensors,
                 op_name="concat")


@_export
def stack(x, axis=0):
    tensors = list(x)
    return apply(lambda *vs: torch.stack(_same(*vs), dim=axis), *tensors,
                 op_name="stack")


@_export
def split(x, num_or_sections, axis=0):
    ax = int(axis)
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = list(_static_ints(num_or_sections))
        unknown = [i for i, s in enumerate(sizes) if s == -1]
        if unknown:
            sizes[unknown[0]] = dim - builtins.sum(s for s in sizes
                                                   if s != -1)
    return list(apply(lambda v: tuple(torch.split(v, sizes, dim=ax)), x,
                      op_name="split"))


@_export
def chunk(x, chunks, axis=0):
    return split(x, chunks, axis)


@_export
def unbind(input, axis=0):
    return list(apply(lambda v: tuple(torch.unbind(v, axis)), input,
                      op_name="unbind"))


@_export
def tile(x, repeat_times):
    reps = _static_ints(repeat_times)
    return apply(lambda v: torch.tile(v, reps if isinstance(reps, list)
                                      else [reps]), x, op_name="tile")


@_export
def expand(x, shape):
    shape = _static_ints(shape)

    def f(v):
        tgt = list(shape)
        off = len(tgt) - v.dim()
        for i in range(len(tgt)):
            if tgt[i] == -1:
                tgt[i] = v.shape[i - off]
        return v.expand(tgt)
    return apply(f, x, op_name="expand")


@_export
def broadcast_to(x, shape):
    return expand(x, shape)


@_export
def expand_as(x, y):
    return expand(x, list(y.shape))


@_export
def broadcast_tensors(input, name=None):
    shape = torch.broadcast_shapes(*[tuple(t.shape) for t in input])
    return [apply(lambda v: v.expand(shape), t, op_name="broadcast_tensors")
            for t in input]


@_export
def roll(x, shifts, axis=None):
    def f(v):
        if axis is None:
            return torch.roll(v, shifts)
        return torch.roll(v, shifts, axis)
    return apply(f, x, op_name="roll")


@_export
def flip(x, axis):
    axes = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    return apply(lambda v: torch.flip(v, axes), x, op_name="flip")


@_export
def rot90(x, k=1, axes=(0, 1)):
    return apply(lambda v: torch.rot90(v, k, list(axes)), x, op_name="rot90")


def _take(v, i, ax):
    ax = ax % v.dim()
    i = i.to(torch.int64)
    out = torch.index_select(v, ax, i.reshape(-1))
    return out.reshape(*v.shape[:ax], *i.shape, *v.shape[ax + 1:])


@_export
def gather(x, index, axis=0):
    ax = int(axis)
    return apply(lambda v, i: _take(v, i, ax), x, index, op_name="gather")


@_export
def gather_nd(x, index):
    def f(v, idx):
        return v[tuple(torch.movedim(idx.to(torch.int64), -1, 0))]
    return apply(f, x, index, op_name="gather_nd")


@_export
def index_select(x, index, axis=0):
    return gather(x, index, axis)


@_export
def index_sample(x, index):
    def f(v, idx):
        rows = torch.arange(v.shape[0], device=v.device)[:, None]
        return v[rows, idx.to(torch.int64)]
    return apply(f, x, index, op_name="index_sample")


@_export
def take_along_axis(arr, indices, axis, broadcast=True):
    return apply(lambda v, i: torch.take_along_dim(v, i.to(torch.int64),
                                                   axis),
                 arr, indices, op_name="take_along_axis")


@_export
def put_along_axis(arr, indices, values, axis, reduce="assign"):
    mode = {"assign": None, "add": "add", "mul": "multiply",
            "multiply": "multiply"}[reduce]

    def f(v, i, val):
        i = i.to(torch.int64)
        val = torch.as_tensor(val, device=v.device).to(v.dtype) \
            .expand(i.shape).contiguous()
        if mode is None:
            return torch.scatter(v, axis, i, val)
        if mode == "add":
            return torch.scatter_add(v, axis, i, val)
        return torch.scatter_reduce(v, axis, i, val, "prod")
    return apply(f, arr, indices, values, op_name="put_along_axis")


@_export
def scatter(x, index, updates, overwrite=True):
    def f(v, i, u):
        i = i.to(torch.int64)
        u = u.to(v.dtype)
        if overwrite:
            return v.index_copy(0, i, u)
        return v.index_add(0, i, u)
    return apply(f, x, index, updates, op_name="scatter")


@_export
def scatter_nd_add(x, index, updates):
    def f(v, i, u):
        idx = tuple(torch.movedim(i.to(torch.int64), -1, 0))
        return v.index_put(idx, u.to(v.dtype), accumulate=True)
    return apply(f, x, index, updates, op_name="scatter_nd_add")


@_export
def scatter_nd(index, updates, shape):
    shape = _static_ints(shape)

    def f(i, u):
        z = torch.zeros(shape, dtype=u.dtype, device=u.device)
        idx = tuple(torch.movedim(i.to(torch.int64), -1, 0))
        return z.index_put(idx, u, accumulate=True)
    return apply(f, index, updates, op_name="scatter_nd")


@_export
def masked_select(x, mask):
    return apply(lambda v, m: torch.masked_select(v, m.to(torch.bool)),
                 x, mask, op_name="masked_select")


@_export
def masked_fill(x, mask, value):
    if isinstance(value, _T):
        return apply(lambda v, m, val: torch.where(m.to(torch.bool),
                                                   val.to(v.dtype), v),
                     x, mask, value, op_name="masked_fill")
    return apply(lambda v, m: v.masked_fill(m.to(torch.bool), value),
                 x, mask, op_name="masked_fill")


@_export
def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)

    def f(c, a, b):
        dt = dtypes.result_type(a, b)
        dev = c.device
        a = a.to(dt) if isinstance(a, _T) else torch.full((), a, dtype=dt,
                                                           device=dev)
        b = b.to(dt) if isinstance(b, _T) else torch.full((), b, dtype=dt,
                                                           device=dev)
        return torch.where(c.to(torch.bool), a, b)
    return apply(f, condition, x, y, op_name="where")


@_export
def nonzero(x, as_tuple=False):
    idx = torch.nonzero(x)
    if as_tuple:
        return tuple(Tensor(idx[:, i]) for i in range(idx.shape[1]))
    return Tensor(idx)


@_export
def sort(x, axis=-1, descending=False, name=None, stable=False):
    def f(v):
        out = torch.sort(v, dim=axis, stable=True).values
        return torch.flip(out, [axis]) if descending else out
    return apply(f, x, op_name="sort")


@_export
def argsort(x, axis=-1, descending=False, name=None, stable=False):
    def f(v):
        idx = torch.argsort(v, dim=axis, stable=True)
        return torch.flip(idx, [axis]) if descending else idx
    return apply(f, x, op_name="argsort")


@_export
def topk(x, k, axis=-1, largest=True, sorted=True):
    k = int(k)
    out = apply(lambda v: tuple(torch.topk(v, k, dim=axis, largest=largest,
                                           sorted=True)),
                x, op_name="topk")
    return out[0], out[1]


@_export
def kthvalue(x, k, axis=-1, keepdim=False):
    def f(v):
        iv = torch.argsort(v, dim=axis, stable=True)
        vv = torch.take_along_dim(v, iv, axis)
        vals = vv.select(axis, k - 1)
        idx = iv.select(axis, k - 1)
        if keepdim:
            vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
        return vals, idx
    out = apply(f, x, op_name="kthvalue")
    return out[0], out[1]


@_export
def mode(x, axis=-1, keepdim=False):
    """The most frequent value along ``axis`` (the smallest of a tie) and
    the index of its last occurrence, as the JAX op's sorted-run scan."""
    def f(v):
        ax = axis % v.dim()
        vm = torch.movedim(v, ax, -1)
        counts = (vm[..., :, None] == vm[..., None, :]).sum(-1)
        best = counts.amax(-1, keepdim=True)
        big = torch.where(counts == best, vm, torch.full_like(
            vm, float("inf") if vm.is_floating_point()
            else torch.iinfo(vm.dtype).max))
        vals = big.amin(-1, keepdim=True)
        pos = torch.arange(vm.shape[-1], device=v.device)
        idx = torch.where(vm == vals, pos, -1).amax(-1, keepdim=True)
        vals, idx = torch.movedim(vals, -1, ax), torch.movedim(idx, -1, ax)
        if not keepdim:
            vals, idx = vals.squeeze(ax), idx.squeeze(ax)
        return vals, idx.to(torch.int64)
    out = apply(f, x, op_name="mode")
    return out[0], out[1]


@_export
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    res = np.unique(_host(x), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return _on(res, x)
    return tuple(_on(r, x) for r in res)


@_export
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    if axis is not None:
        raise NotImplementedError("unique_consecutive with axis")
    v = _host(x).ravel()
    keep = np.ones(v.shape[0], bool)
    keep[1:] = v[1:] != v[:-1]
    out = [_on(v[keep], x)]
    if return_inverse:
        out.append(_on(np.cumsum(keep) - 1, x))
    if return_counts:
        idx = np.flatnonzero(keep)
        out.append(_on(np.diff(np.append(idx, v.shape[0])), x))
    return out[0] if len(out) == 1 else tuple(out)


@_export
def one_hot(x, num_classes):
    n = int(num_classes)
    return apply(lambda v: torch.nn.functional.one_hot(
        v.to(torch.int64), n).to(dtypes.get_default_dtype()), x,
        op_name="one_hot")


@_export
def slice(input, axes, starts, ends):
    axes = _static_ints(axes)
    starts = _static_ints(starts)
    ends = _static_ints(ends)

    def f(v):
        out = v
        for ax, st, en in zip(axes, starts, ends):
            dim = v.shape[ax]
            st2 = builtins.min(st % dim if st < 0 else st, dim)
            en2 = dim if en >= dim else (en % dim if en < 0 else en)
            out = out.narrow(ax, st2, builtins.max(en2 - st2, 0))
        return out
    return apply(f, input, op_name="slice")


@_export
def strided_slice(x, axes, starts, ends, strides):
    def f(v):
        for ax, st, en, sd in zip(axes, starts, ends, strides):
            idx = np.arange(v.shape[ax])[_slice(st, en, sd)]
            v = torch.index_select(v, ax, torch.as_tensor(idx.copy(),
                                                          device=v.device))
        return v
    return apply(f, x, op_name="strided_slice")


def _pad_index(n, lo, hi, mode, dev):
    i = torch.arange(-lo, n + hi, device=dev)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i.remainder(n)
    period = 2 * (n - 1)
    j = i.abs().remainder(period) if period else torch.zeros_like(i)
    return torch.where(j >= n, period - j, j)


@_export
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    pad = _static_ints(pad)

    def f(v):
        if len(pad) == v.dim() * 2:
            cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(v.dim())]
        else:
            # Paddle's convention: pairs apply from the last dim backward
            npair = len(pad) // 2
            cfg = [(0, 0)] * (v.dim() - npair) + list(reversed(
                [(pad[2 * i], pad[2 * i + 1]) for i in range(npair)]))
        if mode == "constant":
            flat = [p for lo_hi in reversed(cfg) for p in lo_hi]
            return torch.nn.functional.pad(v, flat, value=value)
        jmode = {"reflect": "reflect", "replicate": "edge",
                 "circular": "wrap"}[mode]
        out = v
        for d, (lo, hi) in enumerate(cfg):
            if lo or hi:
                out = torch.index_select(out, d, _pad_index(
                    v.shape[d], lo, hi, jmode, v.device))
        return out
    return apply(f, x, op_name="pad")


@_export
def repeat_interleave(x, repeats, axis=None):
    def f(v):
        r = repeats.to(v.device) if isinstance(repeats, _T) else repeats
        return torch.repeat_interleave(v, r, dim=axis)
    return apply(f, x, op_name="repeat_interleave")


@_export
def as_strided(x, shape, stride, offset=0):
    raise NotImplementedError(
        "as_strided is not supported (nor by the JAX package)")


@_export
def numel(x):
    return Tensor(torch.full((), x.numel(), dtype=torch.int64,
                             device=x.device))


@_export
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    def f(v):
        size = index_num // nshards
        shard = torch.div(v, size, rounding_mode="floor")
        return torch.where(shard == shard_id, v.remainder(size),
                           torch.full_like(v, ignore_value))
    return apply(f, input, op_name="shard_index")


@_export
def bincount(x, weights=None, minlength=0):
    if weights is not None:
        return apply(lambda v, w: torch.bincount(v.to(torch.int64), w,
                                                 minlength=minlength),
                     x, weights, op_name="bincount")
    return _on(np.bincount(_host(x), minlength=minlength), x)


@_export
def histogram(input, bins=100, min=0, max=0, name=None):
    rng = None if (min == 0 and max == 0) else (min, max)
    hist, _ = np.histogram(_host(input), bins=bins, range=rng)
    return _on(hist.astype(np.int64), input)


@_export
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return apply(lambda s, v: torch.searchsorted(s, v, right=right,
                                                 out_int32=out_int32),
                 sorted_sequence, values, op_name="searchsorted")


def _along(v, ax, i):
    return tuple(i if d == ax else _slice(None) for d in range(v.dim()))


@_export
def index_add(x, index, axis, value):
    return apply(lambda v, i, val: torch.index_add(
        v, axis % v.dim(), i.to(torch.int64), val.to(v.dtype)),
        x, index, value, op_name="index_add")


@_export
def index_fill(x, index, axis, value):
    def f(v, i, *rest):
        val = rest[0] if rest else value
        if isinstance(val, _T):
            val = val.to(v.dtype)
        return v.index_fill(axis % v.dim(), i.to(torch.int64), val)
    if isinstance(value, _T):
        return apply(f, x, index, value, op_name="index_fill")
    return apply(f, x, index, op_name="index_fill")


@_export
def index_put(x, indices, value, accumulate=False):
    def f(v, val, *idx):
        idx = tuple(i if i.dtype == torch.bool else i.to(torch.int64)
                    for i in idx)
        return v.index_put(idx, val.to(v.dtype), accumulate=accumulate)
    return apply(f, x, value, *indices, op_name="index_put")


@_export
def masked_scatter(x, mask, value):
    """Fill the masked positions of ``x`` with ``value``'s elements in
    order."""
    def f(v, m, val):
        m = m.to(torch.bool).expand(v.shape)
        return torch.masked_scatter(v, m, val.to(v.dtype))
    return apply(f, x, mask, value, op_name="masked_scatter")


def _split_equal(name, axis):
    def fn(x, num_or_sections, name=None, *, opname=name):
        def f(v):
            sec = num_or_sections if isinstance(num_or_sections, int) \
                else list(num_or_sections)
            return tuple(torch.tensor_split(v, sec, dim=axis))
        return apply(f, x, op_name=opname)
    fn.__name__ = name
    return _export(fn, name)


vsplit = _split_equal("vsplit", 0)
dsplit = _split_equal("dsplit", 2)


@_export
def hsplit(x, num_or_sections):
    """Split on axis 1, or axis 0 for 1-D input (numpy's hsplit)."""
    def f(v):
        ax = 0 if v.dim() == 1 else 1
        sec = num_or_sections if isinstance(num_or_sections, int) \
            else list(num_or_sections)
        return tuple(torch.tensor_split(v, sec, dim=ax))
    return apply(f, x, op_name="hsplit")


@_export
def tensor_split(x, num_or_indices, axis=0):
    def f(v):
        sec = num_or_indices if isinstance(num_or_indices, int) \
            else list(num_or_indices)
        return tuple(torch.tensor_split(v, sec, dim=axis))
    return apply(f, x, op_name="tensor_split")


@_export
def take(x, index, mode="raise"):
    def f(v, i):
        flat = v.reshape(-1)
        n = flat.numel()
        i = i.to(torch.int64)
        if mode == "wrap":
            i = i.remainder(n)
        elif mode == "clip":
            i = i.clamp(-n, n - 1)
        i = torch.where(i < 0, i + n, i)
        return flat[i]
    return apply(f, x, index, op_name="take")


@_export
def unfold(x, axis, size, step):
    """Sliding windows over ``axis``: ``[..., n_windows, ..., size]`` (the
    window dim last)."""
    return apply(lambda v: v.unfold(axis % v.dim(), size, step), x,
                 op_name="unfold")


@_export
def unflatten(x, axis, shape):
    shape = _static_ints(shape)
    return apply(lambda v: torch.unflatten(v, axis % v.dim(), shape), x,
                 op_name="unflatten")


@_export
def view(x, shape_or_dtype):
    def f(v):
        if isinstance(shape_or_dtype, (list, tuple)):
            return v.reshape([int(s) for s in shape_or_dtype])
        return v.view(dtypes.convert_dtype(shape_or_dtype))
    return apply(f, x, op_name="view")


@_export
def view_as(x, other):
    return apply(lambda v, o: v.reshape(o.shape), x, other,
                 op_name="view_as")


@_export
def crop(x, shape=None, offsets=None):
    def f(v):
        shp = _static_ints(shape) if shape is not None else list(v.shape)
        shp = [v.shape[i] if s == -1 else s for i, s in enumerate(shp)]
        offs = _static_ints(offsets) if offsets is not None \
            else [0] * v.dim()
        return v[tuple(_slice(o, o + s) for o, s in zip(offs, shp))]
    return apply(f, x, op_name="crop")


@_export
def as_complex(x):
    """``[..., 2]`` real pairs to complex."""
    return apply(lambda v: torch.complex(v[..., 0], v[..., 1]), x,
                 op_name="as_complex")


@_export
def as_real(x):
    return apply(lambda v: torch.stack([v.real, v.imag], -1), x,
                 op_name="as_real")


@_export
def polar(abs, angle):
    return apply(lambda r, t: torch.complex(r * torch.cos(t),
                                            r * torch.sin(t)),
                 abs, angle, op_name="polar")


def tolist(x):
    return _host(x).tolist()


_export(tolist)


@_export
def unstack(x, axis=0, num=None):
    return apply(lambda v: tuple(torch.unbind(v, axis)), x,
                 op_name="unstack")


@_export
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1):
    """Write ``y`` into the (dim1, dim2) diagonal band of ``x``."""
    def f(v, val):
        d1, d2 = dim1 % v.dim(), dim2 % v.dim()
        n = builtins.min(v.shape[d1], v.shape[d2] - offset) if offset >= 0 \
            else builtins.min(v.shape[d1] + offset, v.shape[d2])
        i = torch.arange(n, device=v.device)
        idx = [_slice(None)] * v.dim()
        idx[d1] = i - builtins.min(offset, 0)
        idx[d2] = i + builtins.max(offset, 0)
        val = val.to(v.dtype)
        if val.dim() == v.dim() - 1:
            val = torch.movedim(val, -1, d1 if d1 < d2 else d1 - 1)
        return v.index_put(tuple(idx), val)
    return apply(f, x, y, op_name="fill_diagonal_tensor")


@_export
def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))
