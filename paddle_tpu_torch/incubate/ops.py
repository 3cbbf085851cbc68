"""Paddle's ``incubate`` top-level ops: counterpart of
``paddle_tpu/incubate/ops.py``. Segment reductions, graph message
passing and sampling, the fused softmax-mask ops, ``identity_loss``, and
the ``LookAhead`` and ``ModelAverage`` wrapper optimizers over the port's
``Optimizer``.

The segment and graph reductions are ``scatter_reduce`` over the rows;
an empty segment gives 0 (as the JAX package, which replaces XLA's
identity there). The result is trimmed to ``max(segment_ids) + 1`` rows
(one host read of the ids). Graph sampling and reindexing run on the host
in numpy, as in the JAX package; the sampler's numpy generator is seeded
by ``core.generator.next_key`` (deterministic under ``seed``, a stream of
its own: the JAX package's draws differ).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core import generator as gen
from ..core.device import resolve_device
from ..core.tensor import Tensor, as_port, plain_views
from ..ops.dispatch import apply
from ..optimizer.optimizer import Optimizer

__all__ = [
    "LookAhead", "ModelAverage", "softmax_mask_fuse",
    "softmax_mask_fuse_upper_triangle", "graph_send_recv",
    "graph_khop_sampler", "graph_sample_neighbors", "graph_reindex",
    "segment_sum", "segment_mean", "segment_max", "segment_min",
    "identity_loss",
]

_REDUCE = {"sum": "sum", "max": "amax", "min": "amin"}


def _scatter(rows, ids, num, mode):
    """Rows reduced onto ``num`` segments by ``ids``: sum, mean (sum over
    max(count, 1)), max or min (0 where a segment is empty)."""
    out = torch.zeros((num,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    idx = ids.to(torch.int64).reshape((-1,) + (1,) * (rows.dim() - 1)) \
        .expand(rows.shape)
    if mode == "mean":
        s = out.scatter_add(0, idx, rows)
        c = torch.zeros(num, dtype=rows.dtype, device=rows.device) \
            .index_add(0, ids.to(torch.int64),
                       torch.ones(ids.shape[0], dtype=rows.dtype,
                                  device=rows.device))
        return s / torch.clamp(c, min=1.0).reshape(
            (-1,) + (1,) * (rows.dim() - 1))
    return out.scatter_reduce(0, idx, rows, _REDUCE[mode],
                              include_self=False)


def _segment(x, segment_ids, mode):
    def f(*ts):
        v, ids = plain_views(ts)
        out = _scatter(v, ids, v.shape[0], mode)
        n = ids.shape[0]
        return as_port(out[: int(ids.max()) + 1] if n else out[:0])
    return apply(f, x, segment_ids, op_name=f"segment_{mode}")


def segment_sum(data, segment_ids, name=None):
    return _segment(data, segment_ids, "sum")


def segment_mean(data, segment_ids, name=None):
    return _segment(data, segment_ids, "mean")


def segment_max(data, segment_ids, name=None):
    return _segment(data, segment_ids, "max")


def segment_min(data, segment_ids, name=None):
    return _segment(data, segment_ids, "min")


def graph_send_recv(x, src_index, dst_index, pool_type="sum",
                    out_size=None, name=None):
    """Gather ``x[src]`` and reduce onto ``dst`` (sum, mean, max or min)
    over ``out_size`` rows (default: x's rows): the message-passing
    primitive."""
    mode = {"sum": "sum", "mean": "mean", "max": "max", "min": "min"}[
        pool_type]

    def f(*ts):
        v, src, dst = plain_views(ts)
        return as_port(_scatter(v[src.to(torch.int64)], dst,
                                out_size or v.shape[0], mode))
    return apply(f, x, src_index, dst_index, op_name="graph_send_recv")


def _host(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(
        x, torch.Tensor) else x)


def _out(arr, dev):
    return Tensor(np.ascontiguousarray(arr), place=dev)


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(None)


def graph_sample_neighbors(row, colptr, input_nodes, sample_size=-1,
                           eids=None, return_eids=False, perm_buffer=None,
                           flag_perm_buffer=False, edge_weight=None,
                           name=None):
    """Up to ``sample_size`` neighbours of each input node of a CSC graph
    (all of them at -1), without replacement; with ``edge_weight`` the
    draw is weight-proportional and zero-weight edges are never picked.
    Returns ``(neighbors, counts)``, and the picked edges' ids (``eids``,
    aligned with ``row``) when ``return_eids``."""
    dev = _device_of(row, colptr, input_nodes)
    rown, cptr, nodes = _host(row), _host(colptr), _host(input_nodes)
    wts = _host(edge_weight).astype(np.float64) \
        if edge_weight is not None else None
    eid_arr = _host(eids) if eids is not None else None
    if return_eids and eid_arr is None:
        raise ValueError("return_eids=True requires eids")
    seed = gen.next_key(device=dev).initial_seed()
    rng = np.random.Generator(np.random.Philox(seed))
    out_neighbors, out_count, out_eids = [], [], []
    for n in nodes.ravel():
        beg, end = int(cptr[n]), int(cptr[n + 1])
        idx = np.arange(beg, end)
        if wts is not None:
            idx = idx[wts[beg:end] > 0]
        if 0 <= sample_size < len(idx):
            p = None if wts is None else wts[idx] / wts[idx].sum()
            idx = rng.choice(idx, size=sample_size, replace=False, p=p)
        out_neighbors.append(rown[idx])
        out_count.append(len(idx))
        if return_eids:
            out_eids.append(eid_arr[idx])
    flat = np.concatenate(out_neighbors) if out_neighbors \
        else np.zeros(0, rown.dtype)
    result = (_out(flat, dev), _out(np.asarray(out_count), dev))
    if return_eids:
        result += (_out(np.concatenate(out_eids) if out_eids
                        else np.zeros(0, np.int64), dev),)
    return result


def graph_reindex(x, neighbors, count, value_buffer=None, index_buffer=None,
                  flag_buffer_hashtable=False, name=None):
    """A sampled subgraph with local ids: ``(reindexed neighbors, the
    edges' local destinations, the nodes in local-id order)``; the input
    nodes come first."""
    dev = _device_of(x, neighbors, count)
    xs, nb, ct = _host(x).ravel(), _host(neighbors).ravel(), \
        _host(count).ravel()
    order = {}
    for v in np.concatenate([xs, nb]):
        order.setdefault(int(v), len(order))
    reindex_nb = np.asarray([order[int(v)] for v in nb], np.int64)
    dst = np.repeat(np.arange(len(xs), dtype=np.int64), ct)
    nodes = np.asarray(sorted(order, key=order.get), np.int64)
    return _out(reindex_nb, dev), _out(dst, dev), _out(nodes, dev)


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None):
    """K-hop sampling: sample each hop from the frontier, then reindex the
    union subgraph to local ids. Returns ``(edge_src, edge_dst,
    sample_index, reindex_counts)``."""
    dev = _device_of(row, colptr, input_nodes)
    centers = _host(input_nodes).ravel()
    order = {}
    for v in centers:
        order.setdefault(int(v), len(order))
    e_src, e_dst, counts = [], [], []
    frontier = centers
    for k in sample_sizes:
        neigh, cnt = graph_sample_neighbors(row, colptr, frontier,
                                            sample_size=k)
        nb, ct = _host(neigh).ravel(), _host(cnt).ravel()
        e_src.append(nb)
        e_dst.append(np.repeat(frontier, ct))
        counts.append(ct)
        for v in nb:
            order.setdefault(int(v), len(order))
        frontier = np.unique(nb)
    cat = (lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64))
    src_all, dst_all, cnts = cat(e_src), cat(e_dst), cat(counts)
    ridx = np.asarray([order[int(v)] for v in src_all], np.int64)
    rdst = np.asarray([order[int(v)] for v in dst_all], np.int64)
    nodes = np.asarray(sorted(order, key=order.get), np.int64)
    return (_out(ridx, dev), _out(rdst, dev), _out(nodes, dev),
            _out(cnts, dev))


def softmax_mask_fuse(x, mask, name=None):
    """``softmax(x + mask)`` over the last axis, added and normalised in
    fp32, rounded to x's dtype."""
    def f(*ts):
        v, m = plain_views(ts)
        return as_port(torch.softmax(v.float() + m.float(), -1).to(v.dtype))
    return apply(f, x, mask, op_name="fused_softmax_mask")


def softmax_mask_fuse_upper_triangle(x):
    """Softmax over the last axis with the causal upper triangle masked
    out."""
    def f(*ts):
        (v,) = plain_views(ts)
        q, k = v.shape[-2], v.shape[-1]
        causal = torch.ones((q, k), dtype=torch.bool, device=v.device).tril()
        z = torch.where(causal, v.float(), -1e30)
        return as_port(torch.softmax(z, -1).to(v.dtype))
    return apply(f, x, op_name="fused_softmax_mask_upper_triangle")


def identity_loss(x, reduction="none"):
    """The loss as it is, or its mean or sum (``reduction`` also 0 sum, 1
    mean, 2 none)."""
    if isinstance(reduction, int):
        reduction = {0: "sum", 1: "mean", 2: "none"}[reduction]
    red = {"none": lambda v: v, "mean": torch.mean, "sum": torch.sum}[
        reduction]
    return apply(lambda v: as_port(red(plain_views((v,))[0])), x,
                 op_name="identity_loss")


class LookAhead(Optimizer):
    """Lookahead over an inner optimizer: every ``k`` steps the slow
    weights move ``alpha`` of the way to the fast ones and the fast
    weights take their value (the slow weights start at the fast weights
    of step k, as in the JAX class)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = int(k)
        self._slow = {}
        self._steps = 0
        self._params = inner_optimizer._params
        self._grad_clip = inner_optimizer._grad_clip

    def step(self):
        self.inner_optimizer.step()
        self._steps += 1
        if self._steps % self.k:
            return
        with torch.no_grad():
            for p in self._params:
                if not p.requires_grad:
                    continue
                fast = p.detach().as_subclass(torch.Tensor)
                slow = self._slow.get(id(p))
                if slow is None:
                    slow = fast.clone()
                new_slow = slow + self.alpha * (fast - slow)
                self._slow[id(p)] = new_slow
                torch.Tensor.copy_(p, new_slow)

    def clear_grad(self, *a, **k):
        self.inner_optimizer.clear_grad(*a, **k)

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self.clear_grad()

    def state_dict(self):
        sd = self.inner_optimizer.state_dict()
        sd["lookahead_steps"] = self._steps
        return sd


class ModelAverage(Optimizer):
    """The running mean of the parameters over the steps taken; ``apply()``
    swaps it in for a ``with`` block (restored after unless
    ``need_restore=False``), ``restore()`` swaps the trained values
    back."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        super().__init__(0.0, parameters)
        self.rate = average_window_rate
        self.min_w = min_average_window
        self.max_w = max_average_window
        self._sum = {}
        self._cnt = 0
        self._backup = {}

    def step(self):
        self._cnt += 1
        with torch.no_grad():
            for p in self._params:
                if not p.requires_grad:
                    continue
                v = p.detach().as_subclass(torch.Tensor)
                s = self._sum.get(id(p))
                self._sum[id(p)] = v.clone() if s is None else s + v

    def minimize(self, loss, *a, **k):
        self.step()

    def apply(self, executor=None, need_restore=True):
        @contextlib.contextmanager
        def ctx():
            with torch.no_grad():
                for p in self._params:
                    if id(p) in self._sum and self._cnt:
                        self._backup[id(p)] = p.detach().clone()
                        torch.Tensor.copy_(p, self._sum[id(p)] / self._cnt)
            try:
                yield
            finally:
                if need_restore:
                    self.restore()
        return ctx()

    def restore(self, executor=None):
        with torch.no_grad():
            for p in self._params:
                if id(p) in self._backup:
                    torch.Tensor.copy_(p, self._backup.pop(id(p)))
