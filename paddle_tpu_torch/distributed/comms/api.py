"""The routed comms layer: every collective of the port goes through here.

Counterpart of ``paddle_tpu/distributed/comms/api.py``. Each call gets a
``CommOp`` record (owner, axis, logical / wire / staged bytes, deadline)
and, when the opt-in context is on, an eligible reduction rides the
quantized wire format instead of full precision::

    with comms.quantized("int8"):      # or "fp8"
        loss = step(batch)             # dp grad sync moves int8 + scales

The JAX functions act on a mesh axis bound inside ``shard_map``; these act
on each rank's local tensor over a group: a mesh axis name (or a tuple of
names), a ``collective.Group``, or None for every rank of the mesh. A
group of one is a local round trip: nothing crosses a wire and the record
says so.

The quantized all-reduce is EQuARX's two-shot decomposition (:186-233):
quantize, all-to-all the per-rank chunks (shot one: payload plus fp32
per-block scales), dequantize and reduce in fp32, requantize, all-gather
(shot two), dequantize. Reducing in fp32 between the shots keeps the
error from compounding with the rank count. Exactness-critical traffic
(tensor-parallel activations, ring hand-offs, ids) passes ``exact=True``
and never quantizes.

Unlike the JAX package, where GSPMD already reduced the grads and
``grad_sync`` re-rides them over the wire only inside the context,
``grad_sync`` here IS the data-parallel gradient sync: exact (one
flattened all-reduce per dtype) with the context off, the quantized
two-shot per gradient with it on.

Gloo carries a CUDA tensor natively only for the ops that have a CUDA
variant in gloo and work there (``GLOO_CUDA_NATIVE``); for the others the
tensors are copied through the host here, explicitly, and the bytes
copied are recorded as ``staged_bytes``. An NCCL group never stages.

Every phase is named for chaos (``comm.quantize`` / ``comm.collective`` /
``comm.dequant``) and runs under one Deadline (``PT_COMM_DEADLINE``,
default 60 s) that turns a stall in the issue path into a typed
``CommTimeout``; a dropped wire (ConnectionError) is retried once. The
process group's own timeout (``init_parallel_env``) bounds a wait on a
peer, and the backend's error when a peer dies or that timeout fires (a
``RuntimeError`` from gloo or NCCL: "Connection closed by peer", "Connection
reset by peer", a timeout) is raised as ``CommTimeout`` too, naming the
collective, so an elastic supervisor classifies a lost rank as one of its
typed step signals. The JAX package has no such error to map: its
collectives run inside one program.

Env knobs: ``PT_COMM_QUANT`` (the wire dtype of ``quantized()`` with no
argument), ``PT_COMM_BLOCK`` (block size, default 256),
``PT_COMM_DEADLINE`` (seconds).
"""
from __future__ import annotations

import os
import re
import threading
import time
from contextlib import contextmanager
from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist

from ...utils.deadline import CommTimeout, Deadline, env_int, env_timeout
from ..chaos import faultpoint, register_fault
from . import quantize as Q
from .schedule import CommOp, record

__all__ = [
    "quantized", "quant_state", "comms_cache_key", "comm_deadline",
    "grad_sync", "quantized_all_reduce", "wire_all_reduce",
    "wire_all_gather", "wire_all_to_all", "wire_exchange", "wire_broadcast",
    "wire_reduce_scatter", "wire_p2p", "Link", "link",
    "GLOO_CUDA_NATIVE",
]

SITE_QUANTIZE = register_fault(
    "comm.quantize", "blockwise quantization of a collective's payload")
SITE_COLLECTIVE = register_fault(
    "comm.collective", "the wire passes of a quantized/scheduled collective")
SITE_DEQUANT = register_fault(
    "comm.dequant", "dequantization of a collective's received payload")

# gloo collectives that take CUDA tensors (torch 2.11 on the card:
# all_reduce, broadcast, all_gather(_into_tensor), reduce_scatter and
# all_to_all_single do; send/recv abort the process in gloo's TCP transport,
# which is handed a device pointer, so point-to-point is staged)
GLOO_CUDA_NATIVE = frozenset({"all_reduce", "broadcast", "all_gather",
                              "reduce_scatter", "all_to_all"})


def comm_deadline() -> float:
    return env_timeout("PT_COMM_DEADLINE", 60.0)


class _QuantState(threading.local):
    def __init__(self):
        self.dtype: Optional[str] = None     # None: exact (the default)
        self.block: int = env_int("PT_COMM_BLOCK", Q.DEFAULT_BLOCK)
        self.stochastic: bool = False
        self.generator: Optional[torch.Generator] = None


_state = _QuantState()


def quant_state() -> _QuantState:
    return _state


def comms_cache_key():
    """Hashable token of the comms regime (False when exact): a captured
    step keys its graphs by it, as the JAX step keys its lowering."""
    if _state.dtype is None:
        return False
    return (_state.dtype, _state.block, _state.stochastic)


@contextmanager
def quantized(dtype: Optional[str] = None, block: Optional[int] = None,
              stochastic: bool = False,
              generator: Optional[torch.Generator] = None):
    """Opt into the quantized wire format for eligible collectives issued
    inside the context. ``dtype`` defaults to ``PT_COMM_QUANT`` (or int8);
    ``stochastic`` (int8 only) needs ``generator`` on the tensors'
    device."""
    if dtype is None:
        dtype = os.environ.get("PT_COMM_QUANT", "").strip() or "int8"
    if dtype not in Q.WIRE_DTYPES:
        raise ValueError(f"comms.quantized: unknown wire dtype {dtype!r} "
                         f"(pick from {Q.WIRE_DTYPES})")
    if stochastic and dtype != "int8":
        raise ValueError("stochastic rounding is int8-only (uniform grid); "
                         "fp8+stochastic would bias the rounding")
    if stochastic and generator is None:
        raise ValueError("stochastic rounding needs an explicit "
                         "torch.Generator")
    prev = (_state.dtype, _state.block, _state.stochastic, _state.generator)
    _state.dtype = dtype
    _state.block = int(block) if block else env_int("PT_COMM_BLOCK",
                                                    Q.DEFAULT_BLOCK)
    _state.stochastic = bool(stochastic)
    _state.generator = generator
    try:
        yield _state
    finally:
        (_state.dtype, _state.block, _state.stochastic,
         _state.generator) = prev


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------

class Link(NamedTuple):
    """Where a collective runs: the process group (None for a group of
    one), its size, this rank's index in it, the axis label, the
    backend."""
    pg: object
    n: int
    rank: int
    label: str
    backend: Optional[str]


def link(group=None, mesh=None) -> Link:
    """Resolve ``group`` (a mesh axis, a tuple of axes, None for every
    rank of the mesh, or a ``collective.Group``) against the mesh."""
    if hasattr(group, "link"):
        return group.link()
    from ...parallel import mesh as mesh_mod
    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    if mesh is None:
        return Link(None, 1, 0, "local", None)
    axes = group
    pg = mesh.group(axes)
    label = "+".join(mesh._axes(axes)) if axes is not None else "world"
    n = mesh.axis_size(axes)
    if pg is None:
        return Link(None, 1, 0, label, mesh.backend)
    return Link(pg, n, mesh.axis_index(axes), label, mesh.backend)


def _global(lk: Link, i: int) -> int:
    return dist.get_global_rank(lk.pg, int(i))


# ---------------------------------------------------------------------------
# transport: exact ops, host staging for gloo, no records
# ---------------------------------------------------------------------------

class _Stager:
    """Copies the CUDA tensors of a gloo op that gloo cannot carry through
    the host and back, counting the bytes (both directions)."""

    def __init__(self, lk: Link, kind: str, ref: torch.Tensor):
        self.on = (lk.backend == "gloo" and ref.is_cuda
                   and kind not in GLOO_CUDA_NATIVE)
        self.bytes = 0

    def out(self, t: torch.Tensor) -> torch.Tensor:
        if not self.on:
            return t
        self.bytes += t.numel() * t.element_size()
        return t.to("cpu")

    def back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if not self.on:
            return t
        self.bytes += t.numel() * t.element_size()
        return t.to(like.device)


_RED = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT,
        "avg": dist.ReduceOp.SUM}


# what a backend says when a peer died (its socket closed or reset; NCCL:
# a remote error, the watchdog's abort) or the group's timeout fired while
# a collective waited on it
_PEER_LOST = re.compile(r"(?i)connection (closed|reset|refused)|by peer|"
                        r"timed? ?out|timing out|broken pipe|aborted|socket|"
                        r"remote process|ncclRemoteError")


class _Issuing(threading.local):
    depth = 0


_issuing = _Issuing()


def issuing() -> bool:
    """Whether this thread is inside one of this layer's
    ``torch.distributed`` calls (the capture tier's lint tells a routed
    collective from an unscheduled one by it)."""
    return _issuing.depth > 0


@contextmanager
def _peer_guard(kind: str, lk: Link):
    """Raise a backend's lost-peer error inside a collective as the typed
    ``CommTimeout`` (the process group's timeout is the budget)."""
    _issuing.depth += 1
    try:
        yield
    except RuntimeError as e:
        if not _PEER_LOST.search(str(e)):
            raise
        raise CommTimeout(f"{kind} over {lk.label} ({lk.backend})",
                          comm_deadline(),
                          detail=f"a peer is gone: {str(e)[:300]}") from e
    finally:
        _issuing.depth -= 1


def _t_all_reduce(t: torch.Tensor, lk: Link, op: str, st: _Stager):
    """The reduction of ``t`` over the group, a new tensor."""
    x = st.out(t.contiguous())
    x = x.clone() if x is t else x
    with _peer_guard("all_reduce", lk):
        dist.all_reduce(x, op=_RED[op], group=lk.pg)
    if op == "avg":
        x = x / lk.n
    return st.back(x, t)


def _t_all_gather(t: torch.Tensor, lk: Link, st: _Stager) -> torch.Tensor:
    """``[n, *t.shape]``: every rank's ``t`` in group order."""
    x = st.out(t.contiguous())
    out = torch.empty((lk.n,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    with _peer_guard("all_gather", lk):
        if lk.backend == "gloo":
            dist.all_gather(list(out.unbind(0)), x, group=lk.pg)
        else:
            dist.all_gather_into_tensor(out, x, group=lk.pg)
    return st.back(out, t)


def _t_all_to_all(t: torch.Tensor, lk: Link, st: _Stager) -> torch.Tensor:
    """``t`` is ``[n, ...]``: block j goes to rank j; the result stacks the
    block each rank sent here, in group order."""
    x = st.out(t.contiguous())
    out = torch.empty_like(x)
    with _peer_guard("all_to_all", lk):
        dist.all_to_all_single(out, x, group=lk.pg)
    return st.back(out, t)


def _t_broadcast(t: torch.Tensor, lk: Link, src: int, st: _Stager):
    x = st.out(t.contiguous())
    x = x.clone() if x is t else x
    with _peer_guard("broadcast", lk):
        dist.broadcast(x, _global(lk, src), group=lk.pg)
    return st.back(x, t)


def _wire_view(q: torch.Tensor) -> torch.Tensor:
    """A wire payload as bytes (gloo and NCCL carry no float8)."""
    return q.view(torch.uint8)


# ---------------------------------------------------------------------------
# phases, deadline and records
# ---------------------------------------------------------------------------

def _phase(site: str, dl: Deadline, owner: str) -> None:
    try:
        faultpoint(site)
    except ConnectionError:
        faultpoint(site)   # a transient wire death is absorbed once
    dl.check(f"{site} ({owner})", exc=CommTimeout)


def _deadline(owner: str, budget: Optional[float]) -> Deadline:
    return Deadline(budget if budget is not None else comm_deadline(),
                    what=f"comms:{owner}")


def _record(owner, kind, lk: Link, v, volume, quantized_dt, dl, block,
            staged=0, t0=None, n=1):
    """One CommOp (api.py:_record): ``volume`` is the per-rank wire
    multiplier in payloads (a two-shot all-reduce moves 2 (n-1)/n, an
    all-gather receives n-1); quantized wire bytes count the padded
    payload the two-shot moves."""
    size = v.numel()
    logical = int(volume * size * v.element_size())
    if quantized_dt and volume > 0:
        nb_pad = -(-Q.n_blocks(size, block) // max(n, 1)) * max(n, 1)
        wire = int(volume * (nb_pad * block + 4 * nb_pad))
    else:
        wire = logical
    ms = 0.0 if t0 is None else (time.perf_counter() - t0) * 1e3
    label = lk.label if lk.n > 1 else "local"
    return record(CommOp(
        owner=owner, site=f"{owner}/{kind}/{label}", kind=kind, axis=label,
        shape=tuple(v.shape), dtype=str(v.dtype).replace("torch.", ""),
        bytes_logical=logical, bytes_wire=wire, quantized=quantized_dt,
        deadline_s=dl.timeout, staged_bytes=int(staged), ms=ms))


def _ar_volume(n: int) -> float:
    return 2.0 * (n - 1) / n if n > 1 else 0.0


def _quant_eligible(v: torch.Tensor, op: str, exact: bool) -> bool:
    return (not exact and _state.dtype is not None and op in ("sum", "avg")
            and v.is_floating_point())


# ---------------------------------------------------------------------------
# the quantized two-shot
# ---------------------------------------------------------------------------

def _quantize(x, st):
    return Q.quantize_blockwise(x, st.dtype, st.block, st.stochastic,
                                st.generator)


def _two_shot(v: torch.Tensor, lk: Link, op: str, qs,
              stager: _Stager) -> torch.Tensor:
    """EQuARX two-shot all-reduce of ``v`` over the group: v's shape and
    dtype on every rank (api.py:186-233)."""
    n, block = lk.n, qs.block
    shape, dtype = v.shape, v.dtype
    flat = v.reshape(-1).to(torch.float32)
    size = flat.shape[0]
    nb = Q.n_blocks(size, block)
    nb_pad = -(-nb // n) * n
    pad = nb_pad * block - size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    per = nb_pad // n
    q, s = _quantize(flat, qs)
    qx = _t_all_to_all(_wire_view(q).reshape(n, -1), lk, stager)
    sx = _t_all_to_all(s.reshape(n, -1), lk, stager)
    vals = qx.view(q.dtype).to(torch.float32).reshape(n, per, block) \
        * sx.reshape(n, per, 1)
    red = vals.sum(dim=0)
    if op == "avg":
        red = red / n
    q2, s2 = _quantize(red.reshape(per * block), qs)
    qg = _t_all_gather(_wire_view(q2), lk, stager)
    sg = _t_all_gather(s2, lk, stager)
    full = qg.view(q2.dtype).to(torch.float32).reshape(n, per, block) \
        * sg.reshape(n, per, 1)
    return full.reshape(nb_pad * block)[:size].reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# the recorded collectives
# ---------------------------------------------------------------------------

def wire_all_reduce(v: torch.Tensor, axis=None, op: str = "sum", *,
                    owner: str = "collective", exact: bool = False,
                    budget: Optional[float] = None, mesh=None
                    ) -> torch.Tensor:
    """The reduction (sum, avg, max, min, prod) of each rank's ``v`` over
    the axis, as a new tensor. Quantized (sum and avg of floats) when the
    context is on and not ``exact``. Always recorded."""
    lk = link(axis, mesh)
    dl = _deadline(owner, budget)
    t0 = time.perf_counter()
    if lk.n == 1:
        _phase(SITE_COLLECTIVE, dl, owner)
        _record(owner, "all_reduce", lk, v, 0, None, dl, _state.block, t0=t0)
        return v
    if _quant_eligible(v, op, exact):
        qs = _state
        st = _Stager(lk, "all_to_all", v)
        _phase(SITE_QUANTIZE, dl, owner)
        _phase(SITE_COLLECTIVE, dl, owner)
        out = _two_shot(v, lk, op, qs, st)
        _phase(SITE_DEQUANT, dl, owner)
        _record(owner, "all_reduce", lk, v, _ar_volume(lk.n), qs.dtype, dl,
                qs.block, staged=st.bytes, t0=t0, n=lk.n)
        return out
    _phase(SITE_COLLECTIVE, dl, owner)
    st = _Stager(lk, "all_reduce", v)
    out = _t_all_reduce(v, lk, op, st)
    _record(owner, "all_reduce", lk, v, _ar_volume(lk.n), None, dl,
            _state.block, staged=st.bytes, t0=t0)
    return out


def wire_all_gather(v: torch.Tensor, axis=None, *,
                    owner: str = "collective", exact: bool = False,
                    budget: Optional[float] = None, mesh=None
                    ) -> torch.Tensor:
    """``[n, *v.shape]``: every rank's ``v`` in axis order. Quantized when
    the context is on and not ``exact``."""
    lk = link(axis, mesh)
    dl = _deadline(owner, budget)
    t0 = time.perf_counter()
    if lk.n == 1:
        _phase(SITE_COLLECTIVE, dl, owner)
        _record(owner, "all_gather", lk, v, 0, None, dl, _state.block, t0=t0)
        return v.unsqueeze(0)
    st = _Stager(lk, "all_gather", v)
    if _quant_eligible(v, "sum", exact):
        qs = _state
        _phase(SITE_QUANTIZE, dl, owner)
        q, s = _quantize(v, qs)
        _phase(SITE_COLLECTIVE, dl, owner)
        qg = _t_all_gather(_wire_view(q), lk, st).view(q.dtype)
        sg = _t_all_gather(s, lk, st)
        _phase(SITE_DEQUANT, dl, owner)
        out = torch.stack([Q.dequantize_blockwise(qg[i], sg[i], v.shape,
                                                  v.dtype, qs.block)
                           for i in range(lk.n)])
        _record(owner, "all_gather", lk, v, lk.n - 1, qs.dtype, dl,
                qs.block, staged=st.bytes, t0=t0)
        return out
    _phase(SITE_COLLECTIVE, dl, owner)
    out = _t_all_gather(v, lk, st)
    _record(owner, "all_gather", lk, v, lk.n - 1, None, dl, _state.block,
            staged=st.bytes, t0=t0)
    return out


def wire_all_to_all(v: torch.Tensor, axis=None, *,
                    owner: str = "collective", exact: bool = False,
                    budget: Optional[float] = None, mesh=None
                    ) -> torch.Tensor:
    """Block exchange: ``v`` is ``[n, ...]``, block j lands on rank j, and
    the result stacks at dim 0 the block every rank addressed here. A
    floating payload rides int8/fp8 (one quantize per destination block)
    when the context is on and not ``exact``."""
    lk = link(axis, mesh)
    dl = _deadline(owner, budget)
    t0 = time.perf_counter()
    if v.shape[0] != lk.n:
        raise ValueError(f"wire_all_to_all: leading dim {v.shape[0]} must "
                         f"equal the axis size {lk.n}")
    vol = (lk.n - 1) / lk.n if lk.n > 1 else 0.0
    if lk.n == 1:
        _phase(SITE_COLLECTIVE, dl, owner)
        _record(owner, "all_to_all", lk, v, 0, None, dl, _state.block, t0=t0)
        return v
    st = _Stager(lk, "all_to_all", v)
    if _quant_eligible(v, "sum", exact):
        qs = _state
        _phase(SITE_QUANTIZE, dl, owner)
        pairs = [_quantize(b, qs) for b in v.unbind(0)]
        q = torch.stack([p[0] for p in pairs])
        s = torch.stack([p[1] for p in pairs])
        _phase(SITE_COLLECTIVE, dl, owner)
        qx = _t_all_to_all(_wire_view(q), lk, st).view(q.dtype)
        sx = _t_all_to_all(s, lk, st)
        _phase(SITE_DEQUANT, dl, owner)
        out = torch.stack([Q.dequantize_blockwise(qx[i], sx[i], v.shape[1:],
                                                  v.dtype, qs.block)
                           for i in range(lk.n)])
        _record(owner, "all_to_all", lk, v, vol, qs.dtype, dl, qs.block,
                staged=st.bytes, t0=t0, n=lk.n)
        return out
    _phase(SITE_COLLECTIVE, dl, owner)
    out = _t_all_to_all(v, lk, st)
    _record(owner, "all_to_all", lk, v, vol, None, dl, _state.block,
            staged=st.bytes, t0=t0)
    return out


def wire_reduce_scatter(v: torch.Tensor, axis=None, op: str = "sum", *,
                        owner: str = "collective",
                        budget: Optional[float] = None, mesh=None
                        ) -> torch.Tensor:
    """Exact reduce-scatter over dim 0: ``v`` is ``[n * m, ...]`` on every
    rank, rank j gets the reduction of rows ``[j m, (j + 1) m)``. Carried
    as an all-to-all and a local reduction in fp32 (the same bytes as a
    ring reduce-scatter, and one path for gloo and NCCL)."""
    lk = link(axis, mesh)
    dl = _deadline(owner, budget)
    t0 = time.perf_counter()
    n = lk.n
    if v.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({v.shape[0]}) not "
                         f"divisible by the axis size {n}")
    _phase(SITE_COLLECTIVE, dl, owner)
    if n == 1:
        _record(owner, "reduce_scatter", lk, v, 0, None, dl, _state.block,
                t0=t0)
        return v
    st = _Stager(lk, "all_to_all", v)
    x = _t_all_to_all(v.reshape(n, v.shape[0] // n, *v.shape[1:]), lk, st)
    if op in ("sum", "avg"):
        out = x.to(torch.float32).sum(dim=0) if v.is_floating_point() \
            else x.sum(dim=0)
        if op == "avg":
            out = out / n
    elif op == "max":
        out = x.amax(dim=0)
    elif op == "min":
        out = x.amin(dim=0)
    elif op == "prod":
        out = x.prod(dim=0)
    else:
        raise ValueError(f"unknown reduction {op!r}")
    _record(owner, "reduce_scatter", lk, v, (n - 1) / n, None, dl,
            _state.block, staged=st.bytes, t0=t0)
    return out.to(v.dtype)


def wire_broadcast(v: torch.Tensor, src: int = 0, axis=None, *,
                   owner: str = "collective", budget: Optional[float] = None,
                   mesh=None) -> torch.Tensor:
    """Group rank ``src``'s ``v`` on every rank (exact)."""
    lk = link(axis, mesh)
    dl = _deadline(owner, budget)
    t0 = time.perf_counter()
    _phase(SITE_COLLECTIVE, dl, owner)
    if lk.n == 1:
        _record(owner, "broadcast", lk, v, 0, None, dl, _state.block, t0=t0)
        return v
    st = _Stager(lk, "broadcast", v)
    out = _t_broadcast(v, lk, int(src) % lk.n, st)
    _record(owner, "broadcast", lk, v, 1, None, dl, _state.block,
            staged=st.bytes, t0=t0)
    return out


def wire_p2p(sends, recvs, axis=None, *, owner: str = "collective",
             budget: Optional[float] = None, mesh=None) -> list:
    """One batched exchange of point-to-point messages over the axis (the
    ring's and the pipeline's hand-offs): ``sends`` is ``[(tensor, dst)]``, ``recvs``
    ``[(like, src)]`` with peers as axis indices; returns a tensor like
    each ``like``, in order. Every send and receive of the call goes into
    one ``batch_isend_irecv``, so two neighbours that both send and both
    receive in one tick cannot deadlock. Exact; staged through the host
    for CUDA tensors on gloo. Recorded as one ``sendrecv`` whose logical
    bytes are the bytes sent."""
    lk = link(axis, mesh)
    dl = _deadline(owner, budget)
    t0 = time.perf_counter()
    _phase(SITE_COLLECTIVE, dl, owner)
    if not sends and not recvs:
        return []
    if lk.n == 1:
        raise ValueError("wire_p2p: an axis of one rank has no peer")
    ref = (sends or recvs)[0][0]
    st = _Stager(lk, "sendrecv", ref)
    ops, outs = [], []
    for t, dst in sends:
        x = st.out(t.contiguous())
        ops.append(dist.P2POp(dist.isend, x, _global(lk, int(dst) % lk.n),
                              lk.pg))
    for like, src in recvs:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if st.on else like.device)
        outs.append((buf, like))
        ops.append(dist.P2POp(dist.irecv, buf, _global(lk, int(src) % lk.n),
                              lk.pg))
    with _peer_guard("sendrecv", lk):
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    got = [st.back(b, like) for b, like in outs]
    sent = sum(t.numel() * t.element_size() for t, _ in sends)
    unit = ref.numel() * ref.element_size()
    _record(owner, "sendrecv", lk, ref, sent / unit if unit else 0, None, dl,
            _state.block, staged=st.bytes, t0=t0)
    return got


class _Exchange(torch.autograd.Function):
    """The split = concat = 0 all-to-all is its own transpose across ranks
    (block i on rank d swaps with block d on rank i), so its backward is
    the same exchange of the cotangent, recorded as ``owner + '.grad'``."""

    @staticmethod
    def forward(ctx, v, group, owner, exact, mesh):
        ctx.group, ctx.owner, ctx.exact, ctx.mesh = group, owner, exact, mesh
        return wire_all_to_all(v, group, owner=owner, exact=exact, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return (wire_all_to_all(g.contiguous(), ctx.group,
                                owner=ctx.owner + ".grad", exact=ctx.exact,
                                mesh=ctx.mesh),
                None, None, None, None)


def wire_exchange(v: torch.Tensor, axis=None, owner: str = "collective",
                  exact: bool = False, mesh=None) -> torch.Tensor:
    """Differentiable ``wire_all_to_all``: the backward exchanges the
    cotangent blocks over the same wire (quantized when the context is on
    and not ``exact``, straight through the rounding)."""
    return _Exchange.apply(v, axis, owner, exact, mesh)


# ---------------------------------------------------------------------------
# the quantized all-reduce and the trainer's grad sync
# ---------------------------------------------------------------------------

def quantized_all_reduce(v: torch.Tensor, axis: Optional[str] = None,
                         mesh=None, op: str = "avg", *,
                         owner: str = "comms",
                         budget: Optional[float] = None) -> torch.Tensor:
    """The quantized all-reduce of each rank's ``v`` over ``axis``; needs
    the context. With no axis or an extent of 1 the value still makes the
    quantize -> dequantize round trip, so the numerics are the same on one
    rank as on many, and the record says nothing crossed a wire."""
    qs = _state
    if qs.dtype is None:
        raise ValueError("quantized_all_reduce outside comms.quantized(): "
                         "enter the context (or use collective.all_reduce "
                         "for the exact path)")
    lk = link(axis, mesh) if axis is not None else Link(None, 1, 0, "local",
                                                        None)
    if lk.n > 1:
        return wire_all_reduce(v, axis, op, owner=owner, budget=budget,
                               mesh=mesh)
    dl = _deadline(owner, budget)
    t0 = time.perf_counter()
    _phase(SITE_QUANTIZE, dl, owner)
    q, s = _quantize(v, qs)
    _phase(SITE_COLLECTIVE, dl, owner)
    _phase(SITE_DEQUANT, dl, owner)
    out = Q.dequantize_blockwise(q, s, v.shape, v.dtype, qs.block)
    _record(owner, "all_reduce", lk, v, 0, qs.dtype, dl, qs.block, t0=t0)
    return out


# the exact grad sync flattens grads into buckets of at most this many
# bytes (a bucket holds at least one grad): one all-reduce per bucket
BUCKET_BYTES = 256 << 20


def grad_sync(grads: List[torch.Tensor], mesh=None, axis="dp",
              owner: str = "trainer.grad_sync", *, op: str = "avg",
              exact: bool = False) -> List[torch.Tensor]:
    """The data-parallel gradient sync over ``axis`` (a name or a tuple of
    names): a new list. Context off: exact all-reduces over the grads
    flattened together, one per dtype and ``BUCKET_BYTES`` bucket. Context
    on: each floating grad of at least one block per rank takes the
    quantized two-shot (api.py:458-493: a smaller one would move more
    bytes quantized than exact, so it stays exact, bucketed with the
    rest). ``exact=True`` never quantizes (the tensor-parallel sums)."""
    lk = link(axis, mesh)
    if lk.n == 1:
        return list(grads)
    out = list(grads)
    rest = []
    for i, g in enumerate(grads):
        if not exact and _state.dtype is not None \
                and g.is_floating_point() \
                and g.numel() >= _state.block * lk.n:
            out[i] = wire_all_reduce(g, axis, op, owner=owner, mesh=mesh)
        else:
            rest.append(i)
    buckets = {}
    for i in rest:
        dt = grads[i].dtype
        size = grads[i].numel() * grads[i].element_size()
        open_ = buckets.setdefault(dt, [[[], 0]])
        if open_[-1][0] and open_[-1][1] + size > BUCKET_BYTES:
            open_.append([[], 0])
        open_[-1][0].append(i)
        open_[-1][1] += size
    for idx in (b[0] for per in buckets.values() for b in per):
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        red = wire_all_reduce(flat, axis, op, owner=owner, exact=True,
                              mesh=mesh)
        for i, piece in zip(idx, red.split([grads[i].numel()
                                            for i in idx])):
            out[i] = piece.view_as(grads[i])
    return out
