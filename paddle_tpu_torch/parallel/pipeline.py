"""Pipeline schedules over the mesh's ``pp`` axis, one process a stage.

Counterpart of ``paddle_tpu/parallel/pipeline.py``. The JAX package runs
a whole schedule as one program: ``shard_map`` over pp, the clock a
``lax.scan``, each hand-off a ``lax.ppermute``. Here each pp rank is a
process and runs the same clock for its own stage, with the same tick
formulas; each ``ppermute`` becomes a hand-off to its neighbour, and
every tick's sends and receives go into one paired exchange
(``comms.wire_p2p``: ``batch_isend_irecv``, staged through the host for
CUDA tensors on gloo), so no tick can deadlock. A rank sends only along
real edges (the JAX ring also carries values the receiver ignores).

- ``gpipe`` (:47): forward fill-drain over ``T = M + S - 1`` ticks, fwd of
  microbatch m on rank i at tick ``m + i``. The backward (JAX: AD of the
  scan) runs the same clock in reverse: rank i takes the cotangent of its
  output from rank i + 1 (the last stage from the outputs' cotangent),
  runs the stage's backward and hands dx to rank i - 1.
- ``vpp`` (:117): each rank holds v chunks; chunk c of rank i runs
  microbatch ``g S + r`` at tick ``i + r + S (g v + c)``; the wrap
  ``S-1 -> 0`` is the ring's last edge. Backward as gpipe's, reversed.
- ``1f1b`` (``spmd_pipeline_1f1b``, :163): loss AND grads in one clock.
  ``fused`` (:222): fwd(m) at round ``m + i``, bwd(m) at
  ``m + 2(S-1) - i``; a stash of ``min(2S-1, M)`` stage inputs.
  ``compact`` (:329): one unit a tick on ``2(M+S-1)`` ticks, with the
  ``fill`` / ``steady`` / arrival rule (:350-375) and a stash of
  ``min(S, M)``. A backward unit recomputes the stage from its stashed
  input and takes ``torch.autograd.grad`` with the cotangent received
  from rank i + 1, or, on the last stage, of ``loss_fn`` with cotangent
  ``1 / M`` (:273-277).

``spmd_pipeline`` is differentiable: an autograd Function whose backward
runs the reversed clock. Its output, the last stage's, is broadcast to
every pp rank (the JAX psum); every rank computes the same loss from it
and calls backward, the last stage feeds its own cotangent in, and the
microbatches' cotangent is broadcast back from stage 0, so replicated
parameters before and after the pipeline get equal grads on every pp
rank. ``spmd_pipeline_1f1b`` returns its loss and grads as the JAX
function does: the loss and the head's grads broadcast from the last
stage, ``dx`` from stage 0.

Each rank holds only its stage's parameters: for gpipe and 1f1b a tree
of this rank's leaves (JAX: leaf ``[pp, ...]`` split over pp), for vpp
leaves ``[v, ...]`` whose element ``c`` is virtual stage ``c S + i``
(JAX: ``[v, pp, ...]`` split on dim 1). ``pipeline_info()`` reports the
last schedule run on this rank: ticks, busy ticks, the stash's peak and
the hand-offs' bytes.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

from ..distributed import comms
from . import mesh as mesh_mod

__all__ = ["PP_AXIS", "spmd_pipeline", "spmd_pipeline_1f1b",
           "activation_stash_microbatches", "stack_stage_params",
           "pipeline_info"]

PP_AXIS = "pp"
_OWNER = "pipeline.handoff"
_info: Dict[str, object] = {}


def pipeline_info() -> dict:
    """The last schedule run on this rank: ``schedule``, ``ticks`` (clock
    length, forward and backward), ``busy`` (ticks that ran a unit),
    ``stash_peak`` (stage inputs held at once), ``sends`` and
    ``bytes_sent``."""
    return dict(_info)


def activation_stash_microbatches(schedule: str, pp: int, n_microbatches: int,
                                  n_virtual: int = 1) -> int:
    """Peak number of stashed microbatch activations per stage, by
    construction of each schedule (pipeline.py:482)."""
    if schedule in ("1f1b", "1f1b_fused"):
        return min(2 * pp - 1, n_microbatches)
    if schedule == "1f1b_compact":
        return min(pp, n_microbatches)
    if schedule == "gpipe":
        return n_microbatches + pp - 1   # scan-carry residuals over T ticks
    if schedule == "vpp":
        return n_microbatches * n_virtual + pp - 1
    raise ValueError(schedule)


def stack_stage_params(param_list):
    """Stack per-stage trees (a list of length pp) into leading-dim
    tensors (pipeline.py:497)."""
    flat = [pytree.tree_flatten(t) for t in param_list]
    spec = flat[0][1]
    leaves = [torch.stack(xs, 0) for xs in zip(*(f[0] for f in flat))]
    return pytree.tree_unflatten(leaves, spec)


# ---------------------------------------------------------------------------
# the clock's plumbing
# ---------------------------------------------------------------------------

class _Rank:
    """This rank's place on the pp axis and its hand-off bookkeeping."""

    def __init__(self, axis, mesh, schedule: str):
        self.axis, self.mesh = axis, mesh
        lk = comms.link(axis, mesh)
        self.S, self.i = lk.n, lk.rank
        self.stats = {"schedule": schedule, "ticks": 0, "busy": 0,
                      "stash_peak": 0, "sends": 0, "bytes_sent": 0}

    def tick(self, busy: bool) -> None:
        self.stats["ticks"] += 1
        self.stats["busy"] += int(bool(busy))

    def exchange(self, sends, recvs) -> list:
        """One tick's paired exchange: sends ``[(tensor, peer)]``, recvs
        ``[(like, peer)]``; peers are pp coordinates."""
        if not sends and not recvs:
            return []
        if self.S == 1:             # a ring of one: the send comes back
            return [t for t, _ in sends][:len(recvs)]
        self.stats["sends"] += len(sends)
        self.stats["bytes_sent"] += sum(t.numel() * t.element_size()
                                        for t, _ in sends)
        return comms.wire_p2p(sends, recvs, self.axis, owner=_OWNER,
                              mesh=self.mesh)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        if self.S == 1:
            return t
        return comms.wire_broadcast(t.contiguous(), src, self.axis,
                                    owner="pipeline.replicate",
                                    mesh=self.mesh)

    def broadcast_tree(self, tree, src: int):
        """Every floating leaf of ``tree`` from pp rank ``src``, one
        broadcast per dtype."""
        leaves, spec = pytree.tree_flatten(tree)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for k, t in enumerate(leaves):
            by_dtype.setdefault(t.dtype, []).append(k)
        out = list(leaves)
        for idx in by_dtype.values():
            flat = torch.cat([leaves[k].reshape(-1) for k in idx])
            flat = self.broadcast(flat, src)
            for k, piece in zip(idx, flat.split([leaves[k].numel()
                                                 for k in idx])):
                out[k] = piece.view_as(leaves[k])
        return pytree.tree_unflatten(out, spec)

    def done(self, stash_peak: int = 0) -> None:
        self.stats["stash_peak"] = max(self.stats["stash_peak"], stash_peak)
        _info.clear()
        _info.update(self.stats)


class _Stash:
    """A ring of ``n`` slots of stage inputs, slot ``m % n``; reading a
    slot that holds another microbatch raises (the bound was broken)."""

    def __init__(self, n: int):
        self.n = n
        self.slots: List[Optional[tuple]] = [None] * n
        self.peak = 0

    def put(self, m: int, x: torch.Tensor) -> None:
        self.slots[m % self.n] = (m, x)
        self.peak = max(self.peak, sum(s is not None for s in self.slots))

    def get(self, m: int) -> torch.Tensor:
        s = self.slots[m % self.n]
        if s is None or s[0] != m:
            raise RuntimeError(f"pipeline stash: microbatch {m} was "
                               f"overwritten (slot holds "
                               f"{None if s is None else s[0]})")
        return s[1]

    def drop(self, m: int) -> None:
        s = self.slots[m % self.n]
        if s is not None and s[0] == m:
            self.slots[m % self.n] = None


def _leaves_like(tree, requires_grad: bool = True):
    """Detached leaves of ``tree`` (requiring grad where floating) and
    the tree rebuilt over them."""
    leaves, spec = pytree.tree_flatten(tree)
    out = [t.detach().requires_grad_(requires_grad and t.is_floating_point())
           for t in leaves]
    return out, pytree.tree_unflatten(out, spec)


def _grads(outputs, inputs, grad_outputs):
    """``torch.autograd.grad`` with zeros for inputs it does not reach."""
    need = [t for t in inputs if t.requires_grad]
    got = iter(torch.autograd.grad(outputs, need, grad_outputs,
                                   allow_unused=True))
    out = []
    for t in inputs:
        g = next(got) if t.requires_grad else None
        out.append(torch.zeros_like(t) if g is None else g)
    return out


# ---------------------------------------------------------------------------
# gpipe and vpp: forward by the clock, backward by the reversed clock
# ---------------------------------------------------------------------------

def _units(schedule: str, S: int, M: int, v: int):
    """The forward clock: per tick, each rank's unit ``(m, c)`` or None,
    as a function ``unit(t, rank)``, and the clock length."""
    if schedule == "gpipe":
        def unit(t, i):
            m = t - i
            return (m, 0) if 0 <= m < M else None
        return unit, M + S - 1

    def unit(t, i):
        q = t - i
        if q < 0:
            return None
        r, qq = q % S, q // S
        c, g = qq % v, qq // v
        m = g * S + r
        return (m, c) if m < M else None
    return unit, M * v + S - 1


class _Pipeline(torch.autograd.Function):
    """Forward: the schedule's clock; backward: the clock reversed. Inputs
    after the plan: the microbatches and this rank's parameter leaves."""

    @staticmethod
    def forward(ctx, plan, x_mb, *leaves):
        rk: _Rank = plan["rank"]
        S, i, M, v = rk.S, rk.i, plan["M"], plan["v"]
        unit, T = _units(plan["schedule"], S, M, v)
        chunks = plan["chunks"]
        last_c = v - 1
        like = x_mb[0]
        outs = [None] * M
        saved = {}          # (m, c) -> stashed input, or (x leaf, y)
        a_in = None
        for t in range(T):
            u = unit(t, i)
            rk.tick(u is not None)
            y = None
            if u is not None:
                m, c = u
                x = x_mb[m] if (i == 0 and c == 0) else a_in
                params = chunks[c][1]
                if plan["remat"]:
                    with torch.no_grad():
                        y = plan["fn"](params, x)
                    saved[u] = (x, None)
                else:
                    xl = x.detach().requires_grad_(True)
                    with torch.enable_grad():
                        y = plan["fn"](params, xl)
                    saved[u] = (xl, y)
                if i == S - 1 and c == last_c:
                    outs[m] = y.detach()
            # hand-off to rank i + 1 (ring: S-1 -> 0 for the next chunk)
            sends, recvs = [], []
            if u is not None and not (i == S - 1 and u[1] == last_c):
                sends.append((y.detach(), (i + 1) % S))
            up = unit(t, (i - 1) % S)
            if up is not None and not ((i - 1) % S == S - 1
                                       and up[1] == last_c) \
                    and not (plan["schedule"] == "gpipe" and i == 0):
                recvs.append((like, (i - 1) % S))
            got = rk.exchange(sends, recvs)
            a_in = got[0] if got else None
        ctx.plan, ctx.saved, ctx.T = plan, saved, T
        ctx.n_leaves = len(leaves)
        rk.peak = len(saved)
        if i == S - 1:
            out = torch.stack(outs)
        else:
            out = torch.zeros((M,) + tuple(like.shape), dtype=like.dtype,
                              device=like.device)
        return rk.broadcast(out, S - 1) if plan["replicate"] else out

    @staticmethod
    def backward(ctx, g_out):
        plan = ctx.plan
        rk: _Rank = plan["rank"]
        S, i, M, v = rk.S, rk.i, plan["M"], plan["v"]
        unit, T = _units(plan["schedule"], S, M, v)
        chunks = plan["chunks"]
        acc = [[torch.zeros_like(t) for t in ch[0]] for ch in chunks]
        like = g_out[0]
        dx_all = torch.zeros_like(g_out)
        g_in = None
        for t in reversed(range(T)):
            u = unit(t, i)
            rk.tick(u is not None)
            dx = None
            if u is not None:
                m, c = u
                leaves, params = chunks[c]
                g = g_out[m] if (i == S - 1 and c == v - 1) else g_in
                x, y = ctx.saved.pop(u)
                if y is None:           # recompute from the stashed input
                    x = x.detach().requires_grad_(True)
                    with torch.enable_grad():
                        y = plan["fn"](params, x)
                got = _grads([y], [x] + leaves, [g.to(y.dtype)])
                dx = got[0]
                for a, gp in zip(acc[c], got[1:]):
                    a.add_(gp)
                if i == 0 and c == 0:
                    dx_all[m] = dx
            sends, recvs = [], []
            if u is not None and not (i == 0 and u[1] == 0):
                sends.append((dx.detach(), (i - 1) % S))
            dn = unit(t, (i + 1) % S)
            if dn is not None and not ((i + 1) % S == 0 and dn[1] == 0) \
                    and not (plan["schedule"] == "gpipe" and i == S - 1):
                recvs.append((like, (i + 1) % S))
            got = rk.exchange(sends, recvs)
            g_in = got[0] if got else None
        rk.done(rk.peak)
        dx_all = rk.broadcast(dx_all, 0)
        # per-chunk grads back onto the leaves (vpp: stacked on dim 0)
        if plan["schedule"] == "vpp":
            grads = [torch.stack([acc[c][k] for c in range(v)])
                     for k in range(ctx.n_leaves)]
        else:
            grads = acc[0]
        return (None, dx_all, *grads)


def spmd_pipeline(stage_fn: Callable, stage_params, microbatches, *,
                  n_microbatches: int, mesh=None, axis: str = PP_AXIS,
                  remat: bool = True, schedule: str = "gpipe",
                  n_virtual: int = 1, replicate: bool = True):
    """Run ``stage_fn(params, x) -> y`` as a pp-pipelined computation.

    ``stage_params``: this rank's stage (gpipe), or leaves ``[v, ...]``
    whose element c is virtual stage ``c pp + i`` (vpp); ``microbatches``
    ``[M, mb, ...]`` (read on stage 0). Returns the final (virtual)
    stage's outputs ``[M, mb, ...]`` on every pp rank, differentiable:
    every pp rank must run the backward of a loss of them. ``remat``
    keeps each unit's input and recomputes the stage in the backward;
    without it each unit's graph is kept. ``replicate=False`` (the port's
    knob) skips the broadcast: the outputs are the last stage's there and
    zeros elsewhere, and only the last stage's cotangent is read anyway;
    a caller that computes the loss on the last stage alone passes it
    and runs the other ranks' backward with a zero cotangent."""
    if schedule not in ("gpipe", "vpp"):
        raise ValueError(f"unknown schedule {schedule!r} "
                         "(use gpipe|vpp here, spmd_pipeline_1f1b for 1f1b)")
    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    M = int(n_microbatches)
    if microbatches.shape[0] != M:
        raise ValueError(f"microbatches has {microbatches.shape[0]} rows, "
                         f"n_microbatches={M}")
    rk = _Rank(axis, mesh, schedule)
    v = int(n_virtual) if schedule == "vpp" else 1
    if schedule == "vpp" and M % rk.S:
        raise ValueError(f"vpp requires n_microbatches % pp == 0, got "
                         f"{M} % {rk.S}")
    leaves, spec = pytree.tree_flatten(stage_params)
    if schedule == "vpp":
        chunks = []
        for c in range(v):
            lv = [t.detach()[c] for t in leaves]
            lv = [t.requires_grad_(t.is_floating_point()) for t in lv]
            chunks.append((lv, pytree.tree_unflatten(lv, spec)))
    else:
        chunks = [_leaves_like(stage_params)]
    plan = dict(rank=rk, fn=stage_fn, M=M, v=v, schedule=schedule,
                remat=remat, chunks=chunks, replicate=replicate)
    return _Pipeline.apply(plan, microbatches, *leaves)


# ---------------------------------------------------------------------------
# 1F1B: loss and grads in one clock
# ---------------------------------------------------------------------------

def _f1b_fused_clock(S: int, M: int):
    """Per round and rank: (fwd microbatch or None, bwd microbatch or
    None)."""
    def at(r, i):
        mf = r - i
        mb = r - 2 * (S - 1) + i
        return (mf if 0 <= mf < M else None, mb if 0 <= mb < M else None)
    return at, M + 2 * (S - 1)


def _f1b_compact_clock(S: int, M: int):
    """Per tick and rank: (fwd microbatch or None, bwd microbatch or None,
    arrival microbatch or None); fwd and bwd never share a tick."""
    def at(t, i):
        d = t - i
        fill = 0 <= d < min(S - i, M)
        m_st = d // 2
        steady = d >= 0 and d % 2 == 0 and S - i <= m_st < M
        mf = d if fill else (m_st if steady else None)
        e = t - (2 * S - 1 - i)
        mb = e // 2 if (e >= 0 and e % 2 == 0 and e // 2 < M) else None
        arr_fill = 0 <= d < min(S - i + 1, M)
        arr_steady = d >= 0 and d % 2 == 0 and S - i + 1 <= d // 2 < M
        ma = None
        if i > 0 and (arr_fill or arr_steady):
            ma = d if arr_fill else d // 2
        if mb is not None:
            mf = None
        return mf, mb, ma
    return at, 2 * (M + S - 1)


def spmd_pipeline_1f1b(stage_fn: Callable, loss_fn: Callable, stage_params,
                       head_params, x_mb, labels_mb, *, n_microbatches: int,
                       mesh=None, axis: str = PP_AXIS, remat: bool = True,
                       variant: str = "fused"):
    """One-clock 1F1B training pipeline: ``(loss_mean, grads_stage,
    grads_head, dx_mb)`` (pipeline.py:163-221).

    ``stage_fn(params, x) -> y``; ``loss_fn(head_params, y, labels) ->``
    the scalar loss of ONE microbatch; ``stage_params`` this rank's stage;
    ``head_params`` replicated over pp; ``x_mb`` ``[M, mb, ...]`` (read on
    stage 0); ``labels_mb`` ``[M, ...]`` (read on the last stage). The
    loss is the mean of the microbatches' losses. ``grads_stage`` are
    this rank's; the loss, ``grads_head`` (from the last stage) and
    ``dx_mb`` (from stage 0) are the same on every pp rank. ``remat`` is
    accepted for the JAX signature: a backward unit always recomputes its
    stage from the stash; checkpointing inside the stage is
    ``stage_fn``'s."""
    if variant not in ("fused", "compact"):
        raise ValueError(f"unknown 1f1b variant {variant!r}")
    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    M = int(n_microbatches)
    rk = _Rank(axis, mesh, "1f1b" if variant == "fused" else "1f1b_compact")
    S, i = rk.S, rk.i
    p_leaves, params = _leaves_like(stage_params)
    h_leaves, head = _leaves_like(head_params)
    g_stage = [torch.zeros_like(t) for t in p_leaves]
    g_head = [torch.zeros_like(t) for t in h_leaves]
    loss = torch.zeros((), dtype=torch.float32, device=x_mb.device)
    dx_all = torch.zeros_like(x_mb)
    like = x_mb[0]
    inv_m = 1.0 / M
    is_last = i == S - 1

    def fwd(x):
        with torch.no_grad():
            return stage_fn(params, x)

    def bwd(m, x, g_in):
        nonlocal loss
        xl = x.detach().requires_grad_(True)
        with torch.enable_grad():
            y = stage_fn(params, xl)
            if is_last:
                lv = loss_fn(head, y, labels_mb[m])
                got = _grads([lv], [xl] + p_leaves + h_leaves,
                             [torch.full((), inv_m, dtype=lv.dtype,
                                         device=lv.device)])
                loss = loss + lv.detach().float() * inv_m
                for a, g in zip(g_head, got[1 + len(p_leaves):]):
                    a.add_(g)
            else:
                got = _grads([y], [xl] + p_leaves, [g_in.to(y.dtype)])
        for a, g in zip(g_stage, got[1:1 + len(p_leaves)]):
            a.add_(g)
        if i == 0:
            dx_all[m] = got[0]
        return got[0]

    if variant == "fused":
        at, R = _f1b_fused_clock(S, M)
        stash = _Stash(min(2 * (S - 1) + 1, M))
        a_in = g_in = None
        for r in range(R):
            mf, mb = at(r, i)
            rk.tick(mf is not None or mb is not None)
            y = dx = None
            if mf is not None:
                x = x_mb[mf] if i == 0 else a_in
                if i > 0:
                    stash.put(mf, x)
                if not is_last:     # the last stage's output goes nowhere
                    y = fwd(x)
            if mb is not None:
                x = x_mb[mb] if i == 0 else stash.get(mb)
                dx = bwd(mb, x, g_in)
                stash.drop(mb)
            sends, recvs = [], []
            if y is not None:
                sends.append((y, i + 1))
            if dx is not None and i > 0:
                sends.append((dx.detach(), i - 1))
            if i > 0 and at(r, i - 1)[0] is not None:
                recvs.append((like, i - 1))
            if i < S - 1 and at(r, i + 1)[1] is not None:
                recvs.append((like, i + 1))
            got = iter(rk.exchange(sends, recvs))
            a_in = next(got) if i > 0 and at(r, i - 1)[0] is not None \
                else None
            g_in = next(got) if i < S - 1 and at(r, i + 1)[1] is not None \
                else None
    else:
        at, T = _f1b_compact_clock(S, M)
        stash = _Stash(min(S, M))
        g_in = None
        for t in range(T):
            mf, mb, _ = at(t, i)
            rk.tick(mf is not None or mb is not None)
            y = dx = None
            if mf is not None and not is_last:
                y = fwd(x_mb[mf] if i == 0 else stash.get(mf))
            elif mb is not None:
                dx = bwd(mb, x_mb[mb] if i == 0 else stash.get(mb), g_in)
                stash.drop(mb)
            sends, recvs = [], []
            if y is not None and i < S - 1:
                sends.append((y, i + 1))
            if dx is not None and i > 0:
                sends.append((dx.detach(), i - 1))
            # the arrival rule: what rank i - 1 forwards this tick is
            # stashed here on arrival (pipeline.py:350-375)
            arrive = i > 0 and at(t + 1, i)[2] is not None
            back = i < S - 1 and at(t, i + 1)[1] is not None
            if arrive:
                recvs.append((like, i - 1))
            if back:
                recvs.append((like, i + 1))
            got = iter(rk.exchange(sends, recvs))
            if arrive:
                stash.put(at(t + 1, i)[2], next(got))
            g_in = next(got) if back else None
    rk.done(stash.peak)
    loss = rk.broadcast(loss, S - 1)
    g_head = rk.broadcast_tree(g_head, S - 1) if S > 1 else g_head
    dx_all = rk.broadcast(dx_all, 0)
    _, p_spec = pytree.tree_flatten(stage_params)
    _, h_spec = pytree.tree_flatten(head_params)
    return (loss, pytree.tree_unflatten(g_stage, p_spec),
            pytree.tree_unflatten(list(g_head), h_spec), dx_all)
