"""Mixture of experts, with the experts split over an ``ep`` axis.

Counterpart of ``paddle_tpu/distributed/fleet/moe.py`` (after Paddle's
``incubate/distributed/models/moe/moe_layer.py:263``): a gate, a
capacity-bucketed dispatch, the experts and the combine, routed exactly as
the JAX layer routes (``moe.py:107-134``):

- softmax over the gate's logits, the ``top_k`` experts of each token and
  their probabilities renormalised to sum to 1 (the combine weights);
- each (token, k) slot's position in its expert's queue is the
  token-major running count over the ``[T·k, E]`` one-hot, so the tokens
  that come first keep their slots and the capacity drops the later ones;
- ``capacity = max(ceil(capacity_factor · T · k / E), k)``; a dropped slot
  adds 0 at ``clip(pos, 0, C - 1)``;
- ``l_aux`` (gshard's load-balancing loss) is ``E · Σ_e mean_t(p_te) ·
  mean_t(top1_te)``, from the first choice only.

The dispatch ``[T, E, C] x [T, d] -> [E, C, d]`` and the combine are plain
products (``torch.einsum``), as the JAX package computes them outside any
Pallas kernel.

Over a mesh with an ``ep`` axis (``moe_group``: that axis name, or the
mesh's ``ep`` when None) every ep rank sees the same tokens (the JAX
layout: only the expert dim carries ``ep``, ``moe.py:140-154``) and
computes the same routing; rank r holds experts ``[r E/ep, (r+1) E/ep)``
and runs them on its slice of the dispatch. Its combine is a partial sum
over its experts, all-reduced over ep by an autograd Function whose
backward is the identity; the tokens and the top-k combine weights
(``[T, k]``, before they are scattered to ``[T, E, C]``) enter the local
experts through the conjugate (identity forward, all-reduce backward), so
every rank ends with the full grads of the gate and of the input, and the
grads of its own experts. ``experts`` then holds this
rank's experts only (``expert_offset`` is the first one's global index);
``load_paddle_tpu_state`` maps the JAX layer's global names onto them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ...core.device import resolve_device
from ...nn import functional as F
from ...nn.layer.activation import GELU
from ...nn.layer.common import Linear
from ...nn.layer.container import LayerList, Sequential
from ...nn.layers import _param, xavier_normal_
from ...parallel import mesh as mesh_mod
from .. import comms

__all__ = ["NaiveGate", "GShardGate", "SwitchGate", "MoELayer", "EP_AXIS",
           "load_paddle_tpu_state"]

EP_AXIS = "ep"


class NaiveGate(nn.Module):
    def __init__(self, d_model, num_experts, top_k=2, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.top_k = top_k
        self.num_experts = num_experts
        self.weight = _param([d_model, num_experts], device, dtype)
        xavier_normal_(self.weight, generator)

    def forward(self, x):
        return F.linear(x, self.weight)


class GShardGate(NaiveGate):
    """The gshard gate (``moe/gate/gshard_gate.py``): top-k with the
    load-balancing loss."""

    def __init__(self, d_model, num_experts, top_k=2, capacity=(1.2, 2.4),
                 **kw):
        super().__init__(d_model, num_experts, top_k, **kw)
        self.capacity_factor = capacity[0]


class SwitchGate(NaiveGate):
    """The switch gate: top-1."""

    def __init__(self, d_model, num_experts, top_k=1, capacity=(1.2, 2.4),
                 **kw):
        super().__init__(d_model, num_experts, 1, **kw)
        self.capacity_factor = capacity[0]


def _ep_axis(moe_group, mesh):
    """The ep axis name and (extent, this rank's coordinate) on ``mesh``."""
    axis = getattr(moe_group, "axis", moe_group) or EP_AXIS
    if isinstance(axis, tuple):
        axis = axis[0] if len(axis) == 1 else axis
    return axis, mesh_mod.mesh_axis_size(axis, mesh), \
        mesh_mod.axis_index(axis, mesh)


class _CopyToEP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comms.wire_all_reduce(g.contiguous(), ctx.axis, "sum",
                                     exact=True, mesh=ctx.mesh,
                                     owner="moe.ep_input.grad"), None, None


class _ReduceFromEP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return comms.wire_all_reduce(x.contiguous(), axis, "sum", exact=True,
                                     mesh=mesh, owner="moe.combine")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def route(logits: torch.Tensor, top_k: int, capacity: int,
          weights_hook=None):
    """``(dispatch [T, E, C], combine [T, E, C], l_aux)`` of the gate's
    logits ``[T, E]`` (``moe.py:107-134``); ``weights_hook`` maps the
    normalised combine weights ``[T, k]`` before they are scattered."""
    T, E = logits.shape
    probs = torch.softmax(logits, -1)
    topv, topi = torch.topk(probs, top_k, dim=-1)              # [T, k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    if weights_hook is not None:
        topv = weights_hook(topv)
    flat = torch.nn.functional.one_hot(topi, E).reshape(T * top_k, E)
    pos = torch.cumsum(flat, 0) - flat          # slots before this one
    pos = (pos * flat).sum(-1).reshape(T, top_k)
    keep = (pos < capacity).to(probs.dtype)
    idx = (torch.arange(T, device=logits.device)[:, None].expand(T, top_k)
           .reshape(-1), topi.reshape(-1),
           pos.clamp(0, capacity - 1).reshape(-1))
    zeros = torch.zeros((T, E, capacity), dtype=probs.dtype,
                        device=logits.device)
    disp = zeros.index_put(idx, keep.reshape(-1), accumulate=True)
    comb = zeros.index_put(idx, (keep * topv).reshape(-1), accumulate=True)
    me = probs.mean(0)
    ce = flat.reshape(T, top_k, E)[:, 0, :].to(probs.dtype).mean(0)
    return disp, comb, (me * ce).sum() * E


class MoELayer(nn.Module):
    """MoE block: gate -> capacity-bucketed dispatch -> experts -> combine.

    ``experts``: a list of modules (one per expert); without it,
    ``num_experts`` experts ``Sequential(Linear(d_model, d_hidden), GELU(),
    Linear(d_hidden, d_model))``. ``gate``: ``"gshard"`` (default),
    ``"switch"``, ``"naive"`` or a module. The port's knobs (``device``,
    ``dtype``, ``generator``, ``mesh``) are keyword-only; the experts and
    the gate are drawn from ``generator`` on ``device`` (default: the
    card), every expert of the ep=1 layer in order, so a layer built on an
    ep mesh from one seed holds that layer's experts.
    """

    def __init__(self, d_model, experts=None, gate=None, num_experts=None,
                 top_k=2, capacity_factor=1.25, moe_group=None,
                 recompute_interval=0, expert_fn=None, d_hidden=None, *,
                 device=None, dtype=torch.float32, generator=None, mesh=None):
        super().__init__()
        device = resolve_device(device)
        self.d_model = d_model
        self.mesh = mesh if mesh is not None else mesh_mod.get_mesh()
        self.ep_axis, self.ep, ep_rank = _ep_axis(moe_group, self.mesh)
        if experts is not None:
            self.num_experts = len(experts)
        else:
            if not (num_experts and d_hidden):
                raise ValueError("MoELayer needs experts, or num_experts and "
                                 "d_hidden")
            self.num_experts = num_experts
        if self.num_experts % self.ep:
            raise ValueError(f"{self.num_experts} experts do not split over "
                             f"{self.ep_axis}={self.ep}")
        self.local_experts = self.num_experts // self.ep
        self.expert_offset = ep_rank * self.local_experts
        mine = range(self.expert_offset,
                     self.expert_offset + self.local_experts)
        if experts is not None:
            self.experts = LayerList([experts[e] for e in mine])
        else:
            kw = dict(device=device, dtype=dtype, generator=generator)
            built = []
            for e in range(num_experts):   # draw all: same weights any ep
                seq = Sequential(Linear(d_model, d_hidden, **kw), GELU(),
                                 Linear(d_hidden, d_model, **kw))
                if e in mine:
                    built.append(seq)
            self.experts = LayerList(built)
        gkw = dict(device=device, dtype=dtype, generator=generator)
        if gate is None or gate == "gshard":
            self.gate = GShardGate(d_model, self.num_experts, top_k, **gkw)
        elif gate == "switch":
            self.gate = SwitchGate(d_model, self.num_experts, **gkw)
        elif gate == "naive":
            self.gate = NaiveGate(d_model, self.num_experts, top_k, **gkw)
        else:
            self.gate = gate
        self.top_k = getattr(self.gate, "top_k", top_k)
        self.capacity_factor = capacity_factor
        self.l_aux = None

    def capacity(self, tokens: int) -> int:
        c = int(np.ceil(self.capacity_factor * tokens * self.top_k
                        / self.num_experts))
        return max(c, self.top_k)

    def forward(self, x):
        """x: ``[batch, seq, d]`` or ``[tokens, d]``."""
        shape = x.shape
        tokens = x.reshape(-1, shape[-1])
        hook = None
        if self.ep > 1:
            def hook(w):       # [T, k]: all-reduce its grad, not [T, E, C]'s
                return _CopyToEP.apply(w, self.ep_axis, self.mesh)
        disp, comb, self.l_aux = route(self.gate(tokens), self.top_k,
                                       self.capacity(tokens.shape[0]), hook)
        lo, n = self.expert_offset, self.local_experts
        if self.ep > 1:
            tokens = _CopyToEP.apply(tokens, self.ep_axis, self.mesh)
        exp_in = torch.einsum("tec,td->ecd", disp[:, lo:lo + n], tokens)
        exp_out = torch.stack([self.experts[e](exp_in[e]) for e in range(n)])
        mixed = torch.einsum("tec,ecd->td", comb[:, lo:lo + n], exp_out)
        if self.ep > 1:
            mixed = _ReduceFromEP.apply(mixed, self.ep_axis, self.mesh)
        return mixed.reshape(shape)


def load_paddle_tpu_state(layer: MoELayer,
                          state: Dict[str, np.ndarray]) -> MoELayer:
    """Copy the JAX layer's ``{name: array}`` (global expert indices,
    ``experts.<e>.0.weight``, ...) into ``layer``: the gate whole, and the
    experts this rank holds. A missing key or a shape mismatch raises."""
    own = dict(layer.named_parameters())
    for name, p in own.items():
        key = name
        if name.startswith("experts."):
            head, idx, rest = name.split(".", 2)
            key = f"{head}.{int(idx) + layer.expert_offset}.{rest}"
        if key not in state:
            raise KeyError(f"state has no {key!r} (for {name!r})")
        arr = np.asarray(state[key])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{key}: state shape {tuple(arr.shape)} != "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.tensor(np.ascontiguousarray(arr), dtype=p.dtype,
                                 device=p.device))
    return layer
