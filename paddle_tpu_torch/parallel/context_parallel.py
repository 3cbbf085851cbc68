"""Context parallelism for long sequences: ring attention and Ulysses.

Counterpart of ``paddle_tpu/parallel/context_parallel.py``. The sequence
is split into contiguous chunks over a mesh axis (``sep``): rank i holds
tokens ``[i S_loc, (i+1) S_loc)`` of q, k and v and gets its chunk of the
attention output. ``ring_attention`` and ``ulysses_attention`` take the
JAX functions' per-device ``[B, H, S_loc, D]`` and arguments;
``sdpa_context_parallel`` takes ``[B, S_loc, H, D]`` (the flash layout),
which the kernels read.

- **Ring attention** (:49-150): q stays, the K/V block moves one rank
  along the ring per step (an exact send/recv over the axis). Rank i's
  queries meet the block that started on rank j fully when j < i,
  causally (top-left mask, as the kernel's) when j = i, and not at all
  when j > i. Each block that is met goes through ``flash_attention_lse``
  (K2 forward, K3/K4 backward on the card, their plain versions on the
  CPU), and the blocks' partial outputs merge by a streaming logsumexp
  (``_merge_partials``, :38). GQA stays unrepeated: the kernels map q
  heads onto kv heads, so the ring moves kv-head-sized blocks.
- **Ulysses** (:188): an all-to-all re-shards heads <-> sequence, so each
  rank runs flash attention over the whole sequence for H/n heads, and a
  second all-to-all brings the output back. GQA kv heads are repeated
  only when their count does not divide by n (:249-257).

The ring's hand-off is an autograd Function whose backward hands the
K/V grads back along the ring. It passes the running output through
itself, so every rank's backward runs every hand-off in the same order,
also where causal skipping leaves a block unused (a rank that skipped its
last block would otherwise drop out of that exchange and hang its peer).
For the same reason a checkpointed (remat) block that holds a ring must
recompute in full: ``build_hybrid_train_step`` turns the early stop of
``torch.utils.checkpoint`` off on a mesh.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..distributed import comms
from ..ops.kernels.flash_attention import flash_attention, flash_attention_lse
from . import mesh as mesh_mod

__all__ = ["ring_attention", "ulysses_attention", "sdpa_context_parallel"]

_IMPLS = ("auto", "flash", "einsum")


def _merge_partials(o_acc, lse_acc, o_t, lse_t):
    """Streaming logsumexp merge of two normalized partial attentions
    (exact, differentiable): o ``[B, S, H, D]`` fp32, lse ``[B, H, S]``."""
    m = torch.maximum(lse_acc, lse_t)
    w1 = torch.exp(lse_acc - m)
    w2 = torch.exp(lse_t - m)
    den = w1 + w2

    def bshd(x):
        return x.transpose(1, 2)[..., None]
    o_new = (o_acc * bshd(w1) + o_t * bshd(w2)) / bshd(den)
    return o_new, m + torch.log(den)


class _RingHandOff(torch.autograd.Function):
    """K/V to the next rank, K/V from the previous one; ``carry`` passes
    through unchanged (it ties this hand-off into every rank's backward).
    The backward sends the K/V grad back to the rank the block came
    from."""

    @staticmethod
    def forward(ctx, kv, carry, group, mesh):
        lk = comms.link(group, mesh)
        ctx.group, ctx.mesh, ctx.n, ctx.rank = group, mesh, lk.n, lk.rank
        (out,) = comms.wire_p2p([(kv, lk.rank + 1)], [(kv, lk.rank - 1)],
                                group, owner="context_parallel.ring",
                                mesh=mesh)
        return out, carry.view_as(carry)

    @staticmethod
    def backward(ctx, g_kv, g_carry):
        (back,) = comms.wire_p2p([(g_kv, ctx.rank - 1)],
                                 [(g_kv, ctx.rank + 1)], ctx.group,
                                 owner="context_parallel.ring.grad",
                                 mesh=ctx.mesh)
        return back, g_carry, None, None


def _ring_bshd(q, k, v, group, causal: bool, scale, mesh) -> torch.Tensor:
    """Ring attention of this rank's chunk in the flash layout: q
    ``[B, S_loc, H, D]``, k and v ``[B, S_loc, Hkv, D]``; returns
    ``[B, S_loc, H, D]`` in q's dtype. Launches ``flash_attention_lse``
    for the ``i + 1`` blocks rank i meets when causal (its own and the
    earlier ranks'), for all n otherwise."""
    lk = comms.link(group, mesh)
    n, i = lk.n, lk.rank
    kv = torch.stack([k, v])
    o = lse = None
    for t in range(n):
        if t:
            kv, o = _RingHandOff.apply(kv, o, group, mesh)
        # after t hand-offs this rank holds the block of rank (i - t) mod n
        if causal and t > i:
            continue
        o_t, lse_t = flash_attention_lse(q, kv[0], kv[1], causal and t == 0,
                                         scale)
        if o is None:
            o, lse = o_t.float(), lse_t
        else:
            o, lse = _merge_partials(o, lse, o_t.float(), lse_t)
    return o.to(q.dtype)


def _check_impl(impl: str) -> None:
    if impl not in _IMPLS:
        raise ValueError(f"unknown ring-attention impl {impl!r} "
                         f"({' | '.join(_IMPLS)})")


def _bhsd(fn, q, k, v, *args):
    """Run a ``[B, S, H, D]`` function on ``[B, H, S, D]`` inputs."""
    out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), *args)
    return out.transpose(1, 2)


def ring_attention(q, k, v, axis_name, causal: bool = True,
                   scale: Optional[float] = None, impl: str = "auto", *,
                   mesh=None) -> torch.Tensor:
    """Ring attention of this rank's sequence chunk over ``axis_name`` (a
    mesh axis, a tuple of axes or a ``collective.Group``), in the JAX
    function's per-device layout: q ``[B, H, S_loc, D]``, k and v
    ``[B, Hkv, S_loc, D]``; returns ``[B, H, S_loc, D]``. ``impl``
    ("auto", "flash" or "einsum") picks the JAX function's block kernel;
    here every value runs the blocks through ``flash_attention_lse``
    (K2-K4 on the card, their plain versions for CPU tensors), which
    computes what both JAX paths compute."""
    _check_impl(impl)
    return _bhsd(_ring_bshd, q, k, v, axis_name, causal, scale, mesh)


def _heads_to_seq(x, group, mesh):
    """``[B, S_loc, H, D]`` -> ``[B, n S_loc, H/n, D]`` (all-to-all)."""
    n = comms.link(group, mesh).n
    B, S, H, D = x.shape
    if H % n:
        raise ValueError(f"Ulysses splits {H} heads over {n} ranks")
    blocks = x.reshape(B, S, n, H // n, D).permute(2, 0, 1, 3, 4)
    y = comms.wire_exchange(blocks.contiguous(), group,
                            owner="context_parallel.ulysses", exact=True,
                            mesh=mesh)
    return y.permute(1, 0, 2, 3, 4).reshape(B, n * S, H // n, D)


def _seq_to_heads(y, group, mesh):
    """The inverse: ``[B, n S_loc, H/n, D]`` -> ``[B, S_loc, H, D]``."""
    n = comms.link(group, mesh).n
    B, S_all, Hn, D = y.shape
    S = S_all // n
    blocks = y.reshape(B, n, S, Hn, D).permute(1, 0, 2, 3, 4)
    x = comms.wire_exchange(blocks.contiguous(), group,
                            owner="context_parallel.ulysses", exact=True,
                            mesh=mesh)
    return x.permute(1, 2, 0, 3, 4).reshape(B, S, n * Hn, D)


def _ulysses_bshd(q, k, v, group, causal: bool, scale, mesh
                  ) -> torch.Tensor:
    """Ulysses attention of this rank's chunk in the flash layout (shapes
    as ``_ring_bshd``): flash attention over the whole sequence on H/n
    heads between two all-to-alls."""
    n = comms.link(group, mesh).n
    if k.shape[2] != q.shape[2] and k.shape[2] % n:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    o = flash_attention(_heads_to_seq(q, group, mesh),
                        _heads_to_seq(k, group, mesh),
                        _heads_to_seq(v, group, mesh), causal, scale)
    return _seq_to_heads(o, group, mesh)


def ulysses_attention(q, k, v, axis_name, causal: bool = True,
                      scale: Optional[float] = None, *, mesh=None
                      ) -> torch.Tensor:
    """Ulysses attention of this rank's sequence chunk over ``axis_name``,
    in the JAX function's layout (as ``ring_attention``)."""
    return _bhsd(_ulysses_bshd, q, k, v, axis_name, causal, scale, mesh)


def sdpa_context_parallel(query, key, value, *, mesh=None, axis: str = "sep",
                          mode: str = "ring", is_causal: bool = True,
                          scale: Optional[float] = None,
                          impl: str = "auto") -> torch.Tensor:
    """Context-parallel attention of this rank's sequence chunk
    ``[B, S_loc, H, D]`` over mesh axis ``axis`` (the JAX function takes
    the global array with S sharded over the axis); ``impl`` as
    ``ring_attention``'s."""
    _check_impl(impl)
    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    if mesh is None or axis not in mesh.shape:
        raise ValueError(f"mesh with axis {axis!r} required for context "
                         "parallel attention")
    if mode == "ring":
        return _ring_bshd(query, key, value, axis, is_causal, scale, mesh)
    if mode == "ulysses":
        return _ulysses_bshd(query, key, value, axis, is_causal, scale,
                             mesh)
    raise ValueError(f"unknown context-parallel mode {mode!r}")
