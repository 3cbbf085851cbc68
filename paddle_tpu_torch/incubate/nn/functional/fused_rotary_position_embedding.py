"""fused_rotary_position_embedding: counterpart of
``paddle_tpu/incubate/nn/functional/fused_rotary_position_embedding.py``.

Layout ``[B, S, H, D]``. ``use_neox_rotary_style=True`` rotates the half
blocks ``x[..., :D/2]``, ``x[..., D/2:]``; False the interleaved even and
odd lanes (GPT-J, as ``models/llama.py``'s RoPE). The angles default to
the ``rotary_theta`` schedule over positions ``0 .. S-1``, in fp32, the
products formed as LLaMA's RoPE forms them; a user ``sin``/``cos`` of
width D (its first half is used) or D/2 replaces them; ``position_ids
[B, S]`` gathers rows of the table, or without a table computes the
angles of those positions (any position, past S included). One op of the
library (``fused_rotary_position_embedding``).
"""
from __future__ import annotations

import torch

from ....core.tensor import as_port, plain_views
from ....ops.dispatch import apply

__all__ = ["fused_rotary_position_embedding"]


def _inv_freq(d, theta, device):
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=device) / d))


def _table(t, d):
    """A user sin or cos as ``[rows, D/2]`` fp32."""
    t = t.float()
    return t.reshape(-1, d)[..., : d // 2] if t.shape[-1] == d \
        else t.reshape(-1, d // 2)


def _rotate(x, sin, cos, neox):
    """x ``[B, S, H, D]`` by sin/cos broadcastable to ``[B, S, 1, D/2]``,
    in fp32, rounded to x's dtype."""
    xf = x.float()
    if neox:
        d2 = x.shape[-1] // 2
        x1, x2 = xf[..., :d2], xf[..., d2:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    rotary_theta=10000.0):
    """Rotary embeddings on q (and k, v when given); returns ``(q, k, v)``
    with None for the inputs not given."""
    have = [t for t in (q, k, v) if t is not None]
    has_table = sin is not None and cos is not None
    extra = [t for t in (sin, cos, position_ids) if t is not None]
    n_sin, n_cos = sin is not None, cos is not None

    def f(*args):
        args = plain_views(args)
        ts = args[:len(have)]
        rest = list(args[len(have):])
        s_ = rest.pop(0) if n_sin else None
        c_ = rest.pop(0) if n_cos else None
        pids = rest.pop(0) if position_ids is not None else None
        S, D = ts[0].shape[1], ts[0].shape[-1]
        dev = ts[0].device
        if has_table:
            s_, c_ = _table(s_, D), _table(c_, D)
        elif pids is None:
            pos = torch.arange(S, dtype=torch.float32, device=dev)
            freqs = pos[:, None] * _inv_freq(D, rotary_theta, dev)[None, :]
            s_, c_ = torch.sin(freqs), torch.cos(freqs)
        if pids is not None:
            if has_table:                       # rows of the table [B,S,D/2]
                sb, cb = s_[pids], c_[pids]
            else:                                # angles of any position
                ang = pids.float()[..., None] \
                    * _inv_freq(D, rotary_theta, dev)
                sb, cb = torch.sin(ang), torch.cos(ang)
            sb, cb = sb[:, :, None, :], cb[:, :, None, :]
        else:
            sb, cb = s_[None, :S, None, :], c_[None, :S, None, :]
        outs = [as_port(_rotate(t, sb, cb, use_neox_rotary_style))
                for t in ts]
        return tuple(outs) if len(outs) > 1 else outs[0]

    res = apply(f, *have, *extra, op_name="fused_rotary_position_embedding")
    it = iter([res] if len(have) == 1 else res)
    return tuple(next(it) if t is not None else None for t in (q, k, v))
