"""masked_multihead_attention: one decode token's attention over a KV
cache. Counterpart of
``paddle_tpu/incubate/nn/functional/masked_multihead_attention.py``.

One op of the library: the token's fused qkv (plus its bias) split into
heads, rotary embeddings at each example's position (a ``[2, S_max,
D/2]`` sin/cos table), the new k and v written into the cache at the
examples' ``sequence_lengths``, and attention over the cache rows up to
that position (inclusive) plus an additive ``src_mask``, softmax in fp32.
The JAX function is plain math over the whole ``S_max`` cache, not a
Pallas kernel, and this is its plain counterpart (K1, the port's decode
kernel, reads another cache layout and takes no additive mask). The new
cache is returned; the one passed in is not written.
"""
from __future__ import annotations

import torch

from ....core.tensor import as_port, plain_views
from ....ops.dispatch import apply

__all__ = ["masked_multihead_attention"]


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               cum_offsets=None, sequence_lengths=None,
                               rotary_tensor=None, beam_cache_offset=None,
                               seq_len=1, rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype="default", out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """x ``[B, 3 H D]`` (one token's fused qkv), cache_kv ``[2, B, H,
    S_max, D]``, sequence_lengths ``[B]`` (each example's write position;
    0 when None). Returns ``(out [B, H D], new_cache_kv)``."""
    if cache_kv is None:
        raise ValueError("masked_multihead_attention requires cache_kv")
    present = [t is not None for t in (bias, src_mask, sequence_lengths,
                                       rotary_tensor)]

    def f(*ts):
        xv, ck, *rest = plain_views(ts)
        it = iter(rest)
        b_, m_, sl, rt = (next(it) if here else None for here in present)
        B = xv.shape[0]
        H, S_max, D = ck.shape[2], ck.shape[3], ck.shape[4]
        qkv = xv.reshape(B, 3, H, D)
        if b_ is not None:
            qkv = qkv + b_.reshape(1, 3, H, D)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]            # [B, H, D]
        pos = sl.to(torch.int64) if sl is not None else \
            torch.zeros(B, dtype=torch.int64, device=xv.device)
        if rt is not None and rotary_emb_dims > 0:
            sin_p = rt[0][pos][:, None]                       # [B, 1, D/2]
            cos_p = rt[1][pos][:, None]

            def rot(t):
                tf = t.float()
                if use_neox_rotary_style:
                    x1, x2 = tf[..., :D // 2], tf[..., D // 2:]
                    out = torch.cat([x1 * cos_p - x2 * sin_p,
                                     x2 * cos_p + x1 * sin_p], dim=-1)
                else:
                    x1, x2 = tf[..., 0::2], tf[..., 1::2]
                    out = torch.stack([x1 * cos_p - x2 * sin_p,
                                       x2 * cos_p + x1 * sin_p],
                                      dim=-1).reshape(t.shape)
                return out.to(t.dtype)
            q, k = rot(q), rot(k)
        idx = pos.reshape(B, 1, 1, 1).expand(B, H, 1, D)
        kc = ck[0].scatter(2, idx, k[:, :, None].to(ck.dtype))
        vc = ck[1].scatter(2, idx, v[:, :, None].to(ck.dtype))
        scale = 1.0 / (D ** 0.5)
        dt = torch.promote_types(q.dtype, kc.dtype)
        logits = torch.einsum("bhd,bhsd->bhs", (q * scale).to(dt),
                              kc.to(dt))
        allowed = torch.arange(S_max, device=xv.device)[None, None, :] \
            <= pos[:, None, None]
        logits = torch.where(allowed, logits, -1e30)
        if m_ is not None:
            logits = logits + m_.reshape(B, 1, -1)[..., :S_max]
        probs = torch.softmax(logits.float(), dim=-1).to(xv.dtype)
        pdt = torch.promote_types(probs.dtype, vc.dtype)
        out = torch.einsum("bhs,bhsd->bhd", probs.to(pdt), vc.to(pdt))
        return as_port(out.reshape(B, H * D)), \
            as_port(torch.stack([kc, vc]))

    extra = [t for t in (bias, src_mask, sequence_lengths, rotary_tensor)
             if t is not None]
    out, new_cache = apply(f, x, cache_kv, *extra,
                           op_name="masked_multihead_attention")
    return out, new_cache
