"""Attention: counterpart of ``paddle_tpu/nn/functional/attention.py``.

``scaled_dot_product_attention`` on ``[B, S, H, D]`` runs flash attention
(K2 forward, K3/K4 backward on the card; their plain versions on the CPU)
when there is no mask, as the JAX package takes its Pallas kernel on the
TPU, and the plain ``sdpa_ref`` with a mask (an additive one, as
``MultiHeadAttention`` passes) or another dtype. ``dropout_p`` is
ignored on both paths, as in the JAX function (``_sdpa_ref`` takes it and
does not use it). ``_sdpa`` looks ``_flash`` and ``sdpa_ref`` up on the
``nn.functional`` package at each call, so a caller can swap either there
(the tests and the card smoke do).
"""
from __future__ import annotations

import sys
from typing import Optional

import torch

from ...ops.dispatch import apply
from ...ops.math import matmul as _matmul
from ...ops.kernels.flash_attention import (  # noqa: F401
    flash_attention as _flash)
from .activation import softmax

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "sdp_attention_ref", "sdpa_ref"]

_FLASH_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _pkg():
    return sys.modules[__package__]


def sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: Optional[torch.Tensor] = None, causal: bool = False,
             scale: Optional[float] = None) -> torch.Tensor:
    """Attention on ``[B, S, H, D]`` step for step as ``_sdpa_ref``
    (attention.py:22-44): logits ``q·kᵀ·scale`` in the input dtype, the
    causal fill with the dtype's min, the additive mask cast to the logits'
    dtype, softmax in >= fp32 with the probabilities cast back to q's
    dtype, then ``@ v``. GQA repeats the kv heads. The two products and
    the softmax run as the op library's ``matmul`` and ``softmax`` (under
    ``auto_cast``: bf16 and float32, as ``sdpa``'s own casts)."""
    qT = q.transpose(1, 2)     # [B, H, S, D]
    kT = k.transpose(1, 2)
    vT = v.transpose(1, 2)
    s = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if kT.shape[1] != qT.shape[1]:
        rep = qT.shape[1] // kT.shape[1]
        kT = kT.repeat_interleave(rep, dim=1)
        vT = vT.repeat_interleave(rep, dim=1)
    logits = _matmul(qT, kT.transpose(-1, -2)) * s
    if causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        cmask = torch.ones(qlen, klen, dtype=torch.bool,
                           device=logits.device).tril(diagonal=klen - qlen)
        logits = logits.masked_fill(~cmask, torch.finfo(logits.dtype).min)
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    acc = torch.promote_types(logits.dtype, torch.float32)
    probs = softmax(logits.to(acc), axis=-1).to(q.dtype)
    out = _matmul(probs, vT)
    return out.transpose(1, 2)


def sdp_attention_ref(q, k, v, mask=None, dropout_p: float = 0.0,
                      causal: bool = False, scale: Optional[float] = None):
    """The plain attention (attention.py:47-48); ``dropout_p`` is ignored
    there too."""
    return sdpa_ref(q, k, v, mask=mask, causal=causal, scale=scale)


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    name=None):
    """Paddle's ``flash_attention(...) -> (out, None)`` (attention.py:75-80)
    over ``scaled_dot_product_attention`` with no mask (which takes any
    strided view of q, k and v)."""
    return scaled_dot_product_attention(query, key, value, None, dropout,
                                        causal), None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None,
                                 scale: Optional[float] = None):
    """Attention on ``[B, S, H, D]`` (attention.py:60-72). With no mask and
    a float32/bfloat16/float16 dtype it runs flash attention (K2 forward,
    K3/K4 backward on the card; their plain versions on the CPU), as the
    JAX package takes its Pallas kernel on the TPU (``_use_pallas``,
    :51-57); with a mask, or another dtype, the plain ``sdpa_ref``. The
    flash causal mask is top-left, ``sdpa_ref``'s bottom-right: they agree
    when Sq == Sk."""
    return apply(_sdpa, query, key, value, attn_mask, is_causal, scale,
                 op_name="sdpa")


def _sdpa(query, key, value, attn_mask, is_causal, scale):
    pkg = _pkg()
    if attn_mask is None and query.dtype in _FLASH_DTYPES:
        # the kernels read contiguous [B, S, H, D]; any strided view is
        # copied here, as the reference's _prep transposes and pads
        return pkg._flash(query.contiguous(), key.contiguous(),
                          value.contiguous(), is_causal, scale)
    return pkg.sdpa_ref(query, key, value, mask=attn_mask, causal=is_causal,
                        scale=scale)
