"""The functionals the LLaMA serving and training paths run.

Counterparts of ``paddle_tpu/nn/functional/{norm,activation,common,
attention,loss}.py``: ``rms_norm``, ``silu``, ``linear`` (weights in
Paddle's ``[in, out]`` layout, ``y = x @ W``), ``embedding``;
``scaled_dot_product_attention`` (flash attention without a mask, the
plain ``sdpa_ref`` with one), ``sdp_attention_ref`` and the Paddle
``flash_attention`` shim; and ``cross_entropy`` with hard labels.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.errors import NotInThisSlice
from ..ops.kernels.flash_attention import flash_attention as _flash

__all__ = ["rms_norm", "silu", "linear", "embedding", "sdpa_ref",
           "sdp_attention_ref", "scaled_dot_product_attention",
           "flash_attention", "cross_entropy"]

_FLASH_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """fp32 mean square over the last axis, ``x * rsqrt(ms + eps)`` cast
    back to the input dtype, *then* times the weight (norm.py:108-119)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def silu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x)


def linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ W`` with W ``[in, out]`` (LLaMA's projections have no bias)."""
    return torch.matmul(x, weight)


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return weight[ids]


def sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: Optional[torch.Tensor] = None, causal: bool = False,
             scale: Optional[float] = None) -> torch.Tensor:
    """Attention on ``[B, S, H, D]`` step for step as ``_sdpa_ref``
    (attention.py:22-44): logits ``q·kᵀ·scale`` in the input dtype, the
    causal fill with the dtype's min, the additive mask cast to the logits'
    dtype, softmax in >= fp32 with the probabilities cast back to q's
    dtype, then ``@ v``. GQA repeats the kv heads."""
    qT = q.transpose(1, 2)     # [B, H, S, D]
    kT = k.transpose(1, 2)
    vT = v.transpose(1, 2)
    s = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if kT.shape[1] != qT.shape[1]:
        rep = qT.shape[1] // kT.shape[1]
        kT = kT.repeat_interleave(rep, dim=1)
        vT = vT.repeat_interleave(rep, dim=1)
    logits = torch.matmul(qT, kT.transpose(-1, -2)) * s
    if causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        cmask = torch.ones(qlen, klen, dtype=torch.bool,
                           device=logits.device).tril(diagonal=klen - qlen)
        logits = logits.masked_fill(~cmask, torch.finfo(logits.dtype).min)
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    acc = torch.promote_types(logits.dtype, torch.float32)
    probs = torch.softmax(logits.to(acc), dim=-1).to(q.dtype)
    out = torch.matmul(probs, vT)
    return out.transpose(1, 2)


def sdp_attention_ref(query, key, value, mask=None, dropout_p: float = 0.0,
                      causal: bool = False, scale: Optional[float] = None):
    """The plain attention (attention.py:47-48); ``dropout_p`` is ignored
    there too."""
    return sdpa_ref(query, key, value, mask=mask, causal=causal, scale=scale)


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
    if attn_mask is None and query.dtype in _FLASH_DTYPES:
        # the kernels read contiguous [B, S, H, D]; any strided view is
        # copied here, as the reference's _prep transposes and pads
        return _flash(query.contiguous(), key.contiguous(),
                      value.contiguous(), is_causal, scale)
    return sdpa_ref(query, key, value, mask=attn_mask, causal=is_causal,
                    scale=scale)


def cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  use_softmax: bool = True, name=None,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Hard-label cross entropy over the last axis (loss.py:27-67):
    ``log_softmax`` in the logits' dtype, rows whose label is
    ``ignore_index`` contribute 0, and ``mean`` divides by
    ``max(valid count, 1)``; ``sum`` and ``none`` as named. Weights, soft
    labels, label smoothing, another axis and ``use_softmax=False`` are not
    in this slice and raise."""
    for off, knob in ((weight is not None, "weight="),
                      (soft_label, "soft_label=True"),
                      (axis not in (-1, input.dim() - 1), f"axis={axis}"),
                      (not use_softmax, "use_softmax=False"),
                      (label_smoothing != 0.0, "label_smoothing")):
        if off:
            raise NotInThisSlice("cross_entropy option", knob)
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    logp = torch.log_softmax(input, dim=-1)
    ids = label
    if ids.dim() == logp.dim() and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    ids = ids.to(torch.int64)
    valid = ids != ignore_index
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    loss = -torch.gather(logp, -1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / valid.sum().to(loss.dtype).clamp_min(1.0)
    if reduction == "sum":
        return loss.sum()
    return loss
