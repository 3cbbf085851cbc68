"""The functionals the LLaMA serving and training paths and DeepFM run.

Counterparts of ``paddle_tpu/nn/functional/{norm,activation,common,
attention,loss}.py``: ``rms_norm``, ``silu``, ``gelu``, ``relu``,
``sigmoid``, ``linear`` (weights in Paddle's ``[in, out]`` layout,
``y = x @ W``), ``embedding``;
``scaled_dot_product_attention`` (flash attention without a mask, the
plain ``sdpa_ref`` with one), ``sdp_attention_ref`` and the Paddle
``flash_attention`` shim; ``cross_entropy`` (hard and soft labels,
class weights, label smoothing, any class axis) and
``binary_cross_entropy_with_logits``. Each runs through
``ops.dispatch.apply`` under the JAX package's op name (``rms_norm``,
``silu``, ``linear``, ``sdpa``, ``cross_entropy``, ...), so
``amp.auto_cast`` casts its inputs as the JAX package's does; with amp
and the dispatch hooks off that is one direct call.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import dtype as dtypes
from ..ops.dispatch import apply
from ..ops.math import matmul as _matmul
from ..ops.kernels.flash_attention import flash_attention as _flash

__all__ = ["rms_norm", "silu", "gelu", "relu", "sigmoid", "linear",
           "embedding", "softmax", "sdpa_ref", "sdp_attention_ref",
           "scaled_dot_product_attention",
           "flash_attention", "cross_entropy",
           "binary_cross_entropy_with_logits"]

_FLASH_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6, axis=-1) -> torch.Tensor:
    """fp32 mean square over ``axis`` (an int or a tuple), ``x * rsqrt(ms
    + eps)`` cast back to the input dtype, *then* times the weight
    (norm.py:108-119)."""
    if weight is not None:
        return apply(_rms_norm, x, weight, epsilon, axis, op_name="rms_norm")
    return apply(_rms_norm, x, None, epsilon, axis, op_name="rms_norm")


def _rms_norm(x, weight, epsilon, axis):
    xf = x.float()
    ms = xf.square().mean(dim=axis, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def silu(x: torch.Tensor, name=None) -> torch.Tensor:
    return apply(torch.nn.functional.silu, x, op_name="silu")


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU: exact (erf) by default, the tanh form with ``approximate``
    (activation.py:67)."""
    return apply(torch.nn.functional.gelu, x, op_name="gelu",
                 approximate="tanh" if approximate else "none")


def relu(x: torch.Tensor, name=None) -> torch.Tensor:
    return apply(torch.relu, x, op_name="relu")


def sigmoid(x: torch.Tensor, name=None) -> torch.Tensor:
    return apply(torch.sigmoid, x, op_name="sigmoid")


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, name=None) -> torch.Tensor:
    """``x @ W (+ b)`` with W ``[in, out]`` (common.py:25-30)."""
    if bias is None:
        return apply(_linear, x, weight, op_name="linear")
    return apply(_linear, x, weight, bias, op_name="linear")


def _linear(x, weight, bias=None):
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x: torch.Tensor, weight: torch.Tensor, padding_idx=None,
              sparse: bool = False, name=None) -> torch.Tensor:
    """Rows of ``weight`` at the ids ``x``; rows at ``padding_idx`` are
    zeros (common.py:33-40). ``sparse`` asks Paddle for a sparse grad;
    the JAX function and this one take the dense one."""
    return apply(_embedding, x, weight, padding_idx, op_name="embedding")


def _embedding(x, weight, padding_idx):
    out = weight[x]
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


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


def softmax(x: torch.Tensor, axis: int = -1, dtype=None, name=None):
    """Softmax over ``axis`` (activation.py:123), in ``dtype`` if given."""
    def f(v):
        return torch.softmax(v if dtype is None else v.to(
            dtypes.convert_dtype(dtype)), dim=axis)
    return apply(f, x, op_name="softmax")


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
    if attn_mask is None:
        return apply(_sdpa, query, key, value, None, is_causal, scale,
                     op_name="sdpa")
    return apply(_sdpa, query, key, value, attn_mask, is_causal, scale,
                 op_name="sdpa")


def _sdpa(query, key, value, attn_mask, is_causal, scale):
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
    """Cross entropy over the class axis ``axis`` (loss.py:27-67):
    ``log_softmax`` in the logits' dtype, or ``log(max(input, 1e-30))``
    with ``use_softmax=False``.

    - Hard labels (integer ids, with or without a size-1 class axis): rows
      whose label is ``ignore_index`` contribute 0; ``label_smoothing``
      mixes in the mean of -log p over the classes; ``weight`` (one per
      class) multiplies each row's loss, and ``mean`` then divides by
      ``max(sum of the valid rows' weights, 1e-12)``, else by ``max(valid
      count, 1)``.
    - ``soft_label=True``: ``-sum(label * log p)`` over the class axis, no
      row ignored and no weight; ``mean`` over the rows.

    ``sum`` and ``none`` as named."""
    return apply(_cross_entropy, input, label, weight, ignore_index,
                 reduction, soft_label, axis, use_softmax, label_smoothing,
                 op_name="cross_entropy")


def _cross_entropy(input, label, weight, ignore_index, reduction,
                   soft_label, axis, use_softmax, label_smoothing):
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    ax = axis % input.dim()
    if use_softmax:
        logp = torch.log_softmax(input, dim=ax)
    else:
        logp = torch.log(torch.clamp_min(input, 1e-30))
    if soft_label:
        loss = -torch.sum(label * logp, dim=ax)
        valid = torch.ones(loss.shape, dtype=torch.bool, device=loss.device)
    else:
        ids = label
        if ids.dim() == logp.dim() and ids.shape[ax] == 1:
            ids = ids.squeeze(ax)
        ids = ids.to(torch.int64)
        valid = ids != ignore_index
        safe = torch.where(valid, ids, torch.zeros_like(ids))
        loss = -torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
        if label_smoothing > 0.0:
            smooth = -torch.mean(logp, dim=ax)
            loss = (1 - label_smoothing) * loss + label_smoothing * smooth
        if weight is not None:
            loss = loss * weight[safe]
        loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if weight is not None and not soft_label:
            ww = torch.where(valid, weight[safe], torch.zeros_like(loss))
            return loss.sum() / ww.sum().clamp_min(1e-12)
        return loss.sum() / valid.sum().to(loss.dtype).clamp_min(1.0)
    if reduction == "sum":
        return loss.sum()
    return loss


def _reduce(v: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return torch.mean(v)
    if reduction == "sum":
        return torch.sum(v)
    return v


def binary_cross_entropy_with_logits(logit: torch.Tensor,
                                     label: torch.Tensor, weight=None,
                                     reduction: str = "mean",
                                     pos_weight=None) -> torch.Tensor:
    """The numerically stable form of loss.py:96-122, in its op order:
    ``(1 - y) z + m + log(exp(-m) + exp(-z - m))`` with ``m = max(-z,
    0)``; ``pos_weight`` scales the log term by ``(pw - 1) y + 1``;
    ``weight`` multiplies each element's loss before the reduction."""
    return apply(_bce_with_logits, logit, label, weight, reduction,
                 pos_weight, op_name="bce_with_logits")


def _bce_with_logits(logit, label, weight, reduction, pos_weight):
    z, y = logit, label
    max_val = torch.clamp_min(-z, 0.0)
    soft = torch.log(torch.exp(-max_val) + torch.exp(-z - max_val))
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * y + 1.0
        loss = (1 - y) * z + log_w * (soft + max_val)
    else:
        loss = (1 - y) * z + max_val + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)
