"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain PyTorch versions and the ``torch.autograd.Function`` that joins them.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``
(``flash_attention``, :219-346). q is ``[B, Sq, H, D]``, k and v are
``[B, Sk, Hkv, D]``; grouped-query attention maps q head ``h`` to kv head
``h // (H / Hkv)``. The causal mask is top-left aligned (``qid >= kid``),
as the Pallas kernel's (:68); it equals ``sdpa_ref``'s bottom-right mask
only when ``Sq == Sk``.

Three kernels in ``paddle_tpu_torch/csrc/flash_attention.cu``:

- ``flash_attention_fwd`` (K2) -> ``(O, LSE)``, LSE ``[B, H, Sq]`` fp32;
- ``flash_attention_bwd_dq`` (K3) -> ``dQ``;
- ``flash_attention_bwd_dkv`` (K4) -> ``(dK, dV)``, the GQA group's grads
  summed in fp32 and rounded once (the JAX backward repeats K/V and sums
  the group's already-rounded grads, :269-274, :340-342; in fp32 the two
  agree to rounding).

``delta = rowsum(dO * O)`` is computed here, in fp32, as a PyTorch op
(``_flash_bwd_core``, :280), and handed to K3 and K4.

Each wrapper takes its plain version (``*_ref``: the same math over the
full ``[Sq, Sk]`` matrices) for tensors on the CPU, and launches its kernel
for tensors on the card, or raises: there is no fallback from the card to
the plain version. ``<wrapper>.launches`` counts kernel launches.
``flash_attention`` is the differentiable entry point: its forward and
backward both go through the wrappers, never through autograd of the
plain forward.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_fwd_ref",
           "flash_attention_bwd_dq_ref", "flash_attention_bwd_dkv_ref"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, Sq, H, D] and k, v both "
                         f"[B, Sk, Hkv, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hkv < 1 or H % Hkv:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} (need same B and D, H % Hkv == 0)")
    return B, Sq, Sk, H, Hkv, D


def _scale(scale, D) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(D)


# ---------------------------------------------------------------------------
# plain versions: full [B, H, Sq, Sk] matrices in fp32
# ---------------------------------------------------------------------------

def _heads(x, group):
    """[B, S, Hx, D] -> fp32 [B, Hx * group, S, D] (kv heads repeated)."""
    x = x.float().transpose(1, 2)
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def _scores(q, k, causal, s):
    """Masked fp32 logits [B, H, Sq, Sk]: -1e30 where ``qid < kid``."""
    group = q.shape[2] // k.shape[2]
    logits = torch.matmul(_heads(q, 1), _heads(k, group).transpose(-1, -2))
    logits = logits * s
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        keep = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        logits = logits.masked_fill(~keep, _NEG_INF)
    return logits


def flash_attention_fwd_ref(q, k, v, causal: bool = False,
                            scale: Optional[float] = None):
    """Plain forward: ``P = exp(S - max)``, ``l = max(sum P, 1e-30)``,
    ``O = (P cast to v's dtype) @ V / l`` in q's dtype, ``LSE = max +
    log l`` ``[B, H, Sq]`` fp32 (``_fwd_kernel``, :47-85)."""
    B, Sq, Sk, H, Hkv, D = _shapes(q, k, v)
    logits = _scores(q, k, causal, _scale(scale, D))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), _heads(v, H // Hkv)) / l
    return o.transpose(1, 2).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs_and_ds(q, k, v, do, lse, delta, causal, s):
    group = q.shape[2] // k.shape[2]
    p = torch.exp(_scores(q, k, causal, s) - lse[..., None])
    dp = torch.matmul(_heads(do, 1), _heads(v, group).transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal: bool = False,
                               scale: Optional[float] = None):
    """Plain dQ: ``scale * (dS cast to q's dtype) @ K`` with ``P = exp(S -
    LSE)``, ``dS = P * (dO V^T - delta)`` (``_bwd_dq_kernel``, :129-163)."""
    B, Sq, Sk, H, Hkv, D = _shapes(q, k, v)
    s = _scale(scale, D)
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, s)
    dq = s * torch.matmul(ds.to(q.dtype).float(), _heads(k, H // Hkv))
    return dq.transpose(1, 2).to(q.dtype)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal: bool = False,
                                scale: Optional[float] = None):
    """Plain dK, dV: ``dV = (P cast to dO's dtype)^T @ dO``, ``dK = scale *
    (dS cast to q's dtype)^T @ Q``, each summed over the GQA group in fp32
    and rounded once to k's / v's dtype (``_bwd_dkv_kernel``, :166-202)."""
    B, Sq, Sk, H, Hkv, D = _shapes(q, k, v)
    s = _scale(scale, D)
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, s)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), _heads(do, 1))
    dk = s * torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                          _heads(q, 1))

    def fold(x, dtype):     # [B, H, Sk, D] -> [B, Sk, Hkv, D]
        x = x.reshape(B, Hkv, H // Hkv, Sk, D).sum(dim=2)
        return x.transpose(1, 2).to(dtype)
    return fold(dk, k.dtype), fold(dv, v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(tensors, fp32=()):
    """Raise on what the kernels cannot take: mixed devices, a dtype other
    than float32/float16/bfloat16 (or not shared by q, k, v, dO), fp32
    side inputs (lse, delta) of another dtype, non-contiguous or
    unaligned storage, D % 8 != 0 or D > 256."""
    named = list(tensors) + list(fp32)
    dev = named[0][1].device
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    dtype = tensors[0][1].dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32/float16/bfloat16, got {dtype}")
    for name, t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {dtype}")
    for name, t in fp32:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    D = tensors[0][1].shape[-1]
    if D % 8 or D > 256:
        raise ValueError(f"kernel takes D % 8 == 0 and D <= 256, got D={D}")


def _launch(fn_name, q, *ptrs_and_shape):
    from ._build import library
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn_name)(*ptrs_and_shape, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError {err}")


def _device_gate(q, what):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {q.device}")
    return q.device.type == "cpu"


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O ``[B, Sq, H, D]`` in q's dtype, LSE ``[B, H, Sq]`` fp32). CPU
    tensors take the plain version; CUDA tensors launch K2 or raise."""
    B, Sq, Sk, H, Hkv, D = _shapes(q, k, v)
    if _device_gate(q, "flash-attention"):
        return flash_attention_fwd_ref(q, k, v, causal, scale)
    _check_cuda([("q", q), ("k", k), ("v", v)])
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, device=q.device, dtype=torch.float32)
    if q.numel() == 0 or Sk == 0:
        return o.zero_(), lse.fill_(_NEG_INF)
    _launch("pt_flash_attention_fwd", q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, Hkv, D,
            _scale(scale, D), int(bool(causal)), _DTYPE_CODE[q.dtype])
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                           scale: Optional[float] = None) -> torch.Tensor:
    """dQ in q's dtype. CPU tensors take the plain version; CUDA tensors
    launch K3 or raise."""
    B, Sq, Sk, H, Hkv, D = _shapes(q, k, v)
    if _device_gate(q, "flash-attention dQ"):
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal,
                                          scale)
    _check_cuda([("q", q), ("k", k), ("v", v), ("do", do)],
                [("lse", lse), ("delta", delta)])
    dq = torch.empty_like(q)
    if q.numel() == 0 or Sk == 0:
        return dq.zero_()
    _launch("pt_flash_attention_bwd_dq", q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), B, Sq, Sk, H, Hkv, D, _scale(scale, D),
            int(bool(causal)), _DTYPE_CODE[q.dtype])
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) in k's dtype, ``[B, Sk, Hkv, D]``. CPU tensors take the
    plain version; CUDA tensors launch K4 or raise."""
    B, Sq, Sk, H, Hkv, D = _shapes(q, k, v)
    if _device_gate(q, "flash-attention dK/dV"):
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal,
                                           scale)
    _check_cuda([("q", q), ("k", k), ("v", v), ("do", do)],
                [("lse", lse), ("delta", delta)])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.numel() == 0 or Sq == 0:
        return dk.zero_(), dv.zero_()
    _launch("pt_flash_attention_bwd_dkv", q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, Hkv, D,
            _scale(scale, D), int(bool(causal)), _DTYPE_CODE[q.dtype])
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """``jax.custom_vjp`` of flash_attention.py:219-346: K2 forward, saving
    (q, k, v, O, LSE); K3 + K4 backward with ``delta`` in fp32."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
        delta = delta.contiguous()                      # [B, H, Sq]
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.causal,
                                    ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention on ``[B, S, H, D]``: forward through
    K2, backward through K3 and K4 (their plain versions on the CPU)."""
    return _FlashAttention.apply(q, k, v, bool(causal), scale)
