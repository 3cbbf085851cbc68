"""Ragged KV-cache decode attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/decode_attention.py``. One new query
token per sequence attends over a static-length cache ``[B, S_max, Hkv, D]``
of which only the first ``lengths[b]`` rows are valid; grouped-query
attention serves ``H / Hkv`` query heads per kv head. The kernel
(``paddle_tpu_torch/csrc/decode_attention.cu``) reads only the live rows;
``ragged_decode_attention_ref`` is the same function written plainly over
the full ``S_max`` (the math of ``_ragged_ref``).

The kernel takes any GQA group (up to 8 query heads per CTA, several CTAs
per kv head above that, in one launch) and any head width up to ``MAX_D``
(512): rows that are not a multiple of 16 bytes, or wider than 256, are
read with element loads instead of TMA, so the caches are never padded.

``ragged_decode_attention`` takes the plain version for tensors on the CPU
and launches the kernel for tensors on the card, or raises: there is no
fallback from the card to the plain version. ``ragged_decode_attention.
launches`` counts kernel launches. The wrapper calls the ``torch.library``
operator ``paddle_tpu_torch::ragged_decode_attention`` (cpu, cuda and
fake bodies), so a recorded Program or an exported graph names it.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ragged_decode_attention", "ragged_decode_attention_ref"]

_NEG_INF = -1e30
MAX_D = 512               # the widest head the CUDA kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _shapes(q, k_cache, v_cache, lengths):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, H, D], got {tuple(q.shape)}")
    B, _, H, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"k/v caches must both be [B, S_max, Hkv, D], got "
                         f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    Bk, S, Hkv, Dk = k_cache.shape
    if Bk != B or Dk != D or Hkv < 1 or H % Hkv:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)} (need same B and D, H % Hkv == 0)")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [B]={B}, got {tuple(lengths.shape)}")
    return B, S, H, Hkv, D


def ragged_decode_attention_ref(q, k_cache, v_cache, lengths,
                                scale: Optional[float] = None):
    """Plain version: fp32 einsum over the full S_max, positions
    ``j >= lengths[b]`` masked to -1e30, softmax, zeros for rows with
    ``lengths[b] == 0``; the result in q's dtype (``_ragged_ref``,
    decode_attention.py:101-115)."""
    B, S, H, Hkv, D = _shapes(q, k_cache, v_cache, lengths)
    s = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, H // Hkv, D).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * s
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    out = torch.where((lengths > 0)[:, None, None, None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return out.reshape(B, 1, H, D).to(q.dtype)


def _check_cuda(q, k_cache, v_cache, lengths, B, H, Hkv, D):
    dev = q.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32/float16/bfloat16, got {q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"caches must have q's dtype {q.dtype}, got "
                        f"{k_cache.dtype}/{v_cache.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if D > MAX_D:
        raise ValueError(f"kernel takes D <= {MAX_D}, got D={D}")


def _decode_cuda(q, k_cache, v_cache, lengths, scale):
    """The kernel on CUDA tensors, or raise."""
    B, S, H, Hkv, D = _shapes(q, k_cache, v_cache, lengths)
    _check_cuda(q, k_cache, v_cache, lengths, B, H, Hkv, D)
    s = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    from ._build import library
    lib = library()
    out = torch.empty_like(q)
    if B == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_ragged_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, S, H, Hkv, D, s,
            _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ragged_decode_attention kernel launch failed: "
                           f"cudaError {err}")
    ragged_decode_attention.launches += 1
    return out


@torch.library.custom_op("paddle_tpu_torch::ragged_decode_attention",
                         mutates_args=(), device_types=("cpu", "cuda"))
def _decode_op(q: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, lengths: torch.Tensor,
               scale: Optional[float]) -> torch.Tensor:
    """The kernel as an operator of its own (a recorded Program and an
    exported graph name it): the plain version on the CPU, the launch on
    the card."""
    if q.device.type == "cpu":
        return ragged_decode_attention_ref(q, k_cache, v_cache, lengths,
                                           scale)
    return _decode_cuda(q, k_cache, v_cache, lengths, scale)


@_decode_op.register_fake
def _(q, k_cache, v_cache, lengths, scale):
    _shapes(q, k_cache, v_cache, lengths)
    return q.new_empty(q.shape)


def ragged_decode_attention(q, k_cache, v_cache, lengths,
                            scale: Optional[float] = None):
    """q ``[B, 1, H, D]``; caches ``[B, S_max, Hkv, D]``; lengths ``[B]``
    int32 (positions ``j < lengths[b]`` are attended). Returns
    ``[B, 1, H, D]`` in q's dtype, through the
    ``paddle_tpu_torch::ragged_decode_attention`` operator.

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream, or raise on an input it cannot take or on a launch
    error. Meta and fake tensors get the shape."""
    _shapes(q, k_cache, v_cache, lengths)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no decode-attention kernel for device {q.device}")
    return torch.ops.paddle_tpu_torch.ragged_decode_attention(
        q, k_cache, v_cache, lengths, None if scale is None else float(scale))


ragged_decode_attention.launches = 0
