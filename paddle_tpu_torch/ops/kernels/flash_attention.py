"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain PyTorch versions and the operator that joins them.

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

The kernels take head widths that are multiples of 8 up to ``MAX_D``
(512); the wrappers zero-pad any other D up to the next multiple of 8
(``_pad_d``) and slice the outputs back, with the scale taken from the
real D, as the Pallas kernels pad D to a multiple of 128 (``_prep``).
Above ``MAX_D`` they raise.

Each wrapper takes its plain version (``*_ref``: the same math over the
full ``[Sq, Sk]`` matrices) for tensors on the CPU, and launches its kernel
for tensors on the card, or raises: there is no fallback from the card to
the plain version. ``<wrapper>.launches`` counts kernel launches.
``flash_attention`` and ``flash_attention_lse`` (:350, which also returns
the LSE, for ring attention) are the differentiable entry points: their
forward and backward both go through the wrappers, never through autograd
of the plain forward.

The forward is the ``torch.library`` operator
``paddle_tpu_torch::flash_attention_fwd`` (a ``cuda`` body that launches
K2 and counts it, a ``cpu`` body that is the plain version, a fake body
that gives the shapes), with K3 and K4 as its registered backward; both
differentiable entry points call it. So a
static ``Program`` infers its shapes on meta tensors, ``torch.export``
names the operator instead of tracing into a ``ctypes`` launch, and an
exported graph saved on the CPU launches K2 once loaded on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["flash_attention", "flash_attention_lse", "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_fwd_ref",
           "flash_attention_bwd_dq_ref", "flash_attention_bwd_dkv_ref"]

_NEG_INF = -1e30
MAX_D = 512               # the widest head the CUDA kernels take
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


def _pad_d(*xs):
    """Zero-pad the last axis of each tensor to the next multiple of 8 (the
    kernels' 16-byte rows); zero columns add nothing to q k^T and give zero
    output columns, which the caller slices away."""
    D = xs[0].shape[-1]
    pad = -D % 8
    if not pad:
        return xs
    return tuple(torch.nn.functional.pad(x, (0, pad)) for x in xs)


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
    unaligned storage, D > MAX_D."""
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
    if D > MAX_D:
        raise ValueError(f"kernel takes D <= {MAX_D}, got D={D}")


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


def _fwd_cuda(q, k, v, causal, scale):
    """K2 on CUDA tensors, or raise."""
    B, Sq, Sk, H, Hkv, D = _shapes(q, k, v)
    _check_cuda([("q", q), ("k", k), ("v", v)])
    lse = torch.empty(B, H, Sq, device=q.device, dtype=torch.float32)
    if q.numel() == 0 or Sk == 0:
        return torch.zeros_like(q), lse.fill_(_NEG_INF)
    qp, kp, vp = _pad_d(q, k, v)
    o = torch.empty_like(qp)
    _launch("pt_flash_attention_fwd", q, qp.data_ptr(), kp.data_ptr(),
            vp.data_ptr(), o.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, Hkv,
            qp.shape[-1], _scale(scale, D), int(bool(causal)),
            _DTYPE_CODE[q.dtype])
    flash_attention_fwd.launches += 1
    return o[..., :D].contiguous(), lse


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types=("cpu", "cuda"))
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 as an operator of its own: a recorded Program, a CUDA graph and
    an exported graph name it, and never inline its plain body. CPU
    tensors take the plain version; CUDA tensors launch K2 or raise."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal, scale)
    return _fwd_cuda(q, k, v, causal, scale)


@_fwd_op.register_fake
def _(q, k, v, causal, scale):
    B, Sq, Sk, H, Hkv, D = _shapes(q, k, v)
    return (q.new_empty(q.shape),
            q.new_empty((B, H, Sq), dtype=torch.float32))


def _fwd_setup(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.scale = causal, scale


def _fwd_backward(ctx, do, g_lse):
    return _flash_bwd(ctx, do, g_lse) + (None, None)


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O ``[B, Sq, H, D]`` in q's dtype, LSE ``[B, H, Sq]`` fp32) through
    the ``paddle_tpu_torch::flash_attention_fwd`` operator. CPU tensors
    take the plain version; CUDA tensors launch K2 or raise; meta and
    fake tensors get the shapes. Differentiable in both outputs: K3 and K4
    are the operator's registered backward."""
    _shapes(q, k, v)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    return torch.ops.paddle_tpu_torch.flash_attention_fwd(
        q, k, v, bool(causal), None if scale is None else float(scale))


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
    if q.numel() == 0 or Sk == 0:
        return torch.zeros_like(q)
    qp, kp, vp, dop = _pad_d(q, k, v, do)
    dq = torch.empty_like(qp)
    _launch("pt_flash_attention_bwd_dq", q, qp.data_ptr(), kp.data_ptr(),
            vp.data_ptr(), dop.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), B, Sq, Sk, H, Hkv, qp.shape[-1], _scale(scale, D),
            int(bool(causal)), _DTYPE_CODE[q.dtype])
    flash_attention_bwd_dq.launches += 1
    return dq[..., :D].contiguous()


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
    if k.numel() == 0 or Sq == 0:
        return torch.zeros_like(k), torch.zeros_like(v)
    qp, kp, vp, dop = _pad_d(q, k, v, do)
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    _launch("pt_flash_attention_bwd_dkv", q, qp.data_ptr(), kp.data_ptr(),
            vp.data_ptr(), dop.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, Hkv, qp.shape[-1],
            _scale(scale, D), int(bool(causal)), _DTYPE_CODE[q.dtype])
    flash_attention_bwd_dkv.launches += 1
    return dk[..., :D].contiguous(), dv[..., :D].contiguous()


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def _flash_bwd(ctx, do, g_lse):
    """K3 + K4 for the saved (q, k, v, O, LSE) with ``delta = rowsum(dO *
    O)`` in fp32; an LSE cotangent folds in as ``delta - g_lse``
    (``_flash_bwd_core``, :263-286: d lse / d s = p, so it joins
    ``dS = P * (dP - delta)``)."""
    q, k, v, o, lse = ctx.saved_tensors
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
    if g_lse is not None:       # (zeros where the LSE went unused)
        delta = delta - g_lse.float()
    delta = delta.contiguous()                          # [B, H, Sq]
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.causal,
                                ctx.scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                                     ctx.scale)
    return dq, dk, dv


_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention on ``[B, S, H, D]``: forward through
    K2, backward through K3 and K4 (their plain versions on the CPU)."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]


def flash_attention_lse(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention`` that also returns the per-row logsumexp
    ``[B, H, Sq]`` (fp32): the state that merges partial attentions over
    key blocks (ring attention). Differentiable in both outputs: K2
    forward, K3 and K4 backward with the LSE's cotangent folded into
    ``delta`` (their plain versions on the CPU)."""
    return flash_attention_fwd(q, k, v, causal, scale)
