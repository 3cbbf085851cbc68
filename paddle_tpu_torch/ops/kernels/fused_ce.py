"""Fused linear + softmax cross-entropy: the CUDA kernels' wrappers, their
plain PyTorch versions and the ``torch.autograd.Function`` that joins them.

Counterpart of ``paddle_tpu/ops/pallas/fused_ce.py``. For hidden states h
``[N, H]``, the lm-head weight W ``[H, V]`` (Paddle's ``[in, out]``
layout) and integer labels ``[N]``, the per-row loss is ``logsumexp(h W) -
(h W)[label]``, computed without writing the ``[N, V]`` logits, or in the
backward their cotangent, to device memory.

Three kernels in ``paddle_tpu_torch/csrc/fused_ce.cu``:

- ``fused_ce_fwd`` (K5) -> per-row ``(m, l, z)``: max, sum of
  ``exp(s - m)`` and the fp32 logit at ``label - vocab_offset`` (0 outside
  ``[0, V)``), as ``_fwd_partials`` (:97-124). The vocab is split across
  CTAs (as many as the launcher plans for the card, ``_fwd_splits``)
  and the splits' partials are merged by a second launch.
- ``fused_ce_bwd_dh`` (K6) -> dh in h's dtype: ``dl = (softmax - onehot) g``
  rounded to W's dtype, then ``dl W^T`` summed in fp32 (``_bwd_dh_kernel``,
  :131-153).
- ``fused_ce_bwd_dw`` (K7) -> dW in W's dtype: the same ``dl`` rounded to
  h's dtype, then ``h^T dl`` summed in fp32 (``_bwd_dw_kernel``, :156-179).

K6 and K7 add their products into a zeroed fp32 buffer with fp32
reductions, so their sums are taken in an order that changes from run to
run; the buffer is rounded once to the output dtype here. In bfloat16 and
float16 with H and V multiples of 8 (the training path) all three are
Hopper kernels (wgmma, TMA, a warp-specialised pipeline); float32 and
unaligned widths take the mma.sync kernels. ``set_block_sizes`` (:49) is
a knob of the TPU's VMEM tiling and has no counterpart: the CUDA tiles are
fixed by the card's shared memory.

``fused_linear_cross_entropy_tp`` (:291-340) is the vocab-parallel form:
each rank of the group holds the lm-head shard ``[H, V/mp]``, runs K5 on
it at ``vocab_offset = rank * V/mp``, and the rows' (m, l, z) merge over
the group (all-reduce MAX of m, then SUM of ``l exp(m - M)`` and z); the
backward runs K6 and K7 on the shard and all-reduces dh.

Each wrapper takes its plain version (``*_ref``: the same math over the
full ``[N, V]`` logits in fp32) for tensors on the CPU, and launches its
kernel for tensors on the card, or raises: there is no fallback from the
card to the plain version. ``<wrapper>.launches`` counts kernel launches.
The forward is the ``torch.library`` operator
``paddle_tpu_torch::fused_ce_fwd`` (cpu, cuda and fake bodies), so a
recorded Program or an exported graph names it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .flash_attention import _DTYPE_CODE, _device_gate, _launch

__all__ = ["fused_linear_cross_entropy", "fused_linear_cross_entropy_tp",
           "fused_linear_ce_partials",
           "fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw",
           "fused_ce_fwd_ref", "fused_ce_bwd_dh_ref", "fused_ce_bwd_dw_ref"]


def _shapes(h, w, labels) -> Tuple[int, int, int]:
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(f"h must be [N, H] and w [H, V], got "
                         f"{tuple(h.shape)}, {tuple(w.shape)}")
    if labels.shape != (h.shape[0],):
        raise ValueError(f"labels must be [N] = [{h.shape[0]}], got "
                         f"{tuple(labels.shape)}")
    if labels.is_floating_point() or labels.is_complex() \
            or labels.dtype == torch.bool:
        raise TypeError(f"labels must be integers, got {labels.dtype}")
    return h.shape[0], h.shape[1], w.shape[1]


# ---------------------------------------------------------------------------
# plain versions: the full [N, V] logits in fp32
# ---------------------------------------------------------------------------

def _logits(h, w):
    return torch.matmul(h.float(), w.float())


def _local(labels, vocab_offset, V):
    """(local label, whether it lies in [0, V)) as int64 / bool."""
    lab = labels.long() - int(vocab_offset)
    return lab, (lab >= 0) & (lab < V)


def fused_ce_fwd_ref(h, w, labels, vocab_offset: int = 0):
    """Plain forward: fp32 ``(m, l, z)`` per row of ``s = h W``."""
    N, _, V = _shapes(h, w, labels)
    s = _logits(h, w)
    m = s.amax(dim=1)
    l = torch.exp(s - m[:, None]).sum(dim=1)
    lab, inside = _local(labels, vocab_offset, V)
    at = s.gather(1, lab.clamp(0, V - 1)[:, None])[:, 0]
    return m, l, torch.where(inside, at, torch.zeros_like(at))


def _cotangent(h, w, labels, lse, g, vocab_offset):
    """``(exp(s - lse) - onehot(label)) * g`` in fp32, ``[N, V]`` (no
    data-dependent shapes, so a CUDA graph can capture it)."""
    _, _, V = _shapes(h, w, labels)
    p = torch.exp(_logits(h, w) - lse.float()[:, None])
    lab, inside = _local(labels, vocab_offset, V)
    p.scatter_add_(1, lab.clamp(0, V - 1)[:, None], -inside.float()[:, None])
    return p * g.float()[:, None]


def fused_ce_bwd_dh_ref(h, w, labels, lse, g, vocab_offset: int = 0):
    """Plain dh: ``(dl cast to w's dtype) W^T`` in fp32, cast to h's dtype."""
    dl = _cotangent(h, w, labels, lse, g, vocab_offset).to(w.dtype).float()
    return torch.matmul(dl, w.float().t()).to(h.dtype)


def fused_ce_bwd_dw_ref(h, w, labels, lse, g, vocab_offset: int = 0):
    """Plain dW: ``h^T (dl cast to h's dtype)`` in fp32, cast to w's dtype."""
    dl = _cotangent(h, w, labels, lse, g, vocab_offset).to(h.dtype).float()
    return torch.matmul(h.float().t(), dl).to(w.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(h, w, labels, fp32=()):
    """Raise on what the kernels cannot take; return labels as contiguous
    int32 on the card."""
    for name, t in [("w", w), ("labels", labels)] + list(fp32):
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32/float16/bfloat16, got "
                        f"{h.dtype}")
    if w.dtype != h.dtype:
        raise TypeError(f"w is {w.dtype}, h is {h.dtype}")
    for name, t in fp32:
        if t.dtype != torch.float32 or t.shape != (h.shape[0],):
            raise TypeError(f"{name} must be float32 [N], got {t.dtype} "
                            f"{tuple(t.shape)}")
    for name, t in [("h", h), ("w", w)] + list(fp32):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h.shape[1] == 0 or w.shape[1] == 0:
        raise ValueError(f"kernel takes H > 0 and V > 0, got "
                         f"{tuple(w.shape)}")
    return labels.to(torch.int32).contiguous()


def _fwd_splits(h, w) -> int:
    """K5's vocab splits for these inputs on h's card, as the launcher in
    fused_ce.cu plans them; they size its ``part`` scratch."""
    from ._build import library
    N, H = h.shape
    with torch.cuda.device(h.device):
        splits = library().pt_fused_ce_fwd_splits(
            h.data_ptr(), w.data_ptr(), N, H, w.shape[1],
            _DTYPE_CODE[h.dtype])
    if splits <= 0:
        raise RuntimeError(f"fused_ce_fwd: no split plan for h "
                           f"{tuple(h.shape)}, w {tuple(w.shape)}")
    return splits


def _fwd_cuda(h, w, labels, vocab_offset):
    """K5 on CUDA tensors, or raise."""
    N, H, V = _shapes(h, w, labels)
    lab = _check_cuda(h, w, labels)
    m, l, z = (torch.empty(N, device=h.device, dtype=torch.float32)
               for _ in range(3))
    if N == 0:
        return m, l, z
    splits = _fwd_splits(h, w)
    part = torch.empty(3, splits, N, device=h.device, dtype=torch.float32)
    _launch("pt_fused_ce_fwd", h, h.data_ptr(), w.data_ptr(), lab.data_ptr(),
            int(vocab_offset), part.data_ptr(), m.data_ptr(), l.data_ptr(),
            z.data_ptr(), N, H, V, splits, _DTYPE_CODE[h.dtype])
    fused_ce_fwd.launches += 1
    return m, l, z


@torch.library.custom_op("paddle_tpu_torch::fused_ce_fwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _fwd_op(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
            vocab_offset: int) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K5 as an operator of its own (a recorded Program and an exported
    graph name it): the plain version on the CPU, the launch on the
    card."""
    if h.device.type == "cpu":
        return fused_ce_fwd_ref(h, w, labels, vocab_offset)
    return _fwd_cuda(h, w, labels, vocab_offset)


@_fwd_op.register_fake
def _(h, w, labels, vocab_offset):
    N, _, _ = _shapes(h, w, labels)
    return tuple(h.new_empty((N,), dtype=torch.float32) for _ in range(3))


def fused_ce_fwd(h, w, labels, vocab_offset: int = 0):
    """fp32 ``(m, l, z)``, each ``[N]``, through the
    ``paddle_tpu_torch::fused_ce_fwd`` operator. CPU tensors take the
    plain version; CUDA tensors launch K5 (two launches: the splits, then
    their merge) or raise; meta and fake tensors get the shapes."""
    _shapes(h, w, labels)
    if h.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no fused cross-entropy kernel for device "
                         f"{h.device}")
    return torch.ops.paddle_tpu_torch.fused_ce_fwd(h, w, labels,
                                                   int(vocab_offset))


def _bwd(fn_name, h, w, labels, lse, g, vocab_offset, shape):
    lab = _check_cuda(h, w, labels, [("lse", lse), ("g", g)])
    out = torch.zeros(shape, device=h.device, dtype=torch.float32)
    if h.shape[0]:
        N, H = h.shape
        _launch(fn_name, h, h.data_ptr(), w.data_ptr(), lab.data_ptr(),
                int(vocab_offset), lse.data_ptr(), g.data_ptr(),
                out.data_ptr(), N, H, w.shape[1], _DTYPE_CODE[h.dtype])
    return out


def fused_ce_bwd_dh(h, w, labels, lse, g, vocab_offset: int = 0):
    """dh ``[N, H]`` in h's dtype for per-row loss grads g and the
    forward's lse (both fp32 ``[N]``). CPU tensors take the plain version;
    CUDA tensors launch K6 or raise."""
    _shapes(h, w, labels)
    if _device_gate(h, "fused cross-entropy dh"):
        return fused_ce_bwd_dh_ref(h, w, labels, lse, g, vocab_offset)
    out = _bwd("pt_fused_ce_bwd_dh", h, w, labels, lse, g, vocab_offset,
               tuple(h.shape))
    fused_ce_bwd_dh.launches += int(h.shape[0] > 0)
    return out.to(h.dtype)


def fused_ce_bwd_dw(h, w, labels, lse, g, vocab_offset: int = 0):
    """dW ``[H, V]`` in w's dtype. CPU tensors take the plain version;
    CUDA tensors launch K7 or raise."""
    _shapes(h, w, labels)
    if _device_gate(h, "fused cross-entropy dW"):
        return fused_ce_bwd_dw_ref(h, w, labels, lse, g, vocab_offset)
    out = _bwd("pt_fused_ce_bwd_dw", h, w, labels, lse, g, vocab_offset,
               tuple(w.shape))
    fused_ce_bwd_dw.launches += int(h.shape[0] > 0)
    return out.to(w.dtype)


fused_ce_fwd.launches = 0
fused_ce_bwd_dh.launches = 0
fused_ce_bwd_dw.launches = 0


def fused_linear_ce_partials(h, w, labels, vocab_offset: int = 0):
    """Per-row online-softmax partials of ``s = h @ w`` (fused_ce.py:242-254):
    ``(m, l, z)`` with m the row max, ``l = sum exp(s - m)`` and z the logit
    at ``labels`` (global vocab ids; a label outside ``[vocab_offset,
    vocab_offset + V)`` gives z = 0). A vocab-sharded caller merges the
    shards' partials: ``M = max m_i``, ``L = sum l_i exp(m_i - M)``,
    ``lse = M + log L``, ``loss = lse - sum z_i``."""
    return fused_ce_fwd(h, w, labels, vocab_offset)


class _FusedLinearCE(torch.autograd.Function):
    """``jax.custom_vjp`` of fused_ce.py:257-284: K5 forward, saving (h, w,
    labels, lse); K6 and K7 backward with the per-row grad g in fp32."""

    @staticmethod
    def forward(ctx, h, w, labels):
        m, l, z = fused_ce_fwd(h, w, labels)
        lse = m + torch.log(l)
        ctx.save_for_backward(h, w, labels, lse)
        return lse - z

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        g = g.float().contiguous()
        dh = fused_ce_bwd_dh(h, w, labels, lse, g) \
            if ctx.needs_input_grad[0] else None
        dw = fused_ce_bwd_dw(h, w, labels, lse, g) \
            if ctx.needs_input_grad[1] else None
        return dh, dw, None


def fused_linear_cross_entropy(h, w, labels) -> torch.Tensor:
    """Per-row cross-entropy of ``softmax(h @ w)`` against integer labels,
    fp32 ``[N]`` (fused_ce.py:257-263): forward through K5, backward
    through K6 and K7 (their plain versions on the CPU)."""
    return _FusedLinearCE.apply(h, w, labels)


class _FusedLinearCETP(torch.autograd.Function):
    """fused_ce.py:291-340 over a process group. The JAX backward leans on
    shard_map's transpose (a replicated output's cotangent arrives split by
    the group size, and the transpose psums dh); in torch autograd the
    cotangent arrives whole, so g is used as it is and dh, each rank's
    partial ``dl W_shard^T``, is all-reduced here (in fp32)."""

    @staticmethod
    def forward(ctx, h, w, labels, group, offset, mesh):
        from ...distributed import comms
        m, l, z = fused_ce_fwd(h, w, labels, offset)
        M = comms.wire_all_reduce(m, group, "max", exact=True, mesh=mesh,
                                  owner="fused_ce_tp.max")
        S = comms.wire_all_reduce(torch.stack([l * torch.exp(m - M), z]),
                                  group, "sum", exact=True, mesh=mesh,
                                  owner="fused_ce_tp.sum")
        lse = M + torch.log(S[0])
        ctx.save_for_backward(h, w, labels, lse)
        ctx.group, ctx.offset, ctx.mesh = group, offset, mesh
        return lse - S[1]

    @staticmethod
    def backward(ctx, g):
        from ...distributed import comms
        h, w, labels, lse = ctx.saved_tensors
        g = g.float().contiguous()
        dh = dw = None
        if ctx.needs_input_grad[0]:
            part = fused_ce_bwd_dh(h, w, labels, lse, g, ctx.offset)
            dh = comms.wire_all_reduce(part.float(), ctx.group, "sum",
                                       exact=True, mesh=ctx.mesh,
                                       owner="fused_ce_tp.dh").to(h.dtype)
        if ctx.needs_input_grad[1]:
            dw = fused_ce_bwd_dw(h, w, labels, lse, g, ctx.offset)
        return dh, dw, None, None, None, None


def fused_linear_cross_entropy_tp(h, w_shard, labels, axis="mp",
                                  vocab_offset=None, mesh=None
                                  ) -> torch.Tensor:
    """Vocab-parallel fused cross-entropy: this rank holds ``w_shard``
    ``[H, V/n]`` (ColumnParallelLinear's layout) and the whole ``h``
    ``[N, H]`` and global ``labels`` ``[N]``; returns every row's loss,
    fp32 ``[N]``, the same on every rank of ``axis`` (a mesh axis or a
    ``collective.Group``). ``vocab_offset`` defaults to ``rank * V/n``.
    K5 forward and K6/K7 backward on the shard (plain versions on the
    CPU)."""
    from ...distributed import comms
    lk = comms.link(axis, mesh)
    offset = lk.rank * w_shard.shape[1] if vocab_offset is None \
        else int(vocab_offset)
    return _FusedLinearCETP.apply(h, w_shard, labels, axis, offset, mesh)
