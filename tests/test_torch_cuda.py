"""The port's CUDA kernels on the card (marked ``cuda``; they skip on a
machine without an NVIDIA GPU, since a CUDA kernel has no CPU mode).

This file imports torch and the port only, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances, outputs compared in fp32: float32 atol 1e-5 / rtol 1e-4 (the
kernel and the plain version sum in different orders); bfloat16 and
float16 one rounding step of the dtype, rtol 2**-7 and 2**-10 with atol
1e-5 for outputs near zero (both round their fp32 result to the storage
dtype once, from different partial sums). Flash attention holds each row
of D values to its own scale: atol is one step (O) or two (grads) of the
dtype times the row's max|want|, so a row of small values is not judged
against the largest row of the tensor.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import fused_ce as fce
from paddle_tpu_torch.ops.kernels.decode_attention import (
    ragged_decode_attention, ragged_decode_attention_ref)

TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 2.0 ** -7),
       torch.float16: (1e-5, 2.0 ** -10)}
LENS_7B = [0, 1, 17, 255, 256, 777, 2047, 2048]
CASES = [
    # (B, S_max, H, Hkv, D, lengths)
    (3, 384, 8, 8, 64, [1, 200, 384]),
    (3, 384, 8, 4, 64, [1, 200, 384]),
    (4, 300, 8, 4, 64, [0, 1, 150, 300]),     # length 0, S_max % 256 != 0
    (2, 100, 12, 4, 96, [37, 100]),           # group 3, D = 96
    (2, 64, 8, 1, 256, [64, 5]),              # group 8, D = 256
    (8, 2048, 32, 32, 128, LENS_7B),          # LLaMA-7B decode, MHA
    (8, 2048, 32, 8, 128, LENS_7B),           # GQA
    # The split-KV edges (ranks of 256 keys at S_max 2048): a length at a
    # rank boundary, one below and one above it, one key in the last rank.
    (4, 2048, 8, 8, 128, [256, 255, 257, 1793]),
    (3, 2047, 8, 2, 128, [2047, 1792, 1]),    # S_max % (splits x chunk) != 0
    (3, 200, 8, 8, 64, [200, 199, 0]),        # S_max < 256: one rank
    (3, 4096, 8, 4, 128, [4096, 512, 3585]),  # ranks of 512 keys
    # Groups above 8 (chunks of query heads along grid y, one launch) and
    # head widths off the TMA path (D x 2 bytes not a multiple of 16, or
    # D > 256: element loads).
    (2, 300, 16, 1, 128, [300, 77]),          # group 16
    (3, 600, 32, 1, 64, [600, 1, 0]),         # group 32 (MQA), split ranks
    (2, 200, 32, 2, 128, [200, 13]),          # group 16 on two kv heads
    (2, 300, 8, 2, 80, [300, 41]),            # D = 80 (TMA, 160-byte rows)
    (2, 300, 8, 2, 100, [300, 41]),           # D = 100 (element loads)
    (2, 300, 4, 1, 320, [300, 257]),          # D = 320 (element loads)
    (1, 64, 32, 1, 100, [64]),                # group 32 and D = 100
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, S, H, hkv, D, dtype, device, seed=2):
    g = torch.Generator(device=device).manual_seed(seed)
    return [(0.5 * torch.randn(shape, generator=g, device=device)).to(dtype)
            for shape in ((B, 1, H, D), (B, S, hkv, D), (B, S, hkv, D))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,S,H,hkv,D,lengths", CASES)
def test_decode_kernel_matches_plain_version(cuda_device, dtype, B, S, H,
                                             hkv, D, lengths):
    q, k, v = _inputs(B, S, H, hkv, D, dtype, cuda_device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = ragged_decode_attention.launches
    got = ragged_decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert ragged_decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ragged_decode_attention_ref(q, k, v, lens)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    for b, n in enumerate(lengths):
        if n == 0:
            assert not got[b].any()


@pytest.mark.cuda
def test_decode_kernel_honours_scale_and_long_lengths(cuda_device):
    q, k, v = _inputs(2, 40, 4, 2, 64, torch.float32, cuda_device, seed=3)
    lens = torch.tensor([40, 1000], dtype=torch.int32, device=cuda_device)
    got = ragged_decode_attention(q, k, v, lens, scale=0.3)
    want = ragged_decode_attention_ref(q, k, v, lens, scale=0.3)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_decode_wrapper_raises_on_inputs_it_cannot_take(cuda_device):
    q = torch.zeros(2, 1, 8, 64, device=cuda_device)
    k = torch.zeros(2, 16, 4, 64, device=cuda_device)
    lens = torch.ones(2, dtype=torch.int32, device=cuda_device)
    before = ragged_decode_attention.launches
    with pytest.raises(TypeError):
        ragged_decode_attention(q.double(), k.double(), k.double(), lens)
    with pytest.raises(TypeError):
        ragged_decode_attention(q, k, k, lens.long())
    with pytest.raises(TypeError):
        ragged_decode_attention(q, k.half(), k.half(), lens)
    with pytest.raises(ValueError):
        ragged_decode_attention(
            q, k.transpose(1, 2).contiguous().transpose(1, 2), k, lens)
    with pytest.raises(ValueError):
        ragged_decode_attention(q, k, k, lens.cpu())
    with pytest.raises(ValueError):                   # D > 512
        ragged_decode_attention(
            torch.zeros(2, 1, 8, 520, device=cuda_device),
            torch.zeros(2, 16, 4, 520, device=cuda_device),
            torch.zeros(2, 16, 4, 520, device=cuda_device), lens)
    assert ragged_decode_attention.launches == before


@pytest.mark.cuda
def test_engine_on_card_matches_cpu_engine_fp32(cuda_device):
    """The same weights served on the card (decode through the kernel) and
    on the CPU (decode through the plain version) give equal tokens."""
    cfg = LlamaConfig.tiny(vocab=64, hidden=256, layers=2, heads=4,
                           inter=512, seq=64)
    cfg.num_key_value_heads = 2
    gpu = LlamaForCausalLM(cfg, device=cuda_device, seed=4)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=4)
    cpu.load_state_dict({n: p.cpu() for n, p in gpu.state_dict().items()})
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, n) for n in (3, 8, 11)]
    before = ragged_decode_attention.launches
    on_card = ServingEngine(gpu, max_batch=2).generate(prompts,
                                                       max_new_tokens=6)
    assert ragged_decode_attention.launches > before
    on_cpu = ServingEngine(cpu, max_batch=2).generate(prompts,
                                                      max_new_tokens=6)
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_array_equal(a, b)


FLASH_STEP = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2.0 ** -7,) * 2,
              torch.float16: (2.0 ** -10,) * 2}
FLASH_CASES = [
    # (B, Sq, Sk, H, Hkv, D, causal)
    (2, 200, 200, 4, 4, 64, True),        # S not a multiple of the tile
    (2, 200, 200, 8, 2, 64, False),       # group 4
    (1, 64, 160, 8, 2, 128, True),        # causal Sq < Sk (top-left)
    (1, 160, 64, 4, 1, 128, True),        # causal Sq > Sk, group 4
    (2, 130, 300, 4, 4, 128, False),      # Sq != Sk
    (1, 96, 96, 4, 2, 96, True),          # D = 96 (padded to 128 inside)
    (1, 70, 70, 2, 2, 256, True),         # D = 256
    (2, 129, 129, 4, 4, 128, True),       # one row past a 128-row tile
    (1, 300, 129, 8, 1, 128, True),       # causal Sq > Sk, group 8
    (1, 129, 129, 8, 1, 96, True),        # group 8, D = 96, S = 129
    (1, 129, 257, 8, 1, 64, False),       # group 8, D = 64, Sk = 2 tiles + 1
    (2, 2048, 2048, 32, 32, 128, True),   # the llama_7b training shape
    (1, 1, 129, 4, 4, 128, True),         # causal Sq = 1: only key 0 is live
    (1, 257, 257, 8, 2, 64, True),        # a partial last 128-row q-block
    # D not a multiple of 8 (padded by the wrappers) and D above 256
    (1, 130, 130, 4, 2, 80, True),        # D = 80
    (2, 100, 140, 4, 4, 100, False),      # D = 100
    (1, 150, 150, 4, 1, 100, True),       # D = 100, group 4
    (1, 70, 90, 2, 2, 320, True),         # D = 320 (16 x 16 tiles)
    (1, 40, 40, 2, 1, 512, False),        # D = 512, group 2
]


def _close(got, want, rtol, step, mult=1.0):
    """Each row of D values (one batch, position and head) within rtol x
    |want| plus mult x step x the row's own max|want| (at least 1e-6, for
    rows that are fp32 noise in both, as dQ of causal row 0)."""
    got, want = got.float(), want.float()
    atol = (mult * step * want.abs().amax(-1, keepdim=True)).clamp_min(1e-6)
    ok = (got - want).abs() <= atol + rtol * want.abs()
    assert ok.all(), (f"{int((~ok).sum())} of {ok.numel()} elements out of "
                      f"tolerance; max abs error "
                      f"{float((got - want).abs().max())}")


def flash_inputs(B, Sq, Sk, H, Hkv, D, dtype, device, seed=5):
    g = torch.Generator(device=device).manual_seed(seed)
    return [(0.5 * torch.randn(shape, generator=g, device=device)).to(dtype)
            for shape in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                          (B, Sq, H, D))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,Sq,Sk,H,hkv,D,causal", FLASH_CASES)
def test_flash_kernels_match_plain_versions(cuda_device, dtype, B, Sq, Sk, H,
                                            hkv, D, causal):
    q, k, v, do = flash_inputs(B, Sq, Sk, H, hkv, D, dtype, cuda_device)
    rtol, step = FLASH_STEP[dtype]
    n = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
         fa.flash_attention_bwd_dkv.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    want_o, want_lse = fa.flash_attention_fwd_ref(q, k, v, causal)
    assert o.dtype == dtype and lse.shape == (B, H, Sq)
    _close(o, want_o, rtol, step)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    delta = (do.float() * want_o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, want_lse, delta, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, want_lse, delta, causal)
    torch.cuda.synchronize()
    want_dq = fa.flash_attention_bwd_dq_ref(q, k, v, do, want_lse, delta,
                                            causal)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_ref(q, k, v, do, want_lse,
                                                      delta, causal)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dtype and got.shape == want.shape
        _close(got, want, rtol, step, mult=2.0)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq
            .launches, fa.flash_attention_bwd_dkv.launches) == tuple(
                x + 1 for x in n)


@pytest.mark.cuda
def test_flash_autograd_on_card_matches_cpu_plain_path(cuda_device):
    """The same fp32 inputs through flash_attention's autograd on the card
    (K2, K3, K4) and on the CPU (the plain versions)."""
    q, k, v, do = flash_inputs(2, 100, 100, 8, 2, 64, torch.float32, "cpu")
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        leaves = [x.to(dev).requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention(*leaves, True)
        out.backward(do.to(dev))
        grads.append([out.detach().cpu()] + [x.grad.cpu() for x in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_flash_sdpa_takes_strided_views_on_card(cuda_device):
    """Transposed q/k/v views through F.scaled_dot_product_attention on the
    card (K2-K4 get contiguous copies) equal the contiguous call, output
    and grads, bitwise."""
    from paddle_tpu_torch.nn import functional as F
    q, k, v, do = flash_inputs(2, 100, 100, 8, 2, 64, torch.bfloat16,
                               cuda_device)
    dense = [x.clone().requires_grad_() for x in (q, k, v)]
    store = [x.transpose(1, 2).contiguous().requires_grad_()
             for x in (q, k, v)]
    strided = [x.transpose(1, 2) for x in store]
    assert not any(x.is_contiguous() for x in strided)
    before = fa.flash_attention_fwd.launches
    want = F.scaled_dot_product_attention(*dense, is_causal=True)
    got = F.scaled_dot_product_attention(*strided, is_causal=True)
    assert fa.flash_attention_fwd.launches == before + 2
    want.backward(do)
    got.backward(do)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, b in zip(store, dense):
        torch.testing.assert_close(a.grad.transpose(1, 2), b.grad, rtol=0,
                                   atol=0)


@pytest.mark.cuda
def test_flash_wrappers_raise_on_inputs_they_cannot_take(cuda_device):
    q, k, v, do = flash_inputs(1, 16, 16, 4, 2, 64, torch.float32,
                               cuda_device)
    lse = torch.zeros(1, 4, 16, device=cuda_device)
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)

    def wide(d):
        return [torch.zeros(1, 16, 2, d, device=cuda_device)] * 3
    with pytest.raises(ValueError):                   # D > 512
        fa.flash_attention_fwd(*wide(520))
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_dq(*wide(1000), wide(1000)[0], lse, lse)
    with pytest.raises(ValueError):                   # mixed devices
        fa.flash_attention_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError):                   # non-contiguous
        fa.flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v)
    with pytest.raises(TypeError):                    # dtypes differ
        fa.flash_attention_fwd(q, k.half(), v)
    with pytest.raises(TypeError):                    # float64
        fa.flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):                    # lse not fp32
        fa.flash_attention_bwd_dq(q, k, v, do, lse.half(), lse)
    with pytest.raises(ValueError):                   # dO on the CPU
        fa.flash_attention_bwd_dkv(q, k, v, do.cpu(), lse, lse)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == before


# Fused linear + cross-entropy (K5-K7). (N, H, V, vocab_offset, last):
# ragged N, H and V (element loads), V not a multiple of 8 with H aligned
# (the mma.sync kernels in every dtype), the 16-byte path with a vocab offset (a
# third of the labels fall outside the shard), and labels all in the last
# vocab tile (last=True). In bf16/fp16 with H and V multiples of 8, K6/K7
# run the wgmma kernels: N, H and V off their 128-row, 64-deep and
# 512-column tiles, many vocab tiles at the training head's width, a last
# 512-column slice 8 columns wide, and two 512-row slices of K7.
FCE_CASES = [
    (13, 50, 777, 0, False),
    (24, 64, 1000, 0, False),
    (200, 136, 1030, 0, False),
    (300, 256, 4096, 1000, False),
    (130, 512, 2000, 0, True),
    (200, 520, 1032, 0, False),
    (256, 4096, 32000, 0, False),
    (333, 136, 2056, 0, True),
    (1000, 128, 1024, 300, False),
]
# (rtol, step) per dtype for dh rows and dW columns, as FLASH_STEP's grads:
# the kernel and the plain version round the same dl, from fp32 logits
# summed in other orders (K6/K7 also add their products with atomics, in
# an order that changes from run to run), then round the fp32 sum once.
FCE_STEP = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2.0 ** -7,) * 2,
            torch.float16: (2.0 ** -10,) * 2}


def fce_inputs(N, H, V, offset, last, dtype, device, seed=6):
    g = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn(N, H, generator=g, device=device).to(dtype)
    w = (0.05 * torch.randn(H, V, generator=g, device=device)).to(dtype)
    top = V + offset + (V // 2 if offset else 0)
    labels = torch.randint(0, top, (N,), generator=g, device=device)
    if last:                        # the last vocab tile of 128 columns
        labels = V - 1 - labels % (V - (V - 1) // 128 * 128)
    gr = torch.randn(N, generator=g, device=device)
    gr[::5] = 0.0                           # rows that add nothing
    return h, w, labels, gr


def _close_lines(got, want, rtol, step, dim):
    """Each line along `dim` (a row of dh, a column of dW) within rtol x
    |want| plus two steps of the dtype times the line's max|want|."""
    got, want = got.float(), want.float()
    atol = (2 * step * want.abs().amax(dim, keepdim=True)).clamp_min(1e-6)
    ok = (got - want).abs() <= atol + rtol * want.abs()
    assert ok.all(), (f"{int((~ok).sum())} of {ok.numel()} elements out of "
                      f"tolerance; max abs error "
                      f"{float((got - want).abs().max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("N,H,V,offset,last", FCE_CASES)
def test_fused_ce_kernels_match_plain_versions(cuda_device, dtype, N, H, V,
                                               offset, last):
    """m, lse and the loss per row within atol 1e-4 / rtol 1e-5 (both are
    fp32 sums of the same products, in other orders); dh row by row and
    dW column by column under FCE_STEP."""
    h, w, labels, gr = fce_inputs(N, H, V, offset, last, dtype,
                                  cuda_device)
    before = (fce.fused_ce_fwd.launches, fce.fused_ce_bwd_dh.launches,
              fce.fused_ce_bwd_dw.launches)
    m, l, z = fce.fused_ce_fwd(h, w, labels, offset)
    torch.cuda.synchronize()
    wm, wl, wz = fce.fused_ce_fwd_ref(h, w, labels, offset)
    for got, want in ((m, wm), (m + torch.log(l), wm + torch.log(wl)),
                      (m + torch.log(l) - z, wm + torch.log(wl) - wz)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    local = labels - offset
    assert not z[(local < 0) | (local >= V)].any()
    lse = (wm + torch.log(wl)).contiguous()
    dh = fce.fused_ce_bwd_dh(h, w, labels, lse, gr, offset)
    dw = fce.fused_ce_bwd_dw(h, w, labels, lse, gr, offset)
    torch.cuda.synchronize()
    rtol, step = FCE_STEP[dtype]
    assert dh.dtype == dw.dtype == dtype
    _close_lines(dh, fce.fused_ce_bwd_dh_ref(h, w, labels, lse, gr, offset),
                 rtol, step, -1)
    _close_lines(dw, fce.fused_ce_bwd_dw_ref(h, w, labels, lse, gr, offset),
                 rtol, step, 0)
    assert not dh[::5].any()
    assert (fce.fused_ce_fwd.launches, fce.fused_ce_bwd_dh.launches,
            fce.fused_ce_bwd_dw.launches) == tuple(x + 1 for x in before)


@pytest.mark.cuda
def test_fused_ce_autograd_on_card_matches_cpu_plain_path(cuda_device):
    """The same fp32 inputs through fused_linear_cross_entropy's autograd on
    the card (K5, K6, K7) and on the CPU (the plain versions)."""
    h, w, labels, gr = fce_inputs(70, 96, 1500, 0, False, torch.float32,
                                  "cpu")
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        th, tw = (x.to(dev).requires_grad_() for x in (h, w))
        loss = fce.fused_linear_cross_entropy(th, tw, labels.to(dev))
        loss.backward(gr.to(dev))
        outs.append([loss.detach().cpu(), th.grad.cpu(), tw.grad.cpu()])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_fused_ce_wrappers_raise_on_inputs_they_cannot_take(cuda_device):
    h, w, labels, gr = fce_inputs(8, 16, 40, 0, False, torch.float32,
                                  cuda_device)
    before = (fce.fused_ce_fwd.launches, fce.fused_ce_bwd_dh.launches,
              fce.fused_ce_bwd_dw.launches)
    with pytest.raises(ValueError):                   # h not [N, H]
        fce.fused_ce_fwd(h[None], w, labels)
    with pytest.raises(ValueError):                   # H mismatch
        fce.fused_ce_fwd(h, w[:15], labels)
    with pytest.raises(TypeError):                    # float labels
        fce.fused_ce_fwd(h, w, labels.float())
    with pytest.raises(ValueError):                   # non-contiguous w
        fce.fused_ce_fwd(h, w.t().contiguous().t(), labels)
    with pytest.raises(TypeError):                    # dtypes differ
        fce.fused_ce_fwd(h, w.half(), labels)
    with pytest.raises(TypeError):                    # float64
        fce.fused_ce_fwd(h.double(), w.double(), labels)
    with pytest.raises(ValueError):                   # labels on the CPU
        fce.fused_ce_fwd(h, w, labels.cpu())
    with pytest.raises(TypeError):                    # lse not fp32
        fce.fused_ce_bwd_dh(h, w, labels, gr.half(), gr)
    with pytest.raises(ValueError):                   # g on the CPU
        fce.fused_ce_bwd_dw(h, w, labels, gr, gr.cpu())
    assert (fce.fused_ce_fwd.launches, fce.fused_ce_bwd_dh.launches,
            fce.fused_ce_bwd_dw.launches) == before
