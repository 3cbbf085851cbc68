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
from paddle_tpu_torch.ops.kernels import multi_tensor as mt
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
    torch.backends.cudnn.allow_tf32 = False   # fp32 convolutions, as the CPU
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


# Fused linear + cross-entropy (K5-K7). (N, H, V, vocab_offset, kind):
# ragged N, H and V (element loads), V not a multiple of 8 with H aligned
# (the mma.sync kernels in every dtype), the 16-byte path with a vocab offset (a
# third of the labels fall outside the shard); kind "last": labels all in
# the last 128-column vocab tile, "neg": every logit negative (h >= 0,
# W <= 0), so a padded column taken as s = 0 would win the max. In
# bf16/fp16 with H and V multiples of 8 all three run the Hopper kernels:
# N, H and V off their 128-row, 64-deep and 256-column (K5) or 512-column
# (K6) tiles, many vocab tiles at the training head's width, a last tile 8
# columns wide, two 512-row slices of K7, one row, a row past 32 row
# blocks, H off the 64-deep chunk, all logits negative.
FCE_CASES = [
    (13, 50, 777, 0, "any"),
    (24, 64, 1000, 0, "any"),
    (200, 136, 1030, 0, "any"),
    (300, 256, 4096, 1000, "any"),
    (130, 512, 2000, 0, "last"),
    (200, 520, 1032, 0, "any"),
    (256, 4096, 32000, 0, "any"),
    (333, 136, 2056, 0, "last"),
    (1000, 128, 1024, 300, "any"),
    (1, 256, 2048, 0, "any"),
    (4097, 256, 1032, 0, "any"),
    (77, 4104, 1000, 0, "any"),
    (300, 512, 2056, 0, "neg"),
]
# (rtol, step) per dtype for dh rows and dW columns, as FLASH_STEP's grads:
# the kernel and the plain version round the same dl, from fp32 logits
# summed in other orders (K6/K7 also add their products with atomics, in
# an order that changes from run to run), then round the fp32 sum once.
FCE_STEP = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2.0 ** -7,) * 2,
            torch.float16: (2.0 ** -10,) * 2}


def fce_inputs(N, H, V, offset, kind, dtype, device, seed=6):
    g = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn(N, H, generator=g, device=device)
    w = 0.05 * torch.randn(H, V, generator=g, device=device)
    if kind == "neg":               # every logit negative
        h, w = h.abs(), -w.abs()
    h, w = h.to(dtype), w.to(dtype)
    top = V + offset + (V // 2 if offset else 0)
    labels = torch.randint(0, top, (N,), generator=g, device=device)
    if kind == "last":              # the last vocab tile of 128 columns
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
@pytest.mark.parametrize("N,H,V,offset,kind", FCE_CASES)
def test_fused_ce_kernels_match_plain_versions(cuda_device, dtype, N, H, V,
                                               offset, kind):
    """m, lse and the loss per row within atol 1e-4 / rtol 1e-5 (both are
    fp32 sums of the same products, in other orders); dh row by row and
    dW column by column under FCE_STEP."""
    h, w, labels, gr = fce_inputs(N, H, V, offset, kind, dtype,
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
    h, w, labels, gr = fce_inputs(70, 96, 1500, 0, "any", torch.float32,
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
    h, w, labels, gr = fce_inputs(8, 16, 40, 0, "any", torch.float32,
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_fwd_launcher_refuses_a_split_count_it_did_not_derive(
        cuda_device, dtype):
    """K5's launcher derives the split count (fwd_splits) and refuses any
    other than the one pt_fused_ce_fwd_splits gave the wrapper with
    cudaErrorInvalidValue (1), so part [3, splits, N] is never written
    past its end."""
    from paddle_tpu_torch.ops.kernels._build import library
    h, w, labels, _ = fce_inputs(300, 256, 4096, 0, "any", dtype,
                                 cuda_device)
    N, H = h.shape
    V = w.shape[1]
    splits = fce._fwd_splits(h, w)
    lab = labels.to(torch.int32)
    out = torch.zeros(3, N, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    for n in (splits - 1, splits + 1):
        part = torch.zeros(3, n, N, device=cuda_device)
        rc = library().pt_fused_ce_fwd(
            h.data_ptr(), w.data_ptr(), lab.data_ptr(), 0, part.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), N, H, V,
            n, fa._DTYPE_CODE[dtype], stream)
        torch.cuda.synchronize()
        assert rc == 1 and not part.any() and not out.any()


# (N, V, Hopper kernel, splits) on a 132-SM H100: the plans that
# tests/test_torch_fused_ce.py's SPLIT_CASES model on the CPU, and the
# training head (32 row blocks x 4 splits = 128 CTAs).
FWD_PLANS_132 = [(24, 200, True, 1), (24, 1000, True, 4),
                 (4352, 2056, True, 3), (40, 2056, True, 9),
                 (16900, 600, True, 1), (13, 777, False, 7),
                 (4096, 32000, True, 4), (4096, 32000, False, 17)]


@pytest.mark.cuda
def test_fused_ce_fwd_splits_fill_one_wave_without_empty_splits(cuda_device):
    """pt_fused_ce_fwd_splits, which sizes the wrapper's part scratch: every
    split holds a tile; the Hopper kernel's 128-row blocks x splits fit in
    one wave of the card's SMs; on a 132-SM card, FWD_PLANS_132. The
    Hopper kernel takes bf16/fp16 with H, V multiples of 8 and 16-byte
    aligned bases (the bases are only read for their alignment here)."""
    from paddle_tpu_torch.ops.kernels._build import library
    lib = library()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    bf16, fp32 = fa._DTYPE_CODE[torch.bfloat16], fa._DTYPE_CODE[torch.float32]

    def plan(n, v, hopper, base=256, code=bf16):
        with torch.cuda.device(cuda_device):
            return lib.pt_fused_ce_fwd_splits(base, base, n, 64, v,
                                              code if hopper else fp32)

    for n in (1, 128, 4097, 16384, 40000):
        for v in (8, 200, 2056, 32000, 128256):
            for hopper in (True, False):
                splits = plan(n, v, hopper)
                nvt = -(-v // (256 if hopper else 128))
                per = -(-nvt // splits)
                assert 1 <= splits <= nvt and (splits - 1) * per < nvt
                if hopper and splits > 1:
                    assert -(-n // 128) * splits <= sms
            # a base off 16 bytes takes the mma.sync kernel's plan
            assert plan(n, v, True, base=258) == plan(n, v, False)
    if sms == 132:
        assert [plan(n, v, hop) for n, v, hop, _ in FWD_PLANS_132] == \
            [s for *_, s in FWD_PLANS_132]


# ---------------------------------------------------------------------------
# U1 and U2, the multi-tensor optimizer kernels
# ---------------------------------------------------------------------------

def model_shapes(layers=8, hidden=4096, inter=11008, vocab=32000, div=1):
    """The parameter shapes of LlamaForCausalLM at llama_7b width (each
    dim divided by div), in named_parameters order: 2 + 9 x layers + 1."""
    h, i, v = hidden // div, inter // div, vocab // div
    layer = [(h,), (h, h), (h, h), (h, h), (h, h), (h,), (h, i), (h, i),
             (i, h)]
    return [(v, h)] + layer * layers + [(h,), (h, v)]


# Size classes: one element; an empty tensor beside one element; odd sizes
# (no multiple of a 16-byte vector); a view 4 bytes past a 16-byte
# boundary; the 8-layer training model's 75 shapes at 1/64 of each dim; a
# 20-layer model's 183 at 1/64, more than 2 x 80 tensors, so U2 launches 3
# times and U1 twice.
MT_SIZES = {
    "one": [(1,)],
    "empty": [(0,), (1,), (0,)],
    "odd": [(n,) for n in (1, 3, 7, 15, 17, 31, 33, 127, 129, 255, 257,
                           1023, 1031)],
    "misaligned": "misaligned",
    "model_div64": model_shapes(div=64),
    "model20_div64": model_shapes(layers=20, div=64),
}


def _mt_tensors(shapes, dtype, device, seed=0, grad_scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    if shapes == "misaligned":
        def make(scale=1.0, positive=False):
            base = scale * torch.randn(1032, generator=g, device=device)
            if positive:
                base = base.abs()
            return base.to(dtype)[1:]      # 2 or 4 bytes off the boundary
        out = [make(), make(grad_scale), make(0.1), make(0.1, True)]
        assert all(t.data_ptr() % 16 for t in out)
        return out

    def make_list(scale, shapes=shapes):
        return [(scale * torch.randn(s, generator=g, device=device))
                .to(dtype) for s in shapes]
    ps, gs, ms = make_list(1.0), make_list(grad_scale), make_list(0.1)
    return ps, gs, ms, [t.abs() for t in make_list(0.1)]


def _mt_lists(sizes, dtype, device, seed=0, grad_scale=1.0):
    out = _mt_tensors(MT_SIZES[sizes], dtype, device, seed, grad_scale)
    if sizes == "misaligned":
        return tuple([t] for t in out)
    return out


ADAM_KW = dict(lr=0.01, beta1=0.8, beta2=0.95, epsilon=1e-8,
               weight_decay=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sizes", sorted(MT_SIZES))
def test_multi_tensor_kernels_match_plain_versions(cuda_device, sizes,
                                                   dtype, scaled):
    """U1's per-tensor sums against float64 sums at rtol 1e-5 (fp32 sums
    of up to 2**16 squares a CTA in another order), its total the fp32 sum
    of those in list order, bit for bit; U2 bit for bit the plain version
    in every dtype (every op is rounded alike), three steps of Adam and of
    AdamW, with an inverse scale and a clip scale or without."""
    ps, gs, ms, vs = _mt_lists(sizes, dtype, cuda_device,
                               grad_scale=8.0 if scaled else 1.0)
    inv = torch.tensor(0.125, device=cuda_device) if scaled else None
    clip = torch.tensor(0.43, device=cuda_device) if scaled else None
    n1 = mt.multi_tensor_sumsq_finite.launches
    sumsq, total, finite = mt.multi_tensor_sumsq_finite(gs, inv)
    torch.cuda.synchronize()
    assert mt.multi_tensor_sumsq_finite.launches == n1 + -(-len(gs) // mt.SUMSQ_MAX)
    want = [(g * inv.to(dtype) if scaled else g).double().square().sum()
            for g in gs]
    torch.testing.assert_close(sumsq.double(), torch.stack(want),
                               rtol=1e-5, atol=0)
    acc = torch.zeros((), device=cuda_device)
    for x in sumsq:
        acc = acc + x
    assert torch.equal(total, acc) and int(finite) == 1
    again = mt.multi_tensor_sumsq_finite(gs, inv)
    assert torch.equal(again[0], sumsq) and torch.equal(again[1], total)
    for decoupled in (False, True):
        ref = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
        for step in (1, 2, 3):
            n2 = mt.multi_tensor_adam.launches
            mt.multi_tensor_adam(ps, gs, ms, vs, decoupled=decoupled,
                                 step=step, inv_scale=inv, clip_scale=clip,
                                 **ADAM_KW)
            mt.multi_tensor_adam_ref(*ref[:1], gs, *ref[1:],
                                     decoupled=decoupled, step=step,
                                     inv_scale=inv, clip_scale=clip,
                                     **ADAM_KW)
            assert mt.multi_tensor_adam.launches == n2 + sum(
                sum(p.numel() for p in ps[i:i + mt.ADAM_MAX]) > 0
                for i in range(0, len(ps), mt.ADAM_MAX))
        torch.cuda.synchronize()
        for got, want in zip(ps + ms + vs, ref[0] + ref[1] + ref[2]):
            assert torch.equal(got, want), (sizes, dtype, decoupled)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_multi_tensor_nonfinite_grads_skip_every_byte(cuda_device, dtype):
    """U1 finds a nan, +inf or -inf in any tensor (after the inverse
    scale); U2 under that flag writes nothing, however poisoned the grads
    and the clip scale are."""
    ps, gs, ms, vs = _mt_lists("model_div64", dtype, cuda_device, seed=1)
    before = [t.clone() for t in ps + ms + vs]
    for i, bad in ((0, float("nan")), (len(gs) // 2, float("inf")),
                   (len(gs) - 1, float("-inf"))):
        poisoned = [g.clone() for g in gs]
        poisoned[i].view(-1)[7] = bad
        _, total, finite = mt.multi_tensor_sumsq_finite(
            poisoned, torch.tensor(0.5, device=cuda_device))
        assert int(finite) == 0
        mt.multi_tensor_adam(ps, poisoned, ms, vs, decoupled=True, step=1,
                             clip_scale=torch.sqrt(total), finite=finite,
                             **ADAM_KW)
    torch.cuda.synchronize()
    for a, b in zip(before, ps + ms + vs):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
def test_multi_tensor_long_lists_take_several_launches(cuda_device):
    """200 grads: two U1 launches, the second adding to the first's total
    and flag; 200 parameters: three U2 launches; a mixed fp32/bf16 list:
    one U2 launch per dtype. All equal to the plain versions."""
    shapes = [(int(n),) for n in
              np.random.RandomState(3).randint(0, 3000, 200)]
    ps, gs, ms, vs = _mt_tensors(shapes, torch.float32, cuda_device)
    n1, n2 = mt.multi_tensor_sumsq_finite.launches, mt.multi_tensor_adam.launches
    sumsq, total, finite = mt.multi_tensor_sumsq_finite(gs)
    ref = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    mt.multi_tensor_adam(ps, gs, ms, vs, decoupled=True, step=1, **ADAM_KW)
    mt.multi_tensor_adam_ref(ref[0], gs, ref[1], ref[2], decoupled=True,
                             step=1, **ADAM_KW)
    assert mt.multi_tensor_sumsq_finite.launches == n1 + 2
    assert mt.multi_tensor_adam.launches == n2 + 3
    acc = torch.zeros((), device=cuda_device)
    for x in sumsq:
        acc = acc + x
    assert torch.equal(total, acc) and int(finite) == 1
    for got, want in zip(ps + ms + vs, ref[0] + ref[1] + ref[2]):
        assert torch.equal(got, want)
    mixed = [p.to(torch.bfloat16) if i % 2 else p for i, p in
             enumerate(ps[:6])]
    mm = [torch.zeros_like(p) for p in mixed]
    vv = [torch.zeros_like(p) for p in mixed]
    n2 = mt.multi_tensor_adam.launches
    mt.multi_tensor_adam(mixed, gs[:6], mm, vv, decoupled=False, step=1,
                         **ADAM_KW)
    assert mt.multi_tensor_adam.launches == n2 + 2


@pytest.mark.cuda
def test_multi_tensor_graph_replay_equals_eager(cuda_device):
    """U1 then U2 (clip scale and finite flag from U1, on the device)
    captured in one CUDA graph: a replay gives the eager launches' bits."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    clip = ClipGradByGlobalNorm(1.0)
    inv = torch.tensor(2.0 ** -4, device=cuda_device)

    def step(ps, gs, ms, vs):
        _, total, finite = mt.multi_tensor_sumsq_finite(gs, inv)
        mt.multi_tensor_adam(ps, gs, ms, vs, decoupled=True, step=3,
                             inv_scale=inv,
                             clip_scale=clip.scale_from_sumsq(total),
                             finite=finite, **ADAM_KW)

    eager = _mt_lists("model_div64", torch.float32, cuda_device, seed=4,
                      grad_scale=16.0)
    graphed = [[t.clone() for t in ts] for ts in eager]
    warm = [[t.clone() for t in ts] for ts in eager]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(*warm)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(*graphed)
    for ts, ws in zip(graphed, eager):     # capture ran nothing: reset
        for t, w in zip(ts, ws):
            t.copy_(w)
    graph.replay()
    step(*eager)
    torch.cuda.synchronize()
    for a, b in zip(sum(graphed, []), sum(eager, [])):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_multi_tensor_wrappers_raise_on_inputs_they_cannot_take(
        cuda_device):
    p = torch.zeros(8, 8, device=cuda_device)
    kw = dict(decoupled=True, step=1, **ADAM_KW)
    with pytest.raises(ValueError):            # a strided parameter
        mt.multi_tensor_adam([p.t()], [p], [p], [p], **kw)
    with pytest.raises(TypeError):             # moments of another dtype
        mt.multi_tensor_adam([p], [p], [p.half()], [p], **kw)
    with pytest.raises(ValueError):            # a moment of another shape
        mt.multi_tensor_adam([p], [p], [p[:4]], [p], **kw)
    with pytest.raises(TypeError):             # float64
        mt.multi_tensor_adam([p.double()], [p.double()], [p.double()],
                             [p.double()], **kw)
    with pytest.raises(TypeError):             # a scale on the host
        mt.multi_tensor_adam([p], [p], [p], [p], inv_scale=torch.tensor(1.),
                             **kw)
    with pytest.raises(TypeError):             # a bool flag
        mt.multi_tensor_adam([p], [p], [p], [p],
                             finite=torch.ones((), dtype=torch.bool,
                                               device=cuda_device), **kw)
    with pytest.raises(ValueError):            # a grad on the host
        mt.multi_tensor_sumsq_finite([p, torch.zeros(3)])
    with pytest.raises(TypeError):
        mt.multi_tensor_sumsq_finite([p.double()])


@pytest.mark.cuda
def test_training_paths_reach_the_multi_tensor_kernels(cuda_device):
    """On the card, AdamW's step (with a global-norm clip), GradScaler,
    compile_train_step and build_hybrid_train_step each launch U1 and U2
    as many times as their paths run them; compile_train_step on the card
    equals it on the CPU (the plain versions) over three steps, losses and
    parameters at rtol 1e-4 / atol 1e-5 (epsilon 1e-3: see
    tests/test_torch_trainer.py)."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.models import build_hybrid_train_step
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import compile_train_step

    cfg = LlamaConfig.tiny(vocab=64, hidden=64, layers=2, heads=4, inter=128)
    ids = np.random.RandomState(0).randint(0, 64, (4, 17))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:].copy()}

    def counts():
        return (mt.multi_tensor_sumsq_finite.launches,
                mt.multi_tensor_adam.launches)

    def moved(before):
        return tuple(b - a for a, b in zip(before, counts()))

    def loss_fn(m, b):
        return m.compute_loss(b["input_ids"], b["labels"])

    runs = {}
    for dev in (cuda_device, "cpu"):
        m = LlamaForCausalLM(cfg, device="cpu", seed=2).to(dev)
        opt = AdamW(learning_rate=1e-2, epsilon=1e-3,
                    parameters=m.parameters(),
                    grad_clip=ClipGradByGlobalNorm(0.5))
        step = compile_train_step(m, loss_fn, opt,
                                  scaler=GradScaler(init_loss_scaling=256.0))
        c = counts()
        runs[str(dev)] = ([float(step(batch)) for _ in range(3)],
                          {n: p.detach().cpu() for n, p in
                           m.named_parameters()})
        assert moved(c) == ((3, 3) if dev != "cpu" else (0, 0))
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for n, p in runs["cuda"][1].items():
        torch.testing.assert_close(p, runs["cpu"][1][n], rtol=1e-4,
                                   atol=1e-5)

    m = LlamaForCausalLM(cfg, device=cuda_device, seed=2)
    ids_t = torch.from_numpy(batch["input_ids"]).to(cuda_device)
    lab_t = torch.from_numpy(batch["labels"]).to(cuda_device)
    opt = AdamW(parameters=m.parameters(),
                grad_clip=ClipGradByGlobalNorm(0.5))
    c = counts()
    m.compute_loss(ids_t, lab_t).backward()
    opt.step()
    assert moved(c) == (1, 1)
    opt.clear_grad()
    scaler = GradScaler(init_loss_scaling=64.0)
    c = counts()
    scaler.scale(m.compute_loss(ids_t, lab_t)).backward()
    scaler.step(opt)
    scaler.update()
    assert moved(c) == (2, 1)          # the finite check, then the clip
    for clip, want in ((ClipGradByGlobalNorm(0.5), (2, 2)), (None, (0, 2))):
        opt = AdamW(parameters=m.parameters(), grad_clip=clip)
        hstep = build_hybrid_train_step(m, opt, amp=True)
        c = counts()
        for _ in range(2):
            hstep(batch)
        assert moved(c) == want


# ---------------------------------------------------------------------------
# step capture: the serving steps as CUDA graphs
# ---------------------------------------------------------------------------

def _capture_model(device, dtype=torch.float32, seed=4):
    cfg = LlamaConfig.tiny(vocab=128, hidden=256, layers=2, heads=4,
                           inter=512, seq=128)
    cfg.num_key_value_heads = 2
    return LlamaForCausalLM(cfg, device=device, dtype=dtype, seed=seed)


def _step_script(m, device, n=5, b=4, s_max=128, seed=0, caches=None):
    """Decode steps ([b, 1], the decode kernel) and verify windows ([b, 3],
    the masked path) on one set of caches; every output cloned at once
    (a replay's outputs are the graph's buffers)."""
    rng = np.random.default_rng(seed)
    if caches is None:
        caches = m.init_kv_caches(b, s_max)
    outs = []
    for i in range(n):
        tok = torch.from_numpy(rng.integers(0, 128, (b, 1))).to(device)
        off = torch.tensor([i, 3 * i, 10 + i, 40], dtype=torch.int32,
                           device=device)
        nxt, last = m.slot_step(tok, caches, off,
                                torch.zeros(b, dtype=torch.int32,
                                            device=device),
                                return_logits=True)
        outs += [nxt.clone(), last.clone()]
        outs.append(m.slot_step(tok, caches, off, torch.zeros(
            b, dtype=torch.int32, device=device)).clone())
        win = torch.from_numpy(rng.integers(0, 128, (b, 3))).to(device)
        outs.append(m.verify_step(win, caches, off + 1).clone())
    torch.cuda.synchronize()
    return outs, caches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_slot_and_verify_steps_equal_eager_bit_for_bit(
        cuda_device, dtype):
    from paddle_tpu_torch.jit import capture
    m = _capture_model(cuda_device, dtype)
    capture.set_step_capture_enabled(False)
    try:
        want, want_caches = _step_script(m, cuda_device)
    finally:
        capture.set_step_capture_enabled(True)
    before = ragged_decode_attention.launches
    got, got_caches = _step_script(m, cuda_device)
    # 2 decode-kernel layers x 2 [b, 1] calls x 5 steps, replays included
    assert ragged_decode_attention.launches - before == 2 * 2 * 5
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for (gk, gv), (wk, wv) in zip(got_caches, want_caches):
        assert torch.equal(gk, wk) and torch.equal(gv, wv)
    for name in ("_slot_step", "_slot_step_logits", "_verify_step"):
        info = m.captured_step(name).cache_info()
        assert info["lowerings"] == 1 and info["hits"] == 4, (name, info)
        assert info["bailouts"] == 0
    assert capture.capture_info()["graphs"] >= 3


@pytest.mark.cuda
def test_moved_cache_is_a_new_signature_on_card(cuda_device):
    """Two live sets of caches (two addresses) are two signatures, and
    each set's replays compute on its own caches."""
    from paddle_tpu_torch.jit import capture
    m = _capture_model(cuda_device)
    first, second = m.init_kv_caches(4, 128), m.init_kv_caches(4, 128)
    got = [_step_script(m, cuda_device, n=3, caches=c, seed=i)[0]
           for i, c in enumerate((first, second, first))]
    info = m.captured_step("_verify_step").cache_info()
    assert info["lowerings"] == 2 and info["signatures"] == 2
    capture.set_step_capture_enabled(False)
    try:
        fresh = [m.init_kv_caches(4, 128) for _ in range(2)]
        want = [_step_script(m, cuda_device, n=3, caches=c, seed=i)[0]
                for i, c in enumerate((fresh[0], fresh[1], fresh[0]))]
    finally:
        capture.set_step_capture_enabled(True)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("sync", ["item", "python_offset"])
def test_host_sync_in_a_step_bails_out_on_card(cuda_device, sync):
    from paddle_tpu_torch.jit import capture
    m = _capture_model(cuda_device)
    caches = m.init_kv_caches(2, 64)
    tok = torch.ones((2, 1), dtype=torch.int64, device=cuda_device)

    if sync == "item":
        def fn(t, c):
            return t * int(t.sum().item())

        step = capture.capture_step(fn, inplace=(1,))
        args = [(tok, caches)] * 3
    else:
        # a Python int offset copied to the card (the model's own steps
        # write such numbers with a fill, which is not a sync)
        def fn(t, c, off):
            return t + torch.as_tensor(off, device=t.device)

        step = capture.capture_step(fn, inplace=(1,))
        args = [(tok, caches, 5)] * 3
    outs = [step(*a).clone() for a in args]
    info = step.cache_info()
    assert info["bailouts"] == 1 and info["fallback_calls"] >= 2
    assert info["lowerings"] == 0
    assert step.bailout_reason()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("feature", ["spec_ngram", "spec_model", "prefix",
                                     "chunked"])
def test_feature_engines_on_card_finish_with_their_counters(cuda_device,
                                                            feature):
    m = _capture_model(cuda_device)
    rng = np.random.default_rng(1)
    common = rng.integers(0, 128, 40)
    prompts = [np.concatenate([common, rng.integers(0, 128, n)])
               for n in (3, 7, 12)]
    base = ServingEngine(m, max_batch=4, max_seq_len=128,
                         page_size=16).generate(prompts, max_new_tokens=8)
    kw = {"spec_ngram": dict(spec_k=3),
          "spec_model": dict(spec_k=3, drafter="model", draft_model=m),
          "prefix": dict(prefix_sharing=True),
          "chunked": dict(prefill_chunk=16)}[feature]
    eng = ServingEngine(m, max_batch=4, max_seq_len=128, page_size=16, **kw)
    outs = []
    for p in prompts:                       # donors commit before borrowers
        r = eng.submit(p, max_new_tokens=8)
        eng.run()
        outs.append(r.result())
    for a, b in zip(outs, base):
        np.testing.assert_array_equal(a, b)
    info = eng.info()
    assert info["finished"] == 3 and info["step"]["bailouts"] == 0
    if feature.startswith("spec"):
        assert info["spec"]["verify_steps"] > 0
        assert info["spec"]["verify"]["bailouts"] == 0
    elif feature == "prefix":
        assert info["shared_prefix_joins"] == 2
        assert info["prefill_pages_saved"] == 4
    else:
        assert info["chunked_prefills"] == 3 and info["prefill_chunks"] >= 9
        assert info["window"]["bailouts"] == 0


@pytest.mark.cuda
def test_gateway_round_trip_on_card(cuda_device):
    from paddle_tpu_torch.inference.serving.gateway import (GatewayClient,
                                                            ServingGateway)
    m = _capture_model(cuda_device)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 128, n) for n in (4, 9, 17)]
    want = ServingEngine(m, max_batch=4, max_seq_len=128).generate(
        prompts, max_new_tokens=6)
    gw = ServingGateway(ServingEngine(m, max_batch=4, max_seq_len=128))
    try:
        cli = GatewayClient("127.0.0.1", gw.port)
        got = [cli.generate(p, max_new_tokens=6) for p in prompts]
        assert cli.health()["ready"]
        assert "pt_step_capture_hits" in cli.metrics()
        cli.close()
    finally:
        assert gw.stop(drain=True, timeout=30.0)
    assert gw.threads() == []
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---- multi-GPU training, part 1: the entry points the mesh paths add ----

LSE_CASES = [
    # (B, S, H, Hkv, D, causal): a ring block of the llama_7b sep run, a
    # GQA block, a ragged non-causal block
    (1, 2048, 32, 32, 128, True),
    (2, 200, 8, 2, 64, True),
    (1, 129, 4, 4, 128, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,S,H,hkv,D,causal", LSE_CASES)
def test_flash_attention_lse_matches_plain_version(cuda_device, dtype, B, S,
                                                   H, hkv, D, causal):
    """O and LSE, and the grads of a loss on both (the LSE cotangent folds
    into delta as ``delta - g_lse``) through K2, K3 and K4, against the
    plain versions on the same inputs; one launch of each."""
    q, k, v, do = flash_inputs(B, S, S, H, hkv, D, dtype, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    g_lse = torch.randn(B, H, S, generator=g, device=cuda_device)
    n = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
         fa.flash_attention_bwd_dkv.launches)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    o, lse = fa.flash_attention_lse(*leaves, causal)
    torch.autograd.backward([o, lse], [do, g_lse])
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq
            .launches, fa.flash_attention_bwd_dkv.launches) == tuple(
                x + 1 for x in n)
    want_o, want_lse = fa.flash_attention_fwd_ref(q, k, v, causal)
    rtol, step = FLASH_STEP[dtype]
    _close(o, want_o, rtol, step)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    delta = ((do.float() * want_o.float()).sum(-1).transpose(1, 2)
             - g_lse).contiguous()
    want_dq = fa.flash_attention_bwd_dq_ref(q, k, v, do, want_lse, delta,
                                            causal)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_ref(q, k, v, do, want_lse,
                                                      delta, causal)
    for leaf, want in zip(leaves, (want_dq, want_dk, want_dv)):
        assert leaf.grad.dtype == dtype
        _close(leaf.grad, want, rtol, step, mult=2.0)


_TP_WORLD1 = r"""
import sys
import torch
import torch.distributed as dist
from paddle_tpu_torch.distributed import init_parallel_env
from paddle_tpu_torch.ops.kernels import fused_ce as fce
from paddle_tpu_torch.parallel import mesh as mesh_mod
init_parallel_env(backend="gloo", device="cuda", store=dist.HashStore(),
                  rank=0, world_size=1, mesh_shape={"mp": 1})
assert dist.get_backend() == "gloo" and mesh_mod.get_mesh().size == 1
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
g = torch.Generator(device=dev).manual_seed(3)
N, H, V, off = 300, 256, 2056, 2056       # as rank 1 of a 4112-wide vocab
h = torch.randn(N, H, generator=g, device=dev).to(torch.bfloat16)
w = (0.05 * torch.randn(H, V, generator=g, device=dev)).to(torch.bfloat16)
labels = torch.randint(0, 2 * V, (N,), generator=g, device=dev)
gr = torch.randn(N, generator=g, device=dev)
n = (fce.fused_ce_fwd.launches, fce.fused_ce_bwd_dh.launches,
     fce.fused_ce_bwd_dw.launches)
th, tw = (x.detach().requires_grad_() for x in (h, w))
loss = fce.fused_linear_cross_entropy_tp(th, tw, labels, "mp",
                                         vocab_offset=off)
loss.backward(gr)
torch.cuda.synchronize()
assert (fce.fused_ce_fwd.launches, fce.fused_ce_bwd_dh.launches,
        fce.fused_ce_bwd_dw.launches) == tuple(x + 1 for x in n)
wm, wl, wz = fce.fused_ce_fwd_ref(h, w, labels, off)
lse = (wm + torch.log(wl)).contiguous()
torch.testing.assert_close(loss, lse - wz, atol=1e-4, rtol=1e-5)
assert not wz[(labels < off)].any()
for got, want, dim in (
        (th.grad, fce.fused_ce_bwd_dh_ref(h, w, labels, lse, gr, off), -1),
        (tw.grad, fce.fused_ce_bwd_dw_ref(h, w, labels, lse, gr, off), 0)):
    got, want = got.float(), want.float()
    atol = (2 * 2.0 ** -7 * want.abs().amax(dim, keepdim=True)).clamp_min(
        1e-6)
    ok = (got - want).abs() <= atol + 2.0 ** -7 * want.abs()
    assert ok.all(), float((got - want).abs().max())
print("TP_OK")
"""


@pytest.mark.cuda
def test_fused_linear_cross_entropy_tp_world1_with_offset(cuda_device):
    """The vocab-parallel entry point on a world-1 gloo group (its own
    process), holding the vocab half at offset V as rank 1 would: K5, K6
    and K7 once each, the loss, dh and dW against the plain versions."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _TP_WORLD1], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "TP_OK" in res.stdout, res.stderr[-3000:]


_BUILD_ONCE = r"""
import json, time
from paddle_tpu_torch.ops.kernels import _build
t0 = time.time()
took = _build.build()
print(json.dumps({"took": took, "start": t0, "end": time.time()}))
"""


@pytest.mark.cuda
def test_build_file_lock_builds_once_for_two_processes(cuda_device):
    """Two processes that reach the build together (the ranks of a job)
    build once: the first holds the file lock and builds, the second
    waits, finds the stamp and loads; one library, one stamp, no
    temporary left."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    from paddle_tpu_torch.ops.kernels import _build
    root = Path(__file__).resolve().parents[1]
    _build.LIB_PATH.with_suffix(".sha256").unlink(missing_ok=True)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONCE], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    tooks = sorted(o["took"] for o in outs)
    assert tooks[0] == 0.0 and tooks[1] > 0.0, tooks
    assert _build.LIB_PATH.is_file()
    stamp = _build.LIB_PATH.with_suffix(".sha256")
    assert stamp.read_text().strip() == _build._source_hash()
    left = [p.name for p in _build.LIB_PATH.parent.iterdir()
            if ".tmp" in p.name]
    assert not left, left


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_u2_reads_lr_and_step_from_device_tensors(cuda_device, dtype):
    """U2 with the learning rate and the step count as 0-dim device
    tensors, rewritten between launches as a captured train step rewrites
    them before each replay: bit for bit the plain version (which takes
    the bias corrections by torch.pow on the card) over 300 steps and a
    changing lr; a CUDA graph of one launch replayed with new values does
    the same."""
    ps, gs, ms, vs = _mt_lists("model_div64", dtype, cuda_device, seed=2)
    ref = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    lr = torch.zeros((), device=cuda_device)
    step = torch.zeros((), dtype=torch.int32, device=cuda_device)
    kw = dict(ADAM_KW, lr=lr)
    for t in (1, 2, 3, 50, 300):
        lr.fill_(0.01 / t)
        step.fill_(t)
        mt.multi_tensor_adam(ps, gs, ms, vs, decoupled=True, step=step, **kw)
        mt.multi_tensor_adam_ref(ref[0], gs, ref[1], ref[2], decoupled=True,
                                 step=step, **kw)
    torch.cuda.synchronize()
    for got, want in zip(ps + ms + vs, ref[0] + ref[1] + ref[2]):
        assert torch.equal(got, want), dtype
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        mt.multi_tensor_adam(ps, gs, ms, vs, decoupled=True, step=step, **kw)
    torch.cuda.current_stream().wait_stream(s)
    mt.multi_tensor_adam_ref(ref[0], gs, ref[1], ref[2], decoupled=True,
                             step=step, **kw)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        mt.multi_tensor_adam(ps, gs, ms, vs, decoupled=True, step=step, **kw)
    for t in (301, 302, 1000):
        lr.fill_(1e-3 * t / 300)
        step.fill_(t)
        graph.replay()
        mt.multi_tensor_adam_ref(ref[0], gs, ref[1], ref[2], decoupled=True,
                                 step=step, **kw)
    torch.cuda.synchronize()
    for got, want in zip(ps + ms + vs, ref[0] + ref[1] + ref[2]):
        assert torch.equal(got, want), dtype


@pytest.mark.cuda
@pytest.mark.parametrize("hi", [7, 1000, 1 << 30])
def test_static_unique_on_card_equals_the_plain_one(cuda_device, hi):
    """The exchange's static-size unique (sort, first-occurrence mask,
    scatter) on the card: the CPU's uniques and inverse, and what
    ``torch.unique`` finds (its sorted values, then zeros)."""
    from paddle_tpu_torch.distributed.embedding import unique_static
    flat = torch.from_numpy(np.random.RandomState(hi % 97).randint(
        0, hi, 13312))
    u, inv = unique_static(flat.to(cuda_device))
    cu, cinv = unique_static(flat)
    assert torch.equal(u.cpu(), cu) and torch.equal(inv.cpu(), cinv)
    want = torch.unique(flat)
    assert torch.equal(cu[:want.numel()], want)
    assert not cu[want.numel():].any()
    assert torch.equal(cu[cinv], flat)


@pytest.mark.cuda
def test_sharded_lookup_scatter_add_on_card_equals_the_plain_one(
        cuda_device):
    """The owner's scatter-add of the returned row gradients (one
    ``index_add_`` per sending rank, empty slots to a dropped row): bit
    for bit the plain loop on the CPU, as no row takes two additions in
    one call. Under the deduplicating gather's backward (rows that several
    lookups share, summed in another order on the card) the whole grad
    within rtol 1e-6 of the CPU's."""
    from paddle_tpu_torch.distributed.embedding.sharded import _RowGather
    rng = np.random.RandomState(5)
    w = torch.from_numpy(rng.randn(1000, 9).astype(np.float32))
    lidx = torch.from_numpy(rng.randint(0, 1000, (4, 300)))
    for j in range(4):                 # a sender's rows are distinct
        lidx[j] = torch.from_numpy(rng.permutation(1000)[:300])
    valid = torch.from_numpy(rng.rand(4, 300) > 0.2)
    g = torch.from_numpy(rng.randn(4, 300, 9).astype(np.float32))
    inv = torch.from_numpy(rng.randint(0, 1200, 5000))
    got = {}
    for dev in ("cpu", cuda_device):
        wt = w.clone().to(dev).requires_grad_()
        served = _RowGather.apply(wt, lidx.to(dev), valid.to(dev))
        flat = served.reshape(-1, 9)
        out = torch.nn.functional.embedding(inv.to(dev), flat)
        (out * g.to(dev).reshape(-1, 9)[inv.to(dev) % 1200]
         ).sum().backward()
        got[dev] = wt.grad.cpu()
    torch.testing.assert_close(got[cuda_device], got["cpu"], rtol=1e-6,
                               atol=1e-6)
    wt = w.clone().to(cuda_device).requires_grad_()
    _RowGather.apply(wt, lidx.to(cuda_device),
                     valid.to(cuda_device)).backward(g.to(cuda_device))
    plain = torch.zeros(1001, 9)
    dest = torch.where(valid, lidx, torch.full_like(lidx, 1000))
    for j in range(4):
        plain.index_add_(0, dest[j], g[j])
    assert torch.equal(wt.grad.cpu(), plain[:1000])


# ---- the eager core on the card ----

def _op_cases():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_op_cases
    return torch_op_cases


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_op_cases().CASES))
def test_eager_op_on_card_matches_cpu(cuda_device, name):
    """Each op of the table on card tensors against the same port op on
    CPU tensors (tests/torch_op_cases.py: float32 rtol 1e-4, atol 1e-5),
    every output on the card."""
    import paddle_tpu_torch as P
    assert _op_cases().sweep_case(P, name, "cuda") >= 1


@pytest.mark.cuda
def test_creation_ops_and_to_tensor_land_on_the_card(cuda_device):
    import numpy as np
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import device as pdev
    pdev._state.device = None                     # no device named
    made = [P.to_tensor([1.0, 2.0]), P.to_tensor(np.ones(3)),
            P.to_tensor(torch.ones(2)), P.zeros([2]), P.ones([2]),
            P.full([2], 1.0), P.empty([2]), P.arange(4), P.linspace(0, 1, 3),
            P.logspace(0, 1, 3), P.eye(2), P.tril_indices(3),
            P.triu_indices(3), P.rand([2]), P.randn([2]),
            P.randint(0, 3, [2]), P.uniform([2]), P.normal(0.0, 1.0, [2]),
            P.randperm(4), P.create_parameter([2, 2], "float32"),
            P.fill_constant([2], "float32", 1.0), P.create_tensor("float32"),
            P.create_global_var([2], 1.0, "float32"),
            P.gaussian([2]), P.zeros_like(P.zeros([2]))]
    for t in made:
        assert t.device.type == "cuda" and isinstance(t, P.Tensor), t.place
    assert P.to_tensor([1.0], place="cpu").place == "cpu"


@pytest.mark.cuda
def test_port_tensors_through_a_captured_step_equal_eager(cuda_device):
    """A step over port Tensors, captured once and replayed, equals the
    same step run eagerly."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.jit import capture
    w = P.randn([64, 64])
    x = P.randn([8, 64])

    def fn(a, out):
        y = P.tanh(P.matmul(a, w)) * 2.0 + 1.0
        out.copy_(P.sum(y, axis=1))
        return out
    out = P.zeros([8])
    step = capture.capture_step(fn, inplace=(1,))
    got = [step(x, out).clone() for _ in range(3)]
    assert step.cache_info()["lowerings"] == 1
    capture.set_step_capture_enabled(False)
    try:
        want = fn(x, P.zeros([8]))
    finally:
        capture.set_step_capture_enabled(True)
    for g in got:
        assert torch.equal(g, want)


# ---- the nn layers, the in-place family and the measurement API ----

def _nn_cases():
    _op_cases()                  # puts tests/ on the path
    import torch_nn_cases
    return torch_nn_cases


@pytest.mark.cuda
def test_nn_sweep_on_card_matches_cpu(cuda_device):
    """Every functional, layer and initializer of the nn tables on the
    card against the CPU, placement included; BatchNorm2D's running
    statistics after 3 steps."""
    import paddle_tpu_torch as P
    assert _nn_cases().sweep_nn(P, "cuda") >= 150


@pytest.mark.cuda
def test_inplace_ops_keep_their_storage_on_card(cuda_device):
    import paddle_tpu_torch as P
    oc = _op_cases()
    names = [n for n in oc.CASES if n.endswith("_")
             and oc.module_of(n, P.ops)[0] == "breadth"]
    kept = [n for n in names if oc.inplace_keeps_storage(P, n, "cuda")]
    assert len(names) == 78
    assert sorted(set(names) - set(kept)) == sorted(oc.INPLACE_REBINDS)


@pytest.mark.cuda
def test_device_counters_events_and_streams(cuda_device):
    import paddle_tpu_torch as P
    d = P.device
    x = torch.randn(1024, 1024, device="cuda")
    assert d.memory_allocated() == torch.cuda.memory_allocated()
    assert d.max_memory_allocated() == torch.cuda.max_memory_allocated()
    assert d.memory_reserved() == torch.cuda.memory_reserved()
    stats = d.memory_stats()
    assert stats["bytes_limit"] == torch.cuda.mem_get_info()[1]
    assert stats["num_allocs"] > 0
    a, b = d.Event(enable_timing=True), d.Event(enable_timing=True)
    a.record()
    for _ in range(20):
        y = x @ x
    b.record()
    b.synchronize()
    assert b.elapsed_time(a) < 0 < a.elapsed_time(b)
    s = d.Stream()
    s.wait_stream(d.current_stream())
    with d.stream_guard(s):
        assert d.current_stream() == s
        z = x @ x
    d.current_stream().wait_stream(s)
    torch.testing.assert_close(z, y, rtol=0, atol=0)
    assert d.cuda.get_device_properties().name == \
        torch.cuda.get_device_name()
    del x, y, z


@pytest.mark.cuda
def test_initializers_and_layers_land_on_the_card(cuda_device):
    import paddle_tpu_torch as P
    P.set_device("cuda")
    I = P.nn.initializer
    for name in I.__all__:
        cls = getattr(I, name)
        if not isinstance(cls, type) or name in ("Initializer", "ParamAttr",
                                                 "Assign"):
            continue
        p = P.create_parameter([4, 4, 3, 3], "float32")
        cls()(p)
        assert p.is_cuda, name
    for layer in (P.nn.LayerNorm(8), P.nn.BatchNorm2D(3),
                  P.nn.MultiHeadAttention(8, 2), P.nn.PReLU(),
                  P.nn.Bilinear(2, 3, 4), P.nn.GroupNorm(1, 3)):
        for t in list(layer.parameters()) + list(layer.buffers()):
            assert t.is_cuda, type(layer).__name__


@pytest.mark.cuda
def test_one_profiled_step_records_its_ops(cuda_device):
    import paddle_tpu_torch as P
    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    P.set_device("cuda")
    m = GPTForCausalLM(GPTConfig.tiny(hidden_dropout_prob=0.0,
                                      attention_probs_dropout_prob=0.0))
    ids = P.to_tensor(np.arange(32).reshape(2, 16) % 128)
    with debugging.collect_operator_stats() as st:
        m(ids, labels=ids)[1].backward()
    prof = P.profiler.Profiler()
    prof.start()
    with P.profiler.RecordEvent("step"):
        m(ids, labels=ids)[1].backward()
    prof.step()
    prof.stop()
    ops = [e for e in prof.events() if e["cat"] == "op"]
    assert len(ops) == sum(st.stats.values())
    assert P.ops.dispatch._quiet


# ---- the kernel operators (torch.library) and the static/export tier ----

def _ops_cases(dev):
    g = torch.Generator(device=dev).manual_seed(7)

    def r(*s, dtype=torch.bfloat16):
        return (0.5 * torch.randn(*s, generator=g, device=dev)).to(dtype)
    q, k, v = r(2, 256, 8, 64), r(2, 256, 4, 64), r(2, 256, 4, 64)
    qd, kc, vc = r(3, 1, 8, 64), r(3, 128, 4, 64), r(3, 128, 4, 64)
    lengths = torch.tensor([1, 77, 128], dtype=torch.int32, device=dev)
    h, w = r(64, 256), r(256, 512)
    labels = torch.randint(0, 512, (64,), generator=g, device=dev)
    return [
        ("flash_attention_fwd", fa.flash_attention_fwd,
         (q, k, v, True, None), fa.flash_attention_fwd_ref),
        ("ragged_decode_attention",
         __import__("paddle_tpu_torch.ops.kernels.decode_attention",
                    fromlist=["x"]).ragged_decode_attention,
         (qd, kc, vc, lengths, None), ragged_decode_attention_ref),
        ("fused_ce_fwd", fce.fused_ce_fwd, (h, w, labels, 0),
         fce.fused_ce_fwd_ref),
    ]


@pytest.mark.cuda
def test_kernel_operators_launch_their_kernels_and_count(cuda_device):
    """``torch.ops.paddle_tpu_torch.<op>`` on card tensors runs the
    kernel (its wrapper's counter rises by one a call) and agrees with the
    plain version."""
    for name, wrapper, args, ref in _ops_cases(cuda_device):
        op = getattr(torch.ops.paddle_tpu_torch, name)
        before = wrapper.launches
        got = op(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, name
        want = ref(*args)
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        for a, b in zip(got, want):
            assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape
            scale = float(b.float().abs().max().clamp_min(1.0))
            assert float((a.float() - b.float()).abs().max()) <= \
                2 ** -6 * scale, name


@pytest.mark.cuda
def test_register_fake_gives_the_kernel_shapes(cuda_device):
    """On meta tensors (a static Program's shape inference) and under a
    FakeTensor trace each operator gives the kernel's output shapes and
    dtypes, and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    for name, wrapper, args, _ in _ops_cases(cuda_device):
        op = getattr(torch.ops.paddle_tpu_torch, name)
        real = op(*args)
        real = real if isinstance(real, (tuple, list)) else (real,)
        before = wrapper.launches
        meta = op(*[a.to("meta") if isinstance(a, torch.Tensor) else a
                    for a in args])
        meta = meta if isinstance(meta, (tuple, list)) else (meta,)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor)
                        else a for a in args])
        fake = fake if isinstance(fake, (tuple, list)) else (fake,)
        assert wrapper.launches == before, name
        for r, m, f in zip(real, meta, fake):
            assert (m.shape, m.dtype) == (r.shape, r.dtype), name
            assert (f.shape, f.dtype, f.device.type) == (r.shape, r.dtype,
                                                         "cuda"), name


def _tiny_llama(dev, seed=0):
    cfg = LlamaConfig.tiny(vocab=128, hidden=64, layers=2, heads=4,
                           inter=128)
    return LlamaForCausalLM(cfg, device=dev, seed=seed)


@pytest.mark.cuda
def test_kernel_failure_in_a_graph_raises_and_never_takes_the_plain_path(
        cuda_device, monkeypatch):
    """A K2 launch that fails inside a to_static or an Executor graph
    raises (after its bailout to eager, which launches again and fails
    again); the plain version never runs on card tensors."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import static
    P.set_device("cuda")
    plain = []
    ref = fa.flash_attention_fwd_ref

    def spy(q, *a, **k):
        plain.append(q.device.type)
        return ref(q, *a, **k)
    monkeypatch.setattr(fa, "flash_attention_fwd_ref", spy)

    def fail(fn_name, *a):
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError 700")
    monkeypatch.setattr(fa, "_launch", fail)
    m = _tiny_llama(cuda_device)
    ids = P.to_tensor(np.arange(32).reshape(2, 16) % 128)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        P.to_static(m.llama)(ids)
    static.enable_static()
    try:
        main = static.Program()
        with static.program_guard(main):
            x = static.data("ids", [2, 16], "int64")
            loss = m.compute_loss(x, x)
        with pytest.raises(RuntimeError, match="cudaError 700"):
            static.Executor().run(main, feed={"ids": ids.numpy()},
                                  fetch_list=[loss])
    finally:
        static.disable_static()
    assert "cuda" not in plain


@pytest.mark.cuda
def test_to_static_runs_as_graphs_and_counts_replayed_launches(cuda_device):
    """The tiny decoder under to_static on the card: the first call is the
    eager warm-up, then one forward and one backward graph; each replay
    adds K2 = layers and its backward K3 = K4 = layers; outputs and grads
    equal the eager model's (the same kernels replay)."""
    import paddle_tpu_torch as P
    P.set_device("cuda")
    m = _tiny_llama(cuda_device)
    ids = P.to_tensor(np.arange(32).reshape(2, 16) % 128)
    h_e = m.llama(ids)
    h_e.float().square().sum().backward()
    g_e = {n: p.grad.clone() for n, p in m.llama.named_parameters()}
    # drop the eager graph: a live AccumulateGrad node made on the default
    # stream would break the backward graph's capture (a bailout)
    h_e = h_e.detach().clone()
    m.llama.clear_gradients()
    sp = P.to_static(m.llama)
    sf = m.llama._static_function
    for i in range(3):
        for p in m.llama.parameters():
            p.grad = None
        c0 = [fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq
              .launches, fa.flash_attention_bwd_dkv.launches]
        h = sp(ids)
        h.float().square().sum().backward()
        torch.cuda.synchronize()
        c1 = [fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq
              .launches, fa.flash_attention_bwd_dkv.launches]
        assert [b - a for a, b in zip(c0, c1)] == [2, 2, 2], i
        torch.testing.assert_close(h, h_e, rtol=1e-5, atol=1e-5)
        for n, p in m.llama.named_parameters():
            torch.testing.assert_close(p.grad, g_e[n], rtol=1e-4,
                                       atol=1e-5)
    info = sf.cache_info()
    assert info["graphs"] == 2 and info["bailouts"] == 0, info
    assert info["hits"] == 2 and info["lowerings"] == 1, info


def _grads(layer):
    return {n: p.grad.clone() for n, p in layer.named_parameters()}


@pytest.mark.cuda
def test_to_static_calls_keep_their_outputs_and_grads(cuda_device):
    """Two calls of one signature before their outputs are read or
    backpropagated, held against eager: no-grad replays return copies;
    with grads the second forward runs eagerly while the first replay's
    backward is pending (counted in ``in_flight``); two backwards in a row
    accumulate, the second replay overwriting neither the first's
    ``.grad`` nor its output."""
    import paddle_tpu_torch as P
    P.set_device("cuda")
    m = _tiny_llama(cuda_device)
    net = m.llama
    rs = np.random.RandomState(7)
    ids1, ids2 = (P.to_tensor(rs.randint(0, 128, (2, 16))) for _ in "ab")

    def sq(h):
        return h.float().square().sum()

    a_e, b_e = net(ids1), net(ids2)
    (sq(a_e) + 0.5 * sq(b_e)).backward()
    g_pair = _grads(net)
    net.clear_gradients()
    sq(net(ids1)).backward()
    sq(net(ids2)).backward()
    g_acc = _grads(net)
    # drop the eager graphs before any capture (see the test above)
    a_e, b_e = a_e.detach().clone(), b_e.detach().clone()
    net.clear_gradients()

    sp = P.to_static(net)
    sf = net._static_function
    sq(sp(ids1)).backward()                  # warm-up, then the graphs
    net.clear_gradients()
    a, b = sp(ids1), sp(ids2)                # a replay, then in flight
    torch.testing.assert_close(a, a_e, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b, b_e, rtol=1e-5, atol=1e-5)
    (sq(a) + 0.5 * sq(b)).backward()
    for n, p in net.named_parameters():
        torch.testing.assert_close(p.grad, g_pair[n], rtol=1e-4, atol=1e-5)
    net.clear_gradients()
    a = sp(ids1)                             # two replays and backwards
    sq(a).backward()
    b = sp(ids2)
    sq(b).backward()
    for n, p in net.named_parameters():
        torch.testing.assert_close(p.grad, g_acc[n], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(a, a_e, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b, b_e, rtol=1e-5, atol=1e-5)
    info = sf.cache_info()
    assert info["in_flight"] == 1 and info["bailouts"] == 0, info
    assert info["hits"] == 3, info

    with torch.no_grad():
        sp(ids1)                             # the no-grad warm-up
        a, b = sp(ids1), sp(ids2)
    torch.testing.assert_close(a, a_e, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b, b_e, rtol=1e-5, atol=1e-5)
    assert sf.cache_info()["hits"] == 5


@pytest.mark.cuda
def test_to_static_tensor_if_bails_out_with_its_reason(cuda_device):
    import paddle_tpu_torch as P
    P.set_device("cuda")

    @P.to_static
    def f(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = -x
        return y

    for v, want in (([1.0, 2.0], [2.0, 4.0]), ([-1.0, -2.0], [1.0, 2.0]),
                    ([3.0, 1.0], [6.0, 2.0])):
        np.testing.assert_allclose(f(P.to_tensor(v)).numpy(), want)
    info = f._static_function.cache_info()
    assert info["bailouts"] == 1 and info["graphs"] == 0, info
    assert "host sync" in info["bailout_reason"], info


@pytest.mark.cuda
def test_executor_run_is_one_graph_and_matches_the_cpu(cuda_device):
    """The tiny LLaMA as a static Program trained 3 AdamW runs on the card
    (one cache entry, one CUDA graph, no bailout) against the same
    Program on the CPU, fp32; each run feeds its own batch, so a replay
    that read a stale feed would fail."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import static
    toks = np.random.RandomState(3).randint(0, 128, (3, 2, 17))
    feeds = [{"ids": t[:, :-1], "labels": t[:, 1:].copy()} for t in toks]
    losses = {}
    state = _tiny_llama("cpu", seed=5).state_dict()
    for dev in ("cpu", "cuda"):
        P.set_device(dev)
        static.enable_static()
        try:
            main = static.Program()
            with static.program_guard(main):
                m = _tiny_llama(dev)
                m.load_state_dict(state)        # the same weights
                ids = static.data("ids", [2, 16], "int64")
                labels = static.data("labels", [2, 16], "int64")
                loss = m.compute_loss(ids, labels)
                P.optimizer.AdamW(1e-3, parameters=m.parameters()) \
                    .minimize(loss)
            exe = static.Executor()
            with static.scope_guard(static.Scope()):
                losses[dev] = [float(exe.run(main, feed=feed,
                                             fetch_list=[loss])[0])
                               for feed in feeds]
        finally:
            static.disable_static()
    info = exe.cache_info()
    assert info["entries"] == 1 and info["steps"][0]["graphs"] == 1, info
    assert info["steps"][0]["bailouts"] == 0, info
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.cuda
def test_cpu_artifact_launches_k2_on_the_card(cuda_device, tmp_path):
    import paddle_tpu_torch as P
    m = _tiny_llama("cpu")
    P.jit.save(m, str(tmp_path / "t"), input_spec=[
        P.jit.InputSpec([2, 16], "int64")])
    loaded = P.jit.load(str(tmp_path / "t"), device="cuda")
    rs = np.random.RandomState(4)
    for i in range(3):       # the warm-up, then graph replays
        ids = rs.randint(0, 128, (2, 16))
        before = fa.flash_attention_fwd.launches
        got = loaded(P.to_tensor(ids, place="cuda"))
        torch.cuda.synchronize()
        assert fa.flash_attention_fwd.launches == before + 2, i
        want = m.logits(P.to_tensor(ids, place="cpu")).detach()
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
