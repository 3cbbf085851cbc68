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
# boundary; the 8-layer training model's 75 shapes at 1/64 of each dim.
MT_SIZES = {
    "one": [(1,)],
    "empty": [(0,), (1,), (0,)],
    "odd": [(n,) for n in (1, 3, 7, 15, 17, 31, 33, 127, 129, 255, 257,
                           1023, 1031)],
    "misaligned": "misaligned",
    "model_div64": model_shapes(div=64),
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
    assert mt.multi_tensor_sumsq_finite.launches == n1 + 1
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
            assert mt.multi_tensor_adam.launches == n2 + int(
                sum(p.numel() for p in ps) > 0)
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
        # cached_step with a Python int offset copies it to the card
        step = capture.capture_step(m._cached_step, inplace=(1,))
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
