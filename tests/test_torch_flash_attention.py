"""Flash attention in the PyTorch port, held against the JAX package's
Pallas kernel on the CPU.

The port's CPU path is its plain versions (``flash_attention_fwd_ref``,
``flash_attention_bwd_dq_ref``, ``flash_attention_bwd_dkv_ref``) called
through the same ``torch.autograd.Function`` the card uses, in both
directions. The JAX side is ``paddle_tpu.ops.pallas.flash_attention``
run eagerly, which is the Pallas kernel in interpret mode on the CPU, as
tests/test_flash_attention.py runs it; LSE comes from ``_flash_fwd_impl``
sliced to Sq, grads from ``jax.vjp`` with a random cotangent. Inputs are
made with numpy from a seed and compared in fp32 at that file's
tolerances: atol 2e-4 on O and LSE, 2e-3 on dq, dk and dv. The CUDA
kernels themselves are held against the plain versions on the card in
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import (_flash_fwd_impl,
                                                   flash_attention as jax_fa)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.kernels import flash_attention as fa_mod
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_fwd)

CASES = [
    # (B, Sq, H, D, Hkv, causal, Sk): tests/test_flash_attention.py:21-27
    (2, 128, 2, 64, 2, False, 128),
    (2, 128, 2, 64, 2, True, 128),
    (1, 200, 4, 64, 4, True, 200),     # S not a multiple of any tile
    (2, 256, 4, 64, 2, True, 256),     # GQA 4 -> 2
    (1, 128, 2, 64, 2, False, 256),    # Sk != Sq, not causal
    (1, 64, 2, 64, 2, True, 128),      # causal Sq != Sk: top-left mask
    (1, 160, 4, 128, 1, True, 64),     # causal Sq > Sk, group 4, D 128
    (1, 129, 8, 96, 1, True, 129),     # group 8, D 96, S one past 128
    # D not a multiple of 8 (the card's wrappers pad it) and D = 80
    (1, 70, 4, 80, 2, True, 70),
    (1, 70, 4, 80, 2, False, 90),
    (1, 50, 2, 100, 1, True, 50),
    (2, 40, 2, 100, 2, False, 60),
]


def _inputs(B, Sq, H, D, Hkv, Sk, seed=0):
    r = np.random.RandomState(seed)
    q = r.randn(B, Sq, H, D).astype(np.float32)
    k = r.randn(B, Sk, Hkv, D).astype(np.float32)
    v = r.randn(B, Sk, Hkv, D).astype(np.float32)
    g = r.randn(B, Sq, H, D).astype(np.float32)
    return q, k, v, g


def _launches():
    return (fa_mod.flash_attention_fwd.launches,
            fa_mod.flash_attention_bwd_dq.launches,
            fa_mod.flash_attention_bwd_dkv.launches)


@pytest.mark.parametrize("B,Sq,H,D,Hkv,causal,Sk", CASES)
def test_forward_out_and_lse_match_pallas(B, Sq, H, D, Hkv, causal, Sk):
    q, k, v, _ = _inputs(B, Sq, H, D, Hkv, Sk)
    want_o, want_lse = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal, None)
    before = _launches()
    got_o, got_lse = flash_attention_fwd(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(v), causal)
    assert _launches() == before          # the CPU launches no kernel
    assert got_o.dtype == torch.float32 and got_lse.shape == (B, H, Sq)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=2e-4)
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(want_lse)[:, :, :Sq, 0], atol=2e-4)


@pytest.mark.parametrize("B,Sq,H,D,Hkv,causal,Sk", CASES)
def test_backward_grads_match_pallas(B, Sq, H, D, Hkv, causal, Sk):
    q, k, v, g = _inputs(B, Sq, H, D, Hkv, Sk, seed=1)
    out, vjp = jax.vjp(lambda a, b, c: jax_fa(a, b, c, causal, None),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = flash_attention(tq, tk, tv, causal)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               atol=2e-4)
    o.backward(torch.from_numpy(g))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=2e-3)


def test_backward_goes_through_the_plain_backward_not_autograd(monkeypatch):
    """The operator's registered backward calls the dq and dk/dv wrappers
    once each per backward; nothing differentiates through the plain
    forward."""
    q, k, v, g = _inputs(1, 32, 4, 16, 2, 32, seed=2)
    calls = []
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        orig = getattr(fa_mod, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(fa_mod, name, spy)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = flash_attention(tq, tk, tv, True)
    assert "paddle_tpu_torch_flash_attention_fwd" in o.grad_fn.name()
    o.backward(torch.from_numpy(g))
    assert calls == ["flash_attention_bwd_dq", "flash_attention_bwd_dkv"]


def test_causal_mask_is_top_left_and_masked_logits_are_finite():
    """Sq=4 < Sk=8, causal: query i sees keys 0..i (top-left), so query 0
    attends key 0 alone (O = v[0], LSE = its logit) and keys past Sq are
    never seen; sdpa_ref's bottom-right mask would let query 0 see keys
    0..4."""
    q, k, v, _ = _inputs(1, 4, 2, 8, 2, 8, seed=3)
    o, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True)
    s = (q[0, 0] * k[0, 0]).sum(-1) / np.sqrt(8)        # [H]
    np.testing.assert_allclose(o[0, 0].numpy(), v[0, 0], rtol=1e-6)
    np.testing.assert_allclose(lse[0, :, 0].numpy(), s, rtol=1e-6)
    v2 = v.copy()
    v2[:, 4:] = 1e6                                     # unseen keys
    o2, _ = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v2), causal=True)
    np.testing.assert_array_equal(o2.numpy(), o.numpy())
    assert np.isfinite(lse.numpy()).all()


def test_bfloat16_plain_path_matches_pallas_bf16():
    """In bf16 both sides round P to bf16 before P.V and return O in bf16,
    LSE in fp32: within two bf16 steps of max|O| (the two sum in different
    orders and round P against different running maxima)."""
    q, k, v, _ = _inputs(1, 128, 2, 64, 2, 128, seed=4)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want_o, want_lse = _flash_fwd_impl(qb, kb, vb, True, None)
    got_o, got_lse = flash_attention_fwd(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=True)
    assert got_o.dtype == torch.bfloat16 and got_lse.dtype == torch.float32
    want = np.asarray(want_o.astype(jnp.float32))
    np.testing.assert_allclose(got_o.float().numpy(), want,
                               atol=2 * 2.0 ** -8 * np.abs(want).max())
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(want_lse)[:, :, :128, 0], atol=2e-4)


def test_sdpa_takes_flash_without_a_mask_and_sdpa_ref_with_one(monkeypatch):
    import paddle_tpu_torch.nn.functional as fmod
    calls = []
    orig_fa, orig_ref = fmod._flash, fmod.sdpa_ref
    monkeypatch.setattr(fmod, "_flash",
                        lambda *a, **kw: calls.append("flash")
                        or orig_fa(*a, **kw))
    monkeypatch.setattr(fmod, "sdpa_ref",
                        lambda *a, **kw: calls.append("ref")
                        or orig_ref(*a, **kw))
    q, k, v, _ = _inputs(2, 16, 4, 8, 2, 16, seed=5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o = F.scaled_dot_product_attention(tq, tk, tv, is_causal=True)
    assert calls == ["flash"]
    mask = torch.zeros(2, 1, 16, 16)
    o2 = F.scaled_dot_product_attention(tq, tk, tv, attn_mask=mask,
                                        is_causal=True)
    assert calls == ["flash", "ref"]
    np.testing.assert_allclose(o.numpy(), o2.numpy(), atol=1e-5)
    o3 = F.scaled_dot_product_attention(tq.double(), tk.double(),
                                        tv.double(), is_causal=True)
    assert calls == ["flash", "ref", "ref"]         # float64: no kernel
    out, none = F.flash_attention(tq, tk, tv, causal=True)
    assert none is None and calls[-1] == "flash"
    np.testing.assert_allclose(out.numpy(), o.numpy(), atol=0)
    np.testing.assert_allclose(o3.numpy(), o.numpy(), atol=1e-5)


def test_sdp_attention_ref_matches_jax_reference():
    from paddle_tpu.nn.functional.attention import sdp_attention_ref as jref
    q, k, v, _ = _inputs(2, 12, 4, 8, 2, 12, seed=6)
    mask = np.where(np.random.RandomState(7).rand(2, 1, 12, 12) < 0.2,
                    -1e30, 0.0).astype(np.float32)
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(mask), 0.0, False, None))
    got = F.sdp_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("D,causal", [(80, True), (100, True), (100, False),
                                      (12, False)])
def test_padded_head_width_with_the_real_scale_equals_the_unpadded(D,
                                                                   causal):
    """The card's wrappers zero-pad D to a multiple of 8 (``_pad_d``) and
    pass the scale of the real D. The same rule through the plain versions:
    O, LSE, dQ, dK and dV of the padded call, sliced back, equal the
    unpadded ones (rtol 1e-5, atol 1e-6); the scale of the padded width
    would not."""
    q, k, v, g = (torch.from_numpy(x)
                  for x in _inputs(1, 24, 4, D, 2, 24, seed=8))
    padded = fa_mod._pad_d(q, k, v, g)
    Dp = padded[0].shape[-1]
    assert Dp % 8 == 0 and Dp - D < 8
    assert all(x.shape[-1] == Dp and not x[..., D:].any() for x in padded)
    scale = fa_mod._scale(None, D)
    o, lse = fa_mod.flash_attention_fwd_ref(q, k, v, causal)
    po, plse = fa_mod.flash_attention_fwd_ref(*padded[:3], causal, scale)
    torch.testing.assert_close(po[..., :D], o, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(plse, lse, rtol=1e-5, atol=1e-6)
    delta = (g * o).sum(-1).transpose(1, 2).contiguous()
    dq = fa_mod.flash_attention_bwd_dq_ref(q, k, v, g, lse, delta, causal)
    pdq = fa_mod.flash_attention_bwd_dq_ref(*padded, lse, delta, causal,
                                            scale)
    torch.testing.assert_close(pdq[..., :D], dq, rtol=1e-5, atol=1e-6)
    dk, dv = fa_mod.flash_attention_bwd_dkv_ref(q, k, v, g, lse, delta,
                                                causal)
    pdk, pdv = fa_mod.flash_attention_bwd_dkv_ref(*padded, lse, delta,
                                                  causal, scale)
    torch.testing.assert_close(pdk[..., :D], dk, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(pdv[..., :D], dv, rtol=1e-5, atol=1e-6)
    if Dp != D:
        wrong, _ = fa_mod.flash_attention_fwd_ref(*padded[:3], causal)
        assert not torch.allclose(wrong[..., :D], o, rtol=1e-5, atol=1e-6)


def test_strided_views_through_sdpa_equal_the_contiguous_call(monkeypatch):
    """q, k, v as transposed views ([B, H, S, D] storage seen as
    [B, S, H, D]) give the contiguous call's output and grads, and the
    flash entry hands the kernel contiguous tensors (the card's wrappers
    raise on strided ones)."""
    import paddle_tpu_torch.nn.functional as fmod
    seen = []
    orig = fmod._flash
    monkeypatch.setattr(fmod, "_flash", lambda *a, **kw: seen.append(
        all(x.is_contiguous() for x in a[:3])) or orig(*a, **kw))
    q, k, v, g = _inputs(2, 20, 4, 16, 2, 20, seed=9)
    dense = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    views = [torch.from_numpy(x.transpose(0, 2, 1, 3).copy())
             .requires_grad_() for x in (q, k, v)]
    strided = [x.transpose(1, 2) for x in views]
    assert not any(x.is_contiguous() for x in strided)
    want = F.scaled_dot_product_attention(*dense, is_causal=True)
    got = F.scaled_dot_product_attention(*strided, is_causal=True)
    assert seen == [True, True]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    want.backward(torch.from_numpy(g))
    got.backward(torch.from_numpy(g))
    for a, b in zip(views, dense):
        torch.testing.assert_close(a.grad.transpose(1, 2), b.grad, rtol=0,
                                   atol=0)
