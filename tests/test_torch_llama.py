"""The PyTorch port's LLaMA, held against the JAX package's on the CPU.

Both models carry the same weights (the JAX model's parameters handed
across as ``{name: np.ndarray}`` through ``load_paddle_tpu_state``) at
``LlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4, inter=64)``,
once with 4 kv heads (MHA) and once with 2 (GQA). Logits must agree within
rtol 1e-4 / atol 1e-5 in fp32: the two libraries sum their matmuls in
different orders. Greedy tokens must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.models.llama import (
    LlamaConfig, LlamaForCausalLM, _rope, load_paddle_tpu_state)
from paddle_tpu_torch.nn.functional import rms_norm, sdpa_ref
from paddle_tpu_torch.ops.kernels.decode_attention import (
    ragged_decode_attention)

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(vocab=64, hidden=32, layers=2, heads=4, inter=64)


def _pair(kv_heads, seed=3):
    """(jax model, port model on the CPU) over the same weights."""
    P.seed(seed)
    jcfg = JaxConfig.tiny(**TINY)
    jcfg.num_key_value_heads = kv_heads
    jm = JaxLlama(jcfg)
    cfg = LlamaConfig.tiny(**TINY)
    cfg.num_key_value_heads = kv_heads
    pm = LlamaForCausalLM(cfg, device="cpu")
    state = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    load_paddle_tpu_state(pm, state)
    return jm, pm


def _ids(shape, seed=5):
    return np.random.RandomState(seed).randint(0, TINY["vocab"], shape)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_no_cache_forward_logits_match_jax(kv_heads):
    jm, pm = _pair(kv_heads)
    ids = _ids((2, 9))
    want = np.asarray(jm(P.to_tensor(ids)).numpy())
    got = pm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_slot_steps_match_jax_prefill_then_ragged_decode(kv_heads):
    """A bucketed [B, 8] prefill (rows padded on the right, logits picked
    at last_pos) and three [B, 1] decode steps with a different offset per
    slot: logits, argmax tokens and the caches agree."""
    jm, pm = _pair(kv_heads)
    B, bucket, s_max = 3, 8, 24
    plens = np.asarray([3, 8, 5])
    tok = np.zeros((B, bucket), np.int64)
    for b, n in enumerate(plens):
        tok[b, :n] = _ids((n,), seed=10 + b)

    jstep = jm._build_slot_step(return_logits=True)
    params = [p._value for p in jm.parameters()]
    jcaches = [(kc._value, vc._value)
               for kc, vc in jm.init_kv_caches(B, s_max)]
    pcaches = pm.init_kv_caches(B, s_max)

    def both(tok, off, last_pos):
        nonlocal jcaches
        jn, jl, jcaches = jstep(params, jnp.asarray(tok), jcaches,
                                jnp.asarray(off, jnp.int32),
                                jnp.asarray(last_pos, jnp.int32))
        pn, pl = pm.slot_step(torch.from_numpy(tok), pcaches,
                              torch.from_numpy(off.astype(np.int32)),
                              torch.from_numpy(last_pos.astype(np.int32)),
                              return_logits=True)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
        assert pn.dtype == torch.int32
        return pn.numpy()

    nxt = both(tok, np.zeros(B, np.int64), plens - 1)
    off = plens.copy()
    for _ in range(3):
        nxt = both(nxt.reshape(B, 1).astype(np.int64), off,
                   np.zeros(B, np.int64))
        off = off + 1
    for (jk, jv), (pk, pv) in zip(jcaches, pcaches):
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_generate_matches_jax_with_and_without_cache(kv_heads):
    jm, pm = _pair(kv_heads)
    ids = _ids((2, 5), seed=7)
    want = np.asarray(jm.generate(P.to_tensor(ids), max_new_tokens=6)
                      .numpy())
    for use_cache in (True, False):
        got = pm.generate(torch.from_numpy(ids), max_new_tokens=6,
                          use_cache=use_cache).numpy()
        np.testing.assert_array_equal(got, want)


def test_generate_eos_pads_finished_rows_like_jax():
    jm, pm = _pair(4, seed=11)
    ids = _ids((2, 4), seed=8)
    base = pm.generate(torch.from_numpy(ids), max_new_tokens=6).numpy()
    eos = int(base[0, 4 + 1])   # row 0's second generated token
    want = np.asarray(jm.generate(P.to_tensor(ids), max_new_tokens=6,
                                  eos_token_id=eos, pad_token_id=0).numpy())
    got = pm.generate(torch.from_numpy(ids), max_new_tokens=6,
                      eos_token_id=eos, pad_token_id=0).numpy()
    np.testing.assert_array_equal(got, want)


def test_decode_step_goes_through_the_kernel_wrapper_only_for_s1():
    _, pm = _pair(2)
    calls = []
    orig = ragged_decode_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)

    import paddle_tpu_torch.models.llama as mod
    mod.ragged_decode_attention = spy
    try:
        caches = pm.init_kv_caches(2, 16)
        pm.cached_step(torch.from_numpy(_ids((2, 6))), caches, 0)
        assert calls == []                  # prefill: masked plain path
        pm.cached_step(torch.zeros(2, 1, dtype=torch.int64), caches, 6)
        assert len(calls) == TINY["layers"]  # one launch per layer
    finally:
        mod.ragged_decode_attention = orig


def test_rope_rotates_interleaved_pairs_with_per_slot_offsets():
    from paddle_tpu.models.llama import _rope as jax_rope
    r = np.random.RandomState(0)
    q = r.randn(3, 2, 4, 8).astype(np.float32)
    k = r.randn(3, 2, 2, 8).astype(np.float32)
    for off in (5, np.asarray([0, 7, 300], np.int32)):
        jq, jk = jax_rope(jnp.asarray(q), jnp.asarray(k), 10000.0,
                          jnp.asarray(off, jnp.int32))
        pq, pk = _rope(torch.from_numpy(q), torch.from_numpy(k), 10000.0,
                       torch.as_tensor(off))
        np.testing.assert_allclose(pq.numpy(), np.asarray(jq), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), rtol=1e-5,
                                   atol=1e-5)


def test_rms_norm_and_masked_sdpa_match_jax():
    from paddle_tpu.nn.functional.attention import _sdpa_ref
    from paddle_tpu.nn.functional.norm import rms_norm as jax_rms
    r = np.random.RandomState(1)
    x = r.randn(2, 3, 16).astype(np.float32)
    w = r.randn(16).astype(np.float32)
    want = np.asarray(jax_rms(P.to_tensor(x), P.to_tensor(w)).numpy())
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    q = r.randn(2, 3, 4, 8).astype(np.float32)
    kv = r.randn(2, 10, 2, 8).astype(np.float32)
    mask = np.where(np.arange(10)[None, None, :]
                    <= np.arange(3)[None, :, None] + np.asarray([2, 6])
                    [:, None, None], 0.0, -1e30)[:, None].astype(np.float32)
    for causal, m in ((False, mask), (True, None)):
        want = np.asarray(_sdpa_ref(jnp.asarray(q), jnp.asarray(kv),
                                    jnp.asarray(kv),
                                    None if m is None else jnp.asarray(m),
                                    0.0, causal, None))
        got = sdpa_ref(torch.from_numpy(q), torch.from_numpy(kv),
                       torch.from_numpy(kv),
                       None if m is None else torch.from_numpy(m),
                       causal=causal).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_load_paddle_tpu_state_rejects_missing_unexpected_and_shape():
    jm, pm = _pair(4)
    state = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    bad = dict(state)
    bad.pop("lm_head.weight")
    with pytest.raises(KeyError):
        load_paddle_tpu_state(pm, bad)
    bad = dict(state, extra=np.zeros(1))
    with pytest.raises(KeyError):
        load_paddle_tpu_state(pm, bad)
    bad = dict(state)
    bad["llama.norm.weight"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError):
        load_paddle_tpu_state(pm, bad)


def test_port_init_is_seeded_xavier_normal_and_ones():
    cfg = LlamaConfig.tiny(**TINY)
    a = LlamaForCausalLM(cfg, device="cpu", seed=1)
    b = LlamaForCausalLM(cfg, device="cpu", seed=1)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
        if p.dim() == 1:
            assert bool((p == 1).all()), n
    w = a.llama.layers[0].mlp.gate_proj.weight      # [32, 64]
    assert abs(float(w.std()) - (2.0 / (32 + 64)) ** 0.5) < 0.03


@pytest.mark.parametrize("field,value", [
    ("tie_word_embeddings", True), ("use_flash_attention", False),
    ("recompute", True), ("sequence_parallel", False),
    ("context_parallel", None)])
def test_config_takes_the_reference_fields_with_its_defaults(field, value):
    """Every field of the reference's LlamaConfig exists with its default
    and builds a model when set (the mesh-sharding two only at their
    defaults here: set, they raise, see the next test)."""
    ref, port = JaxConfig(), LlamaConfig()
    assert getattr(port, field) == getattr(ref, field)
    cfg = LlamaConfig.tiny(**TINY)
    setattr(cfg, field, value)
    built = LlamaConfig(**{**vars(cfg)})
    assert getattr(built, field) == value
    LlamaForCausalLM(built, device="cpu")
    assert set(vars(JaxConfig())) <= set(vars(LlamaConfig()))


@pytest.mark.parametrize("knob", [{"sequence_parallel": True},
                                  {"context_parallel": "ring"},
                                  {"context_parallel": "ulysses"}])
def test_sequence_and_context_parallel_raise_not_in_this_slice(knob):
    """Both knobs are ported now (tests/test_torch_hybrid.py runs them on
    meshes); with no mesh, sequence parallelism is the plain model and
    context parallelism raises for want of a sep axis, as the JAX
    function does."""
    cfg = LlamaConfig(**{**vars(LlamaConfig.tiny(**TINY)), **knob})
    for k, v in knob.items():
        assert getattr(cfg, k) == v           # stored as the reference
    pm = LlamaForCausalLM(cfg, device="cpu")
    plain = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    ids = torch.arange(8).reshape(1, 8)
    if "context_parallel" in knob:
        with pytest.raises(ValueError, match="sep"):
            pm.logits(ids)
    else:
        torch.testing.assert_close(pm.logits(ids), plain.logits(ids),
                                   rtol=0, atol=0)
