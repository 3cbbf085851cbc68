"""Ragged decode attention in the PyTorch port, held against the JAX package.

The port's plain version (``ragged_decode_attention_ref``) must equal the
JAX ``ragged_decode_attention`` called eagerly, which runs the Pallas kernel
in interpret mode on the CPU, at the JAX test's own tolerance (rtol 1e-5,
atol 1e-6; tests/test_pallas_fused_kernels.py:129-140). The wrapper takes
the plain version for CPU tensors and launches nothing there. The CUDA
kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.decode_attention import (
    ragged_decode_attention as jax_ragged)
from paddle_tpu_torch.ops.kernels.decode_attention import (
    ragged_decode_attention, ragged_decode_attention_ref)


def _inputs(B, S, H, hkv, D, seed=0):
    r = np.random.RandomState(seed)
    q = (r.randn(B, 1, H, D) * 0.5).astype(np.float32)
    k = (r.randn(B, S, hkv, D) * 0.5).astype(np.float32)
    v = (r.randn(B, S, hkv, D) * 0.5).astype(np.float32)
    return q, k, v


CASES = [
    # (B, S_max, H, Hkv, D, lengths)
    (3, 384, 8, 8, 64, [1, 200, 384]),       # MHA, the JAX test's shape
    (3, 384, 8, 4, 64, [1, 200, 384]),       # GQA
    (4, 300, 8, 4, 64, [0, 1, 150, 300]),    # a length-0 row, S_max % 256 != 0
]


@pytest.mark.parametrize("B,S,H,hkv,D,lengths", CASES)
def test_plain_version_matches_jax_interpret_kernel(B, S, H, hkv, D, lengths):
    q, k, v = _inputs(B, S, H, hkv, D)
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(jax_ragged(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens)))
    got = ragged_decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if 0 in lengths:
        assert not got[lengths.index(0)].any()


def _split_kv(q, k, v, lengths, scale):
    """The CUDA kernel's split-KV algebra in plain torch (fp32): splits =
    min(8, ceil(S_max / 256)) ranks, rank r owning key positions
    [r chunk, (r + 1) chunk) with chunk = ceil(S_max / splits); the ranks
    that hold live keys (rank 0 always) each give a partial (m, l, acc)
    over their live keys, an empty one at m = -1e30, l = 0, acc = 0; the
    partials merged in rank order by the max-rescaled sum, l clamped to
    1e-30."""
    B, _, H, D = q.shape
    S, hkv = k.shape[1], k.shape[2]
    splits = min(8, -(-S // 256))
    chunk = -(-S // splits)
    qg = q.reshape(B, hkv, H // hkv, D)
    out = torch.zeros_like(qg)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), S)
        parts = []
        for r in range(max(1, -(-n // chunk))):
            c0, c1 = r * chunk, min((r + 1) * chunk, n)
            if c1 <= c0:
                parts.append((torch.full(qg.shape[1:3], -1e30),
                              torch.zeros(qg.shape[1:3]),
                              torch.zeros(qg.shape[1:])))
                continue
            s = torch.einsum("hgd,shd->hgs", qg[b], k[b, c0:c1]) * scale
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1),
                          torch.einsum("hgs,shd->hgd", p, v[b, c0:c1])))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum = sum(l * torch.exp(m - mx) for m, l, _ in parts)
        acc = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
        out[b] = acc / lsum.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, D)


@pytest.mark.parametrize("H,hkv", [(4, 4), (8, 1)])   # group 1 and group 8
@pytest.mark.parametrize("S", [600, 2048])            # chunks of 200 and 256
def test_split_kv_merge_matches_jax_interpret_kernel(S, H, hkv):
    """Lengths 0, 1, one chunk, one chunk + 1 and S_max: empty ranks, a
    rank with one key, a boundary met exactly and crossed by one key."""
    chunk = -(-S // min(8, -(-S // 256)))
    lengths = [0, 1, chunk, chunk + 1, S]
    q, k, v = _inputs(len(lengths), S, H, hkv, 64, seed=2)
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(jax_ragged(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens)))
    got = _split_kv(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), lens, 1.0 / 8.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not got[0].any()


def test_cpu_wrapper_takes_plain_version_and_launches_nothing():
    q, k, v = _inputs(3, 384, 8, 4, 64, seed=1)
    lens = torch.tensor([5, 0, 384], dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    saved, ragged_decode_attention.launches = \
        ragged_decode_attention.launches, 0
    try:
        got = ragged_decode_attention(tq, tk, tv, lens, scale=0.2)
        assert ragged_decode_attention.launches == 0
    finally:
        ragged_decode_attention.launches = saved
    torch.testing.assert_close(
        got, ragged_decode_attention_ref(tq, tk, tv, lens, scale=0.2),
        rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["q_rank", "cache_shape", "heads", "lengths"])
def test_wrapper_rejects_mismatched_shapes(bad):
    q = torch.zeros(2, 1, 8, 64)
    k = torch.zeros(2, 16, 4, 64)
    lens = torch.ones(2, dtype=torch.int32)
    if bad == "q_rank":
        q = torch.zeros(2, 8, 64)
    elif bad == "cache_shape":
        k = torch.zeros(2, 16, 4, 32)
    elif bad == "heads":
        q = torch.zeros(2, 1, 6, 64)
    else:
        lens = torch.ones(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        ragged_decode_attention(q, k, torch.zeros_like(k), lens)
