"""Fused linear + cross-entropy in the PyTorch port, held against the JAX
package's Pallas kernels on the CPU.

The port's CPU path is its plain versions (``fused_ce_fwd_ref``,
``fused_ce_bwd_dh_ref``, ``fused_ce_bwd_dw_ref``) called through the same
wrappers and ``torch.autograd.Function`` the card uses. The JAX side is
``paddle_tpu.ops.pallas.fused_ce`` run eagerly, which is the Pallas kernel
in interpret mode on the CPU, as tests/test_pallas_fused_kernels.py runs
it. Inputs are made with numpy from a seed and compared in fp32: the
forward at rtol 1e-5 / atol 1e-6, the grads at rtol 1e-4 / atol 1e-6 (that
file's tolerances). The CUDA kernels themselves are held against the plain
versions on the card in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.ops.pallas.fused_ce import (
    fused_linear_ce_partials as jax_partials,
    fused_linear_cross_entropy as jax_flce)
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.ops.kernels import fused_ce as fce
from paddle_tpu_torch.ops.kernels.fused_ce import (
    fused_linear_ce_partials, fused_linear_cross_entropy)

SHAPES = [(24, 64, 1000), (13, 50, 777)]     # (N, H, V); the second unaligned


def _data(n, hd, v, seed=0):
    r = np.random.RandomState(seed)
    h = (r.randn(n, hd) * 0.3).astype(np.float32)
    w = (r.randn(hd, v) * 0.1).astype(np.float32)
    return h, w, r.randint(0, v, (n,))


def _launches():
    return (fce.fused_ce_fwd.launches, fce.fused_ce_bwd_dh.launches,
            fce.fused_ce_bwd_dw.launches)


@pytest.mark.parametrize("n,hd,v", SHAPES)
def test_forward_matches_pallas(n, hd, v):
    h, w, lab = _data(n, hd, v, seed=3)
    want = jax_flce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab,
                                                                 jnp.int32))
    before = _launches()
    got = fused_linear_cross_entropy(torch.from_numpy(h), torch.from_numpy(w),
                                     torch.from_numpy(lab))
    assert _launches() == before          # the CPU launches no kernel
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n,hd,v", SHAPES)
def test_partials_with_a_vocab_offset_match_pallas(n, hd, v):
    """Labels are global ids over a vocab of 3 V; this shard holds
    [V, 2 V), so about two thirds of the rows have z = 0."""
    h, w, _ = _data(n, hd, v, seed=4)
    lab = np.random.RandomState(5).randint(0, 3 * v, (n,))
    lab[:3] = [v - 1, v, 2 * v - 1]       # just outside, first and last
    want = jax_partials(jnp.asarray(h), jnp.asarray(w),
                        jnp.asarray(lab, jnp.int32), vocab_offset=v)
    got = fused_linear_ce_partials(torch.from_numpy(h), torch.from_numpy(w),
                                   torch.from_numpy(lab), vocab_offset=v)
    for name, g, wv in zip("mlz", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    z = got[2].numpy()
    outside = (lab < v) | (lab >= 2 * v)
    assert outside.sum() > 0 and (z[outside] == 0).all()
    assert (z[~outside] != 0).all()


@pytest.mark.parametrize("n,hd,v", SHAPES)
def test_grads_for_a_per_row_cotangent_match_pallas(n, hd, v):
    h, w, lab = _data(n, hd, v, seed=1)
    g = np.random.RandomState(2).randn(n).astype(np.float32)
    g[1] = 0.0                            # a row that adds nothing
    jl = jnp.asarray(lab, jnp.int32)
    dh, dw = jax.grad(lambda a, b: jnp.sum(jax_flce(a, b, jl) * g),
                      argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    loss = fused_linear_cross_entropy(th, tw, torch.from_numpy(lab))
    assert loss.grad_fn.__class__.__name__ == "_FusedLinearCEBackward"
    loss.backward(torch.from_numpy(g))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw), rtol=1e-4,
                               atol=1e-6)
    assert not th.grad[1].any()


def _split_vocab(h, w, labels, vocab_offset, tile, splits):
    """K5's split-vocab algebra in plain torch (fp32): vocab tiles of
    `tile` columns, W zero-filled past V as TMA fills it; split k takes
    tiles [k t, (k + 1) t) with t = ceil(tiles / splits) and folds them into
    an online (m, l, z) per row, columns at or past V at -1e30 for the max
    and left out of the sum, z the logit at the local label when it lies in
    the tile and below V; then the splits merged per row as
    fce_merge_kernel does: M = max m_k, L = sum l_k exp(m_k - M), z = sum
    z_k."""
    N, H = h.shape
    V = w.shape[1]
    nvt = -(-V // tile)
    per = -(-nvt // splits)
    lab = labels.long() - vocab_offset
    parts = []
    for k in range(splits):
        m, l, z = torch.full((N,), -1e30), torch.zeros(N), torch.zeros(N)
        for vt in range(k * per, min((k + 1) * per, nvt)):
            v0 = vt * tile
            wt = torch.zeros(H, tile)
            wt[:, :min(tile, V - v0)] = w[:, v0:v0 + tile]
            col = v0 + torch.arange(tile)
            real = col < V
            s = torch.where(real, h @ wt, torch.tensor(-1e30))
            hit = (col[None] == lab[:, None]) & real
            z = z + torch.where(hit, s, torch.zeros(())).sum(1)
            mn = torch.maximum(m, s.amax(1))
            p = torch.where(real, torch.exp(s - mn[:, None]), torch.zeros(()))
            l = l * torch.exp(m - mn) + p.sum(1)
            m = mn
        parts.append((m, l, z))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = sum(l * torch.exp(m - M) for m, l, _ in parts)
    return M, L, sum(z for _, _, z in parts)


# (N, H, V, vocab_offset, kind, tile, splits): the launch plan that
# fused_ce.cu's fwd_splits makes for the shape on a 132-SM H100 (held
# against the library on the card by test_torch_cuda.py's
# test_fused_ce_fwd_splits_fill_one_wave_without_empty_splits). The Hopper
# kernel's 256-wide tiles with one split (one tile; three tiles when 133
# row blocks fill the wave), one tile a split, and three tiles a split (34
# row blocks leave room for 3 splits in a wave); the mma.sync kernel's
# 128-wide tiles; V not a multiple of the tile with labels in the last,
# partial tile ("last"); a vocab offset; every logit negative ("neg"), so
# a padded column taken as s = 0 would win the max.
SPLIT_CASES = [
    (24, 64, 200, 0, "any", 256, 1),
    (24, 64, 1000, 0, "last", 256, 4),
    (24, 64, 1000, 600, "any", 256, 4),
    (4352, 32, 2056, 0, "last", 256, 3),
    (40, 64, 2056, 0, "neg", 256, 9),
    (4352, 32, 2056, 0, "neg", 256, 3),
    (16900, 16, 600, 0, "last", 256, 1),
    (13, 50, 777, 0, "last", 128, 7),
]


@pytest.mark.parametrize("n,hd,v,offset,kind,tile,splits", SPLIT_CASES)
def test_split_vocab_partials_match_jax_interpret_kernel(n, hd, v, offset,
                                                         kind, tile, splits):
    h, w, lab = _data(n, hd, v, seed=7)
    if kind == "neg":
        h, w = np.abs(h), -np.abs(w)
    if kind == "last":           # labels in the last, partial tile
        lab = v - 1 - lab % (v - (v - 1) // tile * tile)
    if offset:                   # global ids; a third outside the shard
        lab = np.random.RandomState(8).randint(0, v + offset + v // 2, (n,))
    want = jax_partials(jnp.asarray(h), jnp.asarray(w),
                        jnp.asarray(lab, jnp.int32), vocab_offset=offset)
    got = _split_vocab(torch.from_numpy(h), torch.from_numpy(w),
                       torch.from_numpy(lab), offset, tile, splits)
    for name, g, wv in zip("mlz", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    if kind == "neg":
        assert v % tile and (got[0] < 0).all()
    if kind == "last":
        assert v % tile and (lab >= v // tile * tile).all()


def test_backward_goes_through_the_dh_and_dw_wrappers(monkeypatch):
    """The autograd.Function calls the dh and dW wrappers once each per
    backward, and only the one whose input needs a grad."""
    h, w, lab = _data(6, 16, 40, seed=6)
    calls = []
    for name in ("fused_ce_bwd_dh", "fused_ce_bwd_dw"):
        orig = getattr(fce, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(fce, name, spy)
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w)
    fused_linear_cross_entropy(th, tw, torch.from_numpy(lab)).sum().backward()
    assert calls == ["fused_ce_bwd_dh"]
    tw.requires_grad_()
    fused_linear_cross_entropy(th, tw, torch.from_numpy(lab)).sum().backward()
    assert calls == ["fused_ce_bwd_dh", "fused_ce_bwd_dh", "fused_ce_bwd_dw"]


def test_incubate_entry_mean_loss_grad_matches_jax_incubate():
    import paddle_tpu.incubate.nn.functional as JIF
    h, w, lab = _data(24, 64, 1000, seed=4)
    th, tw = P.Tensor(jnp.asarray(h)), P.Tensor(jnp.asarray(w))
    th.stop_gradient = False
    tw.stop_gradient = False
    want = JIF.fused_linear_cross_entropy(th, tw,
                                          P.Tensor(jnp.asarray(lab,
                                                               jnp.int32)))
    want.mean().backward()
    ph, pw = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    got = IF.fused_linear_cross_entropy(ph, pw, torch.from_numpy(lab))
    got.mean().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want.numpy()),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ph.grad.numpy(), np.asarray(th.grad.numpy()),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pw.grad.numpy(), np.asarray(tw.grad.numpy()),
                               rtol=1e-4, atol=1e-6)


def test_wrappers_raise_on_shapes_and_labels_they_cannot_take():
    h, w, lab = (torch.from_numpy(x) for x in _data(4, 8, 20))
    with pytest.raises(ValueError):                   # h not [N, H]
        fce.fused_ce_fwd(h[None], w, lab)
    with pytest.raises(ValueError):                   # H mismatch
        fce.fused_ce_fwd(h, w[:7], lab)
    with pytest.raises(ValueError):                   # labels not [N]
        fce.fused_ce_fwd(h, w, lab[:3])
    with pytest.raises(TypeError):                    # float labels
        fce.fused_ce_fwd(h, w, lab.float())
    lse = torch.zeros(4)
    with pytest.raises(TypeError):
        fce.fused_ce_bwd_dh(h, w, lab.bool(), lse, lse)
    with pytest.raises(ValueError):
        fce.fused_ce_bwd_dw(h, w.t(), lab, lse, lse)
