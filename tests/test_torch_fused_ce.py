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
