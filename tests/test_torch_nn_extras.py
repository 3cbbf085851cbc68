"""The rest of the port's ``nn`` against the JAX package's, on the CPU:
``nn/functional/extras.py`` and ``nn/layer/extras.py`` (the
``EXTRAS_FCASES`` / ``EXTRAS_LCASES`` tables of ``tests/
torch_nn_cases.py``: distances, in-place activations, masks, unpooling,
the losses including ``hsigmoid_loss`` and ``rnnt_loss``, sampling grids,
``gather_tree``, ``sparse_attention``, the cell family), beam search,
``nn.utils`` and ``nn.quant``.

Values and grads at ``rtol=1e-5, atol=1e-6`` in float32 unless a case
states its own (``margin_cross_entropy`` scales logits by 64 and
``rnnt_loss`` runs a log-space DP: ``1e-4 / 1e-5``). ``gumbel_softmax``
draws from the port's generator, so its moments are held instead: the
Gumbel-max frequencies match the softmax, ``hard`` gives one-hot rows
with the soft gradient, and a seed repeats it.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.nn.quant  # noqa: F401 — J.nn.quant
import paddle_tpu.nn.utils  # noqa: F401 — J.nn.utils
import paddle_tpu.ops as jops
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as pdev

from test_torch_nn_layers import (check_functional, check_layer,
                                  functional_refs, layer_refs)
from torch_nn_cases import ATOL, EXTRAS_FCASES, EXTRAS_LCASES, RTOL, _f32, \
    _rng


@pytest.fixture(scope="module", autouse=True)
def _jax_uncached():
    jops.dispatch.set_op_cache_enabled(False)
    yield
    jops.dispatch.set_op_cache_enabled(True)


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


@pytest.fixture(scope="module")
def frefs():
    return functional_refs(EXTRAS_FCASES)


@pytest.fixture(scope="module")
def lrefs():
    return layer_refs(EXTRAS_LCASES)


@pytest.mark.parametrize("name", sorted(EXTRAS_FCASES))
def test_functional_against_jax(name, frefs):
    check_functional(name, EXTRAS_FCASES, frefs)


@pytest.mark.parametrize("name", sorted(EXTRAS_LCASES))
def test_layer_against_jax(name, lrefs):
    check_layer(name, EXTRAS_LCASES, lrefs)


def test_inplace_activation_writes_into_the_tensor():
    x = P.to_tensor(np.array([-1.0, 0.5, 2.0], np.float32))
    ptr = x.data_ptr()
    out = P.nn.functional.hardtanh_(x, -0.5, 0.5)
    assert out is x and x.data_ptr() == ptr
    np.testing.assert_array_equal(x.numpy(), [-0.5, 0.5, 0.5])


def test_gumbel_softmax_moments_hard_and_seed():
    F = P.nn.functional
    logits = np.log(np.array([[0.1, 0.2, 0.3, 0.4]], np.float32))
    x = P.to_tensor(np.repeat(logits, 20000, 0))
    P.seed(7, "cpu")
    soft = F.gumbel_softmax(x, temperature=0.5).numpy()
    np.testing.assert_allclose(soft.sum(-1), 1.0, rtol=1e-5)
    freq = np.bincount(soft.argmax(-1), minlength=4) / len(soft)
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=0.015)
    P.seed(7, "cpu")
    np.testing.assert_array_equal(F.gumbel_softmax(x, 0.5).numpy(), soft)
    xt = P.to_tensor(np.repeat(logits, 8, 0), stop_gradient=False)
    hard = F.gumbel_softmax(xt, hard=True, axis=-1)
    h = hard.numpy()
    assert set(np.unique(h)) <= {0.0, 1.0} and (h.sum(-1) == 1).all()
    P.sum(P.multiply(hard, P.to_tensor(np.arange(4, dtype=np.float32)))
          ).backward()
    assert np.abs(xt.grad.numpy()).sum() > 0        # the soft gradient


def _beam_pair(pkg, state):
    cell = pkg.nn.GRUCell(3, 4)
    cell.set_state_dict(state)
    emb = pkg.to_tensor(_f32(_rng("emb"), 6, 3))
    proj = pkg.to_tensor(_f32(_rng("proj"), 4, 6, lo=-3, hi=3))
    return pkg.nn.BeamSearchDecoder(
        cell, start_token=0, end_token=5, beam_size=3,
        embedding_fn=lambda ids: pkg.nn.functional.embedding(ids, emb),
        output_fn=lambda h: pkg.matmul(h, proj))


def test_beam_search_and_dynamic_decode_against_jax():
    jcell = J.nn.GRUCell(3, 4)
    state = {k: np.asarray(v.numpy()) for k, v in jcell.state_dict().items()}
    init = _f32(_rng("init"), 2, 4)
    res = {}
    for pkg in (J, P):
        dec = _beam_pair(pkg, state)
        ids, scores, lengths = pkg.nn.dynamic_decode(
            dec, pkg.to_tensor(init), max_step_num=7, return_length=True)
        res[pkg] = [_np(ids), _np(scores), _np(lengths)]
    np.testing.assert_array_equal(res[P][0], res[J][0])
    np.testing.assert_allclose(res[P][1], res[J][1], RTOL, 1e-4)
    np.testing.assert_array_equal(res[P][2], res[J][2])
    assert res[P][0].shape[:2] == (2, 3)


def _linear_pair(seed):
    r = _rng(seed)
    w, b = _f32(r, 4, 3), _f32(r, 3)
    out = []
    for pkg in (J, P):
        layer = pkg.nn.Linear(4, 3)
        layer.set_state_dict({"weight": w, "bias": b})
        out.append(layer)
    return out, _f32(r, 5, 4)


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_and_its_removal_against_jax(dim):
    (jl, pl), x = _linear_pair(f"wn{dim}")
    U = {J: J.nn.utils, P: P.nn.utils}
    for pkg, layer in ((J, jl), (P, pl)):
        U[pkg].weight_norm(layer, dim=dim)
    assert list(pl.state_dict()) == list(jl.state_dict())
    assert "weight" not in dict(pl.named_parameters())
    outs = {}
    for pkg, layer in ((J, jl), (P, pl)):
        y = layer(pkg.to_tensor(x))
        pkg.sum(pkg.multiply(y, y)).backward()
        outs[pkg] = [_np(y)] + [_np(p.grad) for _, p in
                                layer.named_parameters()]
        U[pkg].remove_weight_norm(layer)
        outs[pkg].append(_np(layer.weight))
    assert list(pl.state_dict()) == list(jl.state_dict())
    for k, (a, b) in enumerate(zip(outs[P], outs[J])):
        np.testing.assert_allclose(a, b, RTOL, ATOL, err_msg=str(k))


def test_spectral_norm_against_jax():
    r = _rng("sn")
    w = _f32(r, 3, 2, 3, 3)
    outs = {}
    for pkg in (J, P):
        conv = pkg.nn.Conv2D(2, 3, 3, bias_attr=False)
        conv.set_state_dict({"weight": w})
        pkg.nn.utils.spectral_norm(conv, n_power_iterations=2)
        x = pkg.to_tensor(_f32(_rng("snx"), 1, 2, 5, 5))
        y = conv(x)
        pkg.sum(pkg.multiply(y, y)).backward()
        y2 = conv(x)
        outs[pkg] = [list(conv.state_dict()), _np(conv.weight_u),
                     _np(conv.weight_v), _np(y), _np(conv.weight_orig.grad),
                     _np(y2)]
    assert outs[P][0] == outs[J][0]
    for k, (a, b) in enumerate(zip(outs[P][1:], outs[J][1:])):
        np.testing.assert_allclose(a, b, 1e-5, 1e-5, err_msg=str(k))


def test_vectors_and_grad_clips_against_jax():
    r = _rng("clip")
    arrays = [_f32(r, 3, 4), _f32(r, 5), _f32(r, 2, 2)]
    grads = [_f32(r, *a.shape, lo=-3, hi=3) for a in arrays]
    res = {}
    for pkg in (J, P):
        U = pkg.nn.utils
        ps = [pkg.create_parameter(list(a.shape), "float32") for a in arrays]
        for p, a in zip(ps, arrays):
            p.set_value(a)
        vec = U.parameters_to_vector(ps)
        U.vector_to_parameters(pkg.multiply(vec, pkg.to_tensor(
            np.float32(2.0))), ps)
        out = [_np(vec)] + [_np(p) for p in ps]
        for norm_type in (2.0, float("inf")):
            for p, g in zip(ps, grads):
                p.grad = pkg.to_tensor(g.copy())
            total = U.clip_grad_norm_(ps, 1.5, norm_type)
            out += [_np(total)] + [_np(p.grad) for p in ps]
        U.clip_grad_value_(ps, 0.1)
        out += [_np(p.grad) for p in ps]
        res[pkg] = out
    for k, (a, b) in enumerate(zip(res[P], res[J])):
        np.testing.assert_allclose(a, b, RTOL, ATOL, err_msg=str(k))


@pytest.mark.parametrize("algo", ["weight_only_int8", "llm.int8",
                                  "weight_only_int4"])
def test_weight_quantize_and_the_quantized_linears_against_jax(algo):
    r = _rng(algo)
    w = _f32(r, 8, 6, lo=-2, hi=2)
    x = _f32(r, 3, 8, lo=-8, hi=8)
    x3 = _f32(r, 2, 3, 8, lo=-8, hi=8)
    b = _f32(r, 6)
    res = {}
    for pkg in (J, P):
        Q = pkg.nn.quant
        q, s = Q.weight_quantize(pkg.to_tensor(w), algo=algo)
        out = [_np(q), _np(s)]
        args = (pkg.to_tensor(b), s)
        out.append(_np(Q.weight_only_linear(pkg.to_tensor(x), q, *args)))
        out.append(_np(Q.weight_only_linear(pkg.to_tensor(x), q)))
        out.append(_np(Q.llm_int8_linear(pkg.to_tensor(x), q, *args,
                                         threshold=6.0)))
        out.append(_np(Q.llm_int8_linear(pkg.to_tensor(x3), q, None, s)))
        res[pkg] = out
    assert res[P][0].dtype == np.int8
    lo = -8 if algo == "weight_only_int4" else -128
    assert res[P][0].min() >= lo and res[P][0].max() <= -lo - 1
    for k, (a, b_) in enumerate(zip(res[P], res[J])):
        np.testing.assert_allclose(a, b_, 1e-5, 1e-5, err_msg=str(k))


def test_weight_quantize_refuses_another_algorithm_and_stub_is_identity():
    for pkg in (J, P):
        with pytest.raises(ValueError):
            pkg.nn.quant.weight_quantize(pkg.to_tensor(np.ones((2, 2),
                                                               np.float32)),
                                         algo="fp8")
    x = P.to_tensor(np.arange(3, dtype=np.float32))
    assert P.nn.quant.Stub()(x) is x
