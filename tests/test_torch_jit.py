"""The port's compile/export tier against the JAX package's.

Every case of ``tests/test_jit.py`` on the port (``to_static`` of a
function and of a Layer, a training loop, ``jit.save`` / ``jit.load``,
``paddle.save`` / ``load``, dropout under ``to_static``, and the six
dy2static cases), each result held against the JAX package's on the same
inputs where the two compute the same thing; plus ``to_static`` of the
tiny LLaMA decoder stack (outputs and every grad against the JAX
``to_static``), ``.pdmeta`` equal to the JAX file and ``.pdiparams`` equal
to its arrays, the exported tiny LLaMA naming the K2 operator with the
loaded output against the JAX ``jit.load``, a tensor ``if`` kept through
``jit.save`` by ``torch.cond`` (as the JAX export keeps it with
``lax.cond``), and a bfloat16 model's weights through ``.pdiparams``.

On the CPU ``to_static`` runs eagerly (the CUDA graphs are the card's:
tests/test_torch_cuda.py and chip_smoke.py). Tolerances: fp32, rtol 1e-5
/ atol 1e-6 per op; the LLaMA's outputs and grads and the exported
program's outputs at rtol 1e-4 / atol 1e-5, its grads at rtol 1e-4 /
atol 1e-4 (a different summation order per matmul across layers; the
grads reach ~40).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.core import device as pdev
from paddle_tpu_torch.jit import InputSpec

RTOL, ATOL = 1e-5, 1e-6
TINY = dict(vocab=64, hidden=32, layers=2, heads=4, inter=64)


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


def _t(a, stop_gradient=True):
    return (P.to_tensor(np.asarray(a, np.float32), stop_gradient=stop_gradient),
            J.to_tensor(np.asarray(a, np.float32), stop_gradient=stop_gradient))


def _copy_params(pm, jm):
    with torch.no_grad():
        for (_, p), (_, q) in zip(pm.named_parameters(),
                                  jm.named_parameters()):
            p.copy_(torch.from_numpy(np.asarray(q._value).copy()))


def test_to_static_function():
    calls = []

    @P.to_static
    def f(x):
        calls.append(1)   # eager on the CPU: the body runs each call
        return x * 2.0 + 1.0

    y1 = f(P.to_tensor([1.0, 2.0]))
    y2 = f(P.to_tensor([3.0, 4.0]))
    np.testing.assert_allclose(y1.numpy(), [3.0, 5.0])
    np.testing.assert_allclose(y2.numpy(), [7.0, 9.0])
    jf = J.to_static(lambda x: x * 2.0 + 1.0)
    np.testing.assert_allclose(y2.numpy(),
                               jf(J.to_tensor([3.0, 4.0])).numpy())
    assert len(calls) == 2
    info = f._static_function.cache_info()
    assert info["eager_calls"] == 2 and info["graphs"] == 0


def test_to_static_layer_grads_match_eager():
    P.seed(3)
    model = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 2))
    J.seed(3)
    jmodel = J.nn.Sequential(J.nn.Linear(4, 8), J.nn.Tanh(),
                             J.nn.Linear(8, 2))
    _copy_params(model, jmodel)
    xv = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    x = P.to_tensor(xv)

    out_e = model(x)
    out_e.sum().backward()
    grads_e = [p.grad.numpy().copy() for p in model.parameters()]
    model.clear_gradients()

    static_model = P.to_static(model)
    out_s = static_model(x)
    np.testing.assert_allclose(out_s.numpy(), out_e.numpy(), rtol=RTOL,
                               atol=ATOL)
    out_s.sum().backward()
    grads_s = [p.grad.numpy() for p in model.parameters()]
    for ge, gs in zip(grads_e, grads_s):
        np.testing.assert_allclose(gs, ge, rtol=RTOL, atol=ATOL)
    jout = J.to_static(jmodel)(J.to_tensor(xv))
    jout.sum().backward()
    np.testing.assert_allclose(out_s.numpy(), jout.numpy(), rtol=RTOL,
                               atol=ATOL)
    for gs, jp in zip(grads_s, jmodel.parameters()):
        np.testing.assert_allclose(gs, jp.grad.numpy(), rtol=RTOL, atol=ATOL)


def test_to_static_training_loop():
    P.seed(5)
    model = nn.Sequential(nn.Linear(2, 16), nn.ReLU(), nn.Linear(16, 1))
    model = P.to_static(model)
    opt = P.optimizer.Adam(learning_rate=0.02, parameters=model.parameters())
    xv = np.random.RandomState(5).randn(64, 2).astype(np.float32)
    x = P.to_tensor(xv)
    y = P.to_tensor(xv[:, :1] * 2.0 + 1.0)
    first = None
    for _ in range(100):
        loss = P.nn.functional.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        if first is None:
            first = float(loss.numpy())
    assert float(loss.numpy()) < 0.05 * first


def test_jit_save_load(tmp_path):
    model = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    J.seed(6)
    jmodel = J.nn.Sequential(J.nn.Linear(4, 8), J.nn.ReLU(),
                             J.nn.Linear(8, 2))
    _copy_params(model, jmodel)
    model.eval()
    path = str(tmp_path / "model/infer")
    P.jit.save(model, path, input_spec=[InputSpec([None, 4], "float32")])
    assert os.path.exists(path + ".pdmodel")
    J.jit.save(jmodel, str(tmp_path / "j/infer"),
               input_spec=[J.jit.InputSpec([None, 4], "float32")])

    loaded = P.jit.load(path)
    jloaded = J.jit.load(str(tmp_path / "j/infer"))
    for bs in (1, 3):
        xv = np.random.RandomState(bs).randn(bs, 4).astype(np.float32)
        got = loaded(P.to_tensor(xv)).numpy()
        np.testing.assert_allclose(got, model(P.to_tensor(xv)).numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, jloaded(J.to_tensor(xv)).numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_paddle_save_load(tmp_path):
    model = nn.Linear(3, 3)
    path = str(tmp_path / "ckpt.pdparams")
    P.save(model.state_dict(), path)
    sd = P.load(path)
    model2 = nn.Linear(3, 3)
    model2.set_state_dict(sd)
    np.testing.assert_allclose(model2.weight.detach().numpy(),
                               model.weight.detach().numpy())


def test_static_dropout_varies_across_calls():
    drop = nn.Dropout(0.5)
    drop.train()
    model = P.to_static(drop)
    x = P.ones([1000])
    y1 = model(x).numpy()
    y2 = model(x).numpy()
    assert not np.allclose(y1, y2)
    for y in (y1, y2):   # upscale_in_train: kept values are 1 / (1 - p)
        assert set(np.unique(y)) <= {0.0, 2.0}


# ---- data-dependent control flow (dy2static) ----

def test_to_static_tensor_if_changes_across_calls():
    def body(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = -x
        return y + 1.0
    f, jf = P.to_static(body), J.to_static(body)
    for v in ([1.0, 2.0], [-1.0, -2.0]):
        pt, jt = _t(v)
        np.testing.assert_allclose(f(pt).numpy(), jf(jt).numpy())
    np.testing.assert_allclose(f(P.to_tensor([1.0, 2.0])).numpy(),
                               [3.0, 5.0])
    np.testing.assert_allclose(f(P.to_tensor([-1.0, -2.0])).numpy(),
                               [2.0, 3.0])


def test_to_static_tensor_while_loop():
    def body(x):
        s = x
        while s.sum() < 100.0:
            s = s * 2.0
        return s
    f, jf = P.to_static(body), J.to_static(body)
    for v, want in (([1.0, 2.0], [64.0, 128.0]), ([30.0, 40.0],
                                                   [60.0, 80.0])):
        pt, jt = _t(v)
        np.testing.assert_allclose(f(pt).numpy(), want)
        np.testing.assert_allclose(f(pt).numpy(), jf(jt).numpy())


def test_to_static_bool_ops_in_condition():
    def body(x, lo, hi):
        if (x.sum() > lo) and not (x.sum() > hi):
            r = x + 100.0
        else:
            r = x - 100.0
        return r
    f, jf = P.to_static(body), J.to_static(body)
    for lo, want in ((0.0, [101.0, 102.0]), (5.0, [-99.0, -98.0])):
        (pt, jt), (pl, jl), (ph, jh) = _t([1.0, 2.0]), _t(lo), _t(10.0)
        np.testing.assert_allclose(f(pt, pl, ph).numpy(), want)
        np.testing.assert_allclose(f(pt, pl, ph).numpy(),
                                   jf(jt, jl, jh).numpy())


def test_to_static_python_if_still_static():
    hits = []

    @P.to_static
    def f(x, flag):
        if flag:
            hits.append(1)
            return x * 2.0
        return x * 3.0

    a = f(P.to_tensor([1.0]), True)
    b = f(P.to_tensor([1.0]), False)
    np.testing.assert_allclose(a.numpy(), [2.0])
    np.testing.assert_allclose(b.numpy(), [3.0])
    assert hits == [1]


def test_to_static_if_grads_flow_through_cond():
    def body(x):
        if x.sum() > 0:
            y = x * 3.0
        else:
            y = x * 5.0
        return y.sum()
    f, jf = P.to_static(body), J.to_static(body)
    for v, g in (([1.0, 1.0], 3.0), ([-1.0, -1.0], 5.0)):
        pt, jt = _t(v, stop_gradient=False)
        f(pt).backward()
        jf(jt).backward()
        np.testing.assert_allclose(pt.grad.numpy(), [g, g])
        np.testing.assert_allclose(pt.grad.numpy(), jt.grad.numpy())


def test_to_static_eager_call_of_converted_fn():
    from paddle_tpu_torch.jit.dy2static import convert_control_flow

    def f(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = -x
        return y

    g = convert_control_flow(f)
    assert g is not f
    np.testing.assert_allclose(g(P.to_tensor([2.0])).numpy(), [4.0])
    np.testing.assert_allclose(g(P.to_tensor([-2.0])).numpy(), [2.0])


# ---- beyond test_jit.py ----

def _llama_pair(dtype=torch.float32):
    from paddle_tpu.models import LlamaConfig as JC
    from paddle_tpu.models import LlamaForCausalLM as JL
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_paddle_tpu_state)
    J.seed(11)
    jm = JL(JC.tiny(**TINY))
    pm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    load_paddle_tpu_state(pm, {n: np.asarray(p._value)
                               for n, p in jm.named_parameters()})
    return jm, pm


def _ids(shape=(2, 12), seed=4):
    return np.random.RandomState(seed).randint(0, TINY["vocab"], shape)


def test_to_static_llama_decoder_matches_jax():
    """``to_static(model.llama)`` (the decoder stack, as the training path
    wraps it): hidden states and every parameter's grad of a weighted sum
    against the JAX ``to_static``."""
    jm, pm = _llama_pair()
    ids = _ids()
    w = np.random.RandomState(9).randn(2, 12, TINY["hidden"]).astype(
        np.float32)
    sp = P.to_static(pm.llama)
    h = sp(P.to_tensor(ids))
    (h * P.to_tensor(w)).sum().backward()
    jh = J.to_static(jm.llama)(J.to_tensor(ids))
    (jh * J.to_tensor(w)).sum().backward()
    np.testing.assert_allclose(h.numpy(), jh.numpy(), rtol=1e-4, atol=1e-5)
    jg = {n: p.grad.numpy() for n, p in jm.llama.named_parameters()}
    for n, p in pm.llama.named_parameters():
        # atol 1e-4 against grads up to ~40 (the embedding's rows sum the
        # repeated tokens' grads in another order)
        np.testing.assert_allclose(p.grad.numpy(), jg[n], rtol=1e-4,
                                   atol=1e-4, err_msg=n)


def test_llama_save_files_and_program_match_jax(tmp_path):
    """``jit.save`` of the tiny causal LM at the fixed spec ``[2, 12]``
    int64 (the JAX export refuses a dynamic batch for LLaMA): ``.pdmeta``
    equal to the JAX file, ``.pdiparams`` equal to its arrays, the
    exported graph naming ``paddle_tpu_torch::flash_attention_fwd`` (K2,
    never inlined), and the loaded logits against the JAX ``jit.load``'s
    and the eager ``logits``."""
    jm, pm = _llama_pair()
    jpath, ppath = str(tmp_path / "j/llama"), str(tmp_path / "p/llama")
    J.jit.save(jm, jpath, input_spec=[J.jit.InputSpec([2, 12], "int64")])
    P.jit.save(pm, ppath, input_spec=[InputSpec([2, 12], "int64")])
    with open(jpath + ".pdmeta") as a, open(ppath + ".pdmeta") as b:
        assert a.read() == b.read()
    with np.load(jpath + ".pdiparams.npz") as a, \
            np.load(ppath + ".pdiparams") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k])
    with open(ppath + ".pdmodel", "rb") as f:
        ep = torch.export.load(f)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("paddle_tpu_torch.flash_attention_fwd.default") \
        == TINY["layers"]
    assert not any("bmm" in t or "softmax" in t for t in targets)
    ids = _ids()
    got = P.jit.load(ppath)(P.to_tensor(ids)).numpy()
    want = J.jit.load(jpath)(J.to_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, pm.logits(P.to_tensor(ids)).detach()
                               .numpy(), rtol=1e-5, atol=1e-6)


class _Branchy(nn.Layer):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(4, 4)

    def forward(self, x):
        y = self.lin(x)
        if y.sum() > 0:
            z = y * 2.0
        else:
            z = y - 10.0
        return z


class _JBranchy(J.nn.Layer):
    def __init__(self):
        super().__init__()
        self.lin = J.nn.Linear(4, 4)

    def forward(self, x):
        y = self.lin(x)
        if y.sum() > 0:
            z = y * 2.0
        else:
            z = y - 10.0
        return z


def test_tensor_if_kept_through_jit_save(tmp_path):
    """A to_static Layer with a tensor ``if``: the exported program holds
    ``torch.cond`` (the JAX export holds ``lax.cond``), so the loaded
    program takes either branch by the input, as the JAX one does."""
    J.seed(12)
    jl = J.to_static(_JBranchy())
    pl = P.to_static(_Branchy())
    _copy_params(pl, jl)
    J.jit.save(jl, str(tmp_path / "j"), input_spec=[
        J.jit.InputSpec([2, 4], "float32")])
    P.jit.save(pl, str(tmp_path / "p"), input_spec=[
        InputSpec([2, 4], "float32")])
    with open(str(tmp_path / "p.pdmodel"), "rb") as f:
        ep = torch.export.load(f)
    assert any("cond" in str(n.target) for n in ep.graph.nodes)
    jload, pload = J.jit.load(str(tmp_path / "j")), P.jit.load(
        str(tmp_path / "p"))
    outs = []
    for v in (5.0, -5.0):
        xv = np.full((2, 4), v, np.float32)
        got = pload(P.to_tensor(xv)).numpy()
        np.testing.assert_allclose(got, jload(J.to_tensor(xv)).numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, pl(P.to_tensor(xv)).numpy(),
                                   rtol=RTOL, atol=ATOL)
        outs.append(got)
    assert not np.allclose(outs[0], outs[1])


def test_bfloat16_weights_through_pdiparams(tmp_path):
    """bf16 weights are written as the JAX writer's 2-byte void and come
    back as bf16, bit for bit."""
    model = nn.Linear(4, 3)
    model.to(torch.bfloat16)
    P.jit.save(model, str(tmp_path / "b"), input_spec=[
        InputSpec([None, 4], "bfloat16")])
    with np.load(str(tmp_path / "b.pdiparams")) as npz:
        assert npz["0"].dtype == np.dtype("V2")
    loaded = P.jit.load(str(tmp_path / "b"))
    assert loaded._param_vals[0].dtype == torch.bfloat16
    assert torch.equal(loaded._param_vals[0].view(torch.int16),
                       model.weight.detach().view(torch.int16))
    x = P.to_tensor(np.ones((2, 4), np.float32)).astype("bfloat16")
    assert torch.equal(loaded(x).as_subclass(torch.Tensor),
                       model(x).detach().as_subclass(torch.Tensor))


class _Loopy(nn.Layer):
    def forward(self, x):
        s = x
        while s.sum() < 100.0:
            s = s * 2.0
        return s


class _JLoopy(J.nn.Layer):
    def forward(self, x):
        s = x
        while s.sum() < 100.0:
            s = s * 2.0
        return s


def test_tensor_while_kept_through_jit_save(tmp_path):
    """A tensor ``while`` in a to_static Layer exports as ``while_loop``
    (the JAX export: ``lax.while_loop``): the loaded program runs as many
    iterations as each input needs."""
    pl, jl = P.to_static(_Loopy()), J.to_static(_JLoopy())
    P.jit.save(pl, str(tmp_path / "p"), input_spec=[
        InputSpec([2], "float32")])
    J.jit.save(jl, str(tmp_path / "j"), input_spec=[
        J.jit.InputSpec([2], "float32")])
    with open(str(tmp_path / "p.pdmodel"), "rb") as f:
        ep = torch.export.load(f)
    assert any("while_loop" in str(n.target) for n in ep.graph.nodes)
    pload, jload = P.jit.load(str(tmp_path / "p")), J.jit.load(
        str(tmp_path / "j"))
    for v, want in (([1.0, 2.0], [64.0, 128.0]), ([30.0, 40.0],
                                                   [60.0, 80.0])):
        got = pload(P.to_tensor(v)).numpy()
        np.testing.assert_allclose(got, want)
        np.testing.assert_allclose(got, jload(J.to_tensor(v)).numpy())
