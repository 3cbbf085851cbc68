"""The port's mixture-of-experts layer and the layers its experts are
built from, held against the JAX package.

- ``MoELayer`` with the gshard (top-2), switch and naive gates (d 16,
  E 4, hidden 32), the JAX layer's weights carried across: output,
  ``l_aux`` and the grads of the input, the gate and every expert at
  rtol 1e-5 (loss ``sum(y * cot) + 0.1 * l_aux``), also where the
  capacity drops tokens;
- the same layer over ``ep2`` on spawned gloo ranks (each rank holds two
  experts) against one JAX device;
- the routing's capacity and the drop order against the JAX layer's;
- ``Linear``, ``GELU``, ``Sequential`` and ``LayerList``: state-dict keys
  and outputs against the JAX layers.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as jnn
from paddle_tpu.distributed.fleet import moe as jmoe
from paddle_tpu_torch.distributed.fleet import moe as tmoe
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.layer import GELU, LayerList, Linear, Sequential

import torch_dist

RTOL, ATOL = 1e-5, 1e-6
D, E, H = 16, 4, 32
AUX_W = 0.1

# name -> (gate, top_k, capacity_factor, token shape)
CASES = {
    "gshard_top2": ("gshard", 2, 1.25, (2, 6)),
    "switch": ("switch", 2, 1.25, (2, 6)),
    "naive_top2": ("naive", 2, 1.25, (2, 6)),
    "gshard_capacity_drops": ("gshard", 2, 0.3, (3, 8)),
}


def _jax_layer(name, seed=5):
    gate, k, cf, _ = CASES[name]
    P.seed(seed)
    return jmoe.MoELayer(D, gate=gate, num_experts=E, top_k=k,
                         capacity_factor=cf, d_hidden=H)


def _inputs(name):
    shape = CASES[name][3] + (D,)
    r = np.random.RandomState(sum(map(ord, name)))
    return (r.randn(*shape).astype(np.float32),
            r.randn(*shape).astype(np.float32))


def _jax_run(name):
    layer = _jax_layer(name)
    x_np, cot = _inputs(name)
    x = P.to_tensor(x_np, stop_gradient=False)
    y = layer(x)
    loss = (y * P.to_tensor(cot)).sum() + AUX_W * layer.l_aux
    loss.backward()
    state = {n: np.asarray(p._value) for n, p in layer.named_parameters()}
    grads = {n: np.asarray(p.grad._value)
             for n, p in layer.named_parameters()}
    return dict(state=state, y=np.asarray(y._value),
                l_aux=float(layer.l_aux.numpy()),
                dx=np.asarray(x.grad._value), grads=grads, x=x_np, cot=cot)


def _case_payload(name, ref):
    gate, k, cf, _ = CASES[name]
    return dict(name=name, d=D, E=E, h=H, gate=gate, k=k, cf=cf,
                state=ref["state"], x=ref["x"], cot=ref["cot"], aux_w=AUX_W)


def _check(got, ref, name):
    np.testing.assert_allclose(got["y"], ref["y"], rtol=RTOL, atol=ATOL,
                               err_msg=name)
    np.testing.assert_allclose(got["l_aux"], ref["l_aux"], rtol=RTOL)
    np.testing.assert_allclose(got["dx"], ref["dx"], rtol=RTOL, atol=ATOL,
                               err_msg=name)
    for n, g in got["grads"].items():
        np.testing.assert_allclose(g, ref["grads"][n], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {n}")


@pytest.mark.parametrize("name", list(CASES))
def test_moe_layer_matches_jax(name):
    ref = _jax_run(name)
    got = torch_dist.SCENARIOS["moe_ep"]({"cases": [_case_payload(name,
                                                                  ref)]})
    got = got[name]
    assert got["ep"] == 1 and set(got["grads"]) == set(ref["grads"])
    _check(got, ref, name)


def test_capacity_drops_tokens_in_token_order():
    """The drop case really drops: the port's dispatch keeps fewer slots
    than T*k, and exactly the JAX layer's (the first tokens of each
    expert's queue)."""
    name = "gshard_capacity_drops"
    jl = _jax_layer(name)
    x_np, _ = _inputs(name)
    toks = x_np.reshape(-1, D)
    T, k = toks.shape[0], CASES[name][1]
    cap = max(int(np.ceil(CASES[name][2] * T * k / E)), k)
    logits = toks @ np.asarray(jl.gate.weight._value)
    disp, comb, _ = tmoe.route(torch.from_numpy(logits), k, cap)
    assert 0 < int(disp.sum()) < T * k
    port = tmoe.MoELayer(D, gate="gshard", num_experts=E, top_k=k,
                         capacity_factor=CASES[name][2], d_hidden=H,
                         device="cpu")
    assert port.capacity(T) == cap
    # each expert's kept slots are its first `cap` (token, k) positions
    topi = torch.topk(torch.softmax(torch.from_numpy(logits), -1), k)[1]
    for e in range(E):
        order = [(t, j) for t in range(T) for j in range(k)
                 if int(topi[t, j]) == e]
        kept = {(t, j) for t, j in order[:cap]}
        for t, j in order:
            assert (float(disp[t, e].sum()) > 0) == any(
                (t, jj) in kept for jj in range(k) if int(topi[t, jj]) == e)


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    refs = {n: _jax_run(n) for n in ("gshard_top2", "gshard_capacity_drops")}
    res = torch_dist.spawn("moe_ep", 2, tmp_path_factory.mktemp("moe"), {
        "mesh": {"ep": 2},
        "cases": [_case_payload(n, r) for n, r in refs.items()]},
        timeout=120)
    return refs, res


@pytest.mark.parametrize("name", ["gshard_top2", "gshard_capacity_drops"])
def test_moe_over_ep2_matches_one_jax_device(ep_runs, name):
    refs, res = ep_runs
    ref = refs[name]
    grads = {}
    for r, out in enumerate(res):
        got = out[name]
        assert got["ep"] == 2 and got["offset"] == 2 * r
        np.testing.assert_allclose(got["y"], ref["y"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["l_aux"], ref["l_aux"], rtol=RTOL)
        np.testing.assert_allclose(got["dx"], ref["dx"], rtol=RTOL,
                                   atol=ATOL)
        grads.update(got["grads"])      # the gate's: the same on each rank
    assert set(grads) == set(ref["grads"])
    for n, g in grads.items():
        np.testing.assert_allclose(g, ref["grads"][n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_layers_keep_the_reference_keys_and_outputs():
    P.seed(1)
    jm = jnn.Sequential(jnn.Linear(8, 12), jnn.GELU(), jnn.Linear(12, 4))
    jl = jnn.LayerList([jnn.Linear(4, 4, bias_attr=False)])
    tm = Sequential(Linear(8, 12, device="cpu"), GELU(),
                    Linear(12, 4, device="cpu"))
    tl = LayerList([Linear(4, 4, bias_attr=False, device="cpu")])
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert list(tl.state_dict()) == list(jl.state_dict())
    with torch.no_grad():
        for (n, p), (jn, jp) in zip(tm.named_parameters(),
                                    jm.named_parameters()):
            assert n == jn and tuple(p.shape) == tuple(jp.shape)
            p.copy_(torch.from_numpy(np.array(jp._value)))
    x = np.random.RandomState(2).randn(5, 8).astype(np.float32)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm(P.to_tensor(x))._value),
                               rtol=RTOL, atol=ATOL)
    assert tm[0].bias is not None and tl[0].bias is None
    v = np.linspace(-4, 4, 33).astype(np.float32)
    for approx in (False, True):
        want = np.asarray(jnn.functional.gelu(P.to_tensor(v),
                                              approximate=approx)._value)
        got = TF.gelu(torch.from_numpy(v), approximate=approx).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    fresh = Linear(6, 3, device="cpu")
    assert float(fresh.bias.detach().abs().sum()) == 0.0
    assert tuple(fresh.weight.shape) == (6, 3)
