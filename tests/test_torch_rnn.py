"""The port's recurrent layers against the JAX package's, on the CPU.

``LSTM``, ``GRU`` and ``SimpleRNN`` (tanh and relu) over direction x
depth x ``time_major``: the outputs, the final states (``[layers * dirs,
B, H]``, l0, l0_reverse, l1, ...), the input grad and every parameter's
grad of ``sum(y * w1) + sum(h * w2) (+ sum(c * w3))``, the port layer
loaded with the JAX layer's state (same keys: ``weight_ih_l0``,
``weight_hh_l0_reverse``, ...), at ``rtol=1e-5, atol=1e-6`` in float32.
The cells take explicit states. ``RNN_LCASES`` runs through the shared
layer check. The JAX forward ignores ``initial_states`` and ``dropout``;
the port follows it, and a test holds both to it.
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.ops as jops
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as pdev

from test_torch_nn_layers import _traced_refs, check_layer, layer_refs
from torch_nn_cases import ATOL, RNN_LCASES, RTOL, _f32, _rng


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
    return np.asarray(t.detach().numpy() if hasattr(t, "detach")
                      and not hasattr(t, "_value") else t.numpy())


def _state(layer):
    return {k: np.asarray(v.numpy()).copy()
            for k, v in layer.state_dict().items()}


def _run(pkg, layer, x, ws, raw=_np):
    xt = pkg.to_tensor(x, stop_gradient=False)
    y, st = layer(xt)
    states = list(st) if isinstance(st, tuple) else [st]
    loss = pkg.sum(pkg.multiply(y, pkg.to_tensor(ws[0])))
    for s, w in zip(states, ws[1:]):
        loss = loss + pkg.sum(pkg.multiply(s, pkg.to_tensor(w)))
    loss.backward()
    return ([raw(y)] + [raw(s) for s in states], raw(xt.grad),
            {n: raw(p.grad) for n, p in layer.named_parameters()})


MATRIX = [(cls, kw) for cls, extra in (("LSTM", {}), ("GRU", {}),
                                       ("SimpleRNN", {}),
                                       ("SimpleRNN", {"activation": "relu"}))
          for kw in ({**extra, "direction": "forward", "num_layers": 1},
                     {**extra, "direction": "bidirect", "num_layers": 2,
                      "time_major": True},
                     {**extra, "direction": "bidirectional", "num_layers": 1},
                     {**extra, "direction": "forward", "num_layers": 2,
                      "time_major": True})]


IDS = [f"{c}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
       for c, kw in MATRIX]


def _arrays(i):
    cls, kw = MATRIX[i]
    r = _rng(IDS[i])
    T, B = 6, 3
    x = _f32(r, *((T, B, 4) if kw.get("time_major") else (B, T, 4)))
    dirs = 2 if kw["direction"] != "forward" else 1
    ys = (T, B, 5 * dirs) if kw.get("time_major") else (B, T, 5 * dirs)
    n_states = 2 if cls == "LSTM" else 1
    return [x, _f32(r, *ys)] + [_f32(r, kw["num_layers"] * dirs, B, 5)
                                for _ in range(n_states)]


class _MatrixRun:
    """The JAX layers of the matrix, and their runs traced under
    ``jax.jit`` a chunk at a time (one compile instead of one a case)."""

    def __init__(self):
        self.layers = [getattr(J.nn, cls)(4, 5, **kw) for cls, kw in MATRIX]
        self.states = [_state(layer) for layer in self.layers]

    def arrays(self, i):
        return _arrays(i)

    def __call__(self, i, values):
        return _run(J, self.layers[i], values[0], values[1:],
                    raw=lambda t: t._value)


@pytest.fixture(scope="module")
def matrix_refs():
    run = _MatrixRun()
    return run.states, _traced_refs(list(range(len(MATRIX))), run)


@pytest.mark.parametrize("i", range(len(MATRIX)), ids=IDS)
def test_recurrent_layer_against_jax(i, matrix_refs):
    cls, kw = MATRIX[i]
    states, refs = matrix_refs
    pl = getattr(P.nn, cls)(4, 5, **kw)
    assert list(pl.state_dict()) == list(states[i])
    pl.set_state_dict(states[i])
    x, *ws = _arrays(i)
    n_states = 2 if cls == "LSTM" else 1
    if i in refs:
        jo, jx, jg = refs[i]
    else:
        jl = getattr(J.nn, cls)(4, 5, **kw)
        jl.set_state_dict(states[i])
        jo, jx, jg = _run(J, jl, x, ws)
    po, px, pg = _run(P, pl, x, ws)
    assert len(po) == len(jo) == 1 + n_states
    for k, (a, b) in enumerate(zip(po, jo)):
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_allclose(a, b, RTOL, ATOL, err_msg=f"out {k}")
    np.testing.assert_allclose(px, jx, RTOL, ATOL, err_msg="x grad")
    assert sorted(pg) == sorted(jg)
    for n in jg:
        np.testing.assert_allclose(pg[n], jg[n], RTOL, ATOL, err_msg=n)


@pytest.mark.parametrize("cls", ["LSTMCell", "GRUCell"])
def test_cell_with_states_against_jax(cls):
    r = _rng(cls)
    jl, pl = getattr(J.nn, cls)(4, 5), getattr(P.nn, cls)(4, 5)
    assert list(pl.state_dict()) == list(jl.state_dict())
    pl.set_state_dict(_state(jl))
    x, h, c = _f32(r, 3, 4), _f32(r, 3, 5), _f32(r, 3, 5)
    res = {}
    for pkg, layer in ((J, jl), (P, pl)):
        ts = [pkg.to_tensor(a, stop_gradient=False) for a in (x, h, c)]
        states = (ts[1], ts[2]) if cls == "LSTMCell" else ts[1]
        out, new = layer(ts[0], states)
        last = new[1] if cls == "LSTMCell" else new
        pkg.sum(pkg.multiply(out, out) + last).backward()
        res[pkg] = [_np(out), _np(last)] + [
            _np(t.grad) for t in ts[:2 if cls == "GRUCell" else 3]] + [
            _np(p.grad) for _, p in layer.named_parameters()]
    for k, (a, b) in enumerate(zip(res[P], res[J])):
        np.testing.assert_allclose(a, b, RTOL, ATOL, err_msg=str(k))


@pytest.fixture(scope="module")
def lrefs():
    return layer_refs(RNN_LCASES)


@pytest.mark.parametrize("name", sorted(RNN_LCASES))
def test_layer_table_against_jax(name, lrefs):
    check_layer(name, RNN_LCASES, lrefs)


def test_initial_states_and_dropout_are_ignored_as_in_the_jax_forward():
    """Reference caveat kept: the sequence starts from zeros whatever
    ``initial_states`` holds, and ``dropout`` changes nothing."""
    r = _rng("caveat")
    x = _f32(r, 2, 5, 4)
    h0, c0 = _f32(r, 1, 2, 5), _f32(r, 1, 2, 5)
    for pkg in (J, P):
        layer = pkg.nn.LSTM(4, 5, dropout=0.5)
        y0, _ = layer(pkg.to_tensor(x))
        y1, _ = layer(pkg.to_tensor(x), (pkg.to_tensor(h0),
                                         pkg.to_tensor(c0)))
        np.testing.assert_array_equal(_np(y0), _np(y1))
