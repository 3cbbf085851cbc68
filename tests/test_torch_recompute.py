"""The fleet's ``recompute`` and the named RNG states, in the port.

Held against the JAX package (fp32, inputs and weights from numpy):
- ``recompute`` and ``recompute_sequential`` on the same block
  (``Sequential(Linear, GELU, Linear)`` x 2): outputs, input grads and
  parameter grads at rtol 1e-5;
- a 2-layer ``LlamaForCausalLM`` with ``recompute=True``: loss and every
  grad against the JAX model with ``recompute=True``.

The port's own checks, where JAX and torch random streams cannot be
compared:
- the tracker gives the same dropout mask on both mp ranks (spawned gloo
  ranks), and its stream advances between blocks;
- ``recompute`` with dropout inside ``rng_state(...)`` gives the grads of
  the same function without recompute; without ``preserve_rng_state``
  the recomputed mask differs;
- ``Generator`` / ``default_generator`` / ``seed`` state round trips.
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as jnn
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.core import generator as tgen
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    random_state as trs
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import load_paddle_tpu_state
from paddle_tpu_torch.nn.layer import GELU, Linear, Sequential

import torch_dist

# the packages' ``fleet.recompute`` is the function: take the modules
jrc = importlib.import_module("paddle_tpu.distributed.fleet.recompute")
trc = importlib.import_module("paddle_tpu_torch.distributed.fleet.recompute")

RTOL, ATOL = 1e-5, 1e-6


def _blocks(seed=4):
    P.seed(seed)
    jb = [jnn.Sequential(jnn.Linear(8, 16), jnn.GELU(), jnn.Linear(16, 8))
          for _ in range(2)]
    tb = [Sequential(Linear(8, 16, device="cpu"), GELU(),
                     Linear(16, 8, device="cpu")) for _ in range(2)]
    with torch.no_grad():
        for j, t in zip(jb, tb):
            for (n, p), (jn, jp) in zip(t.named_parameters(),
                                        j.named_parameters()):
                assert n == jn
                p.copy_(torch.from_numpy(np.array(jp._value)))
    return jb, tb


def _run_jax(blocks, x_np, cot, kind):
    x = P.to_tensor(x_np, stop_gradient=False)
    if kind == "sequential":
        y = jrc.recompute_sequential({"segments": 2}, blocks, x)
    else:
        y = jrc.recompute(blocks[1], jrc.recompute(blocks[0], x))
    (y * P.to_tensor(cot)).sum().backward()
    grads = [np.asarray(p.grad._value) for b in blocks
             for p in b.parameters()]
    return np.asarray(y._value), np.asarray(x.grad._value), grads


def _run_port(blocks, x_np, cot, kind, **kw):
    x = torch.from_numpy(x_np).requires_grad_(True)
    if kind == "sequential":
        y = trc.recompute_sequential({"segments": 2}, blocks, x)
    else:
        y = trc.recompute(blocks[1], trc.recompute(blocks[0], x, **kw), **kw)
    (y * torch.from_numpy(cot)).sum().backward()
    grads = [p.grad.numpy() for b in blocks for p in b.parameters()]
    return y.detach().numpy(), x.grad.numpy(), grads


@pytest.mark.parametrize("kind", ["recompute", "sequential"])
def test_recompute_matches_jax(kind):
    jb, tb = _blocks()
    r = np.random.RandomState(7)
    x = r.randn(6, 8).astype(np.float32)
    cot = r.randn(6, 8).astype(np.float32)
    want = _run_jax(jb, x, cot, kind)
    got = _run_port(tb, x, cot, kind)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    assert len(got[2]) == len(want[2]) == 8
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_use_reentrant_is_ignored_and_params_get_grads():
    """Paddle's default ``use_reentrant=True`` with an input that needs
    no grad: the parameters still get their grads (torch's reentrant
    checkpoint would give them none)."""
    _, tb = _blocks()
    x = torch.randn(3, 8)
    y = trc.recompute(tb[0], x, use_reentrant=True)
    y.sum().backward()
    assert all(p.grad is not None for p in tb[0].parameters())


def test_llama_recompute_matches_jax():
    cfg = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4,
               max_position_embeddings=32, recompute=True)
    P.seed(9)
    jm = JaxLlama(JaxConfig(**cfg))
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    load_paddle_tpu_state(tm, {n: np.asarray(p._value)
                               for n, p in jm.named_parameters()})
    r = np.random.RandomState(3)
    ids = r.randint(0, 64, (2, 12)).astype(np.int64)
    labels = r.randint(0, 64, (2, 12)).astype(np.int64)
    jl = jm.compute_loss(P.to_tensor(ids), P.to_tensor(labels))
    jl.backward()
    tl = tm.compute_loss(torch.from_numpy(ids), torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl.numpy()),
                               rtol=RTOL)
    jg = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[n], rtol=1e-4,
                                   atol=ATOL, err_msg=n)


def test_tracker_mask_is_the_same_on_both_mp_ranks(tmp_path):
    res = torch_dist.spawn("rng_tracker", 2, tmp_path,
                           {"mesh": {"mp": 2}, "seed": 11})
    a, b = res
    np.testing.assert_array_equal(a["first"], b["first"])
    np.testing.assert_array_equal(a["second"], b["second"])
    assert not np.array_equal(a["first"], a["second"])
    assert not np.array_equal(a["first"], a["plain"])


def _dropout_block(lin):
    def f(x):
        with trs.get_rng_state_tracker().rng_state():
            return torch.nn.functional.dropout(lin(x), 0.5)
    return f


@pytest.mark.parametrize("preserve", [True, False])
def test_recompute_replays_the_tracker_state(preserve):
    trs.model_parallel_random_seed(21, device="cpu")
    torch.manual_seed(0)
    lin = torch.nn.Linear(16, 16)
    x = torch.randn(8, 16)
    f = _dropout_block(lin)
    tracker = trs.get_rng_state_tracker()
    start = tracker.get_states_tracker()
    y0 = f(x)
    y0.sum().backward()
    want = lin.weight.grad.clone()
    lin.weight.grad = None
    tracker.set_states_tracker(start)
    y1 = trc.recompute(f, x, preserve_rng_state=preserve)
    np.testing.assert_array_equal(y1.detach().numpy(), y0.detach().numpy())
    y1.sum().backward()
    if preserve:
        np.testing.assert_array_equal(lin.weight.grad.numpy(), want.numpy())
    else:
        assert not torch.equal(lin.weight.grad, want)


def test_generator_state_round_trip():
    g = tgen.Generator(5, name="g", device="cpu")
    s = g.get_state()
    a = torch.rand(4, generator=g.generator)
    g.set_state(s)
    np.testing.assert_array_equal(torch.rand(4, generator=g.generator), a)
    assert g.initial_seed() == 5 and g.name == "g"
    k1, k2 = g.next_key(), g.next_key()
    assert not torch.equal(torch.rand(3, generator=k1),
                           torch.rand(3, generator=k2))
    d = tgen.default_generator("cpu")
    assert d.generator is torch.default_generator
    assert tgen.seed(13, "cpu") is torch.default_generator
    assert d.initial_seed() == 13
    x = torch.rand(3)
    tgen.seed(13, "cpu")
    np.testing.assert_array_equal(torch.rand(3), x)
    tr = trs.RNGStatesTracker()
    tr.add("a", 1, device="cpu")
    with pytest.raises(ValueError):
        tr.add("b", 1, device="cpu")
    with pytest.raises(ValueError):
        with tr.rng_state("missing"):
            pass
