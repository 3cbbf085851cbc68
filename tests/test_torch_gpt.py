"""GPT in the port against the JAX package's, on the CPU.

``GPTConfig.tiny`` with dropout 0, the JAX model's weights carried across
by ``load_paddle_tpu_state``: the ``state_dict`` keys equal the JAX
model's, three eager AdamW steps (forward with labels, ``backward()``,
``step()``) give the same losses and every grad at ``rtol=1e-5,
atol=1e-6``, and greedy ``generate`` the same ids. Sampled ``generate``
draws from the port's generator: held by shape, range and repeatability
under ``seed``.
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.ops as jops
import paddle_tpu_torch as P
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.core import device as pdev
from paddle_tpu_torch.models import gpt as pgpt

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _jax_uncached():
    """The JAX side op by op (its per-op compiled cache would compile
    each op anew for every sequence length ``generate`` meets)."""
    jops.dispatch.set_op_cache_enabled(False)
    yield
    jops.dispatch.set_op_cache_enabled(True)


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


def _cfg(mod):
    return mod.GPTConfig.tiny(hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def pair():
    J.seed(5)
    jm = jgpt.GPTForCausalLM(_cfg(jgpt))
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    try:
        pm = pgpt.GPTForCausalLM(_cfg(pgpt), device="cpu")
    finally:
        pdev._state.device = prev
    state = {k: np.asarray(v.numpy()).copy()
             for k, v in jm.state_dict().items()}
    pgpt.load_paddle_tpu_state(pm, state)
    return jm, pm


def test_state_dict_keys_equal_the_jax_models(pair):
    jm, pm = pair
    assert list(pm.state_dict()) == list(jm.state_dict())
    assert "gpt.word_embeddings.weight" in pm.state_dict()
    base = pgpt.GPTModel(_cfg(pgpt), device="cpu")
    assert {"gpt." + k for k in base.state_dict()} == set(pm.state_dict())
    back = pgpt.paddle_tpu_state(pm)
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(back[k], np.asarray(v.numpy()))


def test_three_adamw_steps_equal_the_jax_eager_loop(pair):
    jm, pm = pair
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 16)).astype(np.int64)
    jopt = J.optimizer.AdamW(learning_rate=1e-3,
                             parameters=jm.parameters())
    popt = P.optimizer.AdamW(learning_rate=1e-3,
                             parameters=pm.parameters())
    jnames = [n for n, _ in jm.named_parameters()]
    assert jnames == [n for n, _ in pm.named_parameters()]
    for step in range(3):
        ji = J.to_tensor(ids)
        _, jl = jm(ji, labels=ji)
        jl.backward()
        pi = P.to_tensor(ids)
        _, pl = pm(pi, labels=pi)
        pl.backward()
        np.testing.assert_allclose(float(pl.numpy()), float(jl.numpy()),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"loss, step {step}")
        for (n, jp), (_, pp) in zip(jm.named_parameters(),
                                    pm.named_parameters()):
            np.testing.assert_allclose(
                pp.grad.numpy(), np.asarray(jp.grad.numpy()), rtol=RTOL,
                atol=ATOL, err_msg=f"grad {n}, step {step}")
        jopt.step()
        jopt.clear_grad()
        popt.step()
        popt.clear_grad()


def test_greedy_generate_equals_jax(pair):
    jm, pm = pair
    prompt = np.array([[3, 17, 99, 4], [1, 2, 3, 4]], np.int64)
    want = jm.generate(J.to_tensor(prompt), max_new_tokens=4)
    got = pm.generate(P.to_tensor(prompt), max_new_tokens=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


def test_sampled_generate_repeats_under_seed(pair):
    _, pm = pair
    prompt = P.to_tensor(np.array([[3, 17, 99, 4]], np.int64))
    P.seed(9, "cpu")
    a = pm.generate(prompt, max_new_tokens=6, temperature=0.8,
                    top_k=5).numpy()
    P.seed(9, "cpu")
    b = pm.generate(prompt, max_new_tokens=6, temperature=0.8,
                    top_k=5).numpy()
    np.testing.assert_array_equal(a, b)
    assert a.shape == (1, 10) and (a >= 0).all() and (a < 128).all()
    np.testing.assert_array_equal(a[:, :4], [[3, 17, 99, 4]])
