"""Shared builders for the port's serving tests: a JAX LLaMA and the
port's LLaMA over the same weights (fp32, CPU), and seeded prompts.

The JAX model is built as tests/test_torch_serving.py builds it; its
parameters are carried across with ``load_paddle_tpu_state``.
"""
import numpy as np

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.models.llama import (
    LlamaConfig, LlamaForCausalLM, load_paddle_tpu_state)

TINY = dict(vocab=64, hidden=32, layers=2, heads=4, inter=64, seq=64)
DRAFT = dict(vocab=64, hidden=16, layers=1, heads=2, inter=32, seq=64)


def pair(seed=7, **cfg):
    """(JAX model, port model) with equal weights."""
    cfg = {**TINY, **cfg}
    P.seed(seed)
    jm = JaxLlama(JaxConfig.tiny(**cfg))
    pm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_paddle_tpu_state(
        pm, {n: np.asarray(p._value) for n, p in jm.named_parameters()})
    return jm, pm


def prompt(n, seed=0, vocab=64):
    return np.random.RandomState(seed).randint(0, vocab, (n,))


def assert_same_outputs(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
