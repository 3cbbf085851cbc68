"""ZeRO stage 3 between steps: the model the port's train steps leave.

The JAX ``TrainStep`` writes the new values into the model after every
step (``paddle_tpu/parallel/trainer.py:450-455``); at stage 3 the port
keeps each parameter sharded at rest and releases the full tensor, so
``paddle_tpu_state(model)`` must gather it from the slices. Held here:

- ``TrainStep`` over dp2 and over sharding2 at stage 3, two steps, then
  ``paddle_tpu_state`` with no ``write_back()``: equal to the JAX
  ``TrainStep``'s model after the same two steps (same weights and
  batches, fp32, rtol 1e-5 and atol 1e-6; the port's loss is
  ``loss_sum``, the JAX step's global valid-token mean);
- the hybrid step (dp2, and dp2 x pp2 with 1f1b) at stage 3: the read
  before ``write_back()`` is never empty and equals the read after it;
  the dp2 one equals the JAX hybrid step's model after ``write_back()``;
  a ``write_back()`` after the first step leaves no stale copy behind.

The port's ranks are gloo processes (``tests/torch_dist.py``).
"""
import functools

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.fleet.meta_parallel import \
    sharding_optimizer as JSO
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import build_hybrid_train_step as jax_build
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.parallel import mesh as mesh_mod
from paddle_tpu.parallel.trainer import compile_train_step as jax_compile

import torch_dist

RTOL = 1e-5
# Adam moves a weight whose grad is near 0 by about lr either way, so the
# grads' summation order shows at ~3e-7 on single elements of the
# embedding: the absolute floor of tests/test_torch_zero.py
ATOL = 1e-6
LR, EPS = 1e-2, 1e-3
TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)

# name -> (world, mesh, kind, extra payload)
CONFIGS = {
    "trainstep_dp2_zero3": (2, {"dp": 2}, "trainstep", {"loss_sum": True}),
    "trainstep_sharding2_zero3": (2, {"sharding": 2}, "trainstep",
                                  {"loss_sum": True}),
    "hybrid_dp2_zero3": (2, {"dp": 2}, "hybrid", {}),
    "hybrid_dp2_zero3_write_back_first": (2, {"dp": 2}, "hybrid",
                                          {"write_back_first": True}),
    "hybrid_dp2_pp2_zero3": (4, {"dp": 2, "pp": 2}, "hybrid",
                             {"micro": 2}),
    "hybrid_dp2_pp2_zero3_write_back_first": (
        4, {"dp": 2, "pp": 2}, "hybrid", {"micro": 2,
                                          "write_back_first": True}),
}
JAX_HELD = [n for n, c in CONFIGS.items() if "pp" not in c[1]]


def _batches(B=4, seq=8, steps=2):
    out = []
    for s in range(steps):
        r = np.random.RandomState(900 + 5 * s)
        ids = r.randint(0, TINY["vocab_size"], (B, seq + 1))
        labels = ids[:, 1:].copy()
        labels[r.rand(B, seq) < 0.2] = -100
        out.append((ids[:, :-1].astype(np.int64), labels.astype(np.int64)))
    return out


def _jax_model(seed=23):
    P.seed(seed)
    return JaxLlama(JaxConfig(**TINY))


def _payload(name):
    world, mesh, kind, extra = CONFIGS[name]
    jm = _jax_model()
    return dict(name=name, mesh=mesh, config=dict(TINY),
                state={n: np.asarray(p._value)
                       for n, p in jm.named_parameters()},
                batches=_batches(), lr=LR, eps=EPS, kind=kind, clip=1.0,
                remat=False, zero=3, **extra)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero_reads")
    out = {}
    for world in sorted({c[0] for c in CONFIGS.values()}):
        names = [n for n, c in CONFIGS.items() if c[0] == world]
        res = torch_dist.spawn("zero_reads", world, tmp, {
            "mesh": {"dp": world},
            "configs": [_payload(n) for n in names]}, timeout=180)
        for n in names:
            out[n] = res[0][n]
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    _, mesh_shape, kind, _ = CONFIGS[name]
    jm = _jax_model()
    mesh = mesh_mod.init_mesh(mesh_shape)
    try:
        opt = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                         epsilon=EPS, grad_clip=JaxClip(1.0))
        model, opt, _ = JSO.group_sharded_parallel(jm, opt, "p_g_os")
        if kind == "hybrid":
            fn = jax_build(jm, opt, mesh=mesh, remat=False)
        else:
            fn = jax_compile(model, lambda m, b: m.compute_loss(
                b["input_ids"], b["labels"]), opt, mesh=mesh)
        losses = [float(fn({"input_ids": P.to_tensor(i),
                            "labels": P.to_tensor(lab)}).numpy())
                  for i, lab in _batches()]
        if kind == "hybrid":
            fn.write_back()
        state = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    finally:
        mesh_mod.set_mesh(None)
    return losses, state


@pytest.mark.parametrize("name", list(CONFIGS))
def test_read_between_steps_is_whole_and_current(port_runs, name):
    """Before ``write_back()`` every parameter reads whole (never an
    empty released tensor) and equals what ``write_back()`` then gives."""
    res = port_runs[name]
    before, after = res["before"], res["after"]
    assert set(before) == set(after) and before
    for n, want in after.items():
        assert before[n].shape == want.shape and want.size > 0, n
        np.testing.assert_array_equal(before[n], want, err_msg=n)


@pytest.mark.parametrize("name", JAX_HELD)
def test_model_between_steps_equals_jax(port_runs, name):
    """``TrainStep``: the model read with no ``write_back()`` equals the
    JAX ``TrainStep``'s model after the same two steps; the hybrid step:
    after ``write_back()``, the JAX one's after its ``write_back()``."""
    jl, js = _jax_run(name)
    res = port_runs[name]
    np.testing.assert_allclose(res["losses"], jl, rtol=RTOL)
    got = res["before"] if CONFIGS[name][2] == "trainstep" else res["after"]
    assert set(got) == set(js)
    for n, want in js.items():
        np.testing.assert_allclose(got[n], want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {n}")
