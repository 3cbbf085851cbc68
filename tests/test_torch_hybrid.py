"""The slice as a whole: ``build_hybrid_train_step`` and ``TrainStep`` on
meshes with dp, mp (with and without sequence parallelism) and sep (ring
and Ulysses) above 1, each held against the JAX step on the same mesh
shape.

The port's ranks are gloo processes on the CPU (``tests/torch_dist.py``):
one spawn of two ranks runs every two-rank configuration in turn, one of
four runs dp2 x mp2. The JAX step runs here on the 8-device CPU mesh.
Both start from the JAX model's weights (a tiny LLaMA, 2 layers, hidden
32, 4 query and 2 kv heads, fp32) and take the same three global batches;
each rank keeps its own rows and sequence chunk. Losses are held at rtol
1e-5, the parameters after three steps at rtol 1e-4 / atol 1e-6. AdamW
runs at epsilon 1e-3, as in tests/test_torch_trainer.py: at its default
an element whose grad nearly cancels moves by lr times the sign of a
last-bit difference between the libraries.

The dp batches hold ignored labels unevenly (about a third of rank 0's
rows, none of rank 1's): the loss is the mean over the global batch's
valid tokens only if the ranks all-reduce their valid count. ``TrainStep``
on dp gets that from a ``LossSum`` (``LlamaForCausalLM.loss_sum``), with
and without accumulation; on mp it takes the scalar ``compute_loss``.
"""
import functools

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu.optimizer as jopt
from paddle_tpu.amp import GradScaler as JaxScaler
from paddle_tpu.distributed import comms as jcomms
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import build_hybrid_train_step as jax_build
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.parallel import mesh as mesh_mod
from paddle_tpu.parallel.trainer import compile_train_step as jax_compile
import paddle_tpu_torch.optimizer as popt
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     build_hybrid_train_step)
from paddle_tpu_torch.parallel import compile_train_step

import torch_dist

LOSS_RTOL = 1e-5
P_RTOL, P_ATOL = 1e-4, 1e-6
LR, EPS = 1e-2, 1e-3
TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)

# name -> (world, mesh, config knobs, step knobs)
CONFIGS = {
    "dp2": (2, {"dp": 2}, {}, dict(kind="hybrid", clip=1.0, ignore=True)),
    "mp2": (2, {"mp": 2}, {}, dict(kind="hybrid", clip=1.0, ignore=True)),
    "mp2_sp": (2, {"mp": 2}, {"sequence_parallel": True},
               dict(kind="hybrid", clip=1.0, ignore=True)),
    "sep2_ring": (2, {"sep": 2}, {"context_parallel": "ring"},
                  dict(kind="hybrid", clip=1.0, ignore=True, seq=16,
                       remat=True)),
    "sep2_ulysses": (2, {"sep": 2}, {"context_parallel": "ulysses"},
                     dict(kind="hybrid", ignore=True, seq=16)),
    "trainstep_dp2": (2, {"dp": 2}, {},
                      dict(kind="trainstep", clip=1.0, ignore=True,
                           loss_sum=True, scaler=dict(
                               init_loss_scaling=2.0 ** 10,
                               incr_every_n_steps=2))),
    "trainstep_dp2_acc2": (2, {"dp": 2}, {},
                           dict(kind="trainstep", clip=1.0, ignore=True,
                                loss_sum=True, accumulate=2)),
    "trainstep_mp2": (2, {"mp": 2}, {}, dict(kind="trainstep", clip=1.0)),
    "dp2_mp2": (4, {"dp": 2, "mp": 2}, {},
                dict(kind="hybrid", clip=1.0, ignore=True, remat=True,
                     accumulate=2)),
}
QUANT = ("dp2_int8", "dp2_fp8")
QUANT_RTOL = 1e-3


def _batches(name, seq=8, ignore=False, B=4, steps=3):
    out = []
    for s in range(steps):
        r = np.random.RandomState(100 + 7 * s + len(name))
        ids = r.randint(0, TINY["vocab_size"], (B, seq + 1))
        labels = ids[:, 1:].copy()
        if ignore:          # rows of dp rank 0 only: uneven valid counts
            mask = r.rand(B, seq) < 0.35
            mask[B // 2:] = False
            labels[mask] = -100
        out.append((ids[:, :-1].astype(np.int64), labels.astype(np.int64)))
    return out


def _jax_model(knobs, seed=11):
    P.seed(seed)
    return JaxLlama(JaxConfig(**{**TINY, **knobs}))


def _payload_config(name):
    base = name if name in CONFIGS else "dp2"
    world, mesh, knobs, step = CONFIGS[base]
    jm = _jax_model(knobs)
    state = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    return dict(name=name, mesh=mesh, config={**TINY, **knobs}, state=state,
                batches=_batches(base, step.get("seq", 8),
                                 step.get("ignore", False)),
                lr=LR, eps=EPS, kind=step["kind"], clip=step.get("clip"),
                scaler=step.get("scaler"), remat=step.get("remat", False),
                loss_sum=step.get("loss_sum", False),
                accumulate=step.get("accumulate", 1),
                quant={"dp2_int8": "int8", "dp2_fp8": "fp8"}.get(name))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every configuration on the port's ranks: name -> rank results (the
    spawns run on a background thread while the tests compute the JAX
    steps)."""
    tmp = tmp_path_factory.mktemp("hybrid")
    two = [n for n, c in CONFIGS.items() if c[0] == 2] + list(QUANT)
    pay2 = {"mesh": {"dp": 2}, "configs": [_payload_config(n) for n in two]}
    pay4 = {"mesh": {"dp": 4}, "configs": [_payload_config("dp2_mp2")]}

    def job2():
        res2 = torch_dist.spawn("hybrid", 2, tmp, pay2, timeout=90)
        return {n: [r[n] for r in res2] for n in two}

    def job4():
        res4 = torch_dist.spawn("hybrid", 4, tmp, pay4, timeout=90)
        return {"dp2_mp2": [r["dp2_mp2"] for r in res4]}
    runs = torch_dist.Background([(two, job2), (["dp2_mp2"], job4)])
    yield runs
    runs.join()


@functools.lru_cache(maxsize=None)
def _jax_run(name, quant=None):
    world, mesh_shape, knobs, step = CONFIGS[name]
    jm = _jax_model(knobs)
    mesh = mesh_mod.init_mesh(mesh_shape)
    try:
        clip = JaxClip(step["clip"]) if step.get("clip") else None
        opt = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                         epsilon=EPS, grad_clip=clip)
        if step["kind"] == "hybrid":
            fn = jax_build(jm, opt, mesh=mesh, remat=step.get("remat", False),
                           accumulate_steps=step.get("accumulate", 1))
        else:
            scaler = JaxScaler(**step["scaler"]) if step.get("scaler") \
                else None
            fn = jax_compile(jm, lambda m, b: m.compute_loss(
                b["input_ids"], b["labels"]), opt, mesh=mesh, scaler=scaler,
                accumulate_steps=step.get("accumulate", 1))
        losses = []
        for ids, labels in _batches(name, step.get("seq", 8),
                                    step.get("ignore", False)):
            b = {"input_ids": P.to_tensor(ids), "labels": P.to_tensor(labels)}
            if quant:
                with jcomms.quantized(quant):
                    losses.append(float(fn(b).numpy()))
            else:
                losses.append(float(fn(b).numpy()))
        if step["kind"] == "hybrid":
            fn.write_back()
        state = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    finally:
        mesh_mod.set_mesh(None)
    return losses, state


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mesh_step_matches_jax(port_runs, name):
    """Three steps' losses on every rank and the final parameters
    (gathered over mp) equal the JAX step's on the same mesh shape."""
    jl, js = _jax_run(name)
    ranks = port_runs[name]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["losses"], jl, rtol=LOSS_RTOL,
                                   err_msg=f"{name} rank {r}")
    got = ranks[0]["state"]
    assert set(got) == set(js)
    for n, want in js.items():
        np.testing.assert_allclose(got[n], want, rtol=P_RTOL, atol=P_ATOL,
                                   err_msg=f"{name} {n}")


@pytest.mark.parametrize("name", list(QUANT))
def test_quantized_dp_grad_sync_tracks_the_exact_step(port_runs, name):
    """Under ``comms.quantized()`` the dp grads ride the int8 / fp8 two-shot
    (the record says so); the losses stay within 1e-3 of the JAX step's
    exact run (about four times the larger gap of the two wires, 2.8e-4
    for int8 and 1.7e-4 for fp8 on the CPU) and every rank agrees."""
    jl, _ = _jax_run("dp2")
    ranks = port_runs[name]
    dt = "int8" if name.endswith("int8") else "fp8"
    for res in ranks:
        np.testing.assert_allclose(res["losses"], jl, rtol=QUANT_RTOL)
        assert res["losses"] == ranks[0]["losses"]
        sync = {k: v for k, v in res["sites"].items()
                if k.startswith("trainer.grad_sync/all_reduce")}
        assert sync and all(q == dt for _, q in sync.values())


def test_every_rank_of_a_dp_group_reports_the_same_loss(port_runs):
    for name, ranks in port_runs.items():
        for res in ranks[1:]:
            assert res["losses"] == ranks[0]["losses"], name


def test_trainstep_skips_a_poisoned_step_on_every_rank(tmp_path):
    """Under the int8 dp sync a step whose loss is inf on one rank's rows
    only is skipped on every rank with every parameter unchanged: the
    finite flag is judged on the raw local grads, before the wire's
    inf/nan guard, and all-reduced (trainer.py:329-347)."""
    r = np.random.RandomState(4)
    x = r.randn(3, 4, 64).astype(np.float32)
    y = r.randn(3, 4, 8).astype(np.float32)
    poisons = [np.ones(4, np.float32) for _ in range(3)]
    poisons[1][:2] = np.inf                 # rank 0's rows of step 2
    res = torch_dist.spawn("finite_skip", 2, tmp_path, {
        "mesh": {"dp": 2}, "x": x, "y": y, "poisons": poisons})
    for rank in res:
        (l1, same1, s1), (l2, same2, s2), (l3, same3, s3) = rank["steps"]
        assert np.isfinite(l1) and not same1 and s1 == 0
        assert not np.isfinite(l2) and same2 and s2 == 1
        assert np.isfinite(l3) and not same3 and s3 == 1
    assert res[0]["steps"][0][0] == res[1]["steps"][0][0]
