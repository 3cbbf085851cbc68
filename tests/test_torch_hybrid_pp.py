"""The pp leg of ``build_hybrid_train_step``: every schedule (gpipe, 1f1b,
1f1b_compact, vpp) on pp2, on dp2 x pp2 with ZeRO stage 1 and on
dp2 x pp2 x mp2 (sequence parallel) with ZeRO over dp, and the 4-axis
dp2 x pp2 x sharding2 x mp2 vpp step, each held against the JAX step.

The port's ranks are gloo processes on the CPU (``tests/torch_dist.py``):
one spawn a world size runs its configurations in turn. The JAX step runs
here on the 8-device CPU mesh of the same shape; the 16-rank 4-axis step
has no 8-device twin, so it is held against the JAX dp2 x pp2 x mp2 vpp
step with ZeRO over dp (the layout differs, the math is the same: the
sharding ranks compute what a replica computes). A tiny LLaMA (4 layers,
hidden 32, 4 query and 2 kv heads, fp32) takes the JAX model's weights
and three global batches of 8 rows in which dp rank 0's rows hold about a
third ignored labels: gpipe and vpp take the valid-token mean over the
batch, 1f1b the mean of the microbatches' means, as the JAX step.
Losses are held at rtol 1e-5, the parameters after three steps at rtol
1e-4 / atol 1e-6, as in tests/test_torch_hybrid.py.
"""
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

import torch_dist

LOSS_RTOL = 1e-5
P_RTOL, P_ATOL = 1e-4, 1e-6
LR, EPS = 1e-2, 1e-3
TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
SCHEDULES = {"gpipe": 2, "1f1b": 4, "1f1b_compact": 4, "vpp": 4}   # -> M


def _configs():
    out = {}
    for sched, M in SCHEDULES.items():
        v = 2 if sched == "vpp" else 1
        out[f"pp2_{sched}"] = (2, {"pp": 2}, None, {},
                               dict(schedule=sched, micro=M, virtual=v,
                                    clip=1.0))
        out[f"dp2_pp2_zero1_{sched}"] = (
            4, {"dp": 2, "pp": 2}, None, {},
            dict(schedule=sched, micro=2 if sched != "1f1b" else 4,
                 virtual=v, clip=1.0, zero=1))
        out[f"dp2_pp2_mp2_{sched}"] = (
            8, {"dp": 2, "pp": 2, "mp": 2}, None,
            {"sequence_parallel": True},
            dict(schedule=sched, micro=2, virtual=v, clip=1.0, zero=1))
    out["dp2_pp2_sharding2_mp2_vpp"] = (
        16, {"dp": 2, "pp": 2, "sharding": 2, "mp": 2},
        {"dp": 2, "pp": 2, "mp": 2}, {"sequence_parallel": True},
        dict(schedule="vpp", micro=4, virtual=2, clip=1.0, zero=1))
    out["pp2_1f1b_acc2"] = (2, {"pp": 2}, None, {},
                                dict(schedule="1f1b", micro=2, clip=1.0,
                                     accumulate=2))
    return out


CONFIGS = _configs()


def _batches(B=8, seq=8, steps=3):
    out = []
    for s in range(steps):
        r = np.random.RandomState(300 + 7 * s)
        ids = r.randint(0, TINY["vocab_size"], (B, seq + 1))
        labels = ids[:, 1:].copy()
        mask = r.rand(B, seq) < 0.35
        for m in range(2):          # the first half of each microbatch pair
            mask[m * B // 2 + B // 4:(m + 1) * B // 2] = False
        labels[mask] = -100
        out.append((ids[:, :-1].astype(np.int64), labels.astype(np.int64)))
    return out


def _jax_model(knobs, seed=11):
    P.seed(seed)
    return JaxLlama(JaxConfig(**{**TINY, **knobs}))


def _payload(name):
    world, mesh, _, knobs, step = CONFIGS[name]
    jm = _jax_model(knobs)
    return dict(name=name, mesh=mesh, config={**TINY, **knobs},
                state={n: np.asarray(p._value)
                       for n, p in jm.named_parameters()},
                batches=_batches(), lr=LR, eps=EPS, kind="hybrid",
                clip=step.get("clip"), remat=True,
                accumulate=step.get("accumulate", 1),
                micro=step["micro"], schedule=step["schedule"],
                virtual=step.get("virtual", 1), zero=step.get("zero"))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """name -> rank results; the spawns run on a background thread while
    the tests compute the JAX steps."""
    tmp = tmp_path_factory.mktemp("hybrid_pp")
    jobs = []
    for world in sorted({c[0] for c in CONFIGS.values()}):
        names = [n for n, c in CONFIGS.items() if c[0] == world]
        payload = {"mesh": {"dp": world},
                   "configs": [_payload(n) for n in names]}

        def job(world=world, names=names, payload=payload):
            res = torch_dist.spawn("hybrid", world, tmp, payload,
                                   timeout=240)
            return {n: [r[n] for r in res] for n in names}
        jobs.append((names, job))
    runs = torch_dist.Background(jobs)
    yield runs
    runs.join()


def _jax_run(name):
    world, mesh_shape, jax_mesh, knobs, step = CONFIGS[name]
    jm = _jax_model(knobs)
    mesh = mesh_mod.init_mesh(jax_mesh or mesh_shape)
    try:
        opt = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                         epsilon=EPS, grad_clip=JaxClip(step["clip"]))
        if step.get("zero"):
            opt = JSO.DygraphShardingOptimizer(opt)
        fn = jax_build(jm, opt, mesh=mesh, remat=True,
                       n_microbatches=step["micro"],
                       schedule=step["schedule"],
                       n_virtual=step.get("virtual", 1),
                       accumulate_steps=step.get("accumulate", 1))
        losses = [float(fn({"input_ids": P.to_tensor(i),
                            "labels": P.to_tensor(lab)}).numpy())
                  for i, lab in _batches()]
        fn.write_back()
        state = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    finally:
        mesh_mod.set_mesh(None)
    return losses, state


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pipeline_step_matches_jax(port_runs, name):
    """Three steps' losses on every rank and the final parameters
    (gathered over pp and mp) equal the JAX step's."""
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


@pytest.mark.parametrize("name", [n for n, c in CONFIGS.items()
                                  if c[4].get("zero")])
def test_zero_halves_each_ranks_state(port_runs, name):
    """Over a ZeRO axis of 2 (dp, or the explicit sharding axis) each
    rank's Adam moments are half of the unsharded moments' bytes (every
    tensor of the tiny model has a dim the axis divides)."""
    world, mesh, *_ = CONFIGS[name]
    axis = "sharding" if "sharding" in mesh else "dp"
    for res in port_runs[name]:
        z = res["zero"]
        assert z["axis"] == axis and z["stage"] == 1
        assert all(d is not None for d in z["dims"])
        assert z["state_bytes"] * 2 == z["full_bytes"]


def test_ticks_and_stash_on_each_stage(port_runs):
    """The pipeline's clock as the JAX schedules define it: pp2 1f1b with
    M=4 runs M + 2 rounds with the last stage's stash in min(3, M); vpp
    M v + 1 forward and as many backward ticks, M v busy each way."""
    for res in port_runs["pp2_1f1b"]:
        info = res["pipeline"]
        assert info["ticks"] == 4 + 2 and info["stash_peak"] <= 3
    for res in port_runs["pp2_vpp"]:
        info = res["pipeline"]
        assert info["ticks"] == 2 * (4 * 2 + 1)
        assert info["busy"] == 2 * 4 * 2
    for name in CONFIGS:
        for res in port_runs[name]:
            assert res["losses"] == port_runs[name][0]["losses"], name
