"""ZeRO in the port: ``TrainStep`` with stages 1-3 and
``build_hybrid_train_step`` with stages 2-3 (stage 1 on the pp meshes is
tests/test_torch_hybrid_pp.py's), over dp and over an explicit
``sharding`` axis, each against the JAX step on the same mesh shape; the
sep and pp legs of ``TrainStep``; the ``sharding``-to-dp fallback; and
the state shards' dims against ``_zero_state_spec``.

The port's ranks are gloo processes (``tests/torch_dist.py``); the JAX
steps run on the 8-device CPU mesh. A tiny LLaMA (2 layers, hidden 32,
fp32) starts from the JAX model's weights; the wrappers come from
``group_sharded_parallel`` (levels os / os_g / p_g_os) on both sides.
``TrainStep`` takes ``loss_sum`` with uneven ignored labels over dp (the
JAX step's global valid-token mean). Losses at rtol 1e-5, parameters
after three steps at rtol 1e-4 / atol 1e-6.
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
from paddle_tpu.parallel import trainer as JT
from paddle_tpu.parallel.trainer import compile_train_step as jax_compile
from paddle_tpu_torch.parallel import trainer as TT

import torch_dist

LOSS_RTOL = 1e-5
P_RTOL, P_ATOL = 1e-4, 1e-6
LR, EPS = 1e-2, 1e-3
TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
LEVEL = {1: "os", 2: "os_g", 3: "p_g_os"}

# name -> (world, mesh, config knobs, step knobs)
CONFIGS = {}
for _z in (1, 2, 3):
    CONFIGS[f"trainstep_dp2_zero{_z}"] = (
        2, {"dp": 2}, {}, dict(kind="trainstep", zero=_z, loss_sum=True))
    CONFIGS[f"trainstep_dp2_sharding2_zero{_z}"] = (
        4, {"dp": 2, "sharding": 2}, {},
        dict(kind="trainstep", zero=_z, loss_sum=True))
for _z in (2, 3):
    CONFIGS[f"hybrid_dp2_zero{_z}"] = (2, {"dp": 2}, {},
                                       dict(kind="hybrid", zero=_z))
    CONFIGS[f"hybrid_dp2_sharding2_zero{_z}"] = (
        4, {"dp": 2, "sharding": 2}, {}, dict(kind="hybrid", zero=_z))
CONFIGS["trainstep_sep2_ring"] = (2, {"sep": 2}, {"context_parallel": "ring"},
                                  dict(kind="trainstep", loss_sum=True,
                                       seq=16))
CONFIGS["trainstep_pp2"] = (2, {"pp": 2}, {}, dict(kind="trainstep"))


def _batches(seq=8, B=4, steps=3):
    out = []
    for s in range(steps):
        r = np.random.RandomState(500 + 7 * s)
        ids = r.randint(0, TINY["vocab_size"], (B, seq + 1))
        labels = ids[:, 1:].copy()
        mask = r.rand(B, seq) < 0.35
        mask[B // 2:] = False
        labels[mask] = -100
        out.append((ids[:, :-1].astype(np.int64), labels.astype(np.int64)))
    return out


def _jax_model(knobs, seed=11):
    P.seed(seed)
    return JaxLlama(JaxConfig(**{**TINY, **knobs}))


def _payload(name):
    world, mesh, knobs, step = CONFIGS[name]
    jm = _jax_model(knobs)
    return dict(name=name, mesh=mesh, config={**TINY, **knobs},
                state={n: np.asarray(p._value)
                       for n, p in jm.named_parameters()},
                batches=_batches(step.get("seq", 8)), lr=LR, eps=EPS,
                kind=step["kind"], clip=1.0, remat=False,
                loss_sum=step.get("loss_sum", False), zero=step.get("zero"))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero")
    jobs = []
    for world in sorted({c[0] for c in CONFIGS.values()}):
        names = [n for n, c in CONFIGS.items() if c[0] == world]
        payload = {"mesh": {"dp": world},
                   "configs": [_payload(n) for n in names]}

        def job(world=world, names=names, payload=payload):
            res = torch_dist.spawn("hybrid", world, tmp, payload,
                                   timeout=180)
            return {n: [r[n] for r in res] for n in names}
        jobs.append((names, job))
    runs = torch_dist.Background(jobs)      # spawns beside the JAX steps
    yield runs
    runs.join()


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    world, mesh_shape, knobs, step = CONFIGS[name]
    jm = _jax_model(knobs)
    mesh = mesh_mod.init_mesh(mesh_shape)
    try:
        opt = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                         epsilon=EPS, grad_clip=JaxClip(1.0))
        model = jm
        if step.get("zero"):
            model, opt, _ = JSO.group_sharded_parallel(jm, opt,
                                                       LEVEL[step["zero"]])
        if step["kind"] == "hybrid":
            fn = jax_build(jm, opt, mesh=mesh, remat=False)
        else:
            fn = jax_compile(model, lambda m, b: m.compute_loss(
                b["input_ids"], b["labels"]), opt, mesh=mesh)
        losses = [float(fn({"input_ids": P.to_tensor(i),
                            "labels": P.to_tensor(lab)}).numpy())
                  for i, lab in _batches(step.get("seq", 8))]
        if step["kind"] == "hybrid":
            fn.write_back()
        state = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    finally:
        mesh_mod.set_mesh(None)
    return losses, state, fn


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_matches_jax(port_runs, name):
    jl, js, _ = _jax_run(name)
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
                                  if c[3].get("zero")])
def test_state_is_sharded_over_the_resolved_axis(port_runs, name):
    """The axis is the explicit ``sharding`` axis when the mesh has it,
    else dp; every state leaf of the tiny model is sharded, so each
    rank's moments are half the unsharded bytes."""
    world, mesh, _, step = CONFIGS[name]
    for res in port_runs[name]:
        z = res["zero"]
        assert z["axis"] == ("sharding" if "sharding" in mesh else "dp")
        assert z["stage"] == step["zero"]
        assert all(d is not None for d in z["dims"])
        assert z["state_bytes"] * 2 == z["full_bytes"]


@pytest.mark.parametrize("name", [n for n, c in CONFIGS.items()
                                  if c[3].get("zero")
                                  and c[3]["kind"] == "trainstep"])
def test_state_shard_dims_equal_the_jax_steps(port_runs, name):
    """Each state leaf is sharded on the dim the JAX TrainStep's state
    sharding names (``_zero_state_spec``)."""
    _, _, fn = _jax_run(name)
    axis = port_runs[name][0]["zero"]["axis"]
    want = {}
    for n, sh in zip(fn._param_names, fn._state_shardings):
        spec = tuple(sh["moment1"].spec)
        want[n] = next((i for i, s in enumerate(spec)
                        if s == axis or (isinstance(s, tuple)
                                         and axis in s)), None)
    z = port_runs[name][0]["zero"]
    assert dict(zip(z["names"], z["dims"])) == want


def test_resolve_zero_axis_equals_jax():
    """Falls back from ``sharding`` to dp (and to None without either)."""
    cases = [{"dp": 2}, {"dp": 2, "sharding": 2}, {"sharding": 2},
             {"dp": 1, "sharding": 1}, {"mp": 2}, {"dp": 2, "sharding": 1}]
    for shape in cases:
        jm = mesh_mod.init_mesh(shape)
        try:
            pm = type("M", (), {"shape": shape, "axis_names": tuple(shape)})
            for axis in ("sharding", "dp", None):
                assert TT._resolve_zero_axis(axis, pm) == \
                    JT._resolve_zero_axis(axis, jm), (shape, axis)
        finally:
            mesh_mod.set_mesh(None)
    assert TT._resolve_zero_axis("sharding", None) == "sharding"


def test_zero_state_spec_equals_jax():
    from jax.sharding import PartitionSpec
    shapes = [(4096, 11008), (11008, 4096), (32000, 4096), (4096,), (3, 5),
              (8, 6, 4), (2, 2, 1, 64, 64), (6,)]
    specs = [(), (None, "mp"), ("mp", None), ("pp",), ("sharding",),
             (None, "pp", None, None, "mp")]
    for shape in ({"dp": 2}, {"dp": 2, "sharding": 2}, {"dp": 4, "mp": 2}):
        jm = mesh_mod.init_mesh(shape)
        try:
            pm = type("M", (), {"shape": shape, "axis_names": tuple(shape)})
            for axis in ("dp", "sharding"):
                for shp in shapes:
                    for spec in specs:
                        spec = tuple(spec[:len(shp)])
                        want = JT._zero_state_spec(PartitionSpec(*spec), shp,
                                                   axis, jm)
                        got = TT._zero_state_spec(spec, shp, axis, pm)
                        assert tuple(want) + (None,) * (
                            len(got) - len(tuple(want))) == got or \
                            tuple(want) == got, (shape, axis, shp, spec)
        finally:
            mesh_mod.set_mesh(None)
