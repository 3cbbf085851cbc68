"""The fleet facade and the data-parallel names: ``fleet.init`` ->
``distributed_optimizer`` -> ``build_hybrid_train_step`` on pp and ZeRO
meshes against the JAX fleet on the same strategy, the
``HybridCommunicateGroup`` getters, the strategy tags, the lars / lamb
swaps, ``SegmentLayers``, ``DataParallel`` (eager, with and without the
eager ZeRO update), ``distributed.spawn`` and
``env.parallel_device_count``.

The port's ranks are gloo processes (``tests/torch_dist.py``); the JAX
fleet runs on the 8-device CPU platform. A tiny LLaMA (4 layers, hidden
32, fp32) starts from the JAX model's weights. Losses at rtol 1e-5,
parameters after three steps at rtol 1e-4 / atol 1e-6. The port's rank
getters return this process's coordinate (a process per rank); the JAX
ones return 0 (one program): held against the mesh instead.
"""
import json

import functools

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.distributed.fleet as jfleet
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.fleet import meta_parallel as jmeta
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import build_hybrid_train_step as jax_build
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.parallel import mesh as jmesh
import paddle_tpu_torch.distributed as tdist
import paddle_tpu_torch.distributed.fleet as tfleet
import paddle_tpu_torch.optimizer as popt
from paddle_tpu_torch.distributed.fleet import meta_parallel as tmeta

import torch_dist

LOSS_RTOL = 1e-5
P_RTOL, P_ATOL = 1e-4, 1e-6
LR, EPS = 1e-2, 1e-3
TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)

# name -> (world, hybrid degrees, ZeRO stage, schedule, M)
CASES = {
    "pp2_1f1b": (2, {"pp_degree": 2}, 0, "1f1b", 2),
    "dp2_pp2_sharding1": (4, {"dp_degree": 2, "pp_degree": 2}, 1, "gpipe",
                          2),
    "dp2_sharding2_stage2": (4, {"dp_degree": 2, "sharding_degree": 2}, 2,
                             "1f1b", 1),
    "dp2_pp2_mp2_compact": (8, {"dp_degree": 2, "pp_degree": 2,
                                "mp_degree": 2}, 1, "1f1b_compact", 2),
}


def _batches(B=8, seq=8, steps=3):
    out = []
    for s in range(steps):
        r = np.random.RandomState(700 + 7 * s)
        ids = r.randint(0, TINY["vocab_size"], (B, seq + 1))
        labels = ids[:, 1:].copy()
        labels[r.rand(B, seq) < 0.2] = -100
        out.append((ids[:, :-1].astype(np.int64), labels.astype(np.int64)))
    return out


def _jax_model(seed=11):
    P.seed(seed)
    return JaxLlama(JaxConfig(**TINY))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    state = {n: np.asarray(p._value) for n, p in _jax_model()
             .named_parameters()}
    jobs = []
    for name, (world, hybrid, stage, sched, M) in CASES.items():
        payload = {
            "mesh": {"dp": world}, "hybrid": hybrid, "stage": stage,
            "config": TINY, "state": state, "lr": LR, "eps": EPS,
            "micro": M, "schedule": sched, "batches": _batches()}

        def job(name=name, world=world, payload=payload):
            return {name: torch_dist.spawn("fleet", world, tmp, payload,
                                           timeout=120)}
        jobs.append(([name], job))
    runs = torch_dist.Background(jobs)      # spawns beside the JAX steps
    yield runs
    runs.join()


@functools.lru_cache(maxsize=None)
def _jax_fleet(name):
    world, hybrid, stage, sched, M = CASES[name]
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs.update(hybrid)
    if stage:
        strategy.sharding = True
        strategy.sharding_configs["stage"] = stage
    jfleet.init(is_collective=True, strategy=strategy)
    try:
        hcg = jfleet.get_hybrid_communicate_group()
        jm = _jax_model()
        opt = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                         epsilon=EPS, grad_clip=JaxClip(1.0))
        opt = jfleet.distributed_optimizer(opt)
        fn = jax_build(jm, opt, mesh=hcg.mesh, n_microbatches=M,
                       schedule=sched)
        losses = [float(fn({"input_ids": P.to_tensor(i),
                            "labels": P.to_tensor(lab)}).numpy())
                  for i, lab in _batches()]
        fn.write_back()
        state = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
        return hcg, losses, state
    finally:
        jmesh.set_mesh(None)


@pytest.mark.parametrize("name", list(CASES))
def test_fleet_to_hybrid_step_matches_jax(port, name):
    hcg, jl, js = _jax_fleet(name)
    ranks = port[name]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["losses"], jl, rtol=LOSS_RTOL,
                                   err_msg=f"{name} rank {r}")
        world, hybrid, stage, *_ = CASES[name]
        want_axis = "sharding" if hybrid.get("sharding_degree", 1) > 1 \
            else "dp"
        assert res["zero"] == ((want_axis, stage) if stage else None)
    got = ranks[0]["state"]
    for n, want in js.items():
        np.testing.assert_allclose(got[n], want, rtol=P_RTOL, atol=P_ATOL,
                                   err_msg=f"{name} {n}")


@pytest.mark.parametrize("name", list(CASES))
def test_hybrid_communicate_group_getters(port, name):
    """Degrees, parallel mode, the mesh, the pipe comm list and the group
    sizes equal the JAX HCG's; each rank's coordinates and group members
    are its place on the mesh."""
    hcg, _, _ = _jax_fleet(name)
    for r, res in enumerate(port[name]):
        assert res["degrees"] == (hcg.get_data_parallel_world_size(),
                                  hcg.get_model_parallel_world_size(),
                                  hcg.get_pipe_parallel_world_size(),
                                  hcg.get_sharding_parallel_world_size())
        assert res["mode"] == hcg.get_parallel_mode()
        assert res["mesh"] == dict(hcg.mesh.shape)
        assert res["comm_list"] == hcg.topology().get_comm_list("pipe")
        c = res["coords"]
        assert res["ranks"] == (c["dp"], c["mp"], c["pp"], c["sharding"])
        for fname, axis in (("data", "dp"), ("model", "mp"), ("pipe", "pp"),
                            ("sharding", "sharding")):
            n, rank, members = res["groups"][fname]
            assert n == hcg.mesh.shape[axis] and rank == c[axis]
            assert r in members and len(members) == n
        assert res["workers"][2] == (r == 0)


def test_strategy_tags_and_swaps_equal_jax():
    """``HybridParallelOptimizer`` tags the base optimizer as the JAX one
    does (ZeRO stage and axis, accumulation from gradient merge and the
    pipeline), and lars / lamb swap the same optimizer types."""
    for cfg in ({"sharding": True, "stage": 2}, {"gradient_merge": True},
                {"pipeline": True}, {"lars": True}, {"lamb": True}, {}):
        tags = []
        for fl, op, make in (
                (jfleet, jopt, lambda o, m: o.Momentum(
                    parameters=[P.create_parameter([2, 2], "float32")])
                 if "lars" in cfg else o.AdamW(parameters=[
                     P.create_parameter([2, 2], "float32")])),
                (tfleet, popt, lambda o, m: o.Momentum(
                    parameters=[torch.nn.Parameter(torch.ones(2, 2))])
                 if "lars" in cfg else o.AdamW(parameters=[
                     torch.nn.Parameter(torch.ones(2, 2))]))):
            st = fl.DistributedStrategy()
            if cfg.get("sharding"):
                st.sharding = True
                st.sharding_configs["stage"] = cfg["stage"]
            if cfg.get("gradient_merge"):
                st.gradient_merge = True
                st.gradient_merge_configs["k_steps"] = 3
            if cfg.get("pipeline"):
                st.pipeline = True
                st.pipeline_configs["accumulate_steps"] = 4
            st.lars, st.lamb = bool(cfg.get("lars")), bool(cfg.get("lamb"))
            from importlib import import_module
            hyb = import_module(fl.__name__ + ".hybrid_optimizer")
            opt = hyb.apply_meta_optimizers(make(op, None), st)
            wrapped = hyb.HybridParallelOptimizer(opt, None, st)
            base = wrapped.inner_opt
            tags.append((type(base).__name__,
                         getattr(base, "_shard_stage", 0),
                         getattr(base, "_shard_axis", None),
                         getattr(base, "_accumulate_steps", 1)))
        assert tags[0] == tags[1], cfg


def test_segment_layers_equal_jax():
    import paddle_tpu.nn as jnn
    for n_items, parts in ((8, 2), (7, 3), (5, 5), (12, 4)):
        assert tmeta.SegmentLayers.uniform(n_items, parts) == \
            jmeta.SegmentLayers.uniform(n_items, parts)
    jd = [jmeta.LayerDesc(jnn.Linear, 2, 2) if i % 3 else
          jmeta.LayerDesc(jnn.ReLU) for i in range(9)]
    td = [tmeta.LayerDesc(torch.nn.Linear, 2, 2) if i % 3 else
          tmeta.LayerDesc(torch.nn.ReLU) for i in range(9)]
    for method in ("uniform", "layer:Linear", "layer:ReLU"):
        assert tmeta.SegmentLayers(td, 3, method).do_segment() == \
            jmeta.SegmentLayers(jd, 3, method).do_segment()
    pl = tmeta.PipelineLayer(td, num_stages=3)
    assert [len(pl.stage_layers(s)) for s in range(3)] == [3, 3, 3]
    x = torch.randn(4, 2)
    ref = x
    for layer in pl.run_function:
        ref = layer(ref)
    torch.testing.assert_close(pl(x), ref)
    with pytest.raises(TypeError):
        tmeta.LayerDesc(int)


def test_data_parallel_and_eager_zero(tmp_path):
    """Two ranks, each its half of every batch: the grads averaged over dp
    at the end of each backward, so three AdamW steps equal one process
    training on the whole batch (the mean over its rows, what the JAX
    DataParallel computes); under ``DygraphShardingOptimizer`` too, with
    each rank holding half the moments."""
    r = np.random.RandomState(3)
    w = (r.randn(8, 16) * 0.3).astype(np.float32)
    b = (r.randn(8) * 0.1).astype(np.float32)
    xs = [r.randn(4, 16).astype(np.float32) for _ in range(3)]
    ys = [r.randn(4, 8).astype(np.float32) for _ in range(3)]
    res = torch_dist.spawn("data_parallel", 2, tmp_path, {
        "mesh": {"dp": 2}, "w": w, "b": b, "x": xs, "y": ys})
    lin = torch.nn.Linear(16, 8)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    opt = popt.AdamW(learning_rate=1e-2, parameters=lin.parameters())
    for x, y in zip(xs, ys):
        ((lin(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean() \
            .backward()
        opt.step()
        opt.clear_grad()
    for rank in res:
        for key in ("plain", "zero"):
            np.testing.assert_allclose(rank[key]["w"], lin.weight.detach(),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(rank[key]["b"], lin.bias.detach(),
                                       rtol=1e-5, atol=1e-6)
        assert rank["plain"]["state_numel"] == 2 * (8 * 16 + 8)
        assert rank["zero"]["state_numel"] * 2 == rank["plain"]["state_numel"]


def test_spawn_starts_ranks_that_join(tmp_path):
    tdist.spawn(torch_dist.spawn_probe, args=(str(tmp_path),), nprocs=2)
    got = sorted((json.loads((tmp_path / f"spawn{r}.json").read_text())
                  for r in range(2)), key=lambda d: d["rank"])
    assert [(g["rank"], g["world"], g["local"], g["sum"]) for g in got] == \
        [(0, 2, 0, 1.0), (1, 2, 1, 1.0)]


def test_parallel_device_count_counts_visible_cards():
    """The JAX function counts its program's devices (8 CPU devices here);
    the port's counts the cards this process sees, 1 without CUDA."""
    from paddle_tpu_torch.distributed import env
    want = torch.cuda.device_count() if torch.cuda.is_available() else 1
    assert env.parallel_device_count() == want
