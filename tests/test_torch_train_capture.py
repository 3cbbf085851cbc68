"""The capture tier for training (``jit.capture.lower_step``, the
``TrainStep`` built through it, ``jit.program``, ``jit.passes`` and its
lint, the profiler's summaries), on the CPU through
``tests/torch_replay.py``'s ``GraphReplayBackend``: it records every op a
step dispatches and replays them as a CUDA graph replays its kernels, a
value the step read on the host baked in. Also the device scalars of the
update (U2's plain version and every rule read lr and the step count from
0-dim tensors) and the NCCL form of ``reform_world`` over a fake backend.

- 5 captured steps with an LR scheduler are bit for bit 5 eager ones
  (losses, parameters and moments), for every rule ``TrainStep`` runs;
  the same backend does bake a host value (so a baked lr or bias
  correction would show);
- the program: its ops, pass report (``comm_tagged`` 0 with no mesh,
  ``donated_args`` the ``inplace`` leaves), ``describe``/``lower_text``;
  ``memory_stats`` the bytes it names;
- the lint: each rule fires on a step made to break it and a clean step
  has none; the RULES are the JAX package's;
- a backend that holds graphs refuses a step's hazards (a bailout,
  counted), the tier off runs eagerly, ``reshard`` drops the graph, a
  GradScaler's skipped step is skipped in a replay too;
- ``reform_world`` over NCCL aborts the communicators before it destroys
  the group, and gloo only destroys.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.jit.passes import lint as jax_lint

from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch import profiler
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.jit import capture
from paddle_tpu_torch.jit.passes import PassReport, lint
from paddle_tpu_torch.models import DeepFM
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.ops.kernels import multi_tensor as mt
from paddle_tpu_torch.optimizer.lr import StepDecay
from paddle_tpu_torch.parallel import compile_train_step

from torch_replay import GraphReplayBackend

CFG = dict(sparse_feature_number=64, sparse_feature_dim=4,
           dense_feature_dim=3, sparse_field_num=5, layer_sizes=(16,))


@pytest.fixture(autouse=True)
def _clean():
    capture.capture_clear()
    lint.clear_lint_records()
    yield
    capture.set_capture_backend(None)
    capture.set_step_capture_enabled(True)


def _batch(i, B=16):
    r = np.random.RandomState(i)
    return {"sparse": r.randint(0, 64, (B, 5)),
            "dense": r.randn(B, 3).astype(np.float32),
            "y": (r.rand(B, 1) > 0.5).astype(np.float32),
            "mul": np.ones((), np.float32)}


def _loss(m, b):
    return F.binary_cross_entropy_with_logits(
        m(b["sparse"], b["dense"]), b["y"]) * b["mul"]


RULES = {"Adam": lambda s, p: popt.Adam(s, parameters=p),
         "AdamW": lambda s, p: popt.AdamW(s, parameters=p,
                                          grad_clip=ClipGradByGlobalNorm(0.5)),
         "SGD": lambda s, p: popt.SGD(s, parameters=p, weight_decay=0.01),
         "Momentum": lambda s, p: popt.Momentum(s, parameters=p),
         "Adamax": lambda s, p: popt.Adamax(s, parameters=p),
         "Lamb": lambda s, p: popt.Lamb(s, parameters=p),
         "Lars": lambda s, p: popt.Lars(s, parameters=p),
         "RMSProp": lambda s, p: popt.RMSProp(s, parameters=p)}


def _train(rule, backend, steps=5, scaler=None, batches=None):
    model = DeepFM(**CFG, device="cpu", seed=3, mesh=None)
    sched = StepDecay(0.02, step_size=2, gamma=0.5)
    opt = RULES[rule](sched, model.parameters())
    capture.set_capture_backend(backend)
    step = compile_train_step(model, _loss, opt, scaler=scaler)
    losses = []
    for i in range(steps):
        b = batches[i] if batches else _batch(i)
        losses.append(float(step(b)))
        sched.step()
    capture.set_capture_backend(None)
    state = [p.detach().clone() for p in model.parameters()] + [
        v.clone() for st in step._opt_state for v in st.values()]
    return losses, state, step


@pytest.mark.parametrize("rule", sorted(RULES))
def test_captured_steps_with_a_scheduler_equal_eager(rule):
    got, gstate, step = _train(rule, GraphReplayBackend())
    want, wstate, _ = _train(rule, None)
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(gstate, wstate))
    info = step._dispatcher.cache_info()
    assert (info["lowerings"], info["hits"], info["bailouts"],
            info["fallback_calls"]) == (1, 4, 0, 0)
    assert step.captured_program is not None


def test_graph_replay_bakes_a_host_value():
    """The backend is a faithful stand-in: a step that reads a Python
    number at capture time replays that number."""
    box = {"lr": 1.0}
    x = torch.zeros(3)

    def fn(t):
        t.add_(box["lr"])
        return t.sum()

    capture.set_capture_backend(GraphReplayBackend())
    disp, prog = capture.lower_step(fn, (x,), inplace=(0,), name="baked")
    assert prog is not None and x.tolist() == [1.0] * 3
    box["lr"] = 5.0
    disp(x)
    assert x.tolist() == [2.0] * 3          # the replay kept 1.0


def test_program_report_text_and_memory_stats():
    _, _, step = _train("Adam", GraphReplayBackend(), steps=2)
    prog = step.captured_program
    rep = prog.pass_report
    assert isinstance(rep, PassReport)
    assert prog.num_ops == rep.eqns_before == rep.eqns_after > 100
    assert rep.comm_tagged == 0 and rep.passes_run == ["comm"]
    assert (rep.inlined_calls, rep.cse_folded, rep.dve_removed,
            rep.comm_hoisted) == (0, 0, 0, 0)
    n_params = len(step._params)
    # params, 2 moments each, 4 health scalars, then the batch, lr, step
    assert rep.donated_args == tuple(range(3 * n_params + 4)) + tuple(
        3 * n_params + 4 + 4 + i for i in range(2))
    assert prog.op_counts()["aten.mm"] >= 4
    text = step.lower_text(None)
    assert text == prog.describe() and text.startswith("CapturedProgram")
    stats = step.memory_stats(_batch(0))
    params = sum(p.numel() * 4 for p in step._params)
    batch = sum(v.nbytes for v in _batch(0).values())
    assert stats.alias_size_in_bytes == 3 * params + 4 * 6
    assert stats.argument_size_in_bytes == 3 * params + 4 * 6 + batch
    assert (stats.output_size_in_bytes, stats.temp_size_in_bytes) == (4, 0)


def test_lint_rules_fire_and_a_clean_step_has_none():
    assert lint.RULES == jax_lint.RULES
    capture.set_capture_backend(GraphReplayBackend())
    x, y = torch.ones(4), torch.ones(4)
    capture.lower_step(lambda a: (a * 2).sum(), (x,), name="clean")
    capture.lower_step(lambda a: a.sum().item(), (x,), name="sync")
    capture.lower_step(lambda a, b: b.add_(a).sum(), (x, y), inplace=(0,),
                       name="copied")
    disp, _ = capture.lower_step(lambda a: a.sum(), (x,), name="shapes")
    disp(torch.ones(5))
    rec = lint.lint_records()
    assert rec["clean"]["findings"] == []
    assert rec["sync"]["rules_hit"] == ["host-callback"]
    assert rec["copied"]["rules_hit"] == ["donation-miss"]
    assert rec["shapes"]["rules_hit"] == ["recompile-hazard"]
    info = capture.capture_info()
    assert info["bailouts"] == 1 and "HostSync" in info["last_bailout"]
    text = profiler.lint_summary()
    assert "clean" in text and "host-callback" in text
    assert "lowerings=3" in profiler.step_capture_summary()


def test_unscheduled_collective(tmp_path):
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import comms
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        capture.set_capture_backend(GraphReplayBackend())
        x = torch.ones(4)

        def naked(a):
            t = a * 2
            dist.all_reduce(t)
            return t.sum()

        def routed(a):      # a collective issued by the comms layer
            t = a * 2
            with comms.api._peer_guard("all_reduce", comms.link()):
                dist.all_reduce(t)
            return t.sum()
        capture.lower_step(naked, (x,), name="naked")
        capture.lower_step(routed, (x,), name="routed")
    finally:
        dist.destroy_process_group()
    rec = lint.lint_records()
    assert rec["naked"]["rules_hit"] == ["unscheduled-collective"]
    assert rec["routed"]["findings"] == []


def test_hazards_refused_by_a_graph_backend_and_the_tier_off():
    refusing = GraphReplayBackend()
    refusing.holds_graphs = True
    capture.set_capture_backend(refusing)
    calls = []
    disp, prog = capture.lower_step(lambda a: calls.append(1) or a * 2,
                                    (torch.ones(2),), name="hazard",
                                    hazards=("gloo goes through the host",))
    assert prog is None and disp.reason == "gloo goes through the host"
    disp(torch.ones(2))
    assert disp.cache_info()["bailouts"] == 1
    assert disp.cache_info()["fallback_calls"] == 2 and len(calls) == 2
    capture.set_capture_backend(GraphReplayBackend())  # ignores hazards
    _, prog = capture.lower_step(lambda a: a * 2, (torch.ones(2),),
                                 hazards=("gloo",))
    assert prog is not None
    capture.set_step_capture_enabled(False)
    disp, prog = capture.lower_step(lambda a: a * 2, (torch.ones(2),))
    assert prog is None and disp.cache_info()["eager_calls"] == 1


def test_reshard_drops_the_graph_and_the_next_step_captures_again():
    _, _, step = _train("SGD", GraphReplayBackend(), steps=2)
    old = step._dispatcher
    step.reshard({"dp": 1})
    assert step.captured_program is None and old._entry is None
    capture.set_capture_backend(GraphReplayBackend())
    step(_batch(7))
    assert step.captured_program is not None and step._dispatcher is not old


def test_grad_scaler_skip_inside_replays():
    bad = dict(_batch(3), mul=np.full((), np.inf, np.float32))
    batches = [_batch(0), _batch(1), bad, _batch(4), _batch(5)]

    def run(backend):
        scaler = GradScaler(init_loss_scaling=2.0 ** 10,
                            incr_every_n_steps=2)
        losses, state, step = _train("Adam", backend, scaler=scaler,
                                     batches=batches)
        return losses, state, step.skipped_steps, step.loss_scale
    got, gstate, gskip, gscale = run(GraphReplayBackend())
    want, wstate, wskip, wscale = run(None)
    assert np.array_equal(got, want, equal_nan=True)
    assert all(torch.equal(a, b) for a, b in zip(gstate, wstate))
    assert gskip == wskip == 1 and gscale == wscale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_u2_reads_device_lr_and_step(dtype):
    """The plain U2 with lr and step as 0-dim tensors is bit for bit the
    same rule with them as numbers (host powers)."""
    r = np.random.RandomState(0)

    def lists():
        return [[torch.from_numpy(r.randn(7, 5).astype(np.float32))
                 .to(dtype) for _ in range(3)] for _ in range(4)]
    a = lists()
    b = [[t.clone() for t in ts] for ts in a]
    kw = dict(beta1=0.8, beta2=0.95, epsilon=1e-8, weight_decay=0.01,
              decoupled=True)
    for step in (1, 2, 7):
        b[3] = [v.abs() for v in b[3]]
        a[3] = [v.abs() for v in a[3]]
        mt.multi_tensor_adam_ref(*a, lr=3e-3, step=step, **kw)
        mt.multi_tensor_adam_ref(*b, lr=torch.tensor(3e-3),
                                 step=torch.tensor(step, dtype=torch.int32),
                                 **kw)
        for x, y in zip(a, b):
            assert all(torch.equal(u, v) for u, v in zip(x, y))


class _FakeNccl:
    def __init__(self):
        self.calls = []

    def install(self, monkeypatch):
        import torch.distributed as dist
        c10d = dist.distributed_c10d
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_backend", lambda *a: self.backend)
        monkeypatch.setattr(c10d, "_abort_process_group",
                            lambda *a: self.calls.append("abort"))
        monkeypatch.setattr(dist, "destroy_process_group",
                            lambda *a: self.calls.append("destroy"))
        monkeypatch.setattr(dist, "init_process_group",
                            lambda **kw: self.calls.append(
                                ("init", kw["backend"])))
        monkeypatch.setattr(dist, "PrefixStore", lambda p, s: (p, s))


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_reform_world_aborts_nccl_before_destroy(monkeypatch, backend):
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    fake = _FakeNccl()
    fake.backend = backend
    fake.install(monkeypatch)
    monkeypatch.setattr(env, "_env", dict(env._env))
    for k in mesh_mod.NCCL_ELASTIC_ENV:
        monkeypatch.delenv(k, raising=False)
    mesh = mesh_mod.DeviceMesh({"dp": 1}, rank=0, backend=backend,
                               device="cuda:0" if backend == "nccl"
                               else "cpu")
    mesh.rendezvous = (object(), "ev/pg1", 5.0)
    monkeypatch.setattr(mesh, "build_groups", lambda: mesh)
    prev = mesh_mod.get_mesh()
    try:
        mesh_mod.reform_world(mesh)
    finally:
        mesh_mod.set_mesh(prev)
    want = (["abort"] if backend == "nccl" else []) + [
        "destroy", ("init", backend)]
    assert fake.calls == want
    import os
    for k, v in mesh_mod.NCCL_ELASTIC_ENV.items():
        assert os.environ.get(k) == (v if backend == "nccl" else None)


def test_comm_records_of_any_thread_belong_to_the_capture():
    """On the card a step's backward (the exchange's gradient push) runs
    on autograd's device thread: its comms records are observed in the
    warm-up and held back in the capture like those of the forward."""
    import threading
    from paddle_tpu_torch.distributed import comms

    def issue():
        comms.wire_all_reduce(torch.ones(2), None, owner="capture.other")

    for hook in (comms.held_records, comms.observed_records):
        comms.comm_clear()
        with hook() as got:
            t = threading.Thread(target=issue)
            t.start()
            t.join()
        assert [op.owner for op in got] == ["capture.other"]
        counted = comms.comm_info()["collectives"]
        assert counted == (0 if hook is comms.held_records else 1)
    comms.comm_clear()
