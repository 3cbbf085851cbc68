"""Run the port's multi-rank paths as spawned gloo processes on the CPU.

``spawn(scenario, world, tmp_path, payload)`` starts ``world`` processes
(the ``spawn`` start method), each joins a gloo process group through a
``FileStore`` under ``tmp_path`` (so parallel test workers never share a
port), runs ``SCENARIOS[scenario](payload)`` and pickles what it returns;
the parent gets the list of per-rank results. Every process has a time
limit: a late rank is killed and the call raises, as does a rank that
fails (its traceback is in the message).

This module imports torch, numpy and ``paddle_tpu_torch`` only: the ranks
never load JAX. The tests compute the JAX side in their own process and
pass inputs and weights here as numpy arrays.
"""
from __future__ import annotations

import faulthandler
import os
import pickle
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

TIMEOUT_S = 60.0


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, root: str, scenario: str,
               timeout: float) -> None:
    torch.set_num_threads(1)
    repo = str(Path(__file__).resolve().parents[1])
    if repo not in sys.path:
        sys.path.insert(0, repo)
    root = Path(root)
    # a rank still running near its limit writes where it is stuck
    hang = open(root / f"hang{rank}.txt", "w")
    faulthandler.dump_traceback_later(max(1.0, timeout - 3.0), file=hang)
    try:
        import torch.distributed as dist

        from paddle_tpu_torch.distributed import init_parallel_env
        payload = pickle.loads((root / "payload.pkl").read_bytes())
        payload["_root"] = str(root)   # for a rank that leaves early
        store = dist.FileStore(str(root / "store"), world)
        init_parallel_env(backend="gloo", device="cpu", store=store,
                          rank=rank, world_size=world,
                          mesh_shape=payload.get("mesh"), timeout=timeout)
        out = SCENARIOS[scenario](payload)
        (root / f"out{rank}.pkl").write_bytes(pickle.dumps(out))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent, then exit 1
        (root / f"err{rank}.txt").write_text(traceback.format_exc())
        os._exit(1)
    # skip the interpreter's teardown: under load a gloo rank's native
    # threads could abort it ("terminate called without an active
    # exception") after its result was written
    faulthandler.cancel_dump_traceback_later()
    hang.close()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def spawn(scenario: str, world: int, tmp_path, payload: dict,
          timeout: float = TIMEOUT_S) -> list:
    """Per-rank results of ``scenario`` on ``world`` gloo CPU ranks."""
    import torch.multiprocessing as mp
    root = Path(tmp_path) / f"{scenario}_{world}_{time.monotonic_ns()}"
    root.mkdir(parents=True)
    (root / "payload.pkl").write_bytes(pickle.dumps(payload))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(root), scenario, timeout),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    errs = {r: (root / f"err{r}.txt").read_text()
            for r in range(world) if (root / f"err{r}.txt").exists()}
    for r in late:
        errs.setdefault(r, (root / f"hang{r}.txt").read_text())
    if late or errs or any(p.exitcode != 0 for p in procs):
        raise AssertionError(
            f"{scenario} on {world} ranks: late ranks {late}, exit codes "
            f"{[p.exitcode for p in procs]}\n" + "\n".join(
                f"--- rank {r} ---\n{e}" for r, e in errs.items()))
    return [pickle.loads((root / f"out{r}.pkl").read_bytes())
            for r in range(world)]


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# scenarios (each runs on every rank and returns picklable results)
# ---------------------------------------------------------------------------

def _mesh(payload):
    from paddle_tpu_torch.distributed import comms
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    m = mesh_mod.get_mesh()
    out = {"coords": dict(m.coords), "ranks": {}, "sums": {}}
    for axes in list(m.axis_names) + [tuple(m.axis_names), None]:
        key = axes if axes is not None else "world"
        out["ranks"][str(key)] = m.axis_ranks(axes)
        r = torch.tensor([float(m.rank)])
        out["sums"][str(key)] = float(comms.wire_all_reduce(r, axes))
    out["index"] = {a: mesh_mod.axis_index(a) for a in m.axis_names}
    from paddle_tpu_torch.distributed import ParallelEnv, env
    pe = ParallelEnv()
    out["env"] = (pe.rank, pe.world_size, pe.nranks, pe.local_rank,
                  env.get_backend(), str(env.current_device()))
    if "batch" in payload:
        from paddle_tpu_torch.distributed import shard_batch
        out["dp_rows"] = _np(shard_batch(_t(payload["batch"])))
        out["sep_cols"] = _np(shard_batch(_t(payload["batch"]), "mp", 1))
    return out


def _collective(payload):
    import torch.distributed as tdist

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    m = mesh_mod.get_mesh()
    axis = payload["axis"]
    g = dist.new_group(axis=axis)
    me = m.axis_index(axis)
    n = g.nranks
    x = _t(payload["x"][m.rank])
    res = {"group": (g.nranks, g.rank, g.ranks), "backend":
           dist.get_backend(g)}
    for op in ("sum", "max", "min", "avg", "prod"):
        t = x.clone()
        dist.all_reduce(t, op=op, group=g)
        res[f"all_reduce_{op}"] = _np(t)
    t = x.clone()
    dist.reduce(t, dst=0, group=g)
    res["reduce"] = _np(t)
    res["all_gather"] = _np(dist.all_gather(None, x, group=g))
    lst = []
    dist.all_gather(lst, x, group=g)
    res["all_gather_list"] = [_np(v) for v in lst]
    pieces = list(_t(payload["pieces"][m.rank]).unbind(0))
    outs = []
    dist.all_to_all(outs, pieces, group=g)
    res["all_to_all"] = np.stack([_np(v) for v in outs])
    t = torch.empty_like(pieces[0])
    dist.reduce_scatter(t, pieces, group=g)
    res["reduce_scatter"] = _np(t)
    t = x.clone()
    dist.broadcast(t, src=1, group=g)
    res["broadcast"] = _np(t)
    t = torch.empty_like(pieces[0])
    dist.scatter(t, pieces, src=1, group=g)
    res["scatter"] = _np(t)
    gl = []
    dist.gather(x, gl, dst=0, group=g)
    res["gather"] = [_np(v) for v in gl]
    # a ring: rank j receives from j - 1 (JAX: recv(src=lambda r: r - 1))
    y = torch.empty_like(x)
    dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, lambda r: (r + 1) % n, g),
        dist.P2POp(dist.irecv, y, lambda r: (r - 1) % n, g)])
    res["ring"] = _np(y)
    # a pair: rank 0 sends, rank 1 receives
    z = torch.zeros_like(x)
    if me == 0:
        dist.send(x, dst=1, group=g)
    elif me == 1:
        dist.recv(z, src=0, group=g)
    res["pair"] = _np(z)
    objs = []
    dist.all_gather_object(objs, {"rank": me, "tag": "r%d" % me}, group=g)
    res["objects"] = objs
    dist.barrier(group=g)
    dist.wait(x)
    from paddle_tpu_torch.distributed import comms
    res["recorded"] = sorted(comms.comm_info()["sites"])
    res["from_ranks_axis"] = dist.new_group(
        ranks=m.axis_ranks(axis)).axis
    res["world_sum"] = _np(dist.all_reduce(x.clone(), group=None)._tensor)
    res["default_group_n"] = dist.get_group(0).nranks
    res["world_size"] = (dist.get_world_size(), tdist.get_world_size())
    dist.destroy_process_group(g)         # the registry only: g is given
    res["after_destroy"] = dist.get_group(g.id).id
    return res


def _comms(payload):
    from paddle_tpu_torch.distributed import comms
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    m = mesh_mod.get_mesh()
    axis = payload["axis"]
    me = m.axis_index(axis)
    out = {}
    comms.comm_clear()
    for dt in ("int8", "fp8"):
        x = _t(payload["x"][me])
        with comms.quantized(dt, block=payload["block"]):
            with comms.step_schedule("ar") as sch:
                out[f"ar_{dt}"] = _np(comms.wire_all_reduce(x, axis, "sum"))
                out[f"ar_avg_{dt}"] = _np(comms.wire_all_reduce(x, axis,
                                                                "avg"))
            out[f"ar_ops_{dt}"] = [(o.kind, o.bytes_logical, o.bytes_wire,
                                    o.quantized, o.staged_bytes, o.axis)
                                   for o in sch.ops]
            out[f"ag_{dt}"] = _np(comms.wire_all_gather(x, axis))
            blocks = _t(payload["blocks"][me])
            out[f"a2a_{dt}"] = _np(comms.wire_all_to_all(blocks, axis))
            out[f"qar_{dt}"] = _np(comms.quantized_all_reduce(
                x, axis=axis, op="avg", owner="test"))
            grads = [_t(a) for a in payload["grads"][me]]
            with comms.step_schedule("gs") as sch:
                synced = comms.grad_sync(grads, m, axis, op="avg")
            out[f"gs_{dt}"] = [_np(g) for g in synced]
            out[f"gs_ops_{dt}"] = [(o.kind, o.bytes_logical, o.bytes_wire,
                                    o.quantized) for o in sch.ops]
    x = _t(payload["x"][me])
    with comms.step_schedule("exact") as sch:
        out["ar_exact"] = _np(comms.wire_all_reduce(x, axis, "sum"))
        grads = [_t(a) for a in payload["grads"][me]]
        out["gs_exact"] = [_np(g) for g in comms.grad_sync(grads, m, axis)]
    out["exact_ops"] = [(o.kind, o.bytes_logical, o.bytes_wire, o.quantized,
                         o.staged_bytes) for o in sch.ops]
    out["info"] = comms.comm_info()
    return out


def _mp_layers(payload):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers \
        as L
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    m = mesh_mod.get_mesh()
    n, r = L.mp_degree()
    out = {}
    V, H, O = payload["V"], payload["H"], payload["O"]

    def load(p, full):
        split = getattr(p, "split_axis", None)
        arr = np.split(full, n, axis=split)[r] if split is not None else full
        with torch.no_grad():
            p.copy_(_t(arr))

    def grads_of(mod):
        return {k: _np(p.grad) for k, p in mod.named_parameters()}

    ids = _t(payload["ids"])
    emb = L.VocabParallelEmbedding(V, H, device="cpu")
    load(emb.weight, payload["emb"])
    y = emb(ids)
    (y * _t(payload["g_emb"])).sum().backward()
    out["emb"] = (_np(y), grads_of(emb))

    x = _t(payload["x"]).requires_grad_(True)
    for gather in (True, False):
        col = L.ColumnParallelLinear(H, O, device="cpu", has_bias=True,
                                     gather_output=gather)
        load(col.weight, payload["col_w"])
        load(col.bias, payload["col_b"])
        x.grad = None
        y = col(x)
        g = _t(payload["g_col"])
        if not gather:
            g = g.chunk(n, dim=-1)[r]
        (y * g).sum().backward()
        out[f"col_{gather}"] = (_np(y), grads_of(col), _np(x.grad))

    for parallel in (True, False):
        row = L.RowParallelLinear(O, H, device="cpu", has_bias=True,
                                  input_is_parallel=parallel)
        load(row.weight, payload["row_w"])
        load(row.bias, payload["row_b"])
        xr = _t(payload["xr"])
        if parallel:
            xr = xr.chunk(n, dim=-1)[r].contiguous()
        xr.requires_grad_(True)
        y = row(xr)
        (y * _t(payload["g_row"])).sum().backward()
        out[f"row_{parallel}"] = (_np(y), grads_of(row), _np(xr.grad))

    logits = _t(payload["logits"]).chunk(n, dim=-1)[r].contiguous()
    logits.requires_grad_(True)
    ce = L.ParallelCrossEntropy()(logits, _t(payload["labels"]))
    (ce * _t(payload["g_ce"])).sum().backward()
    out["pce"] = (_np(ce), _np(logits.grad))

    seq = _t(payload["seq"])            # [B, S, H]
    for name, op in (("scatter", L.ScatterOp), ("gather", L.GatherOp),
                     ("allgather", L.AllGatherOp),
                     ("reducescatter", L.ReduceScatterOp)):
        inp = seq if name in ("scatter", "reducescatter") \
            else seq.chunk(n, dim=1)[r].contiguous()
        inp = inp.clone().requires_grad_(True)
        y = op.apply(inp, 1)
        gy = _t(payload[f"g_{name}"][r])
        (y * gy).sum().backward()
        out[name] = (_np(y), _np(inp.grad))

    # sequence-parallel linears + the norm-weight hook: [B, S/n, H] in
    colsp = L.ColumnSequenceParallelLinear(H, O, device="cpu",
                                           has_bias=False)
    rowsp = L.RowSequenceParallelLinear(O, H, device="cpu", has_bias=False)
    load(colsp.weight, payload["col_w"])
    load(rowsp.weight, payload["row_w"])
    scale = torch.nn.Parameter(torch.ones(H))
    L.mark_as_sequence_parallel_parameter(scale)
    holder = torch.nn.Module()
    holder.scale = scale
    L.register_sequence_parallel_allreduce_hooks(holder)
    xs = seq.chunk(n, dim=1)[r].contiguous().requires_grad_(True)
    y = rowsp(colsp(xs * scale))
    (y * _t(payload["g_sp"]).chunk(n, dim=1)[r]).sum().backward()
    out["sp"] = (_np(y), _np(colsp.weight.grad), _np(rowsp.weight.grad),
                 _np(scale.grad), _np(xs.grad))
    out["mp"] = (n, r, m.rank)
    return out


def _tp_ce(payload):
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_linear_cross_entropy_tp
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    m = mesh_mod.get_mesh()
    n, r = m.shape["mp"], m.coords["mp"]
    h = _t(payload["h"]).requires_grad_(True)
    w = _t(np.split(payload["w"], n, axis=1)[r]).requires_grad_(True)
    loss = fused_linear_cross_entropy_tp(h, w, _t(payload["labels"]), "mp")
    (loss * _t(payload["g"])).sum().backward()
    return {"loss": _np(loss), "dh": _np(h.grad), "dw": _np(w.grad)}


def _cp(payload):
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.parallel.context_parallel import \
        sdpa_context_parallel
    m = mesh_mod.get_mesh()
    n, r = m.shape["sep"], m.coords["sep"]
    out = {}
    for case in payload["cases"]:
        q, k, v, g = (_t(a).chunk(n, dim=1)[r].contiguous()
                      for a in (case["q"], case["k"], case["v"], case["g"]))
        for t in (q, k, v):
            t.requires_grad_(True)
        o = sdpa_context_parallel(q, k, v, mode=case["mode"],
                                  is_causal=case["causal"])
        (o * g).sum().backward()
        out[case["name"]] = (_np(o), _np(q.grad), _np(k.grad), _np(v.grad))
    return out


def _build_step(cfg_d):
    """(model, step, mesh) of one configuration of
    ``build_hybrid_train_step`` / ``TrainStep`` on its mesh, from the
    payload's weights."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_hybrid_train_step,
                                         load_paddle_tpu_state)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.parallel import compile_train_step
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.init_mesh(cfg_d["mesh"], devices="cpu")
    cfg = LlamaConfig(**cfg_d["config"])
    model = LlamaForCausalLM(cfg, device="cpu", mesh=mesh)
    load_paddle_tpu_state(model, cfg_d["state"])
    clip = ClipGradByGlobalNorm(cfg_d["clip"]) if cfg_d.get("clip") else None
    opt = popt.AdamW(learning_rate=cfg_d["lr"], parameters=model.parameters(),
                     epsilon=cfg_d["eps"], grad_clip=clip)
    if cfg_d.get("zero"):
        from paddle_tpu_torch.distributed.fleet.meta_parallel import \
            sharding_optimizer as SO
        level = {1: "os", 2: "os_g", 3: "p_g_os"}[cfg_d["zero"]]
        _, opt, _ = SO.group_sharded_parallel(model, opt, level)
    if cfg_d["kind"] == "hybrid":
        step = build_hybrid_train_step(
            model, opt, mesh=mesh, remat=cfg_d.get("remat", True),
            amp=cfg_d.get("amp", False),
            accumulate_steps=cfg_d.get("accumulate", 1),
            n_microbatches=cfg_d.get("micro", 1),
            schedule=cfg_d.get("schedule", "1f1b"),
            n_virtual=cfg_d.get("virtual", 1))
    else:
        scaler = GradScaler(**cfg_d["scaler"]) if cfg_d.get("scaler") \
            else None
        loss = LlamaForCausalLM.loss_sum if cfg_d.get("loss_sum") \
            else LlamaForCausalLM.compute_loss
        step = compile_train_step(
            model, lambda mdl, b: loss(mdl, b["input_ids"], b["labels"]),
            opt, mesh=mesh, scaler=scaler,
            accumulate_steps=cfg_d.get("accumulate", 1))
    return model, step, mesh


def _hybrid_run(cfg_d):
    """One configuration of ``build_hybrid_train_step`` / ``TrainStep`` on
    its mesh: per-step losses and (gathered) final parameters."""
    from paddle_tpu_torch.distributed import comms
    from paddle_tpu_torch.models.llama import paddle_tpu_state
    model, step, mesh = _build_step(cfg_d)
    losses = []
    comms.comm_clear()
    for ids, labels in cfg_d["batches"]:
        b = {"input_ids": ids, "labels": labels}
        if cfg_d.get("quant"):
            with comms.quantized(cfg_d["quant"]):
                losses.append(float(step(b)))
        else:
            losses.append(float(step(b)))
    zero = step.state["zero"] if cfg_d["kind"] == "hybrid" \
        else step._zero
    opt_states = step.state["opt"].values() if cfg_d["kind"] == "hybrid" \
        else step._opt_state
    names = list(step.state["params"]) if cfg_d["kind"] == "hybrid" \
        else step._param_names
    zinfo = None if zero is None else {
        "axis": zero.axis, "stage": zero.stage, "dims": list(zero.dims),
        "names": names,
        "state_bytes": zero.state_bytes(list(opt_states)),
        "full_bytes": sum(2 * 4 * int(np.prod(zero.full_shape(k)))
                          for k in range(len(zero.tensors)))}
    step.write_back()
    state = paddle_tpu_state(model)
    info = comms.comm_info()
    return {"losses": losses, "state": state if mesh.rank == 0 else None,
            "zero": zinfo,
            "pipeline": step.state.get("pipeline")
            if cfg_d["kind"] == "hybrid" else None,
            "sites": {k: (v["count"], v["quantized"])
                      for k, v in info["sites"].items()}}


def _hybrid(payload):
    return {c["name"]: _hybrid_run(c) for c in payload["configs"]}


def _finite_skip(payload):
    """TrainStep on dp2 under the quantized grad sync with one step whose
    loss is inf on rank 0's rows only: every rank must skip it."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.distributed import comms
    from paddle_tpu_torch.parallel import compile_train_step
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.init_mesh({"dp": 2}, devices="cpu")
    torch.manual_seed(0)
    model = torch.nn.Linear(64, 8, bias=False)   # every grad quantized
    opt = popt.AdamW(learning_rate=1e-2, parameters=model.parameters())
    step = compile_train_step(
        model, lambda m, b: ((m(b["x"]) - b["y"]) ** 2).mean()
        * b["poison"].max(), opt, mesh=mesh)
    out = []
    with comms.quantized("int8", block=16):
        for i, poison in enumerate(payload["poisons"]):
            before = [p.detach().clone() for p in model.parameters()]
            loss = step({"x": _t(payload["x"][i]), "y": _t(payload["y"][i]),
                         "poison": _t(poison)})
            same = all(torch.equal(a, p) for a, p in
                       zip(before, model.parameters()))
            out.append((float(loss), same, step.skipped_steps))
    return {"steps": out, "rank": mesh.rank}


def _pipe_stage(params, x):
    """A stage of ``tanh(x W + b)`` layers: leaves ``[n, H, H]`` /
    ``[n, H]`` (n layers), or one layer's ``[H, H]`` / ``[H]``."""
    w, b = params["w"], params["b"]
    if w.dim() == 2:
        return torch.tanh(x @ w + b)
    for j in range(w.shape[0]):
        x = torch.tanh(x @ w[j] + b[j])
    return x


def _pipe_head_loss(kind):
    def mse(head, y, labels):
        return ((y @ head["wo"] - labels) ** 2).mean()

    def ce(head, y, labels):
        """The valid-label mean of one microbatch's cross entropy."""
        logits = (y @ head["wo"]).reshape(-1, head["wo"].shape[-1])
        lab = labels.reshape(-1)
        valid = lab != -100
        rows = torch.nn.functional.cross_entropy(
            logits, torch.where(valid, lab, 0), reduction="none")
        return (rows * valid).sum() / valid.sum().clamp_min(1)
    return {"mse": mse, "ce": ce}[kind]


def _pipe_total_loss(kind, head, y, labels):
    """gpipe / vpp: the loss of the whole reassembled batch (for ``ce`` the
    valid-label mean over every microbatch)."""
    M = y.shape[0]
    if kind == "mse":
        return _pipe_head_loss("mse")(head, y.reshape(-1, y.shape[-1]),
                                      labels.reshape(-1, labels.shape[-1]))
    return _pipe_head_loss("ce")(head, y.reshape(M * y.shape[1], -1),
                                 labels.reshape(-1))


def _pipeline(payload):
    """Each case of ``payload["cases"]`` through the port's schedules on the
    pp axis: loss, this rank's stage grads, the head grads, dx (and the
    outputs for gpipe / vpp), and ``pipeline_info()``."""
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.parallel import pipeline as PL
    m = mesh_mod.get_mesh()
    S, i = m.shape["pp"], m.coords["pp"]
    out = {}
    for case in payload["cases"]:
        sched, M, v = case["schedule"], case["M"], case.get("v", 1)
        full = {k: _t(a) for k, a in case["params"].items()}
        if sched == "vpp":      # [L, ...] -> [v, S, ...], this rank's [:, i]
            params = {k: a.reshape(v, S, *a.shape[1:])[:, i].clone()
                      for k, a in full.items()}
        else:                   # [L, ...] -> this rank's [L/S, ...]
            n = full["w"].shape[0] // S
            params = {k: a[i * n:(i + 1) * n].clone() for k, a in
                      full.items()}
        head = {"wo": _t(case["wo"])}
        x = _t(case["x"])
        labels = _t(case["labels"])
        res = {}
        if sched in ("gpipe", "vpp"):
            leaves = {k: p.requires_grad_(True) for k, p in params.items()}
            hl = {k: p.requires_grad_(True) for k, p in head.items()}
            xl = x.clone().requires_grad_(True)
            y = PL.spmd_pipeline(_pipe_stage, leaves, xl, n_microbatches=M,
                                 schedule=sched, n_virtual=v,
                                 remat=case.get("remat", True))
            loss = _pipe_total_loss(case["loss"], hl, y, labels)
            loss.backward()
            res.update(loss=float(loss), y=_np(y),
                       g_stage={k: _np(p.grad) for k, p in leaves.items()},
                       g_head={k: _np(p.grad) for k, p in hl.items()},
                       dx=_np(xl.grad))
        else:
            loss, gs, gh, dx = PL.spmd_pipeline_1f1b(
                _pipe_stage, _pipe_head_loss(case["loss"]), params, head, x,
                labels, n_microbatches=M,
                variant="compact" if sched == "1f1b_compact" else "fused")
            res.update(loss=float(loss),
                       g_stage={k: _np(g) for k, g in gs.items()},
                       g_head={k: _np(g) for k, g in gh.items()},
                       dx=_np(dx))
        res["info"] = PL.pipeline_info()
        out[case["name"]] = res
    return out


def _fleet(payload):
    """``fleet.init`` with the payload's strategy, the HCG's answers, then
    ``distributed_optimizer`` -> ``build_hybrid_train_step`` on the
    installed mesh for three steps."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_hybrid_train_step,
                                         load_paddle_tpu_state)
    from paddle_tpu_torch.models.llama import paddle_tpu_state
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(payload["hybrid"])
    if payload.get("stage"):
        strategy.sharding = True
        strategy.sharding_configs["stage"] = payload["stage"]
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    groups = {}
    for name in ("data", "model", "pipe", "sharding"):
        g = getattr(hcg, f"get_{name}_parallel_group")()
        groups[name] = (g.nranks, g.rank, g.ranks)
    out = {"degrees": (hcg.get_data_parallel_world_size(),
                       hcg.get_model_parallel_world_size(),
                       hcg.get_pipe_parallel_world_size(),
                       hcg.get_sharding_parallel_world_size()),
           "ranks": (hcg.get_data_parallel_rank(),
                     hcg.get_model_parallel_rank(), hcg.get_stage_id(),
                     hcg.get_sharding_parallel_rank()),
           "mode": hcg.get_parallel_mode(), "groups": groups,
           "mesh": dict(hcg.mesh.shape), "coords": dict(hcg.mesh.coords),
           "comm_list": hcg.topology().get_comm_list("pipe"),
           "workers": (fleet.worker_num(), fleet.worker_index(),
                       fleet.is_first_worker())}
    mesh = hcg.mesh
    cfg = LlamaConfig(**payload["config"])
    model = LlamaForCausalLM(cfg, device="cpu", mesh=mesh)
    load_paddle_tpu_state(model, payload["state"])
    opt = popt.AdamW(learning_rate=payload["lr"],
                     parameters=model.parameters(), epsilon=payload["eps"],
                     grad_clip=ClipGradByGlobalNorm(1.0))
    opt = fleet.distributed_optimizer(opt)
    step = build_hybrid_train_step(model, opt, mesh=mesh,
                                   n_microbatches=payload["micro"],
                                   schedule=payload["schedule"])
    out["losses"] = [float(step({"input_ids": i, "labels": lab}))
                     for i, lab in payload["batches"]]
    z = step.state["zero"]
    out["zero"] = None if z is None else (z.axis, z.stage)
    step.write_back()
    state = paddle_tpu_state(model)
    out["state"] = state if mesh.rank == 0 else None
    return out


def _data_parallel(payload):
    """Eager ``DataParallel`` training on dp: each rank feeds its half of
    every batch, ``loss.backward()``, then the optimizer's step (AdamW, or
    ``DygraphShardingOptimizer(AdamW)`` for the eager ZeRO update)."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.distributed import DataParallel, shard_batch
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        DygraphShardingOptimizer
    out = {}
    for zero in (False, True):
        lin = torch.nn.Linear(16, 8, bias=True)
        with torch.no_grad():
            lin.weight.copy_(_t(payload["w"]))
            lin.bias.copy_(_t(payload["b"]))
        model = DataParallel(lin)
        opt = popt.AdamW(learning_rate=1e-2, parameters=lin.parameters())
        if zero:
            opt = DygraphShardingOptimizer(opt)
        for x, y in zip(payload["x"], payload["y"]):
            xl, yl = shard_batch(_t(x)), shard_batch(_t(y))
            loss = ((model(xl) - yl) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
        inner = getattr(opt, "inner_opt", opt)
        out["zero" if zero else "plain"] = {
            "w": _np(lin.weight), "b": _np(lin.bias),
            "state_numel": sum(v.numel() for st in inner._states.values()
                               for v in st.values()
                               if isinstance(v, torch.Tensor))}
    return out


def spawn_probe(root):
    """A ``distributed.spawn`` target: join through the launcher's
    variables, all-reduce the rank, write what this rank saw."""
    import json

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import comms
    env = dist.init_parallel_env(device="cpu")
    total = comms.wire_all_reduce(torch.tensor([float(env.rank)]), "dp",
                                  exact=True)
    Path(root, f"spawn{env.rank}.json").write_text(json.dumps(
        {"rank": env.rank, "world": env.world_size,
         "local": env.local_rank, "sum": float(total)}))
    dist.barrier()
    dist.destroy_process_group()


def _cp_direct(payload):
    """``ring_attention`` / ``ulysses_attention`` called directly in the
    JAX functions' per-rank layout ``[B, H, S_loc, D]`` with ``axis_name``
    second: output and q/k/v grads of each case."""
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.parallel.context_parallel import (
        ring_attention, ulysses_attention)
    m = mesh_mod.get_mesh()
    n, r = m.shape["sep"], m.coords["sep"]
    out = {}
    for case in payload["cases"]:
        q, k, v, g = (_t(a).chunk(n, dim=2)[r].contiguous()
                      for a in (case["q"], case["k"], case["v"], case["g"]))
        for t in (q, k, v):
            t.requires_grad_(True)
        if case["fn"] == "ring":
            o = ring_attention(q, k, v, "sep", case["causal"],
                               impl=case["impl"])
        else:
            o = ulysses_attention(q, k, v, "sep", case["causal"])
        (o * g).sum().backward()
        out[case["name"]] = (_np(o), _np(q.grad), _np(k.grad), _np(v.grad))
    return out


def _zero_reads(payload):
    """ZeRO stage 3 between steps: ``paddle_tpu_state`` read after the
    last step with no ``write_back()`` ("before"), then after it
    ("after"); ``write_back_first`` calls ``write_back()`` after the first
    step too (its copies must not go stale)."""
    from paddle_tpu_torch.models.llama import paddle_tpu_state
    out = {}
    for c in payload["configs"]:
        model, step, mesh = _build_step(c)
        losses = []
        for i, (ids, labels) in enumerate(c["batches"]):
            losses.append(float(step({"input_ids": ids, "labels": labels})))
            if i == 0 and c.get("write_back_first"):
                step.write_back()
        before = paddle_tpu_state(model)
        step.write_back()
        after = paddle_tpu_state(model)
        out[c["name"]] = {"losses": losses,
                          "before": before if mesh.rank == 0 else None,
                          "after": after if mesh.rank == 0 else None}
    return out


def _bricks_np(step):
    from paddle_tpu_torch.distributed import checkpoint
    bricks, _ = checkpoint.shard_bricks(step.state)
    return {k: np.asarray(v).tobytes() for k, v in bricks.items()}


def _ckpt_hybrid(payload):
    """dp2 x mp2 ZeRO-1 hybrid step: ``save`` steps, a sharded generation
    of ``step.state`` (one owner a rank), then the rest; a fresh step from
    other weights restores the generation and takes the rest again."""
    import torch.distributed as tdist

    from paddle_tpu_torch.distributed import CheckpointManager, checkpoint
    from paddle_tpu_torch.models.llama import paddle_tpu_state
    cfg = payload["config"]
    k = payload["save"]
    model, step, mesh = _build_step(cfg)
    batches = [{"input_ids": i, "labels": lab} for i, lab in cfg["batches"]]
    losses = [float(step(b)) for b in batches[:k]]
    mgr = CheckpointManager(payload["root"], keep_last_k=2)
    owners = [f"rank{r}" for r in range(tdist.get_world_size())]
    saved = _bricks_np(step)
    bricks, meta = checkpoint.shard_bricks(step.state)
    stats = mgr.save_sharded(k, owners[mesh.rank], owners, bricks, meta)
    at_save = paddle_tpu_state(step.write_back())
    losses += [float(step(b)) for b in batches[k:]]
    # the gather layout: an untagged mp model's parameters (split_axis),
    # saved by every rank on the writer thread (the barrier's own group)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models import load_paddle_tpu_state
    plain = LlamaForCausalLM(LlamaConfig(**cfg["config"]), device="cpu",
                             mesh=mesh)
    load_paddle_tpu_state(plain, cfg["state"])
    checkpoint.save_state_dict(dict(plain.named_parameters()),
                               payload["root"] + "_flat", async_save=True)
    checkpoint.wait()
    model2, step2, _ = _build_step(dict(cfg, state=payload["other_state"]))
    restored_step = mgr.restore(step2.state)
    restored = _bricks_np(step2)
    resumed = [float(step2(b)) for b in batches[k:]]
    return {"losses": losses, "resumed": resumed, "saved": saved,
            "restored": restored, "step": restored_step,
            "step_count": step2.state["step"], "bytes": stats["bytes"],
            "at_save": at_save if mesh.rank == 0 else None,
            "latest": mgr.latest()}


def _moe_ep(payload):
    """``MoELayer`` over the mesh's ep axis from the JAX layer's weights:
    output, ``l_aux``, the input's grad, the gate's grad and this rank's
    experts' grads (keyed by global expert index)."""
    from paddle_tpu_torch.distributed.fleet import moe
    out = {}
    for c in payload["cases"]:
        layer = moe.MoELayer(c["d"], gate=c["gate"], num_experts=c["E"],
                             top_k=c["k"], capacity_factor=c["cf"],
                             d_hidden=c["h"], device="cpu")
        moe.load_paddle_tpu_state(layer, c["state"])
        x = _t(c["x"]).requires_grad_(True)
        y = layer(x)
        loss = (y * _t(c["cot"])).sum() + c["aux_w"] * layer.l_aux
        loss.backward()
        grads = {}
        for n, p in layer.named_parameters():
            if n.startswith("experts."):
                head, idx, rest = n.split(".", 2)
                n = f"{head}.{int(idx) + layer.expert_offset}.{rest}"
            grads[n] = _np(p.grad)
        out[c["name"]] = {"y": _np(y), "l_aux": float(layer.l_aux.detach()),
                          "dx": _np(x.grad), "grads": grads,
                          "ep": layer.ep, "offset": layer.expert_offset}
    return out


def _rng_tracker(payload):
    """Dropout masks on every mp rank: inside the tracker's
    ``model_parallel_rng`` (the same everywhere), twice in a row (the
    stream advances), and with the default generator."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        random_state as rs
    rs.model_parallel_random_seed(payload["seed"], device="cpu")
    tracker = rs.get_rng_state_tracker()
    ones = torch.ones(64, 16)
    with tracker.rng_state():
        first = torch.nn.functional.dropout(ones, 0.5)
    with tracker.rng_state():
        second = torch.nn.functional.dropout(ones, 0.5)
    plain = torch.nn.functional.dropout(ones, 0.5)
    return {"first": _np(first), "second": _np(second), "plain": _np(plain)}


def _fleet_util(payload):
    """``UtilBase``'s collectives over the world, and the file shard."""
    from paddle_tpu_torch.distributed.fleet import util
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    u = util.UtilBase()
    r = mesh_mod.get_mesh().rank
    x = np.arange(4, dtype=np.float64) * (r + 1)
    u.barrier()
    return {"sum": u.all_reduce(x, "sum"), "max": u.all_reduce(x, "max"),
            "min": u.all_reduce(x, "min"),
            "gather": u.all_gather({"rank": r}),
            "shard": u.get_file_shard([f"f{i}" for i in range(7)])}


def _leave_early(payload, rank, out) -> None:
    """A rank that leaves the world mid-scenario (an elastic shrink): it
    writes its result itself and exits, skipping the harness's barrier
    over a world it is no longer in."""
    (Path(payload["_root"]) / f"out{rank}.pkl").write_bytes(
        pickle.dumps(out))
    sys.stdout.flush()
    os._exit(0)


def _gather_blocks(step, views):
    """Every state block of a ``supervised_state()`` gathered over the
    world and put together whole: name -> full numpy array."""
    import torch.distributed as tdist
    params, _ = step.supervised_state()
    mine = {n: np.asarray(v) for n, v in views.items()}
    allb = [None] * tdist.get_world_size()
    tdist.all_gather_object(allb, mine)
    out = {}
    for n, p in params.items():
        d = next((i for i, s in enumerate(p.spec) if s), None)
        out[n] = allb[0][n] if d is None else np.concatenate(
            [b[n] for b in allb], axis=d)
    return out


def _elastic_reshard(payload):
    """dp2 ZeRO-1 ``TrainStep``: two steps, every block gathered; rank 1
    leaves; rank 0 re-forms a world of one (``elastic_mesh`` over a fresh
    store, ``TrainStep.reshard`` with the moments it lacks from the
    gathered host state), holds every parameter and moment against the
    gathered values, and takes the next step."""
    import torch.distributed as tdist
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    cfg = payload["config"]
    model, step, mesh = _build_step(cfg)
    batches = [{"input_ids": i, "labels": lab} for i, lab in cfg["batches"]]
    losses = [float(step(b)) for b in batches[:2]]
    params, views = step.supervised_state()
    share = sum(np.asarray(v).size for n, v in views.items()
                if n.startswith("opt.")) / sum(
        int(np.prod(p.shape)) for n, p in params.items()
        if n.startswith("opt."))
    full = _gather_blocks(step, views)
    if mesh.rank == 1:
        _leave_early(payload, 1, {"losses": losses, "share": share})
    store = tdist.FileStore(str(Path(payload["_root"]) / "store_e1"), 1)
    t0 = time.perf_counter()
    step.reshard(mesh_mod.elastic_mesh({"dp": 1}, 0, store=store,
                                       prefix="epoch1", timeout=30.0,
                                       device="cpu", backend="gloo"),
                 state={n: a for n, a in full.items()
                        if n.startswith("opt.")})
    swap_s = time.perf_counter() - t0
    _, after = step.supervised_state()
    equal = {n: np.asarray(after[n]).tobytes() == full[n].tobytes()
             for n in full}
    after_share = sum(np.asarray(v).size for n, v in after.items()
                      if n.startswith("opt.")) / sum(
        int(np.prod(p.shape)) for n, p in params.items()
        if n.startswith("opt."))
    losses.append(float(step(batches[2])))
    return {"losses": losses, "equal": equal, "share": share,
            "after_share": after_share, "swap_s": swap_s,
            "world": tdist.get_world_size(),
            "mesh": dict(mesh_mod.get_mesh().shape),
            "skipped": step.skipped_steps, "step": step._step_count}


def _lost_peer(payload):
    """One all-reduce, then rank 1 leaves while rank 0 waits in the next
    one: rank 0 gets ``CommTimeout`` (not a hang, not a raw backend
    error), leaves the broken group and forms a world of one."""
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed import comms
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    from paddle_tpu_torch.utils.deadline import CommTimeout
    x = torch.ones(1024)
    first = float(comms.wire_all_reduce(x, "dp", exact=True)[0])
    if tdist.get_rank() == 1:
        time.sleep(0.5)
        _leave_early(payload, 1, {"first": first})
    t0 = time.perf_counter()
    err = None
    try:
        comms.wire_all_reduce(x, "dp", exact=True)
    except CommTimeout as e:
        err = str(e)
    waited = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_mod.reform_world(mesh_mod.elastic_mesh(
        {"dp": 1}, 0, store=tdist.FileStore(
            str(Path(payload["_root"]) / "store_e1"), 1),
        prefix="epoch1", timeout=30.0, device="cpu", backend="gloo"))
    reform_s = time.perf_counter() - t0
    again = float(comms.wire_all_reduce(x, "dp", exact=True)[0])
    return {"first": first, "error": err, "waited": waited,
            "reform_s": reform_s, "again": again}


SCENARIOS = {"mesh": _mesh, "collective": _collective, "comms": _comms,
             "mp_layers": _mp_layers, "tp_ce": _tp_ce, "cp": _cp,
             "hybrid": _hybrid, "finite_skip": _finite_skip,
             "pipeline": _pipeline, "fleet": _fleet,
             "data_parallel": _data_parallel, "cp_direct": _cp_direct,
             "zero_reads": _zero_reads, "ckpt_hybrid": _ckpt_hybrid,
             "moe_ep": _moe_ep, "rng_tracker": _rng_tracker,
             "fleet_util": _fleet_util, "elastic_reshard": _elastic_reshard,
             "lost_peer": _lost_peer}
