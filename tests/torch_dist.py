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


def _hybrid_run(cfg_d):
    """One configuration of ``build_hybrid_train_step`` / ``TrainStep`` on
    its mesh: per-step losses and (gathered) final parameters."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed import comms
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_hybrid_train_step,
                                         load_paddle_tpu_state)
    from paddle_tpu_torch.models.llama import paddle_tpu_state
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.parallel import compile_train_step
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.init_mesh(cfg_d["mesh"], device="cpu")
    cfg = LlamaConfig(**cfg_d["config"])
    model = LlamaForCausalLM(cfg, device="cpu", mesh=mesh)
    load_paddle_tpu_state(model, cfg_d["state"])
    clip = ClipGradByGlobalNorm(cfg_d["clip"]) if cfg_d.get("clip") else None
    opt = popt.AdamW(learning_rate=cfg_d["lr"], parameters=model.parameters(),
                     epsilon=cfg_d["eps"], grad_clip=clip)
    if cfg_d["kind"] == "hybrid":
        step = build_hybrid_train_step(
            model, opt, mesh=mesh, remat=cfg_d.get("remat", True),
            amp=cfg_d.get("amp", False),
            accumulate_steps=cfg_d.get("accumulate", 1))
    else:
        scaler = GradScaler(**cfg_d["scaler"]) if cfg_d.get("scaler") \
            else None
        loss = LlamaForCausalLM.loss_sum if cfg_d.get("loss_sum") \
            else LlamaForCausalLM.compute_loss
        step = compile_train_step(
            model, lambda mdl, b: loss(mdl, b["input_ids"], b["labels"]),
            opt, mesh=mesh, scaler=scaler,
            accumulate_steps=cfg_d.get("accumulate", 1))
    losses = []
    comms.comm_clear()
    for ids, labels in cfg_d["batches"]:
        b = {"input_ids": ids, "labels": labels}
        if cfg_d.get("quant"):
            with comms.quantized(cfg_d["quant"]):
                losses.append(float(step(b)))
        else:
            losses.append(float(step(b)))
    state = paddle_tpu_state(model)
    info = comms.comm_info()
    return {"losses": losses, "state": state if mesh.rank == 0 else None,
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
    mesh = mesh_mod.init_mesh({"dp": 2}, device="cpu")
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


SCENARIOS = {"mesh": _mesh, "collective": _collective, "comms": _comms,
             "mp_layers": _mp_layers, "tp_ce": _tp_ce, "cp": _cp,
             "hybrid": _hybrid, "finite_skip": _finite_skip}
