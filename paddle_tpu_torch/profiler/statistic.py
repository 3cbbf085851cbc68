"""Summary statistics: counterpart of ``paddle_tpu/profiler/statistic.py``.

``aggregate`` and ``summary`` read a profiler's events (per-name calls,
total / avg / max / min µs and share); the other summaries render a
subsystem's counters: the serving engines and gateways, the comms layer,
the trace ring, the capture tier and its lint, live resharding and the
elastic supervisor. Each renders from what its subsystem recorded in this
process and never imports the subsystem itself: in a process that did not
load it, it says so.

``op_cache_summary`` has no cache to read: the JAX dispatch memoises a
compiled executable per op, the port's dispatch calls torch directly
(``ops/dispatch.py``), so it says that and nothing else."""
from __future__ import annotations

from typing import Dict, List

__all__ = ["aggregate", "summary", "op_cache_summary",
           "step_capture_summary", "lint_summary", "serving_summary",
           "gateway_summary", "comm_summary", "reshard_summary",
           "supervisor_summary", "trace_summary"]


def _subsystem(modname: str):
    """The subsystem module if it is already imported, else None: a
    summary must render in a process that never touched its subsystem,
    and never be what imports it."""
    from ..observability.metrics import loaded_module
    return loaded_module(modname)


def _no_data(label: str) -> str:
    """The shared no-data rendering (subsystem never imported)."""
    return f"{label}: no data (subsystem not loaded)"


def step_capture_summary() -> str:
    """The capture tier's counters (jit/capture.py) as text: the steps
    captured as CUDA graphs (``lowerings``), the calls their replays
    served (``hits``), the captures abandoned (``bailouts``, with the last
    reason) and the calls that ran eagerly instead (``fallback_calls``;
    ``eager_calls`` where no graph backend applies, as on the CPU), the
    live graphs and their pools' MiB. A healthy training loop pins
    ``lowerings`` at one per step signature with ``hits`` climbing; a
    climbing ``fallback_calls`` means a step runs eagerly (a gloo mesh,
    ZeRO, a host sync, a second signature: see the reason). The JAX
    summary's pass totals (inlined calls, CSE folds, constants deduped,
    dead values removed, donated buffers) have no counterpart here
    (jit/passes/__init__.py) and are not printed."""
    capture = _subsystem("paddle_tpu_torch.jit.capture")
    if capture is None:
        return _no_data("step capture")

    info = capture.capture_info()
    pool = info["pool_mib"]
    lines = [
        f"step capture: enabled={info['enabled']} "
        f"lowerings={info['lowerings']} hits={info['hits']} "
        f"bailouts={info['bailouts']} "
        f"fallback_calls={info['fallback_calls']} "
        f"eager_calls={info['eager_calls']}",
        f"graphs: {info['graphs']} live, pool "
        f"{'unknown' if pool is None else f'{pool:.1f} MiB'}",
    ]
    if info["last_bailout"]:
        lines.append(f"last bailout: {info['last_bailout']}")
    return "\n".join(lines)


def lint_summary() -> str:
    """The capture lint's records (jit/passes/lint.py) as text: for every
    recently captured step, the ops its warm-up dispatched and the
    hazards found (recompile-hazard / donation-miss /
    unscheduled-collective / dead-compute / host-callback). A healthy
    step shows ``clean``."""
    lint = _subsystem("paddle_tpu_torch.jit.passes.lint")
    if lint is None:
        return _no_data("capture lint")

    records = lint.lint_records()
    if not records:
        return "capture lint: no recorded captures"
    head = f"{'Step':<28} {'Ops':>6} {'Findings':>9}  Rules"
    lines = [f"capture lint: {len(records)} step(s) "
             f"(enabled={lint.lint_enabled()})", head, "-" * len(head)]
    for name, rec in records.items():
        rules = ",".join(rec["rules_hit"]) or "clean"
        lines.append(f"{name[:28]:<28} {rec['eqns']:>6} "
                     f"{len(rec['findings']):>9}  {rules}")
        for f in rec["findings"][:8]:
            lines.append(f"    {f['rule']}: {f['message'][:100]}")
    return "\n".join(lines)


def reshard_summary() -> str:
    """Live-reshard reports (distributed/reshard.py) as text: per executed
    plan the ladder rung that ran (reshard / partial-restore /
    full-restore), bytes moved on the wire vs. reused locally vs. read
    back from the checkpoint, the naive full-gather volume the plan
    avoided, and the downtime. A healthy elastic fleet shows `reshard`
    rows whose moved bytes sit well under `naive`; recurring
    `full-restore` rows mean peers keep dying mid-transfer (check the
    reshard budget and the victim's logs)."""
    reshard = _subsystem("paddle_tpu_torch.distributed.reshard")
    if reshard is None:
        return _no_data("reshard")

    reports = reshard.reshard_reports()
    if not reports:
        return "reshard: no executed plans"
    head = (f"{'Owner':<14} {'How':<16} {'Moved':>12} {'Local':>12} "
            f"{'FromCkpt':>12} {'Naive':>12} {'Downtime':>10}")
    lines = [f"reshard: {len(reports)} executed plan(s)", head,
             "-" * len(head)]
    for r in reports:
        lines.append(
            f"{str(r['owner'])[:14]:<14} {r['how']:<16} "
            f"{r['bytes_moved']:>12} {r['bytes_local']:>12} "
            f"{r['bytes_from_ckpt']:>12} {r['naive_bytes']:>12} "
            f"{r['downtime_s']:>9.3f}s")
    return "\n".join(lines)


def supervisor_summary() -> str:
    """Elastic-supervisor scale events (distributed/supervisor.py) as
    text: per event the supervision epoch, the cause — a coordinated
    ``drain`` typed-distinct from every crash cause (lease lapse, a
    typed timeout escaping a step, a missed barrier, a join) — the mesh
    transition, the ladder rung the swap landed on, the generation it
    committed/rolled to, detect latency, total downtime, wire bytes
    moved, and this owner's sharded-commit bytes/wall (the per-owner
    O(state/n) stage the two-phase commit buys over a one-node gather).
    A healthy elastic fleet shows `reshard` rungs whose downtime sits
    near the detect latency plus the transfer time; recurring
    `full-restore` rungs mean live bytes keep dying with their exclusive
    owner — shard the state wider or commit more often."""
    supervisor = _subsystem("paddle_tpu_torch.distributed.supervisor")
    if supervisor is None:
        return _no_data("supervisor")

    events = supervisor.supervisor_events()
    if not events:
        return "supervisor: no scale events"
    drains = sum(1 for e in events if str(e.get("cause")) == "drain")
    head = (f"{'Epoch':>5} {'Cause':<18} {'Mesh':<10} {'Rung':<16} "
            f"{'Gen':>5} {'Detect':>8} {'Downtime':>9} {'Moved':>12} "
            f"{'CommitB':>10} {'Commit':>9}")
    lines = [f"supervisor: {len(events)} scale event(s) "
             f"({drains} drain, {len(events) - drains} crash/other)",
             head, "-" * len(head)]
    for e in events:
        mesh = f"{e['old_size']}->{e['new_size']}"
        cb = e.get("commit_bytes")
        cw = e.get("commit_wall_s")
        lines.append(
            f"{e['epoch']:>5} {str(e['cause'])[:18]:<18} {mesh:<10} "
            f"{e['how']:<16} {str(e['generation']):>5} "
            f"{e['detect_latency_s']:>7.3f}s {e['downtime_s']:>8.3f}s "
            f"{e['bytes_moved']:>12} "
            f"{(str(cb) if cb is not None else '-'):>10} "
            f"{(f'{cw:.3f}s' if cw is not None else '-'):>9}")
    return "\n".join(lines)


def op_cache_summary(sorted_by: str = "hits") -> str:
    """The JAX dispatch's compiled-op cache counters; the port has no op
    cache (module docstring)."""
    return "op cache: none (eager torch ops launch their kernels directly)"


def aggregate(events: List[dict]) -> Dict[str, dict]:
    stats: Dict[str, dict] = {}
    for e in events:
        name = e.get("name", "?")
        dur = float(e.get("dur", 0.0))  # microseconds
        s = stats.setdefault(name, {"calls": 0, "total_us": 0.0,
                                    "max_us": 0.0, "min_us": float("inf"),
                                    "cat": e.get("cat", "")})
        s["calls"] += 1
        s["total_us"] += dur
        s["max_us"] = max(s["max_us"], dur)
        s["min_us"] = min(s["min_us"], dur)
    for s in stats.values():
        s["avg_us"] = s["total_us"] / max(s["calls"], 1)
        if s["min_us"] == float("inf"):
            s["min_us"] = 0.0
    return stats


def serving_summary() -> str:
    """Live serving-engine counters (inference/serving) as text: admission
    funnel (submitted -> admitted -> finished / timed_out / rejected),
    batch occupancy, decode-step and token throughput, and the KV-page
    pool (active/free/peak) — so an occupancy or eviction regression is
    readable next to the op timings instead of needing print statements.
    A healthy loaded engine pins `avg_occupancy` near 1.0 with
    `step.lowerings` frozen at (buckets + 1) and `step.hits` climbing;
    climbing `timed_out` means admission is outrunning capacity (grow the
    pool / batch, or shed load by shortening TTLs). Speculative engines
    add a `spec:` line — drafter kind, k, cumulative acceptance rate,
    draft-vs-verify call counts, and the tokens-per-verify histogram; an
    acceptance rate near 0 means the drafter never pays for its window
    (turn spec off or switch drafters), tokens/verify near k+1 means the
    workload is a speculation jackpot (consider raising k)."""
    serving = _subsystem("paddle_tpu_torch.inference.serving")
    if serving is None:
        return _no_data("serving")

    infos = serving.serving_info()
    if not infos:
        return "serving: no live engines"
    lines = []
    for i, e in enumerate(infos):
        pool, step = e["pool"], e["step"]
        lines += [
            f"engine[{i}]: batch={e['max_batch']} seq<={e['max_seq_len']} "
            f"buckets={e['prefill_buckets']}",
            f"  requests: submitted={e['submitted']} admitted={e['admitted']}"
            f" finished={e['finished']} timed_out={e['timed_out']} "
            f"evicted={e['evicted']} rejected={e['rejected']} "
            f"active={e['active']} queued={e['queued']}",
            f"  decode: steps={e['decode_steps']} prefills={e['prefills']} "
            f"tokens={e['tokens_generated']} "
            f"occupancy={e['avg_occupancy']:.2f} "
            f"tokens/s={e['tokens_per_sec']:.1f}",
            f"  kv pool: pages={pool['active_pages']}/{pool['total_pages']} "
            f"active (peak {pool['peak_active']}, page_size "
            f"{pool['page_size']}, allocs={pool['allocs']} "
            f"releases={pool['releases']})",
        ]
        prefix = e.get("prefix")
        if prefix is not None:
            lines.append(
                f"  prefix: nodes={prefix['nodes']} "
                f"pages_held={prefix['pages_held']} "
                f"hits={prefix['hits']}/{prefix['lookups']} "
                f"shared_joins={e['shared_prefix_joins']} "
                f"pages_saved={e['prefill_pages_saved']} "
                f"evicted={prefix['pages_evicted']}")
        if e.get("prefill_chunks") or e.get("prefill_chunk"):
            lines.append(
                f"  chunked prefill: chunk={e['prefill_chunk'] or '-'} "
                f"chunks={e['prefill_chunks']} "
                f"chunked_prefills={e['chunked_prefills']} "
                f"window={e.get('window', {}).get('size', '-')}")
        spec = e.get("spec")
        if spec:
            drafter = spec.get("drafter") or {}
            lines.append(
                f"  spec: drafter={drafter.get('kind')} k={spec['k']} "
                f"acceptance={spec['acceptance_rate']:.2f} "
                f"tokens/verify={spec['tokens_per_verify']:.2f} "
                f"verify_steps={spec['verify_steps']} "
                f"draft_steps={spec['draft_steps']} "
                f"hist={spec['tokens_per_verify_hist']}")
        if step:
            lines.append(
                f"  step capture: lowerings={step.get('lowerings')} "
                f"hits={step.get('hits')} bailouts={step.get('bailouts')} "
                f"fallback_calls={step.get('fallback_calls')}")
    return "\n".join(lines)


def gateway_summary() -> str:
    """Live serving-gateway counters (inference/serving/gateway) as text:
    per gateway the bind address, connection/request/response funnel, the
    per-status response mix, and the drain state — the wire-side view
    that pairs with serving_summary()'s engine-side one. A healthy
    gateway shows responses tracking requests with errors ~0; climbing
    408s mean TTLs are outrunning engine capacity (shed load or grow the
    engine), climbing read_timeouts mean idle/stalled peers are being
    reaped by the per-connection read deadline (normal under churn)."""
    gateway = _subsystem("paddle_tpu_torch.inference.serving.gateway")
    if gateway is None:
        return _no_data("gateway")

    infos = gateway.gateway_info()
    if not infos:
        return "gateway: no live gateways"
    lines = []
    for i, g in enumerate(infos):
        state = ("stopped" if g["stopped"] else
                 "draining" if g["draining"] else "serving")
        codes = " ".join(f"{k}:{v}" for k, v in
                         sorted(g["status_counts"].items())) or "-"
        lines += [
            f"gateway[{i}]: {g['host']}:port={g['port']} {state} "
            f"read_timeout={g['read_timeout']:g}s",
            f"  wire: connections={g['connections']} "
            f"open={g['open_connections']} requests={g['requests']} "
            f"responses={g['responses']} errors={g['errors']} "
            f"read_timeouts={g['read_timeouts']} "
            f"protocol_errors={g['protocol_errors']}",
            f"  status: {codes}",
        ]
    return "\n".join(lines)


def comm_summary() -> str:
    """Comm-subsystem accounting (distributed/comms) as text: per call
    site the collective count, LOGICAL bytes (what full precision would
    move) vs WIRE bytes (what actually moves), the compression ratio, the
    wire dtype when the quantized context was on, and the slots the
    schedule assigned (``comm_info()``). A healthy quantized dp step shows
    the grad-sync site at ~3.9x compression (int8, block 256); 1.0x there
    means the context was not active when the collective ran."""
    comms = _subsystem("paddle_tpu_torch.distributed.comms")
    if comms is None:
        return _no_data("comms")

    info = comms.comm_info()
    if not info["sites"]:
        return "comms: no recorded collectives"
    head = (f"{'Site':<40} {'N':>5} {'Logical':>12} {'Wire':>12} "
            f"{'Ratio':>7} {'Q':>5} {'Slots':>6}")
    lines = [
        f"comms: {info['collectives']} collective(s), "
        f"{info['total_logical']} logical -> {info['total_wire']} wire bytes",
        head, "-" * len(head),
    ]
    for site, s in info["sites"].items():
        slots = ",".join(str(x) for x in s["slots"]) or "-"
        lines.append(
            f"{site[:40]:<40} {s['count']:>5} {s['bytes_logical']:>12} "
            f"{s['bytes_wire']:>12} {s['compression']:>7} "
            f"{(s['quantized'] or '-'):>5} {slots:>6}")
    return "\n".join(lines)


def trace_summary() -> str:
    """Observability trace-ring state (observability/trace.py) as text:
    ring occupancy, per-site span counts and total/avg/max durations, and
    the flight-recorder incident count — the quick look before exporting
    the full Chrome trace (``observability.export_trace``) into Perfetto.
    A site whose avg dwarfs its peers is where the step's wall-clock goes;
    a non-zero incident count means ``observability.last_incident()``
    holds a postmortem timeline for the latest typed deadline error."""
    obs = _subsystem("paddle_tpu_torch.observability")
    if obs is None:
        return _no_data("trace")
    info = obs.trace_info()
    head_line = (f"trace: enabled={info['enabled']} "
                 f"records={info['records']}/{info['capacity']} "
                 f"dropped={info['dropped']} incidents={info['incidents']}")
    sites: Dict[str, dict] = {}
    for r in obs.trace_records():
        s = sites.setdefault(r["name"], {"count": 0, "events": 0,
                                         "total_ns": 0, "max_ns": 0})
        if r["dur"] is None:
            s["events"] += 1
            continue
        s["count"] += 1
        s["total_ns"] += r["dur"]
        s["max_ns"] = max(s["max_ns"], r["dur"])
    if not sites:
        return head_line
    head = (f"{'Site':<28} {'Spans':>6} {'Events':>7} {'Total(ms)':>10} "
            f"{'Avg(ms)':>9} {'Max(ms)':>9}")
    lines = [head_line, head, "-" * len(head)]
    for name, s in sorted(sites.items(), key=lambda kv: -kv[1]["total_ns"]):
        avg = s["total_ns"] / s["count"] if s["count"] else 0.0
        lines.append(
            f"{name[:28]:<28} {s['count']:>6} {s['events']:>7} "
            f"{s['total_ns'] / 1e6:>10.3f} {avg / 1e6:>9.3f} "
            f"{s['max_ns'] / 1e6:>9.3f}")
    return "\n".join(lines)


def summary(events: List[dict], sorted_by: str = "total",
            time_unit: str = "ms") -> str:
    stats = aggregate(events)
    key = {"total": "total_us", "avg": "avg_us", "max": "max_us",
           "calls": "calls"}.get(sorted_by, "total_us")
    div = {"s": 1e6, "ms": 1e3, "us": 1.0}.get(time_unit, 1e3)
    rows = sorted(stats.items(), key=lambda kv: -kv[1][key])
    grand = sum(s["total_us"] for _, s in rows) or 1.0
    lines = [
        f"{'Name':<40} {'Calls':>7} {'Total(' + time_unit + ')':>12} "
        f"{'Avg(' + time_unit + ')':>12} {'Max(' + time_unit + ')':>12} "
        f"{'Ratio':>7}"
    ]
    lines.append("-" * len(lines[0]))
    for name, s in rows[:64]:
        lines.append(
            f"{name[:40]:<40} {s['calls']:>7} {s['total_us']/div:>12.3f} "
            f"{s['avg_us']/div:>12.3f} {s['max_us']/div:>12.3f} "
            f"{100.0 * s['total_us']/grand:>6.1f}%")
    return "\n".join(lines)
