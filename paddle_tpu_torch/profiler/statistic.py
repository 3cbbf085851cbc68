"""Summaries of the elastic tier: counterpart of the JAX package's
``profiler/statistic.py`` cut to ``reshard_summary`` and
``supervisor_summary`` (statistic.py:278-347); the rest of the profiler
waits for a later slice (ROADMAP.md Queue 1).

Each renders from what its subsystem recorded in this process and never
imports the subsystem itself: in a process that did not load it, it says
so."""
from __future__ import annotations

__all__ = ["reshard_summary", "supervisor_summary"]


def _subsystem(modname: str):
    """The subsystem module if it is already imported, else None: a
    summary must render in a process that never touched its subsystem,
    and never be what imports it."""
    from ..observability.metrics import loaded_module
    return loaded_module(modname)


def _no_data(label: str) -> str:
    """The shared no-data rendering (subsystem never imported)."""
    return f"{label}: no data (subsystem not loaded)"


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
