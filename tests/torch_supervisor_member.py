"""The deterministic supervised scenario of the supervisor tests, for
either package, and one member of a real multi-process run of the port.

The scenario (the JAX tests' ``tests/dist_workers/supervisor_member.py``,
with the same numbers): a dp-row-sharded ``table`` and a replicated ``w``,
a global-order sample stream, commit-every-step generations. ``Pkg``
bundles one package's classes, so a test runs the same scenario through
``paddle_tpu`` and ``paddle_tpu_torch``; this module itself imports only
numpy and, when run as a script or asked for the port, the port.

As a script (a member process over the parent's master store)::

    python tests/torch_supervisor_member.py <store_port> <node_id> \\
        <out_dir> <n_steps> <n_members>

with chaos armed through the environment (``PT_FAULTPOINT=supervisor.<site>
PT_FAULTPOINT_MODE=crash`` SIGKILLs it at that transition;
``PT_SUP_LEAVE_STEP=<k>`` drains it once ``steps_done`` reaches k). On a
clean exit it writes ``done_<node_id>.json`` and prints DONE.
"""
import json
import os
import sys
from types import SimpleNamespace

import numpy as np

ROWS, DIM, WVEC = 12, 4, 4
N_SHARDS, PER_SHARD = 4, 16      # 64 samples per stream epoch
BATCH = 2                        # per-rank batch size
HB, LEASE_TIMEOUT = 0.1, 0.6


def port_pkg():
    """The port's classes, bundled as ``Pkg``."""
    from paddle_tpu_torch.distributed import reshard, supervisor
    from paddle_tpu_torch.distributed.ckpt_manager import CheckpointManager
    from paddle_tpu_torch.distributed.launch.elastic import ElasticManager
    from paddle_tpu_torch.distributed.store import (TCPStore,
                                                    create_master_store)
    from paddle_tpu_torch.io import ShardedSampleStream
    return SimpleNamespace(
        name="port", TCPStore=TCPStore,
        create_master_store=create_master_store,
        ElasticManager=ElasticManager, CheckpointManager=CheckpointManager,
        Supervisor=supervisor.Supervisor,
        SupervisedParam=supervisor.SupervisedParam,
        ShardedSampleStream=ShardedSampleStream, sv=supervisor, rs=reshard)


def build_stream(pkg):
    shards = [[np.asarray([100.0 * s + i], np.float32)
               for i in range(PER_SHARD)] for s in range(N_SHARDS)]
    return pkg.ShardedSampleStream(shards, seed=0)


def full_state():
    return {"table": np.arange(ROWS * DIM,
                               dtype=np.float32).reshape(ROWS, DIM),
            "w": np.zeros((WVEC,), np.float32)}


def params(pkg):
    return {"table": pkg.SupervisedParam((ROWS, DIM), np.float32,
                                         ("dp", None)),
            "w": pkg.SupervisedParam((WVEC,), np.float32, (None,))}


def shard_state(members, nid):
    """This member's dp shards of the deterministic full state."""
    full = full_state()
    n = len(members)
    r = sorted(members).index(nid)
    rows = ROWS // n
    return {"table": full["table"][r * rows:(r + 1) * rows].copy(),
            "w": full["w"].copy()}


def owner_shards(full, members, nid):
    n = len(members)
    r = sorted(members).index(nid)
    rows = ROWS // n
    return {"table": full["table"][r * rows:(r + 1) * rows],
            "w": full["w"]}


def apply_rank_step(table_rows, w, stripe):
    """Each owned table row += 1e-3 * sum(stripe values), w += 1."""
    inc = np.float32(sum(float(b[0]) for b in stripe)) if stripe \
        else np.float32(0.0)
    return (table_rows + np.float32(1e-3) * inc, w + np.float32(1.0))


def step_fn(state, batch, sup):
    table, w = apply_rank_step(state["table"], state["w"], batch)
    return {"table": table, "w": w}


def sim_step(full, stream, members):
    """One step of the whole fleet on the full state (the oracle)."""
    n = len(members)
    if stream.pos >= stream.epoch_len():
        stream.roll_epoch()
    take = min(BATCH * n, stream.epoch_len() - stream.pos)
    window = [stream.sample_at(stream.pos + j) for j in range(take)]
    stream.advance(take)
    rows = ROWS // n
    w_new = None
    for r in range(n):
        t, w_new = apply_rank_step(
            full["table"][r * rows:(r + 1) * rows], full["w"], window[r::n])
        full["table"][r * rows:(r + 1) * rows] = t
    full["w"] = w_new


def replay(pkg, events, n_steps, initial_members):
    """(full state, members, cursor positions at each event) after
    replaying ``n_steps`` with the membership / step boundaries the events
    recorded, on ``pkg``'s stream."""
    full = full_state()
    stream = build_stream(pkg)
    members = sorted(initial_members)
    i, cursors = 0, []
    for e in sorted(events, key=lambda ev: ev["epoch"]):
        while i < int(e["steps"]):
            sim_step(full, stream, members)
            i += 1
        cursors.append(stream.pos)
        members = sorted(e["roster"])
    while i < n_steps:
        sim_step(full, stream, members)
        i += 1
    return full, members, cursors


def main() -> None:
    port, node_id, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    n_steps, n_members = int(sys.argv[4]), int(sys.argv[5])
    budget = float(os.environ.get("PT_TEST_BUDGET", "20.0"))
    leave_step = int(os.environ.get("PT_SUP_LEAVE_STEP", "-1"))
    pkg = port_pkg()
    store = pkg.TCPStore("127.0.0.1", port, is_master=False)
    elastic = pkg.ElasticManager(store, node_id=node_id,
                                 np_range=(1, n_members),
                                 heartbeat_interval=HB,
                                 timeout=LEASE_TIMEOUT)
    mgr = pkg.CheckpointManager(os.path.join(out_dir, "ckpt"),
                                keep_last_k=16)
    sup = pkg.Supervisor(
        store=store, elastic=elastic, ckpt=mgr, params=params(pkg),
        state={}, stream=build_stream(pkg), batch_size=BATCH,
        budget=budget, watch_budget=budget, ckpt_every=1, churn_probe=1.0)
    members = sup.bind(n_members, timeout=30.0)
    sup.state = shard_state(members, node_id)

    def fn(state, batch, s):
        if leave_step >= 0 and s.steps_done == leave_step:
            s.request_stop(leave=True)
        return step_fn(state, batch, s)

    final = sup.run(fn, n_steps)
    with open(os.path.join(out_dir, f"done_{node_id}.json"), "w") as f:
        json.dump({"node": node_id, "steps": sup.steps_done,
                   "roster": sup.roster, "events": sup.events,
                   "state": {k: np.asarray(v).tolist()
                             for k, v in final.items()}}, f)
    sup.close()
    elastic.stop()
    store.stop()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
    print("DONE", flush=True)
