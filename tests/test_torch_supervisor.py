"""The port's elastic supervisor against the JAX package's.

The same deterministic numpy scenario (``tests/torch_supervisor_member.py``:
a dp-row-sharded table and a replicated vector, a global-order stream,
commit-every-step generations) runs through both packages, in-process
members over one master store each, and the final state bytes, the event
records (cause, rung, generation, steps, roster, bytes moved, the state
hash, the cursor) and the replayed sample prefix must be equal:
- a graceful leave (dp2 -> dp1) against the deterministic oracle;
- a coordinated drain: the "drain" / "drained" events, zero replayed
  steps, the forensics files beside the generations;
- a joiner that grows the mesh (dp1 -> dp2), its shards by the planner;
- the epoch fence (``StaleEpoch``), a typed failure under a full roster
  that propagates, a stream that is not global-order, the churn re-plan
  of ``reshard_or_restore_churn``;
- the dp2 -> dp1 SIGKILL case with a real member process of the port,
  against the replay on the JAX package's stream;
- ``supervisor_summary``.
The dp4 -> dp2 kill matrix over every supervisor site is the twin of the
JAX matrix and, like it, ``slow``.

Leases: 0.1 s heartbeats, 0.6 s timeout; budgets 20 s, as the JAX tests.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import torch_supervisor_member as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEMBER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_supervisor_member.py")
KEYS = ("cause", "how", "generation", "steps", "roster", "old_size",
        "new_size", "bytes_moved", "state_sha", "cursor_pos", "epoch",
        "node")


def _jax_pkg():
    from paddle_tpu.distributed import reshard, supervisor
    from paddle_tpu.distributed.ckpt_manager import CheckpointManager
    from paddle_tpu.distributed.launch.elastic import ElasticManager
    from paddle_tpu.distributed.store import TCPStore, create_master_store
    from paddle_tpu.io import ShardedSampleStream
    return SimpleNamespace(
        name="jax", TCPStore=TCPStore,
        create_master_store=create_master_store,
        ElasticManager=ElasticManager, CheckpointManager=CheckpointManager,
        Supervisor=supervisor.Supervisor,
        SupervisedParam=supervisor.SupervisedParam,
        ShardedSampleStream=ShardedSampleStream, sv=supervisor, rs=reshard)


PKGS = {"jax": _jax_pkg(), "port": M.port_pkg()}


def _elastic(pkg, store, nid, n=4):
    return pkg.ElasticManager(store, node_id=nid, np_range=(1, n),
                              heartbeat_interval=M.HB,
                              timeout=M.LEASE_TIMEOUT)


def _sup(pkg, store, elastic, mgr, members, nid, **kw):
    kw.setdefault("budget", 20.0)
    kw.setdefault("watch_budget", 20.0)
    kw.setdefault("churn_probe", 1.0)
    return pkg.Supervisor(
        store=store, elastic=elastic, ckpt=mgr, params=M.params(pkg),
        state=M.shard_state(members, nid) if members else {},
        stream=M.build_stream(pkg), batch_size=M.BATCH, ckpt_every=1, **kw)


def _fleet(pkg, root, fns, n_steps=6):
    """One in-process fleet (a thread a member). Returns (sups, results,
    errors, mgr)."""
    pkg.sv.reset_events()
    store = pkg.create_master_store()
    ids = sorted(fns)
    els = {n: _elastic(pkg, store, n) for n in ids}
    mgr = pkg.CheckpointManager(str(root), keep_last_k=16)
    sups = {n: _sup(pkg, store, els[n], mgr, ids, n) for n in ids}
    results, errors = {}, {}

    def run(n):
        try:
            sups[n].bind(len(ids), timeout=15.0)
            results[n] = sups[n].run(fns[n], n_steps)
        except BaseException as e:  # noqa: BLE001 — asserted by callers
            errors[n] = e

    threads = [threading.Thread(target=run, args=(n,), daemon=True)
               for n in ids]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    try:
        assert not any(t.is_alive() for t in threads), "fleet hung"
    finally:
        for s in sups.values():
            s.close()
        for e in els.values():
            e.stop()
        store.stop()
    return sups, results, errors, mgr


def _leaver(at):
    def fn(state, batch, sup):
        if sup.steps_done == at:
            sup.request_stop(leave=True)
        return M.step_fn(state, batch, sup)
    return fn


def _both(tmp_path, fns):
    return {name: _fleet(pkg, tmp_path / name, fns)
            for name, pkg in PKGS.items()}


def _events(sup):
    return [{k: e.get(k) for k in KEYS} for e in sup.events]


def test_graceful_drain_equal_to_jax_and_the_oracle(tmp_path):
    """dp2 -> dp1: b drains after step 3. Both packages record the same
    events on both sides ("drain" / "drained", generation 3, zero replayed
    steps, the same bytes moved and state hash), end on the same bytes,
    equal to the oracle replay, and export the forensics bundle."""
    runs = _both(tmp_path, {"a": M.step_fn, "b": _leaver(2)})
    for name, (sups, results, errors, mgr) in runs.items():
        assert not errors, (name, errors)
        a = sups["a"]
        assert a.steps_done == 6 and a.roster == ["a"]
        full, members, cursors = M.replay(PKGS["jax"], a.events, 6,
                                          ["a", "b"])
        assert members == ["a"]
        assert [e["cursor_pos"] for e in a.events] == cursors
        for k in full:
            assert np.array_equal(results["a"][k], full[k]), (name, k)
        ev = a.events[0]
        assert (ev["cause"], ev["generation"], ev["steps"]) == \
            ("drain", 3, 3)
        eb = sups["b"].events[-1]
        assert eb["how"] == "drained" and eb["state_sha"] is None
        names = os.listdir(tmp_path / name)
        for nid, e in (("a", ev), ("b", eb)):
            tag = f"incident-step{e['generation']}-epoch{e['epoch']}-{nid}"
            assert f"{tag}.json" in names and f"{tag}.trace.json" in names
        assert mgr.latest() == 6
    (ja, jres, _, _), (pa, pres, _, _) = runs["jax"], runs["port"]
    for nid in ("a", "b"):
        assert _events(pa[nid]) == _events(ja[nid]), nid
    for k in jres["a"]:
        assert pres["a"][k].tobytes() == jres["a"][k].tobytes()
    with open(tmp_path / "port" / "incident-step3-epoch1-a.json") as f:
        assert json.load(f)["event"]["cause"] == "drain"
    from paddle_tpu_torch import profiler
    text = profiler.supervisor_summary()
    assert "drain" in text and "drained" in text


def test_joiner_grows_the_mesh_like_jax(tmp_path):
    """dp1 -> dp2: a runs alone; j joins with no state and receives its
    shards through the planner. Both packages end on the oracle's bytes
    with the same events."""
    out = {}
    for name, pkg in PKGS.items():
        pkg.sv.reset_events()
        store = pkg.create_master_store()
        els = {"a": _elastic(pkg, store, "a")}
        mgr = pkg.CheckpointManager(str(tmp_path / name), keep_last_k=16)
        sup_a = _sup(pkg, store, els["a"], mgr, ["a"], "a")
        results, errors = {}, {}

        def slow(state, batch, sup):
            time.sleep(0.3)
            return M.step_fn(state, batch, sup)

        def run_a():
            try:
                sup_a.bind(1, timeout=10.0)
                results["a"] = sup_a.run(slow, 6)
            except BaseException as e:  # noqa: BLE001
                errors["a"] = e

        ta = threading.Thread(target=run_a, daemon=True)
        ta.start()
        while sup_a.steps_done < 2 and ta.is_alive():
            time.sleep(0.05)
        els["j"] = _elastic(pkg, store, "j")
        sup_j = _sup(pkg, store, els["j"], mgr, None, "j", joining=True)

        def run_j():
            try:
                results["j"] = sup_j.run(M.step_fn, 6)
            except BaseException as e:  # noqa: BLE001
                errors["j"] = e

        tj = threading.Thread(target=run_j, daemon=True)
        tj.start()
        ta.join(60.0)
        tj.join(60.0)
        try:
            assert not ta.is_alive() and not tj.is_alive(), "grow hung"
            assert not errors, (name, errors)
            assert sup_a.roster == sup_j.roster == ["a", "j"]
            full, members, _ = M.replay(PKGS["jax"], sup_a.events, 6, ["a"])
            for nid in ("a", "j"):
                want = M.owner_shards(full, members, nid)
                for k in want:
                    assert np.array_equal(results[nid][k], want[k]), \
                        (name, nid, k)
            out[name] = (_events(sup_a), {k: v.tobytes() for k, v in
                                          results["j"].items()})
        finally:
            sup_a.close()
            sup_j.close()
            for e in els.values():
                e.stop()
            store.stop()
    # the joiner's arrival step depends on thread timing: compare what the
    # event moved and where it lands, not its step
    ja, pa = out["jax"][0][0], out["port"][0][0]
    for k in ("cause", "how", "roster", "old_size", "new_size",
              "bytes_moved"):
        assert pa[k] == ja[k], k


@pytest.mark.parametrize("case", ["stale_epoch", "typed_failure",
                                  "global_order"])
def test_fence_and_classifier_like_jax(tmp_path, case):
    """The epoch fence raises StaleEpoch, a typed timeout under an intact
    roster propagates (no event), and a rank-striped stream is refused:
    in both packages, with the same error types and messages."""
    got = {}
    for name, pkg in PKGS.items():
        if case == "global_order":
            class _Fake:
                world_size = 2
            with pytest.raises(ValueError) as e:
                pkg.Supervisor(store=None, elastic=type(
                    "E", (), {"node_id": "a", "_ttl_ms": 1000})(),
                    ckpt=None, stream=_Fake())
            got[name] = str(e.value)
            continue
        store = pkg.create_master_store()
        el = _elastic(pkg, store, "a")
        sup = _sup(pkg, store, el, pkg.CheckpointManager(
            str(tmp_path / name)), ["a"], "a")
        try:
            sup.bind(1, timeout=10.0)
            if case == "stale_epoch":
                store.add(f"{sup.ns}/epoch", 2)
                dl = sys.modules[type(sup).__module__].Deadline(5.0)
                with pytest.raises(pkg.sv.StaleEpoch) as e:
                    sup._rendezvous(dl)
            else:
                err = sys.modules[type(sup).__module__].StoreTimeout

                def bad(state, batch, s):
                    raise err("a wedged dependency", 1.0)
                with pytest.raises(err) as e:
                    sup.run(bad, 2)
                assert sup.events == []
            got[name] = (type(e.value).__name__, str(e.value))
        finally:
            sup.close()
            el.stop()
            store.stop()
    assert got["port"] == got["jax"]


def test_churn_replan_like_jax(tmp_path):
    """Three owners, c's lease lapses 0.8 s into the reshard: the
    churn-aware ladder re-plans against the survivors (a reshard, b
    partial-restore from the generation) in both packages, equal bytes."""
    out = {}
    for name, pkg in PKGS.items():
        rs = pkg.rs
        full = M.full_state()
        src = rs.MeshSpec.from_members(["a", "b", "c"])
        dst = rs.MeshSpec.from_members(["a", "b"])
        params = {n: p.param_spec() for n, p in M.params(pkg).items()}
        states = {o: {n: np.ascontiguousarray(full[n][tuple(
            slice(lo, hi) for lo, hi in rs.shard_index(p.shape, p.src, src,
                                                         o))])
            for n, p in params.items()} for o in src.owners}
        mgr = pkg.CheckpointManager(str(tmp_path / name))
        mgr.save(dict(full), 1)
        transport = rs.LocalTransport()
        t_lapse = time.monotonic() + 0.8

        def alive():
            return ["a", "b"] if time.monotonic() > t_lapse \
                else ["a", "b", "c"]
        res, errs = {}, {}

        def run(o):
            try:
                res[o] = rs.reshard_or_restore_churn(
                    src, dst, params, o, states[o], transport,
                    session="churn", alive_fn=alive, ckpt=mgr,
                    budget=20.0, probe=1.0)
            except BaseException as e:  # noqa: BLE001
                errs[o] = e
        threads = [threading.Thread(target=run, args=(o,), daemon=True)
                   for o in ("a", "b")]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(15.0)
        assert not any(t.is_alive() for t in threads) and not errs, errs
        assert time.monotonic() - t0 < 10.0
        out[name] = {o: (res[o][1], {k: v.tobytes() for k, v in
                                     res[o][0].items()}) for o in res}
    assert out["port"] == out["jax"]
    assert out["port"]["a"][0] == "reshard"
    assert out["port"]["b"][0] == "partial-restore"


def test_supervisor_summary_renders_like_jax():
    import paddle_tpu.profiler as jprof
    from paddle_tpu_torch import profiler as pprof
    ev = {"node": "a", "epoch": 3, "cause": "lease-lapse", "how": "reshard",
          "generation": 7, "steps": 7, "roster": ["a", "b"], "old_size": 3,
          "new_size": 2, "bytes_moved": 4096, "detect_latency_s": 0.01,
          "downtime_s": 0.5, "state_sha": "ff", "cursor_pos": 28}
    for name in ("jax", "port"):
        PKGS[name].sv.reset_events()
    assert pprof.supervisor_summary() == "supervisor: no scale events"
    for name in ("jax", "port"):
        PKGS[name].sv._register_event(ev)
    assert pprof.supervisor_summary() == jprof.supervisor_summary()
    assert "3->2" in pprof.supervisor_summary()
    for name in ("jax", "port"):
        PKGS[name].sv.reset_events()


def _spawn_member(port, nid, out_dir, n_steps, n_members, extra_env=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PT_FAULTPOINT", "PT_CRASHPOINT",
                                "PT_SUP_LEAVE_STEP"))}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               PT_TEST_BUDGET="20.0", **(extra_env or {}))
    return subprocess.Popen(
        [sys.executable, MEMBER, str(port), nid, str(out_dir),
         str(n_steps), str(n_members)],
        cwd=str(out_dir), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _chaos_case(tmp_path, site, n_members, n_steps=6, leave=None,
                armed=("b",), arm_skip="0"):
    """The survivor a runs in-process; the other members are port
    processes; ``armed`` ones SIGKILL at ``site``. Returns a's
    supervisor after holding it against the replay on the JAX stream."""
    pkg = PKGS["port"]
    pkg.sv.reset_events()
    from paddle_tpu_torch.distributed import chaos
    chaos.reset_hits()
    ids = ["a", "b", "c", "d"][:n_members]
    store = pkg.create_master_store()
    procs = {}
    el = _elastic(pkg, store, "a", n=n_members)
    mgr = pkg.CheckpointManager(str(tmp_path / "ckpt"), keep_last_k=16)
    sup = _sup(pkg, store, el, mgr, None, "a")
    outcome = {}
    try:
        for nid in ids[1:]:
            extra = {}
            if nid in armed:
                extra = {"PT_FAULTPOINT": site, "PT_FAULTPOINT_MODE": "crash",
                         "PT_FAULTPOINT_HITS": "1",
                         "PT_FAULTPOINT_SKIP": arm_skip}
            if leave and nid in leave:
                extra["PT_SUP_LEAVE_STEP"] = str(leave[nid])
            procs[nid] = _spawn_member(store.port, nid, tmp_path, n_steps,
                                       n_members, extra)

        def run():
            try:
                members = sup.bind(n_members, timeout=30.0)
                sup.state = M.shard_state(members, "a")
                outcome["state"] = sup.run(M.step_fn, n_steps)
            except BaseException as e:  # noqa: BLE001
                outcome["error"] = e
        t = threading.Thread(target=run, daemon=True)
        t0 = time.monotonic()
        t.start()
        t.join(90.0)
        assert not t.is_alive(), f"{site}: survivor hung"
        assert time.monotonic() - t0 < 90.0
        assert "error" not in outcome, (site, outcome.get("error"))
        for nid in armed:
            out, err = procs[nid].communicate(timeout=60)
            assert procs[nid].returncode == -signal.SIGKILL, (
                f"{site}: {nid} rc={procs[nid].returncode}\n{err[-2000:]}")
            assert "DONE" not in out
        for nid in ids[1:]:
            if nid not in armed:
                out, err = procs[nid].communicate(timeout=60)
                assert procs[nid].returncode == 0 and "DONE" in out, \
                    (site, nid, err[-2000:])
        # each resumed state is bitwise a fresh restore of its generation
        for e in sup.events:
            got = {k: np.zeros(p.shape, np.float32)
                   for k, p in M.params(pkg).items()}
            mgr.restore(got, int(e["generation"]))
            mesh = pkg.rs.MeshSpec.from_members(e["roster"])
            shards = {n: got[n][tuple(slice(lo, hi) for lo, hi in
                                      pkg.rs.shard_index(p.shape, p.spec,
                                                         mesh, "a"))]
                      for n, p in M.params(pkg).items()}
            assert pkg.sv._state_sha(shards) == e["state_sha"], site
        full, members, cursors = M.replay(PKGS["jax"], sup.events, n_steps,
                                          ids)
        assert sorted(sup.roster) == members
        assert [e["cursor_pos"] for e in sup.events] == cursors
        want = M.owner_shards(full, members, "a")
        for k in want:
            assert np.array_equal(outcome["state"][k], want[k]), (site, k)
        return sup
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        sup.close()
        el.stop()
        store.stop()


def test_member_sigkilled_at_detect_survivor_resumes_dp1(tmp_path):
    """dp2 -> dp1 with a real member process: b dies by SIGKILL at its
    first supervisor.detect poll; a detects the lapse, swaps to dp1 and
    ends bitwise the replay on the JAX stream."""
    sup = _chaos_case(tmp_path, "supervisor.detect", n_members=2)
    assert sup.roster == ["a"] and sup.events[-1]["new_size"] == 1


@pytest.mark.slow
@pytest.mark.parametrize("site", ["supervisor.detect",
                                  "supervisor.rendezvous",
                                  "supervisor.swap", "supervisor.resume",
                                  "supervisor.drain",
                                  "ckpt.shard_staged", "ckpt.receipts"])
def test_kill_matrix_dp4_to_dp2_every_supervisor_site(tmp_path, site):
    """The twin of the JAX kill matrix: dp4, b drains at step 2, c
    SIGKILLs at the armed site; a and d converge on dp2 bitwise the
    replay."""
    leave = {"b": 2}
    skip = "0"
    if site == "supervisor.drain":
        leave = {"b": 2, "c": 3}
    if site == "ckpt.shard_staged":
        skip = "1"
    sup = _chaos_case(tmp_path, site, n_members=4, leave=leave,
                      armed=("c",), arm_skip=skip)
    assert sorted(sup.roster) == ["a", "d"], sup.roster
