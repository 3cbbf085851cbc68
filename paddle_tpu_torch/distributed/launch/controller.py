"""Collective controller + watcher: counterpart of
``paddle_tpu/distributed/launch/controller.py`` (Paddle's
launch/controllers/collective.py:37, CollectiveController.build_pod: spawn
one proc per rank with PADDLE_TRAINER_* env, and controllers/watcher.py +
fleet/elastic/manager.py:126, membership + restart). The master KV is the
port's TCPStore: node 0 hosts it; every node registers, a barrier forms
the peer list, and heartbeat keys detect loss. Each worker also gets
``torch.distributed``'s variables: ``MASTER_ADDR`` and ``MASTER_PORT``
name the rendezvous of its process group (a port of its own, which rank 0
binds in ``init_process_group``), with ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

from ...utils.deadline import Deadline, DeadlineExceeded, env_timeout
from ..chaos import crashpoint, register as _register_crashpoint
from ..store import TCPStore

# chaos sites: a launcher preempted around a pod restart must leave the
# store's restart-generation machinery in a state peers can still follow
CP_POD_STOPPING = _register_crashpoint(
    "launch.pod_stopping", "restart decided, old ranks not yet stopped")
CP_POD_RESPAWNED = _register_crashpoint(
    "launch.pod_respawned", "new generation's ranks spawned")


class _Proc:
    def __init__(self, rank: int, popen: subprocess.Popen, log_path: str):
        self.rank = rank
        self.popen = popen
        self.log_path = log_path
        self.restarts = 0


class CollectiveController:
    def __init__(self, ctx):
        self.ctx = ctx
        self.procs: List[_Proc] = []
        self.store: Optional[TCPStore] = None

    # ---- rendezvous ----
    def _connect_store(self) -> TCPStore:
        host, port = self.ctx.master.rsplit(":", 1)
        store = TCPStore(host, int(port), is_master=self.ctx.is_master_node(),
                         world_size=self.ctx.nnodes)
        # node membership: announce, then wait for the full roster — bounded:
        # a peer that never shows up fails this launcher fast into its own
        # exit path instead of wedging the whole pod silently
        store.set(f"node/{self.ctx.node_rank}", os.uname().nodename)
        arrived = store.add("nodes_arrived", 1)
        if arrived == self.ctx.nnodes:
            store.set("roster_ready", b"1")
        store.wait("roster_ready",
                   timeout=env_timeout("PT_LAUNCH_RENDEZVOUS_TIMEOUT", 300.0))
        return store

    # ---- pod ----
    def build_pod(self):
        self.store = self._connect_store()
        self.elastic = None
        if self.ctx.elastic:
            from .elastic import ElasticManager
            # collision-free identity (hostname:pid default): a joining node
            # that keeps the default --node_rank must not alias an existing
            # member's heartbeat key
            self.elastic = ElasticManager(
                self.store, np_range=(self.ctx.nnodes, self.ctx.np_max))
            # hold until the minimum membership is present, then pin ranks;
            # typed failure — wait_for_np's False must not be swallowed
            # into building an under-strength pod
            self.elastic.require_np(
                self.ctx.nnodes,
                timeout=env_timeout("PT_LAUNCH_RENDEZVOUS_TIMEOUT", 300.0))
            self.elastic.commit_roster()
        # torch.distributed's rendezvous needs its OWN port (the
        # rendezvous store keeps serving on ctx.master's port); node 0 picks
        # it and publishes it through the store
        if self.ctx.is_master_node():
            from .context import _free_port
            self.coord_port = _free_port()
            self.store.set("coord_port", str(self.coord_port))
        else:
            # rendezvous read: wait with the rendezvous budget before the
            # get — a bare get() is capped at the shorter per-op deadline
            self.store.wait("coord_port", timeout=env_timeout(
                "PT_LAUNCH_RENDEZVOUS_TIMEOUT", 300.0))
            self.coord_port = int(self.store.get("coord_port"))
        os.makedirs(self.ctx.log_dir, exist_ok=True)
        for local_rank in range(self.ctx.nproc_per_node):
            self._spawn(local_rank)

    def _rank(self, local_rank: int) -> int:
        return self.ctx.node_rank * self.ctx.nproc_per_node + local_rank

    def _spawn(self, local_rank: int, restarts: int = 0):
        rank = self._rank(local_rank)
        env = dict(os.environ)
        host, port = self.ctx.master.rsplit(":", 1)
        env.update(self.ctx.envs)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_LOCAL_RANK": str(local_rank),
            "PADDLE_TRAINERS_NUM": str(self.ctx.world_size),
            # rendezvous store endpoint (Context.from_args format: host:port)
            "PADDLE_MASTER": f"{host}:{port}",
            # torch.distributed rendezvous endpoint (distinct port)
            "MASTER_ADDR": host,
            "MASTER_PORT": str(self.coord_port),
            "PADDLE_JOB_ID": self.ctx.job_id,
            "RANK": str(rank),
            "WORLD_SIZE": str(self.ctx.world_size),
            "LOCAL_RANK": str(local_rank),
        })
        if self.ctx.devices is not None:
            env["PADDLE_DEVICES"] = self.ctx.devices
        log_path = os.path.join(self.ctx.log_dir,
                                f"workerlog.{rank}" if self.ctx.world_size > 1
                                else "workerlog.0")
        logf = open(log_path, "ab")
        popen = subprocess.Popen(
            [sys.executable, self.ctx.script, *self.ctx.script_args],
            env=env, stdout=logf, stderr=subprocess.STDOUT)
        logf.close()
        p = _Proc(rank, popen, log_path)
        p.restarts = restarts
        # replace or append
        for i, old in enumerate(self.procs):
            if old.rank == rank:
                self.procs[i] = p
                return
        self.procs.append(p)

    # ---- watcher / elastic restart ----
    # A failed worker triggers a restart of ALL local ranks (and, via the
    # store's restart-generation counter, every peer node's ranks too): a
    # single respawned rank cannot rejoin an in-flight process group —
    # surviving ranks would block in collectives against the dead peer.
    # Matches the reference's whole-pod restart on membership change
    # (fleet/elastic/manager.py:253-266).

    def _restart_generation(self) -> int:
        try:
            return int(self.store.add("restart_gen", 0))
        except Exception:
            return 0

    def _restart_all(self, gen: int, reason: str) -> int:
        sys.stderr.write(
            f"[launch] {reason}; restarting all local ranks "
            f"(generation {gen}, {self.pod_restarts}/{self.ctx.max_restart})\n")
        crashpoint(CP_POD_STOPPING)
        self.stop(signal.SIGTERM)
        # A fresh rendezvous port per generation: the old store
        # (hosted inside old rank 0) is gone, and rebinding the same port
        # across nodes would race. The master only publishes a port for the
        # LATEST generation it observed, so non-masters must follow the
        # newest generation while they wait (two nodes can bump restart_gen
        # within one poll window, skipping a generation on the master).
        if self.ctx.is_master_node():
            from .context import _free_port
            self.coord_port = _free_port()
            self.store.set(f"coord_port/{gen}", str(self.coord_port))
            self.store.add(f"coord_ready/{gen}", 1)
        else:
            dl = Deadline(120.0, what="pod restart coordination port")
            while True:
                gen = max(gen, self._restart_generation())
                if int(self.store.add(f"coord_ready/{gen}", 0)) > 0:
                    self.coord_port = int(self.store.get(f"coord_port/{gen}"))
                    break
                # master gone (crashed or gave up): exit instead of
                # wedging this node's launcher forever
                dl.check(exc=DeadlineExceeded,
                         detail=f"generation {gen}: master never published "
                                "a coordination port (is it down?)")
                time.sleep(0.2)
        self.procs.clear()
        for local_rank in range(self.ctx.nproc_per_node):
            self._spawn(local_rank, restarts=self.pod_restarts)
        crashpoint(CP_POD_RESPAWNED)
        return gen

    def watch(self, poll: float = 0.2) -> int:
        """Monitor the pod; on worker failure restart the whole pod (all
        local ranks + peers via the store) up to max_restart times.
        Returns the final exit code (0 iff all workers exited 0)."""
        self.pod_restarts = getattr(self, "pod_restarts", 0)
        seen_gen = self._restart_generation()
        while True:
            # elastic membership change? (scale up/down — re-rank + relaunch,
            # fleet/elastic/manager.py:253-266 semantics)
            if getattr(self, "elastic", None) is not None:
                from .elastic import ElasticStatus
                status = self.elastic.watch_once()
                if status == ElasticStatus.EXIT:
                    sys.stderr.write("[launch] node scaled out; stopping pod\n")
                    self.stop(signal.SIGTERM)
                    return 0
                if status == ElasticStatus.RESTART:
                    roster = self.elastic.commit_roster()
                    new_rank = self.elastic.rank_of(roster)
                    sys.stderr.write(
                        f"[launch] membership changed -> {roster}; "
                        f"re-ranked to {new_rank}/{len(roster)}\n")
                    self.ctx.nnodes = len(roster)
                    self.ctx.node_rank = new_rank
                    self.pod_restarts += 1
                    seen_gen = int(self.store.add("restart_gen", 1))
                    seen_gen = self._restart_all(seen_gen, "scale event")
                    continue
            # peer-initiated pod restart? (elastic single-node-min jobs must
            # follow generations too — peers exist even when nnodes == 1)
            if self.ctx.nnodes > 1 or getattr(self, "elastic", None) is not None:
                gen = self._restart_generation()
                if gen > seen_gen:
                    self.pod_restarts += 1
                    seen_gen = self._restart_all(
                        gen, "peer node requested pod restart")
            running = False
            failed: Optional[_Proc] = None
            for p in list(self.procs):
                code = p.popen.poll()
                if code is None:
                    running = True
                elif code != 0:
                    failed = p
                    break
            if failed is not None:
                code = failed.popen.poll()
                if self.pod_restarts < self.ctx.max_restart:
                    self.pod_restarts += 1
                    sys.stderr.write(
                        f"[launch] worker rank={failed.rank} exited {code}; "
                        f"restart {self.pod_restarts}/{self.ctx.max_restart} "
                        f"(log: {failed.log_path})\n")
                    if self.ctx.nnodes > 1 or \
                            getattr(self, "elastic", None) is not None:
                        seen_gen = int(self.store.add("restart_gen", 1))
                    seen_gen = self._restart_all(seen_gen,
                                                 f"rank {failed.rank} failed")
                    continue
                sys.stderr.write(
                    f"[launch] worker rank={failed.rank} failed permanently "
                    f"(exit {code}); stopping pod\n")
                self.stop(signal.SIGTERM)
                return code
            if not running:
                return 0
            time.sleep(poll)

    def stop(self, sig=signal.SIGTERM):
        for p in self.procs:
            if p.popen.poll() is None:
                try:
                    p.popen.send_signal(sig)
                except OSError:
                    pass
        deadline = time.monotonic() + 5
        for p in self.procs:
            try:
                p.popen.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.popen.kill()


def launch(argv=None) -> int:
    from .context import Context
    ctx = Context.from_args(argv)
    ctrl = CollectiveController(ctx)
    ctrl.build_pod()
    try:
        return ctrl.watch()
    except KeyboardInterrupt:
        ctrl.stop(signal.SIGINT)
        return 130
    finally:
        # stop the heartbeat BEFORE the store: a live heartbeat thread
        # would otherwise spin typed-but-futile reconnects against the
        # store we are about to tear down
        if getattr(ctrl, "elastic", None) is not None:
            ctrl.elastic.stop()
        if ctrl.store is not None:
            ctrl.store.stop()
