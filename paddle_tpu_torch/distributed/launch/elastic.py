"""Elastic membership manager: counterpart of
``paddle_tpu/distributed/launch/elastic.py`` (Paddle's
fleet/elastic/manager.py:126 — ETCD leases/watches :253-266, scale up/down
detection, re-rank + relaunch).

Liveness is a store-side TTL LEASE —
each node's daemon thread refreshes `elastic/lease/{node_id}` every interval,
and the STORE's own clock decides expiry (TCPStore kLease/kLeaseCheck,
csrc/host_runtime.cc), so every observer agrees on the alive set regardless of
its local timing — exactly ETCD's lease semantics. The member registry is an
append-only join log (`elastic/njoined` + `elastic/join/{i}`), since the
store is a KV without key listing. A scale event is any change of the alive
set within the [np_min, np_max] window; ranks are recomputed by sorting the
alive node ids, and the launcher relaunches the pod with the new roster
(the reference's whole-job restart on membership change).

A heartbeat-sequence fallback (observer-side liveness, the pre-r4 scheme)
remains for stores without lease support.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ...utils.deadline import Deadline, MembershipTimeout, \
    StoreConnectionError

ELASTIC_TIMEOUT = float(os.environ.get("PADDLE_ELASTIC_TIMEOUT", 5.0))


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"          # waiting for np_min members
    RESTART = "restart"    # membership changed: relaunch with new ranks
    EXIT = "exit"          # this node was scaled out


class ElasticManager:
    def __init__(self, store, node_id: Optional[str] = None,
                 np_range: Tuple[int, int] = (1, 1),
                 heartbeat_interval: float = 0.5,
                 timeout: float = ELASTIC_TIMEOUT):
        self.store = store
        self.node_id = node_id or f"{os.uname().nodename}:{os.getpid()}"
        self.np_min, self.np_max = np_range
        self.interval = heartbeat_interval
        self.timeout = timeout
        self._stop = threading.Event()
        self._seq = 0
        self._last_seen: Dict[str, Tuple[int, float]] = {}  # id -> (seq, t)
        self._members_cache: List[str] = []
        # store-side TTL lease (ETCD semantics) when the store supports it;
        # ttl = 2 heartbeat intervals + the configured timeout
        self._use_lease = hasattr(store, "lease")
        self._ttl_ms = int((2 * heartbeat_interval + timeout) * 1000)
        self._join()
        self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                           daemon=True)
        self._hb_thread.start()

    # ---- lease ----
    def _join(self):
        i = self.store.add("elastic/njoined", 1) - 1
        self.store.set(f"elastic/join/{i}", self.node_id.encode())
        if self._use_lease:
            self.store.lease(f"elastic/lease/{self.node_id}", self._ttl_ms)
        self.store.set(f"elastic/hb/{self.node_id}", b"0")

    def _heartbeat_loop(self):
        failing_since = None
        while not self._stop.is_set():
            self._seq += 1
            try:
                if self._use_lease:
                    self.store.lease(f"elastic/lease/{self.node_id}",
                                     self._ttl_ms)
                self.store.set(f"elastic/hb/{self.node_id}",
                               str(self._seq).encode())
                failing_since = None
            except StoreConnectionError:
                # terminal per-op verdict: reconnect + one retry already
                # failed inside the store op. A partition may still heal,
                # so keep trying — but once we have been dark longer than
                # our own lease TTL every observer has ALREADY evicted us,
                # and further retries are just reconnect storms against a
                # dead master for the life of the process: stop then.
                now = time.monotonic()
                failing_since = failing_since if failing_since is not None \
                    else now
                if now - failing_since > self._ttl_ms / 1e3:
                    return
            except Exception:  # noqa: BLE001 — transient store trouble
                # A StoreTimeout from a briefly overloaded master must NOT
                # silently end heartbeating: the lease would lapse and
                # peers would evict a live node — the spurious restart the
                # no-hang layer exists to prevent. Each op is individually
                # bounded, so retry next interval.
                pass
            self._stop.wait(self.interval)

    def leave(self):
        """Graceful scale-down: stop heartbeating and revoke the lease."""
        self._stop.set()
        # the heartbeat thread may be past its _stop check and about to
        # re-grant the lease; join it BEFORE revoking so the ttl=0 below is
        # the last word
        self._hb_thread.join(timeout=2 * self.interval + 5)
        try:
            if self._use_lease:
                self.store.lease(f"elastic/lease/{self.node_id}", 0)
            self.store.set(f"elastic/hb/{self.node_id}", b"gone")
        except Exception:  # noqa: BLE001
            pass

    # ---- membership ----
    def _registered(self) -> List[str]:
        n = int(self.store.add("elastic/njoined", 0))
        ids = []
        for i in range(n):
            nid = bytes(self.store.get(f"elastic/join/{i}")).decode()
            if nid not in ids:
                ids.append(nid)
        return ids

    def alive_members(self) -> List[str]:
        """Nodes the STORE considers leased (store-side TTL expiry — all
        observers agree), falling back to heartbeat-sequence tracking when
        the store has no lease support."""
        if self._use_lease:
            alive = []
            for nid in self._registered():
                try:
                    if self.store.lease_alive(f"elastic/lease/{nid}"):
                        alive.append(nid)
                except Exception:  # noqa: BLE001
                    continue
            return sorted(alive)
        now = time.monotonic()
        alive = []
        for nid in self._registered():
            try:
                raw = bytes(self.store.get(f"elastic/hb/{nid}")).decode()
            except Exception:  # noqa: BLE001
                continue
            if raw == "gone":
                self._last_seen.pop(nid, None)
                continue
            seq = int(raw)
            last = self._last_seen.get(nid)
            if last is None or seq != last[0]:
                self._last_seen[nid] = (seq, now)
                alive.append(nid)
            elif now - last[1] <= self.timeout:
                alive.append(nid)
        return sorted(alive)

    def rank_of(self, members: Optional[List[str]] = None) -> int:
        """Deterministic re-rank: position in the sorted alive set."""
        members = members if members is not None else self.alive_members()
        return members.index(self.node_id) if self.node_id in members else -1

    # ---- watch ----
    def wait_for_np(self, n: int, timeout: float = 60.0) -> bool:
        """Poll until at least `n` members are alive. Bounded by design —
        returns False on expiry (HOLD is a policy decision for the caller,
        not an error); each poll's store ops carry their own deadlines."""
        dl = Deadline(timeout, what=f"elastic membership >= {n}")
        while not dl.expired:
            if len(self.alive_members()) >= n:
                return True
            dl.sleep(self.interval)
        return len(self.alive_members()) >= n

    def require_np(self, n: int, timeout: float = 60.0) -> List[str]:
        """wait_for_np whose expiry CANNOT be silently swallowed: raises
        the typed MembershipTimeout naming the shortfall (a pod built
        under-strength trains a wrong-world job). Returns the alive set —
        the RETURNED snapshot is re-validated, so a member lapsing between
        the wait and the read also raises instead of handing the caller a
        short roster."""
        ok = self.wait_for_np(n, timeout)
        alive = self.alive_members()
        if not ok or len(alive) < n:
            raise MembershipTimeout(
                f"elastic membership >= {n}", timeout,
                detail=f"only {len(alive)} alive: {alive}")
        return alive

    def watch_once(self) -> str:
        """One membership poll against the roster this pod launched with."""
        alive = self.alive_members()
        if self.node_id not in alive:
            return ElasticStatus.EXIT
        if len(alive) < self.np_min:
            return ElasticStatus.HOLD
        if self._members_cache and alive != self._members_cache:
            return ElasticStatus.RESTART
        if not self._members_cache:
            self._members_cache = alive
        return ElasticStatus.COMPLETED

    def commit_roster(self) -> List[str]:
        """Accept the current alive set as the running roster (called after a
        [re]launch); subsequent watch_once() diffs against it."""
        self._members_cache = self.alive_members()
        return self._members_cache

    def stop(self):
        self._stop.set()
        # join like leave() does: a heartbeat thread past its _stop check
        # would otherwise re-grant the lease one interval after stop(),
        # keeping this node "alive" to observers for a full extra TTL
        self._hb_thread.join(timeout=2 * self.interval + 5)
