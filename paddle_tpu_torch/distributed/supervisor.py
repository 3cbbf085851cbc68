"""Elastic training supervisor: closed-loop failure detection -> live mesh
shrink/grow -> exactly-once resume.

Counterpart of ``paddle_tpu/distributed/supervisor.py``: the same loop,
epoch fence, sharded two-phase commit, coordinated drain, forensics,
chaos sites and knobs, over host state (name -> numpy). The one place the
port differs is the train-step leg: a rank is a process, so
``swap_train_step`` re-forms the ``torch.distributed`` groups over the new
roster and hands ``TrainStep.reshard`` the supervisor's resharded host
state for whatever this rank does not hold.

Every ingredient of fault-tolerant elastic training already exists in
isolation — lease-based membership (`launch/elastic.py`), a bitwise-proven
reshard planner/executor with a reshard -> partial-restore -> full-restore
ladder (`reshard.py`), generation-committed checkpoints (`ckpt_manager.py`)
and exactly-once stream cursors (`io/streaming.py`). This module CLOSES
THE LOOP: a reshard stops being something a test calls and becomes
something the system *does* when a worker dies mid-run.

The supervised loop (one `Supervisor` per worker, stable elastic node id):

1. **detect** — between steps the supervisor polls the store-side lease
   truth (`ElasticManager.alive_members()`); a typed `CommTimeout` /
   `ReshardTimeout` / `StoreTimeout` escaping a step, or a peer missing
   from the per-step barrier, triggers the same classification: if the
   roster changed, it is a scale event; if the roster is intact, the
   typed error propagates (a real infrastructure failure must not be
   silently eaten as churn).
2. **rendezvous** — survivors converge on the new roster through an
   idempotent, epoch-numbered exchange on the TCPStore: each survivor
   publishes its lease-view under ``{ns}/rdv/{epoch}/{view-digest}/{id}``
   and waits for every member OF THAT VIEW to publish the same digest;
   store-side lease expiry is the one clock all observers share, so the
   views converge within a TTL. The monotone supervision-epoch counter
   (``{ns}/epoch``) FENCES stale peers: a worker that missed an epoch
   (suspended process, healed partition) sees ``committed > target`` and
   gets the typed `StaleEpoch` — it may not rejoin mid-swap; it re-enters
   through a fresh rendezvous as a joiner, exactly like a grow event.
3. **swap** — the scale event commits cursor + params as ONE checkpoint
   generation first, SHARDED: every valid survivor stages its OWN bricks
   plus a per-owner receipt and the lowest-id valid member writes the
   unified manifest + atomic COMMIT marker once every receipt landed
   (two-phase; O(state/n) bytes per owner instead of a gather onto one
   node), then drives the existing ladder to the new mesh:
   `reshard_or_restore_churn` moves the cross-process shards, and at
   resume an attached `TrainStep.reshard(new_mesh, state)` re-forms the
   process groups and takes its new blocks from the result (bitwise) —
   re-planning against survivors when a lease
   lapses MID-reshard instead of burning the whole deadline. A
   `rung_agreement` pass converges the fleet: any participant that
   restored (or died unreported) pulls every survivor onto the same
   committed generation, so checkpoint-N shards never mix with live-M
   shards.
4. **resume** — bindings (mesh, rank, roster, epoch) swap, the streaming
   cursor restores exactly-once (live cursor on a live rung, the
   generation's committed cursor on a rollback — either way the delivered
   global-sample prefix and the parameter state come from the SAME commit
   point, so no sample's effect is duplicated or lost), and the loop
   continues with the batch window the new mesh computes.

Every transition carries a chaos `faultpoint` (``supervisor.detect`` /
``supervisor.rendezvous`` / ``supervisor.swap`` / ``supervisor.resume``)
under ONE cumulative `Deadline` (``PT_SUPERVISOR_TIMEOUT``) with the typed
`SupervisorTimeout`, so the no-hang matrix and the SIGKILL chaos matrix
(tests/test_supervisor.py) extend to the whole closed loop. Executed
events are recorded for ``profiler.supervisor_summary()``: per event the
detect latency, downtime, ladder rung, bytes moved and mesh sizes.

Data law: the supervisor's stream is a GLOBAL-ORDER
:class:`~paddle_tpu_torch.io.streaming.ShardedSampleStream` (``world_size=1``);
each step consumes one global window of ``batch_size * len(roster)``
samples and rank ``r`` computes on the ``window[r::n]`` stripe. The one
``(epoch, pos)`` cursor is therefore MESH-INVARIANT — a dp4 -> dp2 shrink
resumes the global prefix exactly where the committed generation said,
with the surviving loss curve changed only by the batch shape it now
computes.

**Coordinated drain** (``request_stop(leave=True)`` on a watched fleet):
the departing member announces intent on the store (one counter add at
the ``supervisor.drain`` site), then participates in the scale event as a
LIVE member — it stages bricks into the commit, serves as a reshard
source and passes rung agreement — and revokes its lease only after the
survivors converged. A graceful leave therefore costs ZERO replayed
steps and lands in the event log as its own cause (``"drain"`` /
``"drained"``), typed-distinct from every crash cause.

**Incident forensics**: every scale event (crash OR drain) best-effort
exports the event record + ``trace.last_incident()`` and the trace ring
(Chrome JSON) beside the generation directory it rolled to
(``incident-step<N>-epoch<E>-<node>.json`` under the checkpoint root),
so elastic events are debuggable after the fact. ``PT_INCIDENT_EXPORT=0``
disables.

Knobs: ``PT_SUPERVISOR_TIMEOUT`` (cumulative per-event budget, default
60s), ``PT_SUPERVISE`` (``0`` disables the watch — steps run unsupervised
and failure signals propagate raw), ``PT_INCIDENT_EXPORT`` (forensics
export switch, default on).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils.deadline import (CheckpointTimeout, CommTimeout, Deadline,
                              DeadlineExceeded, MembershipTimeout,
                              ReshardTimeout, StoreTimeout,
                              SupervisorTimeout, env_timeout)
from . import reshard as rs
from .chaos import faultpoint, register_fault
from .reshard import MeshSpec, ParamSpec, plan_reshard, session_for

# chaos sites: the four transitions of a supervised scale event. The
# no-hang matrix (tests/test_no_hang.py) arms each with
# crash/delay/error/drop; the kill matrix (tests/test_supervisor.py)
# SIGKILLs a real peer process at each, mid-run, and proves the survivors
# resume on the shrunken mesh bitwise vs a fresh restore of the same
# committed generation.
FP_DETECT = register_fault(
    "supervisor.detect",
    "failure-signal classification between supervised steps")
FP_RENDEZVOUS = register_fault(
    "supervisor.rendezvous",
    "epoch-numbered survivor rendezvous on the store")
FP_SWAP = register_fault(
    "supervisor.swap",
    "generation commit + mesh swap via the reshard ladder")
FP_RESUME = register_fault(
    "supervisor.resume",
    "loop resume on the new mesh (cursor + bindings)")
FP_DRAIN = register_fault(
    "supervisor.drain",
    "departing member announcing drain intent on the store")

# the typed failure signals a step (or its barrier/commit) can escape
# with that MAY mean "a peer died" — the detect transition re-checks the
# lease roster (and the drain counter) to decide. CheckpointTimeout is
# the sharded commit's receipt/marker wait giving up on a dead (or
# draining) stager.
STEP_SIGNALS = (CommTimeout, ReshardTimeout, StoreTimeout,
                MembershipTimeout, CheckpointTimeout)


class SupervisorError(RuntimeError):
    """The supervised loop could not converge the survivors (roster
    disagreement, unrecoverable state with no committed generation)."""


class StaleEpoch(SupervisorError):
    """Epoch fencing fired: this worker missed one or more supervision
    epochs (suspended process, healed partition) — the fleet completed a
    scale event without it, so its state and bindings are stale. It MUST
    NOT rejoin mid-swap; re-enter through a fresh rendezvous (a new
    `Supervisor` with ``joining=True`` — the grow path)."""


class Evicted(SupervisorError):
    """This worker is not in the surviving roster: its own lease lapsed
    and every observer has already re-ranked without it."""


def supervise_enabled() -> bool:
    """The PT_SUPERVISE master switch (default on)."""
    return os.environ.get("PT_SUPERVISE", "1").strip().lower() not in (
        "0", "false", "off")


@dataclass(frozen=True)
class SupervisedParam:
    """One supervised array: global shape/dtype plus its per-dim mesh-axis
    layout (the SAME named spec on every mesh the fleet passes through —
    ``("dp", None)`` row-shards dim 0 over however large ``dp`` currently
    is; `distributed.embedding.table_param_spec` produces exactly this
    shape/spec pair for a sharded table)."""

    shape: Tuple[int, ...]
    dtype: "np.dtype"
    spec: tuple = ()

    def param_spec(self) -> ParamSpec:
        return ParamSpec(self.shape, self.dtype, src=self.spec,
                         dst=self.spec)


def _view_digest(view: List[str]) -> str:
    return hashlib.sha256(",".join(view).encode()).hexdigest()[:10]


def _state_sha(state: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for name in sorted(state):
        arr = np.ascontiguousarray(np.asarray(state[name]))
        h.update(name.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


class Supervisor:
    """Run a training step loop under closed-loop elastic supervision.

    Parameters
    ----------
    store, elastic, ckpt
        The TCPStore rendezvous blackboard, this worker's `ElasticManager`
        (its ``node_id`` is the stable owner identity) and the SHARED
        `CheckpointManager` (all workers must see the same generation
        directory — the durable root of every rollback rung). One store
        hosts ONE elastic fleet: the manager's lease/join registry is
        store-global (not namespaced by ``ns``), so a second fleet on the
        same store would adopt the first fleet's members at bind().
    params, state
        ``params`` maps name -> `SupervisedParam` (global shape/dtype +
        mesh-axis layout); ``state`` is THIS owner's local shards of them
        under the current mesh (full arrays when the layout is
        replicated). The supervisor owns ``state`` after construction and
        hands the current dict to ``step_fn`` each step.
    stream
        Optional GLOBAL-ORDER `ShardedSampleStream` (``world_size=1`` is
        enforced: the supervisor does the rank striping so the cursor
        stays mesh-invariant across scale events).
    train_step / train_mesh
        Optional train-step leg: a `TrainStep` plus a callable
        ``n_members -> mesh`` (a ``parallel.mesh.elastic_mesh`` over the
        new roster, built from this supervisor's ``rank`` and ``epoch``,
        which are current when it is called); every resume calls
        ``swap_train_step(train_step, train_mesh(n), state)`` after the
        host-side ladder, with the ladder's result as ``state``.
        ``TrainStep.supervised_state()`` gives matching ``params`` and
        ``state``.
    mesh_shape
        ``n_members -> {axis: size}`` for the host-side `MeshSpec`
        (default ``{"dp": n}``).
    joining
        A fresh joiner (or a fenced stale worker re-entering): it has no
        valid state, its roster is just itself, and its first detect poll
        immediately rendezvouses with the incumbents — whose planner
        sends it its shards (the grow path).
    """

    def __init__(self, *, store, elastic, ckpt,
                 params: Optional[Dict[str, SupervisedParam]] = None,
                 state: Optional[Dict[str, np.ndarray]] = None,
                 stream=None, batch_size: int = 1,
                 mesh_shape: Optional[Callable[[int], dict]] = None,
                 train_step=None,
                 train_mesh: Optional[Callable[[int], object]] = None,
                 budget: Optional[float] = None,
                 watch_budget: Optional[float] = None,
                 barrier: bool = True,
                 barrier_timeout: Optional[float] = None,
                 ckpt_every: int = 1, min_members: int = 1,
                 detect_every: int = 1, churn_probe: float = 3.0,
                 ns: str = "sup", joining: bool = False):
        self.store = store
        self.elastic = elastic
        self.ckpt = ckpt
        self.node_id = elastic.node_id
        self.params: Dict[str, SupervisedParam] = dict(params or {})
        self.state: Dict[str, np.ndarray] = dict(state or {})
        self.stream = stream
        if stream is not None and getattr(stream, "world_size", 1) != 1:
            raise ValueError(
                "Supervisor streams must be GLOBAL-ORDER (world_size=1): "
                "the supervisor stripes the window per rank itself, so the "
                "one (epoch, pos) cursor stays mesh-invariant across scale "
                "events — a rank-striped cursor cannot survive a dp shrink")
        self.batch_size = int(batch_size)
        self._mesh_shape = mesh_shape or (lambda n: {"dp": n})
        self.train_step = train_step
        self._train_mesh = train_mesh
        self.budget = (budget if budget is not None
                       else env_timeout("PT_SUPERVISOR_TIMEOUT", 60.0))
        self.watch_budget = (watch_budget if watch_budget is not None
                             else self.budget)
        self.barrier = bool(barrier)
        ttl = getattr(elastic, "_ttl_ms", 5000) / 1000.0
        self.barrier_timeout = (barrier_timeout if barrier_timeout is not None
                                else ttl + 2.0)
        self.ckpt_every = int(ckpt_every)
        self.min_members = int(min_members)
        self.detect_every = max(1, int(detect_every))
        self.churn_probe = float(churn_probe)
        self.ns = ns
        # ALL supervisor store traffic rides a DEDICATED client connection
        # when the store can give us one: the barrier/rendezvous waits are
        # server-side blocking ops that hold their client for whole
        # seconds, and the ElasticManager's lease heartbeat shares the
        # process's primary client — a supervisor waiting on a dead peer
        # through that same client would starve its OWN heartbeat past the
        # lease TTL and get itself evicted mid-event (observed, not
        # hypothetical). The elastic manager keeps the primary client.
        self._sup_store = store
        self._own_store = False
        from .store import TCPStore
        if isinstance(store, TCPStore):
            self._sup_store = TCPStore(store.host, store.port,
                                       is_master=False)
            self._own_store = True
        self._transport = rs.StoreTransport(self._sup_store,
                                            prefix=f"{ns}/x")
        self.steps_done = 0
        # rendezvous-key GC bookkeeping, so the store does not accumulate
        # {ns}/rdv/* and per-step barrier keys for the life of a run.
        # Every rdv/rdvwin key this worker
        # publishes OR reads is recorded with its epoch and deleted once a
        # LATER epoch converges (the monotone counter fences every reader
        # of older epochs, so the keys are dead); its own barrier keys are
        # deleted rolling, one barrier behind (a member passing barrier S
        # has observed every peer INSIDE barrier S, so no one can still be
        # waiting on any step <= S-1 key).
        self._rdv_keys: List[Tuple[int, str]] = []
        self._bar_keys: List[str] = []
        self.epoch = int(self._sup_store.add(f"{ns}/epoch", 0))
        self._has_state = not joining
        self._joining = bool(joining)
        self.roster: List[str] = [self.node_id] if joining else []
        self.mesh: Optional[MeshSpec] = None
        self.rank = 0
        self._ticks = 0
        self._stop_requested = False
        self._leave_on_stop = False
        self.events: List[dict] = []
        # coordinated-drain bookkeeping: the store-side announcement
        # counter this worker has already folded into a scale event (a
        # joiner adopts the current value — drains before its time are
        # not its events), the set of members known to have DRAINED away
        # (their lease may linger briefly after the event; it must not
        # read as fresh churn), and whether THIS worker is the leaver.
        self._drains_seen = 0
        self._drains_seen = self._drain_counter()
        self._drained: set = set()
        self._leaving = False
        # per-owner sharded-commit accounting (profiler.supervisor_summary
        # renders the bytes/wall columns from the event fields)
        self.commit_stats: List[dict] = []
        self._last_commit: Optional[dict] = None

    # ------------------------------------------------------------------
    # binding
    # ------------------------------------------------------------------
    def bind(self, n_members: int, timeout: float = 60.0) -> List[str]:
        """Wait for the initial fleet (typed `MembershipTimeout` on a
        shortfall — never train under-strength) and adopt it as the
        roster. Every member calls this with the same ``n_members``."""
        members = self.elastic.require_np(n_members, timeout=timeout)
        self._adopt_roster(sorted(members))
        return self.roster

    def _adopt_roster(self, roster: List[str]) -> None:
        self.roster = list(roster)
        self.mesh = MeshSpec.from_members(roster,
                                          self._mesh_shape(len(roster)))
        self.rank = self.mesh.owners.index(self.node_id) \
            if self.node_id in self.mesh.owners else -1

    def _param_specs(self) -> Dict[str, ParamSpec]:
        return {n: p.param_spec() for n, p in self.params.items()}

    # ------------------------------------------------------------------
    # guarded site helper: chaos faultpoint + cumulative deadline +
    # retry-once on a dropped wire (idempotent store ops, safe to reissue)
    # ------------------------------------------------------------------
    def _site(self, site: str, dl: Deadline, what: str) -> None:
        # the observability span carries the supervision epoch, so a scale
        # event's detect/rendezvous/swap/resume transitions line up on one
        # correlated timeline (and a chaos delay here shows as the span's
        # duration — the flight recorder's postmortem names the stall)
        from ..observability import trace
        with trace.span(site, epoch=self.epoch, node=self.node_id,
                        step=self.steps_done):
            for attempt in (0, 1):
                try:
                    faultpoint(site)
                    dl.check(what, exc=SupervisorTimeout)
                    return
                except ConnectionError:
                    if attempt:
                        raise

    # ------------------------------------------------------------------
    # the supervised loop
    # ------------------------------------------------------------------
    def run(self, step_fn: Callable, n_steps: int) -> Dict[str, np.ndarray]:
        """Run ``step_fn(state, batch, sup) -> new_state`` for ``n_steps``
        under watch; returns the final local state. ``batch`` is this
        rank's stripe of the global window (None without a stream);
        ``sup`` is this supervisor (read ``sup.mesh`` / ``sup.rank`` /
        ``sup.steps_done`` for the current bindings — they change across
        scale events)."""
        was_joiner = self._joining
        if self.mesh is None:
            # joiner: enter through the rendezvous before the first step
            if self._joining:
                self._handle_event("join")
            else:
                raise SupervisorError("call bind() before run()")
        watched = supervise_enabled()
        if self.ckpt_every > 0 and not was_joiner:
            # commit the STARTING state as a generation before the first
            # step: a member dying before the first per-step commit would
            # otherwise take its exclusive shards somewhere no rollback
            # rung can reach. Every bound member stages unconditionally
            # (a latest()-is-None check would race the committer's
            # in-flight marker across members); _sharded_commit skips
            # when the boundary is already durable. Wrapped in the same
            # classifier as the loop body: a peer dying mid-initial-commit
            # is a scale event, not a raw typed error.
            try:
                self._sharded_commit(
                    self.mesh, list(self.roster), self.steps_done,
                    Deadline(self.watch_budget, what="initial commit"),
                    tag=f"init{self.epoch}-{self.steps_done}")
            except STEP_SIGNALS + (rs.ReshardError,) as e:
                if not watched:
                    raise
                self._classify_step_failure(e)
        while self.steps_done < int(n_steps):
            if self._stop_requested:
                if (watched and self._leave_on_stop and not self._leaving
                        and len(self.roster) > 1):
                    # coordinated drain: announce on the store, then
                    # participate in the survivors' scale event as the
                    # LEAVER — the fleet commits a generation with this
                    # member still present and reshards its bricks away,
                    # so the graceful leave costs zero replay. A drain
                    # that cannot CONVERGE falls back to the blunt leave
                    # below (survivors recover through the crash path);
                    # a typed deadline error propagates — a wedged
                    # graceful leave must name its stuck dependency, not
                    # exit looking clean.
                    try:
                        self._drain_and_leave()
                    except (SupervisorError, rs.ReshardError,
                            ConnectionError):
                        self._leaving = False  # blunt leave below
                break
            try:
                dl = Deadline(self.watch_budget,
                              what=f"supervised watch @ {self.node_id}")
                cause = self._detect(dl) if watched else None
                if cause:
                    self._handle_event(cause)
                    continue
                if watched and self.barrier and len(self.roster) > 1:
                    self._step_barrier(dl)
                window, mine = self._next_batch()
                self.state = step_fn(self.state, mine, self)
                if self.stream is not None and window is not None:
                    self.stream.advance(len(window))
                self.steps_done += 1
                if self.ckpt_every > 0 \
                        and self.steps_done % self.ckpt_every == 0:
                    self._sharded_commit(
                        self.mesh, list(self.roster), self.steps_done,
                        Deadline(self.watch_budget, what="step commit"),
                        tag=f"s{self.epoch}-{self.steps_done}")
            except STEP_SIGNALS + (rs.ReshardError,) as e:
                # rs.ReshardError / CheckpointTimeout cover the per-step
                # sharded commit: a peer dying mid-stage surfaces there
                # as ShardLost or an aborted receipt wait
                if not watched:
                    raise
                self._classify_step_failure(e)
        if self._stop_requested and self._leave_on_stop \
                and not self._leaving:
            # blunt leave (unwatched fleets, solo member, failed drain):
            # AFTER the final step's commit — revoking the lease
            # mid-commit would make this member's own bricks unavailable
            # to the commit it is still participating in
            self.elastic.leave()
        return self.state

    def _classify_step_failure(self, e: BaseException) -> None:
        """A typed failure escaped a step (or its barrier/commit): a
        pending drain announcement or a changed lease roster makes it a
        scale event; an intact fleet means a genuine infrastructure
        failure that must reach the operator, not be eaten as churn."""
        if self._drains_pending():
            self._handle_event("drain")
        elif self._roster_changed():
            self._handle_event(f"typed:{type(e).__name__}")
        else:
            raise e

    def request_stop(self, leave: bool = True) -> None:
        """Graceful scale-down: finish the current step, then exit the
        loop. With ``leave`` on a watched multi-member fleet this drives
        the COORDINATED DRAIN — announce on the store, commit a
        generation with this member still present, reshard its bricks
        to the survivors, and only then revoke the lease — so peers
        shrink with zero replayed steps and the event is typed "drain",
        not a crash."""
        self._stop_requested = True
        self._leave_on_stop = bool(leave)

    def close(self) -> None:
        """Release the supervisor's dedicated store client (the primary
        client handed to the constructor stays the caller's to stop)."""
        if self._own_store:
            try:
                self._sup_store.stop()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
            self._own_store = False

    # ---- detection ----
    def _detect(self, dl: Deadline) -> Optional[str]:
        """Between-steps poll; returns the scale-event cause (``"drain"``
        / ``"lease-lapse"``) or None. The drain counter is checked FIRST
        and is one cheap store add — a graceful leave is classified
        without waiting out any failure-detection deadline."""
        self._ticks += 1
        self._site(FP_DETECT, dl, "supervisor detect poll")
        if self._ticks % self.detect_every:
            return None
        if self._drains_pending():
            return "drain"
        return "lease-lapse" if self._roster_changed() else None

    def _drain_counter(self) -> int:
        try:
            return int(self._sup_store.add(f"{self.ns}/drainn", 0))
        except STEP_SIGNALS + (ConnectionError,):
            return self._drains_seen

    def _drains_pending(self) -> bool:
        return self._drain_counter() > self._drains_seen

    def _roster_changed(self) -> bool:
        try:
            alive = set(self.elastic.alive_members())
        except STEP_SIGNALS:
            return False  # can't read the roster: not evidence of churn
        # a member that DRAINED away may hold a live lease for a little
        # while after the event (it revokes only once the survivors'
        # rendezvous converged) — that lingering lease is not churn. The
        # mask self-prunes on lease expiry, so the same id re-joining
        # later is detected as a fresh grow event.
        self._drained &= alive
        return (alive - self._drained) != set(self.roster)

    def _step_barrier(self, dl: Deadline) -> None:
        """All roster members must reach step boundary `steps_done` before
        anyone computes — the barrier where a SIGKILLed peer is
        DISCOVERED: its key never appears, the bounded wait raises the
        typed StoreTimeout, and the loop's classifier turns a changed
        roster into a scale event."""
        key = f"{self.ns}/bar/{self.epoch}/{self.steps_done}"
        self._sup_store.set(f"{key}/{self.node_id}", b"1")
        self._bar_keys.append(f"{key}/{self.node_id}")
        for peer in self.roster:
            if peer == self.node_id:
                continue
            while True:
                rem = dl.remaining(floor=0.05)
                slice_t = min(self.barrier_timeout,
                              rem if rem is not None else
                              self.barrier_timeout)
                try:
                    self._sup_store.wait(f"{key}/{peer}", timeout=slice_t)
                    break
                except (StoreTimeout, DeadlineExceeded) as e:
                    if self._drains_pending():
                        # the missing peer is (or follows) a DRAINING
                        # member already in the scale event's rendezvous:
                        # classify now instead of waiting out the budget
                        raise StoreTimeout(
                            f"step barrier {self.steps_done}", slice_t,
                            detail=f"peer {peer!r} missed the barrier "
                                   f"with a drain announced") from e
                    if self._roster_changed():
                        raise StoreTimeout(
                            f"step barrier {self.steps_done}", slice_t,
                            detail=f"peer {peer!r} missed the barrier and "
                                   f"the lease roster changed") from e
                    dl.check(f"step barrier {self.steps_done}",
                             exc=SupervisorTimeout,
                             detail=f"peer {peer!r} alive but absent")
        # rolling GC: everyone is inside barrier `steps_done` now, so our
        # own keys from barriers <= steps_done - 1 can never be waited on
        # again (each member deletes its own — collectively complete)
        while len(self._bar_keys) > 1:
            self._try_delete(self._bar_keys.pop(0))

    def _try_delete(self, key: str) -> None:
        """Best-effort housekeeping delete: a failed delete must never
        fail the loop (the key is retried at the next GC point only if
        still recorded — delete_key is idempotent either way)."""
        try:
            self._sup_store.delete_key(key)
        except Exception:  # noqa: BLE001 — GC is advisory, never fatal
            pass

    def _gc_rendezvous_keys(self) -> None:
        """Delete every recorded rdv/rdvwin key of epochs BEFORE the one
        just converged (the monotone epoch counter fences all readers of
        older epochs: a stale worker sees committed > target and gets the
        typed StaleEpoch without touching those keys), plus the outgoing
        roster's last barrier keys (older ones were rolled away live;
        reconstructed by name because a dead peer cannot delete its own)."""
        keep: List[Tuple[int, str]] = []
        for epoch, key in self._rdv_keys:
            if epoch < self.epoch:
                self._try_delete(key)
            else:
                keep.append((epoch, key))
        self._rdv_keys = keep

    def _gc_barrier_window(self, old_epoch: int, old_roster: List[str],
                           around_step: int) -> None:
        for s in range(max(0, around_step - 2), around_step + 2):
            for m in old_roster:
                self._try_delete(f"{self.ns}/bar/{old_epoch}/{s}/{m}")
        self._bar_keys = []

    # ---- data ----
    def _next_batch(self):
        if self.stream is None:
            return None, None
        n = max(1, len(self.roster))
        global_batch = self.batch_size * n
        if self.stream.exhausted():
            self.stream.roll_epoch()
        remaining = self.stream.epoch_len() - self.stream.pos
        take = min(global_batch, remaining)
        window = [self.stream.sample_at(self.stream.pos + j)
                  for j in range(take)]
        return window, window[self.rank::n]

    # ------------------------------------------------------------------
    # the scale event: rendezvous -> swap -> resume
    # ------------------------------------------------------------------
    def _handle_event(self, cause: str) -> None:
        t0 = time.perf_counter()
        dl = Deadline(self.budget,
                      what=f"supervisor event @ {self.node_id}")
        self._site(FP_DETECT, dl, "scale-event classification")
        detect_latency = time.perf_counter() - t0
        self._last_commit = None
        # announcements up to here are folded into THIS event (a draining
        # member announces immediately before entering the same epoch's
        # rendezvous, where its payload carries the leaving flag); later
        # announcements stay pending for the next detect poll
        drains_at_entry = self._drain_counter()
        while True:
            survivors, infos = self._rendezvous(dl)
            leaving = sorted(m for m in survivors
                             if infos[m].get("leaving"))
            staying = [m for m in survivors if m not in leaving]
            if not staying:
                raise SupervisorError(
                    "every rendezvous participant is draining — no "
                    "surviving mesh to hand the state to")
            new_mesh = MeshSpec.from_members(
                staying, self._mesh_shape(len(staying)))
            try:
                out, how, gen, steps, cursor, moved = \
                    self._swap(new_mesh, infos, dl)
            except SupervisorTimeout:
                raise
            except (DeadlineExceeded, rs.ReshardError, ConnectionError,
                    SupervisorError) as e:
                if set(self.elastic.alive_members()) != set(survivors):
                    # cascade: another member died mid-swap — the NEXT
                    # epoch's rendezvous re-converges what is left
                    dl.check("cascading scale event",
                             exc=SupervisorTimeout,
                             detail=f"swap failed with "
                                    f"{type(e).__name__}, re-entering "
                                    f"rendezvous")
                    continue
                raise
            # _swap returning means every participant passed its commit
            # barrier: the fleet converged. A member dying right after is
            # a FRESH event the next barrier/detect poll handles — a
            # post-swap roster re-check here would let one survivor
            # resume while another re-converges against a stale roster
            # (fleet split), so resume unconditionally.
            if self._leaving:
                # the LEAVER: the survivors converged, the commit barrier
                # passed (its bricks are durable in the committed
                # generation) and the ladder moved its live shards to the
                # stayers — record the typed drain event, export the
                # forensics bundle, revoke the lease, exit the loop.
                self._drain_exit(new_mesh, gen, steps, moved,
                                 detect_latency, t0)
                return
            self._drains_seen = max(self._drains_seen, drains_at_entry)
            self._drained |= set(leaving)
            self._resume(new_mesh, out, how, gen, steps, cursor, cause,
                         detect_latency, t0, moved, dl)
            return

    # ---- coordinated drain ----
    def _drain_and_leave(self) -> None:
        """The leaver's half of the coordinated drain: announce intent on
        the store (the ``supervisor.drain`` chaos site — one counter add,
        so survivors classify the event from a cheap poll instead of
        waiting out a barrier/lease deadline), then participate in the
        scale event as a LIVE member — stage bricks into the commit,
        serve as a reshard source, pass rung agreement — and only then
        revoke the lease and exit (inside `_handle_event`)."""
        dl = Deadline(self.budget,
                      what=f"coordinated drain @ {self.node_id}")
        self._site(FP_DRAIN, dl, "drain announcement")
        for attempt in (0, 1):
            try:
                self._sup_store.add(f"{self.ns}/drainn", 1)
                break
            except ConnectionError:
                if attempt:
                    raise
        self._leaving = True
        self._handle_event("drain")

    def _drain_exit(self, new_mesh: MeshSpec, gen, steps: int,
                    moved: int, detect_latency: float,
                    t0: float) -> None:
        """Leaver's bookkeeping after the survivors converged: the typed
        "drained" event (distinct from every crash cause), the forensics
        bundle, key GC, lease revocation. Zero replayed steps: the event
        rode a live rung, so the survivors' step count never moved."""
        event = {
            "node": self.node_id, "epoch": self.epoch, "cause": "drain",
            "how": "drained", "generation": gen, "steps": int(steps),
            "roster": list(new_mesh.owners),
            "old_size": len(self.roster), "new_size": len(new_mesh.owners),
            "bytes_moved": int(moved),
            "detect_latency_s": float(detect_latency),
            "downtime_s": time.perf_counter() - t0,
            "state_sha": None,  # the leaver hands its state away
            "cursor_pos": (int(self.stream.pos)
                           if self.stream is not None else None),
            "commit_bytes": (self._last_commit or {}).get("bytes"),
            "commit_wall_s": (self._last_commit or {}).get("wall_s"),
        }
        self.events.append(event)
        _register_event(event)
        self._export_forensics(event)
        self._gc_rendezvous_keys()
        self.elastic.leave()
        self._leave_on_stop = False  # the lease is already revoked
        self._stop_requested = True

    # ---- incident forensics ----
    def _export_forensics(self, event: dict) -> None:
        """Best-effort post-event export beside the generation directory
        the event rolled to: the event record + `trace.last_incident()`
        (the typed-deadline postmortem, when one fired) as one JSON, plus
        the trace ring as Chrome trace-event JSON. File names do not
        match the ``step-<N>`` generation pattern, so the checkpoint
        scanner never confuses forensics with state. PT_INCIDENT_EXPORT=0
        disables. Export failures are swallowed — forensics must never
        fail the resume that is trying to keep the fleet alive."""
        if os.environ.get("PT_INCIDENT_EXPORT", "1").strip().lower() in (
                "0", "false", "off"):
            return
        try:
            from ..observability import trace
            tag = (f"incident-step{event.get('generation')}"
                   f"-epoch{event['epoch']}-{self.node_id}")
            path = os.path.join(self.ckpt.root, f"{tag}.json")
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"event": event,
                           "incident": trace.last_incident()},
                          f, indent=1, sort_keys=True, default=str)
            os.replace(tmp, path)
            trace.export_trace(os.path.join(self.ckpt.root,
                                            f"{tag}.trace.json"))
        except Exception:  # noqa: BLE001 — forensics are advisory
            pass

    # ---- rendezvous ----
    def _rendezvous(self, dl: Deadline):
        """Converge the survivors on one view at epoch ``self.epoch + 1``.
        Returns (survivors, infos) where ``infos[id]`` is each survivor's
        published record (validity, roster, steps, cursor). Idempotent:
        keys are namespaced by (epoch, view-digest, node) and values are
        deterministic, so retries and replays are harmless."""
        epoch_key = f"{self.ns}/epoch"
        target = self.epoch + 1
        while True:
            self._site(FP_RENDEZVOUS, dl, "survivor rendezvous")
            committed = int(self._sup_store.add(epoch_key, 0))
            if committed > target:
                # the fleet completed epochs BEYOND the one we are trying
                # to join: definitively fenced
                raise StaleEpoch(
                    f"{self.node_id}: supervision epoch {committed} "
                    f"committed while this worker was at {self.epoch} — "
                    f"it may not rejoin mid-swap; re-enter through a "
                    f"fresh rendezvous (joining=True)")
            if committed == target:
                # epoch `target` committed while we were (re-)converging.
                # That is NOT automatically staleness: our own publication
                # may be part of the winning view (a slow wait slice made
                # us re-loop after the committer bumped the counter). The
                # committer recorded the winning digest before bumping —
                # adopt that view if it contains us, fence otherwise.
                return self._adopt_committed_view(target, dl)
            alive = sorted(set(self.elastic.alive_members()))
            if self.node_id not in alive:
                raise Evicted(
                    f"{self.node_id}: own lease lapsed — every observer "
                    f"has already re-ranked without this worker")
            if len(alive) < self.min_members:
                dl.check("rendezvous HOLD", exc=SupervisorTimeout,
                         detail=f"only {len(alive)} alive, "
                                f"min_members={self.min_members}")
                dl.sleep(self.elastic.interval)
                continue
            digest = _view_digest(alive)
            payload = json.dumps({
                "view": alive,
                "valid": bool(self._has_state),
                "leaving": bool(self._leaving),
                "roster": list(self.roster),
                "steps": int(self.steps_done),
                "cursor": (self.stream.state_dict()
                           if self.stream is not None and self._has_state
                           else None),
            }).encode()
            base = f"{self.ns}/rdv/{target}/{digest}"
            self._sup_store.set(f"{base}/{self.node_id}", payload)
            self._rdv_keys.append((target, f"{base}/{self.node_id}"))
            infos, converged = {}, True
            for m in alive:
                try:
                    rem = dl.remaining(floor=0.05)
                    self._sup_store.wait(
                        f"{base}/{m}",
                        timeout=min(1.0, rem if rem is not None else 1.0))
                    infos[m] = json.loads(
                        bytes(self._sup_store.get(f"{base}/{m}")).decode())
                    self._rdv_keys.append((target, f"{base}/{m}"))
                except (StoreTimeout, DeadlineExceeded):
                    converged = False
                    break
            dl.check("survivor rendezvous", exc=SupervisorTimeout)
            if not converged:
                continue  # view churned under us: re-poll and re-publish
            # every survivor saw the same digest; commit the epoch counter
            committed = int(self._sup_store.add(epoch_key, 0))
            if committed > target:
                raise StaleEpoch(
                    f"{self.node_id}: epoch raced to {committed} past "
                    f"target {target}")
            if committed == target:
                return self._adopt_committed_view(target, dl)
            if committed < target:
                if self.node_id == alive[0]:
                    # record the WINNING view before the bump: a peer
                    # observing committed == target can then tell "my
                    # view won, I'm in" from "the fleet moved on without
                    # me" instead of false-fencing itself
                    self._sup_store.set(f"{self.ns}/rdvwin/{target}",
                                        ",".join(alive).encode())
                    self._rdv_keys.append(
                        (target, f"{self.ns}/rdvwin/{target}"))
                    self._sup_store.add(epoch_key, 1)
                else:
                    while int(self._sup_store.add(epoch_key, 0)) < target:
                        if set(self.elastic.alive_members()) != set(alive):
                            converged = False
                            break
                        dl.check("epoch commit wait",
                                 exc=SupervisorTimeout,
                                 detail=f"waiting on {alive[0]!r} to "
                                        f"commit epoch {target}")
                        dl.sleep(0.05)
                    if not converged:
                        continue  # the committer died: re-converge
            self.epoch = target
            return alive, infos

    def _adopt_committed_view(self, target: int, dl: Deadline):
        """Epoch `target` committed while this worker was still
        converging. The committer recorded the winning view just before
        bumping the counter; if that view CONTAINS this worker, its own
        publication was part of the convergence and it simply adopts the
        result (no false fencing); if not, the fleet really did move on
        without it — typed StaleEpoch."""
        rem = dl.remaining(floor=0.1)
        try:
            self._sup_store.wait(f"{self.ns}/rdvwin/{target}", timeout=rem)
        except (StoreTimeout, DeadlineExceeded) as e:
            raise SupervisorTimeout(
                f"winning view of committed epoch {target}", rem,
                detail="epoch counter advanced but no winning view was "
                       "recorded") from e
        view = bytes(self._sup_store.get(
            f"{self.ns}/rdvwin/{target}")).decode().split(",")
        self._rdv_keys.append((target, f"{self.ns}/rdvwin/{target}"))
        if self.node_id not in view:
            raise StaleEpoch(
                f"{self.node_id}: epoch {target} committed with view "
                f"{view} — this worker was not part of it; re-enter "
                f"through a fresh rendezvous (joining=True)")
        base = f"{self.ns}/rdv/{target}/{_view_digest(view)}"
        infos = {}
        for m in view:
            rem = dl.remaining(floor=0.1)
            try:
                self._sup_store.wait(f"{base}/{m}", timeout=rem)
            except (StoreTimeout, DeadlineExceeded) as e:
                raise SupervisorTimeout(
                    f"payload of committed epoch {target}", rem,
                    detail=f"member {m!r} of the winning view never "
                           f"published") from e
            infos[m] = json.loads(
                bytes(self._sup_store.get(f"{base}/{m}")).decode())
            self._rdv_keys.append((target, f"{base}/{m}"))
        self.epoch = target
        return list(view), infos

    # ---- swap ----
    def _live_of(self, members: List[str]):
        """alive_fn restricted to `members`: a stale-but-alive worker
        (fenced by the epoch counter) holds bytes from an older epoch and
        must never be planned as a source."""
        allowed = set(members)

        def _fn():
            return [m for m in self.elastic.alive_members() if m in allowed]
        return _fn

    def _gather_commit(self, src_mesh: MeshSpec, valid: List[str],
                       steps: int, dl: Deadline, tag: str) -> int:
        """Commit the fleet's live state + cursor as ONE generation: the
        commit IS a reshard onto a one-owner replicated mesh (the
        lowest-id valid member), so the gather reuses the proven
        churn-aware executor — deadline, chaos sites, torn-payload
        checks, survivor re-planning and all. Returns the committed
        generation step. Raises `rs.ShardLost` when a needed brick has no
        live holder (the caller rolls back to the previous generation
        instead)."""
        committer = sorted(valid)[0]
        commit_mesh = MeshSpec.from_members([committer])
        specs = self._param_specs()
        gplan = plan_reshard(src_mesh, commit_mesh, specs,
                             available=set(valid))
        if not gplan.recoverable_from_peers:
            raise rs.ShardLost(
                f"gather-commit {tag}: live bytes lost with a dead owner "
                f"— rolling back to the last committed generation")
        # every valid member executes the gather (a mid-gather re-plan may
        # reassign senders, so "not currently a participant" is not a
        # stable reason to stand aside; a pure observer's execute is cheap
        # and keeps the commit barrier honest)
        full, _ = rs.reshard_or_restore_churn(
            src_mesh, commit_mesh, specs, self.node_id, self.state,
            self._transport, session=f"{tag}-commit",
            alive_fn=self._live_of(valid), ckpt=None,
            budget=dl.remaining(floor=0.1), probe=self.churn_probe,
            dst_alive_fn=self.elastic.alive_members)
        if self.node_id == committer:
            # only the COMMITTER consults latest(): its own previous
            # save is durably done before it got here, so the check
            # can't race an in-flight writer the way a per-node check
            # would (peers just lend bricks either way)
            latest = self.ckpt.latest()
            if latest is None or latest < steps:
                if self.stream is not None:
                    from ..io.streaming import save_stream_checkpoint
                    save_stream_checkpoint(self.ckpt, full, steps,
                                           self.stream)
                else:
                    self.ckpt.save(full, steps)
        return int(steps)

    def _local_bricks(self, src_mesh: MeshSpec,
                      valid: List[str]) -> Dict[str, np.ndarray]:
        """This owner's slice-keyed bricks of the live state, dedup'd
        across replicas: of the valid owners holding an IDENTICAL brick
        (replicated layouts, size-1 axes), only the lowest id stages it —
        every brick lands exactly once and every parameter stays fully
        covered (the recoverability pre-check guarantees a live holder
        for every brick before anyone stages)."""
        bricks: Dict[str, np.ndarray] = {}
        for name, p in self.params.items():
            idx = rs.shard_index(p.shape, p.spec, src_mesh, self.node_id)
            holders = [m for m in valid if m in src_mesh.owners and
                       rs.shard_index(p.shape, p.spec, src_mesh, m) == idx]
            if holders and min(holders) != self.node_id:
                continue
            if all(lo == 0 and hi == d
                   for (lo, hi), d in zip(idx, p.shape)):
                key = f"{name}|full"
            else:
                key = name + "|" + ",".join(f"{lo}:{hi}"
                                            for lo, hi in idx)
            bricks[key] = np.asarray(self.state[name])
        return bricks

    def _brick_stagers(self, src_mesh: MeshSpec,
                       valid: List[str]) -> List[str]:
        """The owners that stage at least one brick under the dedup rule
        — every member derives the SAME list from (params, mesh, valid),
        so the committer never waits for a receipt from an owner whose
        bricks are all duplicates of a lower id (e.g. fully replicated
        state: only the lowest valid owner stages)."""
        stagers = set()
        for name, p in self.params.items():
            seen: Dict[tuple, str] = {}
            for m in sorted(valid):
                if m not in src_mesh.owners:
                    continue
                idx = rs.shard_index(p.shape, p.spec, src_mesh, m)
                if idx not in seen:
                    seen[idx] = m
            stagers.update(seen.values())
        return sorted(stagers) if stagers else sorted(valid)[:1]

    def _stagers_lost(self, valid: List[str]) -> bool:
        """Abort hook for the sharded commit's receipt/marker waits: a
        commit participant losing its lease mid-stage means its receipt
        will never land — stop waiting NOW (typed CheckpointTimeout) and
        let the classifier turn it into a scale event, instead of burning
        the whole commit budget on a dead peer."""
        try:
            alive = set(self.elastic.alive_members())
        except STEP_SIGNALS:
            return False
        return not set(valid) <= alive

    def _sharded_commit(self, src_mesh: MeshSpec, valid: List[str],
                        steps: int, dl: Deadline, tag: str) -> int:
        """Commit the fleet's live state + cursor as ONE sharded
        generation: every valid owner stages its OWN bricks + per-owner
        receipt concurrently — O(state/n) bytes written per owner instead
        of the gather's O(state) onto one node — and the lowest-id valid
        member turns the collected receipts into the unified manifest +
        atomic COMMIT marker (the ckpt_manager two-phase protocol; a
        death at any point leaves the previous committed generation or a
        complete new one). Same recoverability pre-check and `ShardLost`
        contract as `_gather_commit`, which is kept as the bench
        baseline. Returns the committed generation step."""
        committer = sorted(valid)[0]
        specs = self._param_specs()
        gplan = plan_reshard(src_mesh, MeshSpec.from_members([committer]),
                             specs, available=set(valid))
        if not gplan.recoverable_from_peers:
            raise rs.ShardLost(
                f"sharded-commit {tag}: live bytes lost with a dead "
                f"owner — rolling back to the last committed generation")
        latest = self.ckpt.latest()
        if latest is not None and latest >= steps:
            # the boundary is already durable (a restarted fleet or a
            # re-entered event at the same step): never stage into a
            # committed generation. Commits are fleet-synchronized —
            # save_sharded returns only after COMMIT is visible — so
            # every member sees the same answer here.
            return int(steps)
        param_meta = {n: {"shape": list(p.shape),
                          "dtype": np.dtype(p.dtype).name,
                          "spec": list(p.spec)}
                      for n, p in self.params.items()}
        stagers = self._brick_stagers(src_mesh, valid)
        abort = lambda: self._stagers_lost(stagers)  # noqa: E731
        from ..observability import trace
        with trace.span("ckpt.sharded_commit", epoch=self.epoch,
                        node=self.node_id, step=int(steps)):
            if self.node_id not in stagers:
                # every brick this owner holds is a duplicate of a lower
                # id's: participate in the commit barrier only
                self.ckpt.wait_commit(int(steps),
                                      budget=dl.remaining(floor=0.1),
                                      abort=abort)
                return int(steps)
            bricks = self._local_bricks(src_mesh, valid)
            if self.stream is not None:
                from ..io.streaming import save_stream_sharded
                stats = save_stream_sharded(
                    self.ckpt, int(steps), self.node_id, stagers,
                    bricks, param_meta, self.stream,
                    budget=dl.remaining(floor=0.1), abort=abort)
            else:
                stats = self.ckpt.save_sharded(
                    int(steps), self.node_id, stagers, bricks,
                    param_meta, budget=dl.remaining(floor=0.1),
                    abort=abort)
        stats = dict(stats, owner=self.node_id, step=int(steps), tag=tag)
        self.commit_stats.append(stats)
        self._last_commit = stats
        return int(steps)

    def _swap(self, new_mesh: MeshSpec, infos: Dict[str, dict],
              dl: Deadline):
        """One mesh swap at the (already converged) epoch: commit, ladder,
        converge. Returns (new_state, how, generation, steps, cursor,
        bytes_moved)."""
        self._site(FP_SWAP, dl, "mesh swap")
        valid = sorted(m for m, i in infos.items() if i.get("valid"))
        gen_key = f"{self.ns}/gen/{self.epoch}"
        if not valid:
            # nobody holds live state (cold start of a healed fleet):
            # everyone restores from the last committed generation
            gen = self.ckpt.latest()
            if gen is None:
                raise SupervisorError(
                    "no survivor holds valid state and no committed "
                    "generation exists — unrecoverable")
            out, cursor = self._rollback(new_mesh, self._old_mesh_of(
                infos, fallback=new_mesh), gen)
            return out, "full-restore", gen, gen, cursor, 0
        rosters = {tuple(infos[m]["roster"]) for m in valid}
        if len(rosters) != 1:
            raise SupervisorError(
                f"valid survivors disagree on the outgoing roster: "
                f"{sorted(rosters)} — refusing to plan from a torn view")
        old_roster = list(rosters.pop())
        old_mesh = MeshSpec.from_members(
            old_roster, self._mesh_shape(len(old_roster)))
        steps_set = {int(infos[m]["steps"]) for m in valid}
        if len(steps_set) != 1:
            raise SupervisorError(
                f"valid survivors disagree on the step count "
                f"{sorted(steps_set)} — the barrier law was violated")
        steps = steps_set.pop()
        live_cursor = next((infos[m]["cursor"] for m in valid
                            if infos[m]["cursor"] is not None), None)

        # ---- 1. commit cursor+params as ONE generation ----
        # Every VALID member stages its own bricks (the sharded
        # two-phase commit); the lowest-id valid member collects the
        # receipts and writes the atomic COMMIT marker. save_sharded
        # doubles as the commit barrier: nobody proceeds to the ladder
        # until the generation is durably visible.
        rollback = False
        gen: Optional[int] = None
        if self.node_id in valid:
            try:
                gen = self._sharded_commit(old_mesh, valid, steps, dl,
                                           tag=f"g{self.epoch}")
            except rs.ShardLost:
                rollback = True
                gen = self.ckpt.latest()
        if self.node_id == valid[0]:
            self._sup_store.set(gen_key, str(gen if gen is not None
                                        else -1).encode())
        else:
            rem = dl.remaining(floor=0.1)
            try:
                self._sup_store.wait(gen_key, timeout=rem)
            except (StoreTimeout, DeadlineExceeded) as e:
                raise ReshardTimeout(
                    "generation publication", rem,
                    detail=f"committer {valid[0]!r} never published the "
                           f"commit decision") from e
            g = int(bytes(self._sup_store.get(gen_key)).decode())
            gen = None if g < 0 else g
            if gen is not None and gen < steps:
                rollback = True
        if gen is None and rollback:
            raise SupervisorError(
                "live bytes lost with a dead owner and no committed "
                "generation to roll back to — unrecoverable")

        # ---- 2. the ladder to the new mesh ----
        specs = self._param_specs()
        moved = 0
        if not rollback:
            session = session_for(self.epoch, new_mesh)
            out, how = rs.reshard_or_restore_churn(
                old_mesh, new_mesh, specs, self.node_id,
                self.state if self._has_state else {}, self._transport,
                session=session, alive_fn=self._live_of(valid),
                ckpt=self.ckpt, budget=dl.remaining(floor=0.1),
                probe=self.churn_probe,
                dst_alive_fn=self.elastic.alive_members)
            # ---- 3. fleet convergence: one rung for everyone ----
            plan = plan_reshard(old_mesh, new_mesh, specs,
                                available=set(valid))
            moved = plan.bytes_moved
            rem = dl.remaining(floor=0.1)
            agreed = rs.rung_agreement(
                plan, self._transport, session=session,
                budget=min(10.0, rem if rem is not None else 10.0))
            if how == "full-restore" or agreed == "full-restore":
                rollback = True
        if rollback:
            if gen is None:
                # a non-valid participant can land here via the
                # rung_agreement convergence after the committer published
                # "no generation" (-1) — the same unrecoverable corner the
                # valid members raised typed, so raise it typed here too
                raise SupervisorError(
                    "rollback required but no committed generation exists "
                    "— unrecoverable")
            out, cursor = self._rollback(new_mesh, old_mesh, gen)
            return out, "full-restore", gen, int(gen), cursor, moved
        return out, how, gen, steps, live_cursor, moved

    def _old_mesh_of(self, infos, fallback):
        rosters = [tuple(i.get("roster") or ()) for i in infos.values()]
        rosters = [r for r in rosters if r]
        if rosters:
            r = list(sorted(rosters)[0])
            return MeshSpec.from_members(r, self._mesh_shape(len(r)))
        return fallback

    def _rollback(self, new_mesh: MeshSpec, old_mesh: MeshSpec, gen: int):
        """Everyone onto the committed generation: destination shards cut
        from the generation's full arrays, cursor from the SAME
        generation's user_data — state and data position from one commit
        point is the exactly-once law."""
        specs = self._param_specs()
        plan = plan_reshard(old_mesh, new_mesh, specs, available=set())
        out = rs._full_restore_state(plan, self.node_id, self.ckpt)
        cursor = None
        if self.stream is not None:
            from ..io.streaming import STREAM_CURSOR_KEY
            cursor = self.ckpt.manifest(int(gen)).get(
                "user_data", {}).get(STREAM_CURSOR_KEY)
            if cursor is None:
                raise SupervisorError(
                    f"generation step-{gen} carries no stream cursor — "
                    f"cannot resume exactly-once without one")
        return out, cursor

    # ---- resume ----
    def _resume(self, new_mesh: MeshSpec, out: Dict[str, np.ndarray],
                how: str, gen, steps: int, cursor, cause: str,
                detect_latency: float, t0: float, moved: int,
                dl: Deadline) -> None:
        self._site(FP_RESUME, dl, "supervised loop resume")
        old_size = len(self.roster) if self.roster else 0
        old_roster = list(self.roster)
        self._adopt_roster(list(new_mesh.owners))
        # the rendezvous converged and every participant read what it
        # needed: prior-epoch rdv/rdvwin keys and the outgoing roster's
        # barrier window are dead — delete them
        self._gc_rendezvous_keys()
        self._gc_barrier_window(self.epoch - 1, old_roster or self.roster,
                                int(self.steps_done))
        self.state = out
        self.steps_done = int(steps)
        self._has_state = True
        self._joining = False
        if self.stream is not None and cursor is not None:
            self.stream.load_state_dict(cursor)
        if self.train_step is not None and self._train_mesh is not None:
            # the train-step leg: re-form the groups over the new roster,
            # take this rank's new blocks from the ladder's result
            swap_train_step(self.train_step,
                            self._train_mesh(len(self.roster)),
                            state=self.state)
        event = {
            "node": self.node_id, "epoch": self.epoch, "cause": cause,
            "how": how, "generation": gen, "steps": int(steps),
            "roster": list(self.roster),
            "old_size": old_size, "new_size": len(self.roster),
            "bytes_moved": int(moved),
            "detect_latency_s": float(detect_latency),
            "downtime_s": time.perf_counter() - t0,
            "state_sha": _state_sha(self.state),
            "cursor_pos": (int(self.stream.pos)
                           if self.stream is not None else None),
            # per-owner sharded-commit accounting (None when the event
            # rolled back without this owner staging, e.g. ShardLost)
            "commit_bytes": (self._last_commit or {}).get("bytes"),
            "commit_wall_s": (self._last_commit or {}).get("wall_s"),
        }
        self.events.append(event)
        _register_event(event)
        self._export_forensics(event)


# ---------------------------------------------------------------------------
# event records (profiler.supervisor_summary reads these)
# ---------------------------------------------------------------------------

_events: List[dict] = []
_events_lock = threading.Lock()


def _register_event(ev: dict) -> None:
    with _events_lock:
        _events.append(dict(ev))


def supervisor_events() -> List[dict]:
    """Every scale event a supervisor in this process resumed from."""
    with _events_lock:
        return [dict(e) for e in _events]


def reset_events() -> None:
    with _events_lock:
        _events.clear()


# ---------------------------------------------------------------------------
# the train-step leg
# ---------------------------------------------------------------------------

def swap_train_step(step, new_mesh, state=None):
    """The `TrainStep.reshard(new_mesh, state)` leg as one call: re-form
    the process groups over the new roster (a ``mesh.elastic_mesh``),
    re-partition the step's parameters and optimizer state to the new
    degree with whatever this rank does not hold taken from ``state``
    (the supervisor's resharded host state; values bitwise), keep the
    health scalars. Returns the step. The supervisor calls this at every
    resume when a train step is attached. ``state`` is a keyword the JAX
    function does not have: there every shard still exists in the one
    program."""
    step.reshard(new_mesh, state=state)
    return step
