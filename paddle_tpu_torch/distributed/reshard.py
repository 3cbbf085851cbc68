"""Live resharding: elastic shrink/grow without losing progress.

Counterpart of ``paddle_tpu/distributed/reshard.py``: the same planner,
executor, transports and ladder over host bytes (a state is a name ->
numpy dict, as there), so a plan's ``digest()`` and its transfers are
equal in both packages for the same meshes and specs.

The elastic pieces already exist in isolation — membership
(`launch/elastic.py` store-clock leases), durability (`ckpt_manager.py`
generation commits), liveness (`utils/deadline.py` typed budgets). Today
they compose only through the blunt path: any membership change restarts
the pod and every worker reloads a FULL checkpoint. This module is the
surgical path, in the spirit of memory-efficient array redistribution
through portable collective communication (arxiv 2112.01075):

1. a **planner** (`plan_reshard`) that, for any (src mesh, sharding spec)
   -> (dst mesh, sharding spec) pair, cuts every array into the brick grid
   induced by BOTH partitions and assigns each needed brick a source —
   the destination owner itself when it already holds the bytes (local
   reuse, zero transfer), otherwise a load-balanced surviving holder.
   Bricks whose every holder is dead are recorded as `lost`, not guessed;
2. an **executor** (`execute`) that applies a plan to one owner's local
   state (params, optimizer moments, loss scale — any name->array dict)
   over a pluggable transport. Every blocking edge (plan-digest exchange,
   shard payload recv, commit barrier) rides one cumulative `Deadline`
   and a registered chaos site (`reshard.plan` / `reshard.transfer` /
   `reshard.commit`), so the no-hang fault matrix extends to it: a SIGKILLed
   peer turns into a typed `ReshardTimeout`, never a hang. The old state
   is replaced only after the commit barrier — a failure anywhere leaves
   it untouched (never train on torn state);
3. the **fallback ladder** (`reshard_or_restore`): reshard from survivors
   first; bricks lost with the dead node are read back from the last
   committed checkpoint generation (partial restore); a reshard that
   cannot complete at all (peer died mid-transfer) falls back to a full
   `CheckpointManager` restore of this owner's destination shards.

Owners are STABLE ids (elastic node ids), not ranks: after a shrink the
same physical worker keeps its identity even though its rank changed, so
the planner knows exactly which bytes it already holds.

Executed plans are recorded for `profiler.reshard_summary()`: bytes moved
vs. the naive full-gather volume, local-reuse bytes, downtime, and which
rung of the ladder ran.

Note on the name: in the JAX package `distributed.reshard` is also the
auto-parallel `reshard(x, mesh, placements)` API, reached by calling this
module. The port has no auto-parallel API: calling the module raises
`NotInThisSlice` naming it.
"""
from __future__ import annotations

import hashlib
import math
import sys
import threading
import time
import types
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.deadline import Deadline, DeadlineExceeded, ReshardTimeout, \
    env_timeout
from .chaos import faultpoint, register_fault

# chaos sites: every blocking edge of a live reshard. The no-hang matrix
# (tests/test_no_hang.py) arms each with crash/delay/error/drop; the kill
# matrix (tests/test_reshard.py) SIGKILLs a peer at each and proves the
# survivor completes or recovers from the last committed generation.
FP_PLAN = register_fault(
    "reshard.plan", "plan-digest exchange across reshard participants")
FP_TRANSFER = register_fault(
    "reshard.transfer", "shard payload send/recv between owners")
FP_COMMIT = register_fault(
    "reshard.commit", "commit barrier before the state swap")


class ReshardError(RuntimeError):
    """Live resharding could not complete (plan disagreement, torn
    payload, ...). The caller's ladder falls back to checkpoint restore."""


class ShardLost(ReshardError):
    """A needed brick has no surviving holder and no checkpoint reader was
    provided — the state is unrecoverable from peers alone."""


# ---------------------------------------------------------------------------
# mesh + sharding model (host-side, abstract)
# ---------------------------------------------------------------------------

def _prod(xs) -> int:
    return math.prod(int(x) for x in xs)


@dataclass(frozen=True)
class MeshSpec:
    """A named-axis mesh whose positions are owned by STABLE ids.

    `axes` is an ordered tuple of (name, size); `owners` lists the owner id
    of each position in row-major order over the axes. For the elastic
    1-D case, `MeshSpec.from_members(members)` builds a `dp`-only mesh over
    the sorted member ids — the same deterministic order ElasticManager's
    re-rank uses, so mesh position == elastic rank.
    """

    axes: Tuple[Tuple[str, int], ...]
    owners: Tuple[str, ...]

    def __post_init__(self):
        n = _prod(s for _, s in self.axes)
        if n != len(self.owners):
            raise ValueError(f"mesh {dict(self.axes)} has {n} positions but "
                             f"{len(self.owners)} owners")
        if len(set(self.owners)) != len(self.owners):
            raise ValueError("mesh owners must be distinct stable ids")

    @classmethod
    def from_members(cls, members: Sequence[str],
                     shape: Optional[dict] = None) -> "MeshSpec":
        members = sorted(str(m) for m in members)
        if shape is None:
            shape = {"dp": len(members)}
        if _prod(shape.values()) != len(members):
            raise ValueError(f"mesh shape {shape} needs "
                             f"{_prod(shape.values())} members, "
                             f"have {len(members)}")
        return cls(tuple((str(k), int(v)) for k, v in shape.items()),
                   tuple(members))

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(self.axes)

    def owners_at(self, constraint: Dict[str, int]) -> List[str]:
        """Owner ids of every position matching the constrained coords
        (unconstrained axes are free — those positions are replicas)."""
        names = [n for n, _ in self.axes]
        dims = [s for _, s in self.axes]
        out = []
        for flat, idx in enumerate(np.ndindex(*dims) if dims else [()]):
            if all(idx[names.index(a)] == c for a, c in constraint.items()):
                out.append(self.owners[flat])
        return out


def _norm_spec(spec, ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """Normalize a PartitionSpec-like per-dim spec (None | str | tuple) to
    a tuple of axis-name tuples, padded to ndim."""
    spec = tuple(spec or ())
    out = []
    for i in range(ndim):
        s = spec[i] if i < len(spec) else None
        if s is None:
            out.append(())
        elif isinstance(s, (tuple, list)):
            out.append(tuple(str(a) for a in s))
        else:
            out.append((str(s),))
    return tuple(out)


def _dim_layout(dim: int, axes: Tuple[str, ...],
                mesh: MeshSpec) -> Tuple[Tuple[str, ...], int]:
    """Resolve one dim's sharding against a mesh: keep axes present with
    size > 1; an extent that doesn't divide the dim replicates the dim
    instead (the same degrade rule the trainer's placement uses)."""
    kept = tuple(a for a in axes if mesh.sizes.get(a, 1) > 1)
    n = _prod(mesh.sizes[a] for a in kept)
    if n <= 1 or dim % n != 0 or dim == 0:
        return (), 1
    return kept, n


@dataclass(frozen=True)
class ParamSpec:
    """One array's global shape/dtype and its src/dst sharding specs."""

    shape: Tuple[int, ...]
    dtype: "np.dtype"
    src: tuple = ()
    dst: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))
        object.__setattr__(self, "dtype", np.dtype(self.dtype))
        # canonicalize specs to the fully-normalized form (per-dim axis
        # tuples, padded to ndim) so the plan DIGEST is stable across
        # processes no matter how callers spelled them: 'dp' vs ('dp',)
        # vs a trailing-None-dropped list all plan identically and must
        # hash identically — a spelling difference must never force a
        # spurious plan-mismatch abort
        for fld in ("src", "dst"):
            object.__setattr__(
                self, fld, _norm_spec(getattr(self, fld), len(self.shape)))

    @property
    def nbytes(self) -> int:
        return _prod(self.shape) * self.dtype.itemsize


def shard_index(shape: Sequence[int], spec, mesh: MeshSpec,
                owner: str) -> Tuple[Tuple[int, int], ...]:
    """`owner`'s global (start, stop) per dim under `spec` on `mesh`."""
    if owner not in mesh.owners:
        raise ValueError(f"{owner!r} is not in the mesh")
    names = [n for n, _ in mesh.axes]
    dims = [s for _, s in mesh.axes]
    coords = dict(zip(names, np.unravel_index(mesh.owners.index(owner),
                                              dims))) if dims else {}
    out = []
    for d, axes in zip(shape, _norm_spec(spec, len(shape))):
        kept, n = _dim_layout(d, axes, mesh)
        if n == 1:
            out.append((0, int(d)))
            continue
        block = d // n
        b = 0
        for a in kept:
            b = b * mesh.sizes[a] + int(coords[a])
        out.append((b * block, (b + 1) * block))
    return tuple(out)


def _brick_holders(brick: Tuple[Tuple[int, int], ...], shape, spec,
                   mesh: MeshSpec) -> List[str]:
    """Every owner of `mesh` whose shard (under spec) contains `brick`."""
    constraint: Dict[str, int] = {}
    for (lo, _), d, axes in zip(brick, shape, _norm_spec(spec, len(shape))):
        kept, n = _dim_layout(d, axes, mesh)
        if n == 1:
            continue
        b = lo // (d // n)
        for a in reversed(kept):
            constraint[a] = b % mesh.sizes[a]
            b //= mesh.sizes[a]
    return mesh.owners_at(constraint)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TransferStep:
    """One brick moving from a surviving src owner to a dst owner. `index`
    is the brick's global (start, stop) per dim; `sid` keys the payload on
    the transport."""

    sid: int
    param: str
    index: Tuple[Tuple[int, int], ...]
    src: str
    dst: str
    nbytes: int


@dataclass(frozen=True)
class LocalStep:
    """A brick the dst owner already holds — reused in place, zero bytes
    on the wire (the reason this beats a full gather)."""

    param: str
    index: Tuple[Tuple[int, int], ...]
    owner: str
    nbytes: int


@dataclass(frozen=True)
class LostPiece:
    """A brick with NO surviving holder: only a committed checkpoint
    generation can supply it (the partial-restore rung)."""

    param: str
    index: Tuple[Tuple[int, int], ...]
    dst: str
    nbytes: int


@dataclass
class ReshardPlan:
    src_mesh: MeshSpec
    dst_mesh: MeshSpec
    params: Dict[str, ParamSpec]
    steps: List[TransferStep] = field(default_factory=list)
    local: List[LocalStep] = field(default_factory=list)
    lost: List[LostPiece] = field(default_factory=list)

    @property
    def bytes_moved(self) -> int:
        return sum(s.nbytes for s in self.steps)

    @property
    def bytes_local(self) -> int:
        return sum(s.nbytes for s in self.local)

    @property
    def naive_bytes(self) -> int:
        """The full-gather baseline: every dst owner materializes every
        array in full (what restart + full-checkpoint reload ships)."""
        return sum(p.nbytes for p in self.params.values()) \
            * len(self.dst_mesh.owners)

    @property
    def recoverable_from_peers(self) -> bool:
        return not self.lost

    @property
    def participants(self) -> List[str]:
        """Everyone who must reach the commit barrier: all dst owners plus
        any surviving src owner that only sends."""
        return sorted(set(self.dst_mesh.owners)
                      | {s.src for s in self.steps})

    def sends_for(self, owner: str) -> List[TransferStep]:
        return [s for s in self.steps if s.src == owner]

    def recvs_for(self, owner: str) -> List[TransferStep]:
        return [s for s in self.steps if s.dst == owner]

    def local_for(self, owner: str) -> List[LocalStep]:
        return [s for s in self.local if s.owner == owner]

    def lost_for(self, owner: str) -> List[LostPiece]:
        return [p for p in self.lost if p.dst == owner]

    def dst_index(self, param: str, owner: str):
        return shard_index(self.params[param].shape, self.params[param].dst,
                           self.dst_mesh, owner)

    def src_index(self, param: str, owner: str):
        return shard_index(self.params[param].shape, self.params[param].src,
                           self.src_mesh, owner)

    def digest(self) -> str:
        """Stable fingerprint every participant must agree on before any
        byte moves — two nodes planning from different membership views
        must fail typed at the plan edge, not exchange mismatched bricks."""
        h = hashlib.sha256()
        h.update(repr((self.src_mesh, self.dst_mesh,
                       sorted((k, v.shape, str(v.dtype), v.src, v.dst)
                              for k, v in self.params.items()),
                       self.steps, self.local, self.lost)).encode())
        return h.hexdigest()


def _dim_cuts(d: int, n_src: int, n_dst: int) -> List[int]:
    cuts = {0, d}
    for n in (n_src, n_dst):
        block = d // n
        cuts.update(k * block for k in range(1, n))
    return sorted(cuts)


def plan_reshard(src_mesh: MeshSpec, dst_mesh: MeshSpec,
                 params: Dict[str, ParamSpec],
                 available: Optional[set] = None) -> ReshardPlan:
    """Compute the minimal-transfer redistribution plan.

    Every array is cut into the brick grid induced by both partitions; each
    (brick, dst owner) pair is satisfied by, in order: the dst owner's own
    src shard (local reuse), then the least-loaded AVAILABLE src holder
    (deterministic tie-break by id), else recorded as lost. `available`
    defaults to every src owner; the elastic shrink path passes the
    survivor set so a dead node is never chosen as a source.
    """
    if available is None:
        available = set(src_mesh.owners)
    available = set(available)
    plan = ReshardPlan(src_mesh, dst_mesh, dict(params))
    sent_bytes: Dict[str, int] = {o: 0 for o in src_mesh.owners}
    sid = 0
    for name in sorted(params):
        p = params[name]
        spec_src = _norm_spec(p.src, len(p.shape))
        spec_dst = _norm_spec(p.dst, len(p.shape))
        per_dim_cuts = []
        for d, ax_s, ax_d in zip(p.shape, spec_src, spec_dst):
            _, n_s = _dim_layout(d, ax_s, src_mesh)
            _, n_d = _dim_layout(d, ax_d, dst_mesh)
            per_dim_cuts.append(_dim_cuts(d, n_s, n_d))
        if not p.shape:                       # scalar: one "brick"
            grids = [()]
        else:
            ranges = [[(c[i], c[i + 1]) for i in range(len(c) - 1)]
                      for c in per_dim_cuts]
            grids = [()]
            for r in ranges:
                grids = [g + (iv,) for g in grids for iv in r]
        for brick in grids:
            nbytes = _prod(hi - lo for lo, hi in brick) * p.dtype.itemsize
            holders = set(_brick_holders(brick, p.shape, p.src, src_mesh))
            needers = _brick_holders(brick, p.shape, p.dst, dst_mesh)
            live = sorted(holders & available)
            for o in sorted(needers):
                # local reuse only when this owner's OWN src bytes are
                # usable: a state-less rejoiner (same id, lease lapsed,
                # disk gone) sits in both meshes but outside `available` —
                # its bricks must arrive by transfer or checkpoint, not a
                # KeyError into its empty state
                if o in holders and o in available:
                    plan.local.append(LocalStep(name, brick, o, nbytes))
                elif live:
                    src = min(live, key=lambda u: (sent_bytes[u], u))
                    sent_bytes[src] += nbytes
                    plan.steps.append(TransferStep(sid, name, brick, src, o,
                                                   nbytes))
                    sid += 1
                else:
                    plan.lost.append(LostPiece(name, brick, o, nbytes))
    return plan


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

class LocalTransport:
    """In-process blackboard for single-controller reshards and tests: one
    shared dict, condition-variable waits bounded by the caller's Deadline."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}
        self._cv = threading.Condition()

    def put(self, key: str, data: bytes) -> None:
        with self._cv:
            self._data[key] = bytes(data)
            self._cv.notify_all()

    def get(self, key: str, dl: Deadline) -> bytes:
        with self._cv:
            while key not in self._data:
                dl.check(f"reshard recv {key!r}", exc=ReshardTimeout,
                         detail="peer never published the payload")
                rem = dl.remaining(floor=0.005)
                interval = 0.05 if rem is None else min(0.05, rem)
                self._cv.wait(interval)
            return self._data[key]


def session_for(generation: int, dst_mesh: MeshSpec) -> str:
    """Deterministic per-event session id every participant derives
    identically: the elastic restart generation plus the destination
    roster. Session ids namespace EVERY transport key, and a TCPStore
    never forgets a published payload — reusing a session id on the same
    store could hand a receiver a previous attempt's bytes. Derive from a
    monotonic event counter (the restart generation); never hardcode."""
    h = hashlib.sha256(repr((int(generation), dst_mesh.owners)).encode())
    return f"g{int(generation)}-{h.hexdigest()[:8]}"


class StoreTransport:
    """TCPStore-backed transport for the real multi-node path: put is a
    store set, get is the server-side bounded wait + get. Store-level
    deadline errors surface as the reshard-typed timeout."""

    def __init__(self, store, prefix: str = "reshard"):
        self.store = store
        self.prefix = prefix

    def _k(self, key: str) -> str:
        return f"{self.prefix}/{key}"

    def put(self, key: str, data: bytes) -> None:
        self.store.set(self._k(key), bytes(data))

    def get(self, key: str, dl: Deadline) -> bytes:
        try:
            self.store.wait(self._k(key), timeout=dl.remaining(floor=0.01))
            return bytes(self.store.get(self._k(key)))
        except DeadlineExceeded as e:
            raise ReshardTimeout(f"reshard recv {key!r}", dl.timeout,
                                 detail=str(e)) from e


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

def _bounded(site: str, dl: Deadline, what: str, op: Callable):
    """One guarded transport op: chaos faultpoint, cumulative deadline,
    retry-once on a dropped wire (the store client reconnects; our own
    keys are idempotent set/get, safe to reissue)."""
    for attempt in (0, 1):
        try:
            faultpoint(site)
            dl.check(what, exc=ReshardTimeout)
            return op()
        except ConnectionError:
            if attempt:
                raise


def _slices(index: Tuple[Tuple[int, int], ...],
            base: Tuple[Tuple[int, int], ...]) -> Tuple[slice, ...]:
    """Global brick -> local slices relative to a shard's global offset."""
    return tuple(slice(lo - b0, hi - b0)
                 for (lo, hi), (b0, _) in zip(index, base))


def _extents(index) -> Tuple[int, ...]:
    return tuple(hi - lo for lo, hi in index)


def execute(plan: ReshardPlan, owner: str, state: Dict[str, np.ndarray],
            transport, *, session: str, budget: Optional[float] = None,
            ckpt_reader: Optional[Callable[[str], np.ndarray]] = None,
            ) -> Dict[str, np.ndarray]:
    """Apply `plan` as `owner`: send every brick peers need from my src
    shard, assemble my dst shards (local reuse + received bricks + lost
    bricks via `ckpt_reader`), then pass the commit barrier. Returns the
    NEW local state; the input `state` is never mutated, so any failure
    leaves the caller on its old, consistent state.

    Every blocking edge shares one cumulative Deadline (`budget`, default
    PT_RESHARD_TIMEOUT=120s) and raises the typed `ReshardTimeout` at
    expiry — a SIGKILLed peer can stall this owner for at most the budget.

    `session` is REQUIRED and MUST be unique per reshard EVENT on a given
    transport (use `session_for(restart_generation, dst_mesh)`): the
    store never forgets a key, so replaying a session id would serve a
    failed earlier attempt's payloads to this one — with an identical
    plan the byte lengths match and the stale state installs silently.
    There is deliberately no default.
    """
    what = f"reshard[{session}] @ {owner}"
    dl = Deadline(budget if budget is not None
                  else env_timeout("PT_RESHARD_TIMEOUT", 120.0), what=what)
    t0 = time.perf_counter()
    digest = plan.digest().encode()

    # ---- phase 1: plan agreement (reshard.plan) ----
    _bounded(FP_PLAN, dl, f"{what} plan publish",
             lambda: transport.put(f"{session}/plan/{owner}", digest))
    for peer in plan.participants:
        got = _bounded(FP_PLAN, dl, f"{what} plan from {peer!r}",
                       lambda p=peer: transport.get(f"{session}/plan/{p}",
                                                    dl))
        if got != digest:
            raise ReshardError(
                f"{what}: plan digest mismatch with {peer!r} — peers "
                f"planned from different membership views; aborting before "
                f"any state moves")

    # ---- phase 2: transfers (reshard.transfer) ----
    # All sends before any recv: with a blackboard transport this makes the
    # schedule deadlock-free by construction (no owner's put waits on a get).
    for s in plan.sends_for(owner):
        src_base = plan.src_index(s.param, owner)
        payload = np.ascontiguousarray(
            np.asarray(state[s.param])[_slices(s.index, src_base)])
        _bounded(FP_TRANSFER, dl, f"{what} send {s.param} #{s.sid}",
                 lambda b=payload.tobytes(), k=f"{session}/t/{s.sid}":
                 transport.put(k, b))

    out: Dict[str, np.ndarray] = {}
    partial_bytes = 0
    if owner in plan.dst_mesh.owners:
        for name, p in plan.params.items():
            base = plan.dst_index(name, owner)
            out[name] = np.empty(_extents(base), p.dtype)
        for l in plan.local_for(owner):
            base = plan.dst_index(l.param, owner)
            src_base = plan.src_index(l.param, owner)
            piece = np.asarray(state[l.param])[_slices(l.index, src_base)]
            # reshape guards the 0-d case: ascontiguousarray'd scalars
            # arrive as shape (1,) and must land back in a () cell
            out[l.param][_slices(l.index, base)] = \
                np.asarray(piece).reshape(_extents(l.index))
        for s in plan.recvs_for(owner):
            data = _bounded(FP_TRANSFER, dl,
                            f"{what} recv {s.param} #{s.sid} from {s.src!r}",
                            lambda k=f"{session}/t/{s.sid}":
                            transport.get(k, dl))
            p = plan.params[s.param]
            if len(data) != s.nbytes:
                raise ReshardError(
                    f"{what}: torn payload for {s.param} #{s.sid} "
                    f"({len(data)} bytes, want {s.nbytes})")
            brick = np.frombuffer(data, p.dtype).reshape(_extents(s.index))
            out[s.param][_slices(s.index, plan.dst_index(s.param, owner))] \
                = brick
        for piece in plan.lost_for(owner):
            if ckpt_reader is None:
                raise ShardLost(
                    f"{what}: {piece.param}{list(piece.index)} has no "
                    f"surviving holder and no checkpoint reader — "
                    f"unrecoverable from peers")
            full = np.asarray(ckpt_reader(piece.param))
            sls = tuple(slice(lo, hi) for lo, hi in piece.index)
            out[piece.param][_slices(piece.index,
                                     plan.dst_index(piece.param, owner))] \
                = full[sls].astype(plan.params[piece.param].dtype)
            partial_bytes += piece.nbytes

    # ---- phase 3: commit barrier (reshard.commit) ----
    # Idempotent marker-per-owner (retry-safe, unlike store.add): the swap
    # to `out` happens only after EVERY participant confirmed its transfers
    # — an owner that died upstream leaves everyone on old state + typed
    # timeout, never half-swapped.
    _bounded(FP_COMMIT, dl, f"{what} commit publish",
             lambda: transport.put(f"{session}/commit/{owner}", b"1"))
    for peer in plan.participants:
        _bounded(FP_COMMIT, dl, f"{what} commit from {peer!r}",
                 lambda p=peer: transport.get(f"{session}/commit/{p}", dl))

    _register_report({
        "session": session, "owner": owner,
        "how": "partial-restore" if partial_bytes else "reshard",
        "bytes_moved": plan.bytes_moved, "bytes_local": plan.bytes_local,
        "bytes_from_ckpt": partial_bytes, "naive_bytes": plan.naive_bytes,
        "src_owners": len(plan.src_mesh.owners),
        "dst_owners": len(plan.dst_mesh.owners),
        "downtime_s": time.perf_counter() - t0,
    })
    return out


def _full_restore_state(plan: ReshardPlan, owner: str,
                        ckpt) -> Dict[str, np.ndarray]:
    """The bottom rung: cut this owner's DESTINATION shards from the last
    committed generation. A departing pure-sender owns no dst shards — its
    "restore" is the empty state, not a dst_index lookup on a mesh it
    left."""
    out: Dict[str, np.ndarray] = {}
    if owner in plan.dst_mesh.owners:
        restored = ckpt.read_params(sorted(plan.params))
        for name in plan.params:
            full = np.asarray(restored[name])
            sls = tuple(slice(lo, hi)
                        for lo, hi in plan.dst_index(name, owner))
            out[name] = full[sls].astype(plan.params[name].dtype)
    return out


def _publish_rung(transport, session: str, owner: str, how: str) -> None:
    """Best-effort rung publication for rung_agreement(): if the transport
    itself is dead the peers see this owner ABSENT and restore — the same
    converging outcome."""
    try:
        transport.put(f"{session}/how/{owner}", how.encode())
    except Exception:  # noqa: BLE001 — absence IS the disagreement signal
        pass


def reshard_or_restore(plan: ReshardPlan, owner: str,
                       state: Dict[str, np.ndarray], transport, *,
                       session: str, ckpt=None,
                       budget: Optional[float] = None):
    """The fallback ladder, as one call. Returns (new_state, how):

    1. ``reshard``          — everything came from survivors (+ own bytes);
    2. ``partial-restore``  — lost bricks read from the last committed
       generation, the rest moved peer-to-peer;
    3. ``full-restore``     — the reshard itself failed (peer died
       mid-transfer -> ReshardTimeout / wire death / torn payload): this
       owner's dst shards are cut from the committed checkpoint instead.

    With no `ckpt` (a CheckpointManager) the ladder has one rung and the
    typed error propagates.

    The rung each owner lands on is a LOCAL decision, and a failure racing
    the last commit marker can split the fleet (one owner restores while
    peers keep resharded state). Each owner therefore publishes its rung
    to the transport; before resuming training, every survivor MUST call
    `rung_agreement(...)` at its next rendezvous — it returns
    "full-restore" when any participant restored (or never reported), and
    such survivors fall back to the same committed generation so the fleet
    converges instead of training on a torn mixture.
    """
    reader = None
    if ckpt is not None:
        # prefetch this owner's lost params in ONE verified pass over the
        # generation (read_params) instead of re-CRC'ing every shard file
        # once per lost brick inside the downtime window. execute() only
        # asks the reader for this owner's lost pieces, so the prefetch is
        # total — no per-name fallback path exists.
        lost_names = sorted({p.param for p in plan.lost_for(owner)})
        reader = (ckpt.read_params(lost_names).__getitem__
                  if lost_names else None)
    try:
        out = execute(plan, owner, state, transport, budget=budget,
                      ckpt_reader=reader, session=session)
        how = "partial-restore" if plan.lost_for(owner) else "reshard"
    except (DeadlineExceeded, ConnectionError, ReshardError) as e:
        if ckpt is None:
            raise
        t0 = time.perf_counter()
        out = _full_restore_state(plan, owner, ckpt)
        _register_report({
            "session": session, "owner": owner, "how": "full-restore",
            "bytes_moved": 0, "bytes_local": 0,
            "bytes_from_ckpt": sum(v.nbytes for v in out.values()),
            "naive_bytes": plan.naive_bytes,
            "src_owners": len(plan.src_mesh.owners),
            "dst_owners": len(plan.dst_mesh.owners),
            "downtime_s": time.perf_counter() - t0,
            "fallback_cause": type(e).__name__,
        })
        how = "full-restore"
    _publish_rung(transport, session, owner, how)
    return out, how


def _avail_digest(avail) -> str:
    """Deterministic tag of a survivor view. Churn-aware retries derive
    their per-attempt session from it, so every owner that observes the
    SAME survivor set lands on the SAME transport keys without any
    cross-process attempt counter — the store's lease expiry is the one
    clock all observers already agree on."""
    h = hashlib.sha256(repr(tuple(sorted(avail))).encode())
    return h.hexdigest()[:8]


def reshard_or_restore_churn(src_mesh: MeshSpec, dst_mesh: MeshSpec,
                             params: Dict[str, ParamSpec], owner: str,
                             state: Dict[str, np.ndarray], transport, *,
                             session: str, alive_fn,
                             ckpt=None, budget: Optional[float] = None,
                             probe: float = 3.0, dst_alive_fn=None):
    """`reshard_or_restore` that survives membership CHURN mid-reshard.

    The plain ladder plans once: a source owner whose lease lapses while
    its payload is in flight stalls every receiver until the WHOLE budget
    burns, then surfaces as a generic `ReshardTimeout` and forces the
    full-restore rung — even though the shrunken roster could have served
    the same bricks live. This variant executes in `probe`-second slices;
    when a slice expires it re-polls `alive_fn()` (the ElasticManager's
    store-side lease truth) and, if the planned `available` set shrank,
    RE-PLANS against the survivors immediately instead of waiting out the
    deadline. Lost bricks come from `ckpt` (partial restore); only an
    exhausted cumulative budget (or an unrecoverable plan without a
    checkpoint) falls to the full-restore rung / typed error.

    Each attempt's session is derived from the observed survivor set
    (`_avail_digest`), so peers re-planning after the same eviction
    converge on identical transport keys and an identical plan digest with
    no extra coordination; a retry under an UNCHANGED roster reuses the
    same session — every key it re-puts is idempotent (same bytes).

    Returns (new_state, how) exactly like `reshard_or_restore`, publishes
    the rung for `rung_agreement()` under the BASE session, and raises
    `ReshardTimeout` only when the cumulative budget is truly gone.
    """
    bound = (budget if budget is not None
             else env_timeout("PT_RESHARD_TIMEOUT", 120.0))
    dl = Deadline(bound, what=f"churn-aware reshard[{session}] @ {owner}")
    last_err: Optional[BaseException] = None
    # (avail-digest, reader) of the last attempt: retries under an
    # UNCHANGED roster must not re-read the lost params from the
    # checkpoint every probe slice — with a large sharded table that
    # would turn one slow transfer into dozens of redundant full reads
    reader_cache: Tuple[Optional[str], Optional[Callable]] = (None, None)
    while True:
        try:
            dl.check(exc=ReshardTimeout,
                     detail=f"last attempt failed with "
                            f"{type(last_err).__name__}: {last_err}"
                     if last_err is not None else "")
        except ReshardTimeout:
            if ckpt is None:
                raise
            # budget exhausted: the full-restore rung, against the plan of
            # the CURRENT survivor view (dst shards don't depend on it)
            avail = set(alive_fn()) & set(src_mesh.owners)
            plan = plan_reshard(src_mesh, dst_mesh, params, available=avail)
            t0 = time.perf_counter()
            out = _full_restore_state(plan, owner, ckpt)
            _register_report({
                "session": session, "owner": owner, "how": "full-restore",
                "bytes_moved": 0, "bytes_local": 0,
                "bytes_from_ckpt": sum(v.nbytes for v in out.values()),
                "naive_bytes": plan.naive_bytes,
                "src_owners": len(plan.src_mesh.owners),
                "dst_owners": len(plan.dst_mesh.owners),
                "downtime_s": time.perf_counter() - t0,
                "fallback_cause": type(last_err).__name__
                if last_err is not None else "BudgetExhausted",
            })
            _publish_rung(transport, session, owner, "full-restore")
            return out, "full-restore"
        avail = set(alive_fn()) & set(src_mesh.owners)
        plan = plan_reshard(src_mesh, dst_mesh, params, available=avail)
        tag = _avail_digest(avail)
        sess = f"{session}-r{tag}"
        if reader_cache[0] == tag:
            reader = reader_cache[1]
        else:
            reader = None
            if ckpt is not None:
                lost_names = sorted({p.param for p in plan.lost_for(owner)})
                reader = (ckpt.read_params(lost_names).__getitem__
                          if lost_names else None)
            reader_cache = (tag, reader)
        rem = dl.remaining(floor=0.05)
        slice_budget = rem if rem is None else min(max(probe, 0.1), rem)
        try:
            out = execute(plan, owner, state, transport, session=sess,
                          budget=slice_budget, ckpt_reader=reader)
            how = "partial-restore" if plan.lost_for(owner) else "reshard"
            _publish_rung(transport, session, owner, how)
            return out, how
        except ShardLost:
            raise
        except (DeadlineExceeded, ConnectionError, ReshardError) as e:
            # a DEAD DESTINATION owner can never reach the commit barrier
            # and no source re-plan fixes that — the destination MESH
            # itself must be re-planned (the supervisor's next epoch does
            # exactly that), so fail fast instead of burning the budget
            if dst_alive_fn is not None:
                gone = set(dst_mesh.owners) - set(dst_alive_fn())
                if gone:
                    raise ReshardError(
                        f"churn-aware reshard[{session}]: destination "
                        f"owner(s) {sorted(gone)} lapsed mid-reshard — "
                        f"the destination mesh must be re-planned") from e
            # a slice expiring under an UNCHANGED roster is just a slow
            # transfer: loop and retry the SAME session (idempotent keys,
            # published payloads persist, so progress accumulates); a
            # SHRUNKEN roster re-plans next iteration under a new session
            last_err = e


def rung_agreement(plan: ReshardPlan, transport, *, session: str,
                   budget: float = 10.0) -> str:
    """Post-ladder convergence check, run by every survivor at its next
    rendezvous (where connectivity is re-established): returns "reshard"
    iff EVERY participant reported a live-state rung (reshard /
    partial-restore), else "full-restore" — meaning some owner fell back
    to the committed generation (or died before reporting) and survivors
    holding live resharded state must ALSO restore from that generation
    before training resumes, so the fleet never mixes checkpoint-N shards
    with live-M shards."""
    dl = Deadline(budget, what=f"reshard[{session}] rung agreement")
    for peer in plan.participants:
        try:
            how = transport.get(f"{session}/how/{peer}", dl)
        except (DeadlineExceeded, ConnectionError):
            return "full-restore"
        if how not in (b"reshard", b"partial-restore"):
            return "full-restore"
    return "reshard"


def redistribute(src_mesh: MeshSpec, dst_mesh: MeshSpec,
                 params: Dict[str, ParamSpec],
                 states: Dict[str, Dict[str, np.ndarray]], *,
                 available: Optional[set] = None,
                 budget: Optional[float] = None,
                 ckpt=None, transport=None, session: Optional[str] = None):
    """Single-process driver: run every owner's `execute` concurrently over
    one LocalTransport (the in-process analog of the SPMD schedule).
    `states` maps owner -> its local src shards; returns (new_states,
    plan). Used by tests, the no-hang child, and single-controller jobs.

    With the default transport a fresh LocalTransport is built per call,
    so a default session is safe; a caller-PROVIDED (persistent) transport
    must also provide the per-event session — same replay hazard as
    execute().
    """
    if transport is not None and session is None:
        raise ValueError(
            "redistribute: a caller-provided transport needs an explicit "
            "per-event session (see session_for) — a persistent store "
            "never forgets a payload, and replaying a default id could "
            "install a previous event's bytes")
    session = "local" if session is None else session
    plan = plan_reshard(src_mesh, dst_mesh, params, available=available)
    transport = transport if transport is not None else LocalTransport()
    results: Dict[str, Dict[str, np.ndarray]] = {}
    errors: Dict[str, BaseException] = {}
    bound = (budget if budget is not None
             else env_timeout("PT_RESHARD_TIMEOUT", 120.0))

    def _run(owner):
        try:
            if ckpt is not None:
                results[owner], _ = reshard_or_restore(
                    plan, owner, states.get(owner, {}), transport,
                    ckpt=ckpt, budget=budget, session=session)
            else:
                results[owner] = execute(plan, owner, states.get(owner, {}),
                                         transport, budget=budget,
                                         session=session)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[owner] = e

    threads = [threading.Thread(target=_run, args=(o,), daemon=True)
               for o in plan.participants]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 3 * bound + 5
    for t in threads:
        t.join(max(0.1, deadline - time.monotonic()))
    if any(t.is_alive() for t in threads):
        raise ReshardTimeout("redistribute driver", bound,
                             detail="an owner thread outlived 3x the budget")
    if errors:
        # prefer the root cause: an owner that hit ShardLost / an injected
        # error stalls its peers into SECONDARY deadline timeouts — report
        # the original failure, with timeouts last
        def _prio(e: BaseException) -> int:
            if isinstance(e, ReshardError) \
                    and not isinstance(e, ReshardTimeout):
                return 0
            return 2 if isinstance(e, DeadlineExceeded) else 1
        order = sorted(errors, key=lambda o: (_prio(errors[o]), o))
        raise errors[order[0]]
    return results, plan


# ---------------------------------------------------------------------------
# reports (profiler.reshard_summary reads these)
# ---------------------------------------------------------------------------

_reports: List[dict] = []
_reports_lock = threading.Lock()


def _register_report(rep: dict) -> None:
    with _reports_lock:
        _reports.append(dict(rep))


def reshard_reports() -> List[dict]:
    """Every executed reshard/restore this process ran, in order."""
    with _reports_lock:
        return [dict(r) for r in _reports]


def reset_reports() -> None:
    with _reports_lock:
        _reports.clear()


# ---------------------------------------------------------------------------
# `dist.reshard(x, mesh, placements)`: the auto-parallel API
# ---------------------------------------------------------------------------

class _CallableModule(types.ModuleType):
    """Importing this module binds the package attribute `reshard` to it
    (PEP 328 submodule binding), where the JAX package also exports the
    auto-parallel `reshard(x, mesh, placements)` API. The auto-parallel
    API is not ported, so calling the module raises `NotInThisSlice`
    naming it; `dist.reshard.plan_reshard` is the planner."""

    def __call__(self, x, mesh, placements):
        from ..core.errors import NotInThisSlice
        raise NotInThisSlice("the auto-parallel API (auto_parallel)",
                             "distributed.reshard(x, mesh, placements)")


sys.modules[__name__].__class__ = _CallableModule
