"""Streaming sharded ingestion: resumable cursors + worker-death liveness.

Counterpart of ``paddle_tpu/io/streaming.py``. The cursor's format
(``paddle_tpu.stream_cursor.v1``) is the JAX package's, so a cursor
checkpoint written by either package is read by the other; batches come
out as torch tensors on the loader's ``device``.

Epoch-scale recommendation jobs ingest from object storage, shard by
shard, without a local preprocessing step. Two pieces:

- :class:`ShardedSampleStream` — a deterministic, sharded, **seekable**
  view over a list of sample shards (anything with ``len``/``__getitem__``
  per shard: an in-memory list, an ``np.load``-ed file, an object-store
  reader). Per epoch the shard order is a seed-derived permutation,
  shards are striped over ``world_size`` ranks, samples stream
  sequentially within a shard (the object-storage access pattern). The
  whole position is ONE cursor ``(epoch, pos)`` — ``pos`` counts samples
  this rank has **delivered**, so ``state_dict()`` is exact-resume state:
  restoring it replays neither a delivered sample nor skips an
  undelivered one.

- :class:`StreamLoader` — the prefetching iterator: one background
  worker process walks the stream ahead (the fetch/decode proxy) and
  feeds batches over an mp queue; the parent advances the stream cursor
  only as batches are *delivered*. The liveness law applies: a
  SIGKILLed/OOM-killed worker surfaces as a typed
  :class:`~paddle_tpu_torch.io.dataloader.DataLoaderWorkerError` (never a spin
  on an empty queue), a stalled fetch as a typed ``DataLoaderTimeout``
  under ``timeout=``, and :meth:`StreamLoader.recover` respawns the
  worker from the current cursor — prefetched-but-undelivered batches
  are re-fetched, so recovery neither duplicates nor loses samples. The
  worker's fetch loop carries the chaos site ``io.stream_fetch``, which
  widens the no-hang fault matrix (tests/test_no_hang.py).

Cursor durability rides :class:`~paddle_tpu_torch.distributed.ckpt_manager.
CheckpointManager` generations: :func:`save_stream_checkpoint` commits
the model state AND the cursor in one generation (the cursor travels in
the manifest's ``user_data``, under the same COMMIT marker), and
:func:`restore_stream_checkpoint` restores both — a resume lands exactly
where the last *committed* generation said, mid-epoch included. The
crash sites ``stream.cursor_staged`` / ``stream.cursor_committed``
bracket the save so the chaos matrix (tests/test_streaming.py) can
SIGKILL a writer at the cursor-checkpoint site and prove the
no-duplicate/no-loss law against the surviving generation.
"""
from __future__ import annotations

import bisect
import queue as pyqueue
import time
import traceback
from typing import List, Optional, Sequence

import numpy as np

from ..distributed.chaos import (crashpoint, faultpoint, register,
                                 register_fault)
from ..utils.deadline import DataLoaderTimeout
from .dataloader import (DataLoaderWorkerError, _np_collate, _to_tensor_tree)

__all__ = [
    "ShardedSampleStream", "StreamLoader", "save_stream_checkpoint",
    "save_stream_sharded", "restore_stream_checkpoint", "STREAM_CURSOR_KEY",
]

STREAM_CURSOR_KEY = "stream_cursor"

# chaos sites, registered at import so the matrices enumerate them
FP_STREAM_FETCH = register_fault(
    "io.stream_fetch", "streaming-ingestion worker fetching one batch")
CP_CURSOR_STAGED = register(
    "stream.cursor_staged",
    "stream cursor captured, checkpoint generation not yet committed")
CP_CURSOR_COMMITTED = register(
    "stream.cursor_committed",
    "cursor + state committed as one generation, caller not yet resumed")


class ShardedSampleStream:
    """Deterministic sharded sample stream with an exact-resume cursor.

    ``shards``: a list of per-shard sample containers (``len`` +
    ``__getitem__``). ``world_size``/``rank`` stripe the (permuted) shard
    list across data-parallel ranks; ``seed`` fixes the per-epoch
    permutation (``shuffle_shards=False`` keeps file order).
    """

    def __init__(self, shards: Sequence, *, world_size: int = 1,
                 rank: int = 0, seed: int = 0, shuffle_shards: bool = True):
        if not len(shards):
            raise ValueError("ShardedSampleStream needs at least one shard")
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} outside world_size {world_size}")
        self.shards = list(shards)
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.seed = int(seed)
        self.shuffle_shards = bool(shuffle_shards)
        self.epoch = 0
        self.pos = 0            # samples DELIVERED this epoch, this rank
        self._plan_cache = None  # (epoch, sids, cum) of the last plan

    # ---- deterministic per-epoch plan ----
    def _epoch_shards(self, epoch: int) -> List[int]:
        order = np.arange(len(self.shards))
        if self.shuffle_shards:
            order = np.random.RandomState(
                (self.seed + epoch) % (2 ** 31)).permutation(order)
        return [int(s) for s in order[self.rank::self.world_size]]

    def _cum_lengths(self, epoch: int):
        # memoized per epoch: sample_at runs once per SAMPLE in the fetch
        # worker's hot loop, and rebuilding the permutation + cum lengths
        # there would be O(n_shards) work (plus RNG setup) per sample
        cached = self._plan_cache
        if cached is not None and cached[0] == epoch:
            return cached[1], cached[2]
        sids = self._epoch_shards(epoch)
        cum, total = [], 0
        for s in sids:
            total += len(self.shards[s])
            cum.append(total)
        self._plan_cache = (epoch, sids, cum)
        return sids, cum

    def epoch_len(self, epoch: Optional[int] = None) -> int:
        """Samples this rank streams in one epoch."""
        _, cum = self._cum_lengths(self.epoch if epoch is None else epoch)
        return cum[-1] if cum else 0

    def sample_at(self, pos: int, epoch: Optional[int] = None):
        """Random access into the deterministic stream order — the seek
        that makes a mid-epoch resume O(1) instead of a re-read."""
        epoch = self.epoch if epoch is None else epoch
        sids, cum = self._cum_lengths(epoch)
        if not 0 <= pos < (cum[-1] if cum else 0):
            raise IndexError(f"pos {pos} outside epoch of {cum[-1]} samples")
        i = bisect.bisect_right(cum, pos)
        off = pos - (cum[i - 1] if i else 0)
        return self.shards[sids[i]][off]

    # ---- streaming ----
    def __iter__(self):
        """Stream the REMAINDER of the current epoch from the cursor,
        advancing it per sample (exactly-once delivery accounting)."""
        n = self.epoch_len()
        while self.pos < n:
            sample = self.sample_at(self.pos)
            self.pos += 1
            yield sample

    def advance(self, k: int) -> None:
        """Mark ``k`` more samples delivered (the StreamLoader calls this
        per delivered batch — prefetched batches never move the cursor)."""
        self.pos += int(k)

    def roll_epoch(self) -> None:
        self.epoch += 1
        self.pos = 0

    def exhausted(self) -> bool:
        return self.pos >= self.epoch_len()

    # ---- cursor (rides CheckpointManager user_data) ----
    def _shard_lens(self) -> list:
        return [int(len(s)) for s in self.shards]

    def state_dict(self) -> dict:
        return {"format": "paddle_tpu.stream_cursor.v1",
                "epoch": int(self.epoch), "pos": int(self.pos),
                "seed": int(self.seed), "rank": int(self.rank),
                "world_size": int(self.world_size),
                "shuffle_shards": bool(self.shuffle_shards),
                "shard_lens": self._shard_lens()}

    def load_state_dict(self, state: dict) -> None:
        if state.get("format") != "paddle_tpu.stream_cursor.v1":
            raise ValueError(f"not a stream cursor: {state!r}")
        checks = (("seed", self.seed), ("rank", self.rank),
                  ("world_size", self.world_size),
                  ("shuffle_shards", self.shuffle_shards),
                  # the shard SET itself: a data file landing/vanishing
                  # between save and restore re-permutes the epoch, so an
                  # unchanged (count, per-shard length) fingerprint is a
                  # precondition for the cursor to mean anything
                  ("shard_lens", self._shard_lens()))
        for key, mine in checks:
            theirs = state[key]
            if isinstance(mine, list):
                theirs, mine = list(theirs), list(mine)
            if theirs != mine:
                raise ValueError(
                    f"stream cursor {key}={state[key]!r} disagrees with this "
                    f"stream's {mine!r} — resuming would change the sample "
                    f"order and silently duplicate or lose samples")
        self.epoch = int(state["epoch"])
        self.pos = int(state["pos"])
        self._plan_cache = None


# ---------------------------------------------------------------------------
# the prefetching loader (worker-death aware)
# ---------------------------------------------------------------------------

def _put_bounded(data_queue, item, stop_event) -> bool:
    """Blocking put that a teardown can always interrupt: the queue is
    BOUNDED (prefetch depth — a fast worker must not buffer the whole
    epoch into parent memory), so a slow consumer backpressures here and
    stop_event keeps the wait from outliving the loader."""
    while not stop_event.is_set():
        try:
            data_queue.put(item, timeout=0.2)
            return True
        except pyqueue.Full:
            continue
    return False


def _stream_worker(stream_state, shards, collate, batch_size, data_queue,
                   stop_event):
    """Worker process: walk the stream ahead from the parent's cursor and
    feed collated numpy batches. Runs in a fork child, which sends numpy.
    Each queue item carries the DELIVERED-SAMPLE COUNT alongside the
    collated payload: the parent advances the cursor by that exact count
    (a custom collate_fn may reshape the tree arbitrarily — the count
    must never be inferred from it)."""
    stream = ShardedSampleStream(
        shards, world_size=stream_state["world_size"],
        rank=stream_state["rank"], seed=stream_state["seed"],
        shuffle_shards=stream_state["shuffle_shards"])
    stream.load_state_dict(stream_state)
    batch: list = []
    bid = 0
    try:
        for sample in stream:
            if stop_event.is_set():
                return
            batch.append(sample)
            if len(batch) == batch_size:
                # chaos site: crash SIGKILLs the fetcher mid-epoch (the
                # object-store OOM/preemption case), delay models a
                # stalled fetch, error a poisoned shard
                faultpoint(FP_STREAM_FETCH)
                if not _put_bounded(data_queue,
                                    (bid, len(batch), collate(batch), None),
                                    stop_event):
                    return
                bid += 1
                batch = []
        if batch:
            faultpoint(FP_STREAM_FETCH)
            _put_bounded(data_queue, (bid, len(batch), collate(batch), None),
                         stop_event)
    except Exception:
        _put_bounded(data_queue, (bid, 0, None, traceback.format_exc()),
                     stop_event)


class StreamLoader:
    """Iterate a :class:`ShardedSampleStream` in batches with one
    prefetching worker process and the worker-death liveness guarantees.

    The cursor advances per *delivered* batch: ``stream.state_dict()``
    between batches is always exact-resume state. When the epoch is
    already exhausted, iteration rolls to the next epoch first.

    ``timeout`` bounds the wait for any single batch (0 = only worker
    death bounds it). After a typed failure, :meth:`recover` respawns the
    worker from the cursor so ingestion continues with no duplicate or
    lost samples.

    ``device`` (after the JAX loader's parameters): where ``to_tensors``
    puts the batch's tensors, by default the port's default device
    (``cuda``; ``"cpu"`` for the CPU).
    """

    def __init__(self, stream: ShardedSampleStream, batch_size: int = 1,
                 timeout: float = 0, collate_fn=None, to_tensors: bool = True,
                 prefetch: int = 4, device=None):
        self.stream = stream
        self.batch_size = int(batch_size)
        self.timeout = float(timeout or 0)
        self.collate_fn = collate_fn or _np_collate
        self.to_tensors = bool(to_tensors)
        self.prefetch = max(1, int(prefetch))
        self.device = None
        if self.to_tensors:
            from ..core.device import resolve_device
            self.device = resolve_device(device)
        self._proc = None
        self._queue = None
        self._stop = None

    # ---- worker lifecycle ----
    def _spawn(self):
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        self._teardown()
        # bounded prefetch: the worker backpressures instead of buffering
        # the whole epoch into parent memory when the consumer is slower
        self._queue = ctx.Queue(maxsize=self.prefetch)
        self._stop = ctx.Event()
        self._proc = ctx.Process(
            target=_stream_worker,
            args=(self.stream.state_dict(), self.stream.shards,
                  self.collate_fn, self.batch_size, self._queue, self._stop),
            daemon=True)
        self._proc.start()

    def _teardown(self):
        if self._proc is None:
            return
        if self._stop is not None:
            self._stop.set()
        self._proc.join(timeout=2.0)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=1.0)
        # drain + close so the fork queue leaks no feeder/semaphores
        try:
            while True:
                self._queue.get_nowait()
        except Exception:  # noqa: BLE001 — Empty or torn pickle; never raise
            pass
        self._queue.close()
        self._queue.cancel_join_thread()
        self._proc = None
        self._queue = None
        self._stop = None

    def recover(self):
        """Respawn the fetch worker from the current cursor (call after a
        typed DataLoaderWorkerError/DataLoaderTimeout). Undelivered
        prefetches are simply re-fetched — the cursor never moved for
        them."""
        self._spawn()
        return self

    # ---- iteration ----
    def __iter__(self):
        if self.stream.exhausted():
            self.stream.roll_epoch()
        remaining = self.stream.epoch_len() - self.stream.pos
        n_batches = -(-remaining // self.batch_size) if remaining else 0
        if n_batches == 0:
            return
        if self._proc is None or not self._proc.is_alive():
            self._spawn()
        try:
            for _ in range(n_batches):
                # the worker counted the samples it packed — advance by
                # exactly that, never by inference from the collated tree
                # (a custom collate_fn may reshape it arbitrarily)
                count, batch = self._next_batch()
                self.stream.advance(count)
                yield (_to_tensor_tree(batch, self.device) if self.to_tensors
                       else batch)
        finally:
            self._teardown()

    def _next_batch(self):
        start = time.monotonic()
        while True:
            try:
                _bid, count, data, err = self._queue.get(timeout=0.2)
            except pyqueue.Empty:
                # liveness poll: a SIGKILLed fetcher can never feed this
                # queue again — name the culprit instead of spinning
                if not self._proc.is_alive():
                    exitcode = self._proc.exitcode
                    self._teardown()
                    raise DataLoaderWorkerError(0, exitcode)
                if self.timeout > 0 and \
                        time.monotonic() - start > self.timeout:
                    self._teardown()
                    raise DataLoaderTimeout(
                        f"stream batch at cursor "
                        f"{self.stream.state_dict()!r}", self.timeout,
                        detail="fetch worker alive but no batch arrived "
                               "(stalled object-store read?)")
                continue
            if err is not None:
                self._teardown()
                raise RuntimeError(f"stream fetch worker failed:\n{err}")
            return count, data

    def __del__(self):  # pragma: no cover — belt and braces
        try:
            self._teardown()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


# ---------------------------------------------------------------------------
# cursor durability: one generation carries model state AND the cursor
# ---------------------------------------------------------------------------

def save_stream_checkpoint(manager, state_dict, step: int,
                           stream: ShardedSampleStream,
                           user_data: Optional[dict] = None) -> None:
    """Commit model/optimizer state and the stream cursor as ONE
    checkpoint generation: the cursor rides the manifest's ``user_data``
    under the same COMMIT marker, so a restore can never see state from
    one generation and a cursor from another."""
    ud = dict(user_data or {})
    ud[STREAM_CURSOR_KEY] = stream.state_dict()
    crashpoint(CP_CURSOR_STAGED)
    manager.save(state_dict, step, user_data=ud)
    crashpoint(CP_CURSOR_COMMITTED)


def save_stream_sharded(manager, step: int, owner: str, owners,
                        shards, param_meta,
                        stream: ShardedSampleStream,
                        user_data: Optional[dict] = None,
                        budget: Optional[float] = None,
                        abort=None) -> dict:
    """Sharded-layout sibling of `save_stream_checkpoint`: this owner's
    bricks ride `CheckpointManager.save_sharded` and the cursor rides the
    committer's unified manifest — still ONE generation, ONE atomic
    COMMIT marker, so state and data position come from the same commit
    point on every restore. Every owner passes the cursor (the supervisor
    keeps it mesh-invariant, so all copies agree); only the committer's
    lands in the manifest. Returns the per-owner staging stats."""
    ud = dict(user_data or {})
    ud[STREAM_CURSOR_KEY] = stream.state_dict()
    crashpoint(CP_CURSOR_STAGED)
    stats = manager.save_sharded(step, owner, owners, shards, param_meta,
                                 user_data=ud, budget=budget, abort=abort)
    crashpoint(CP_CURSOR_COMMITTED)
    return stats


def restore_stream_checkpoint(manager, state_dict,
                              stream: ShardedSampleStream,
                              step: Optional[int] = None) -> int:
    """Restore state AND cursor from the newest committed generation
    (or ``step``): training resumes mid-epoch with zero duplicate and
    zero lost samples relative to what that generation committed."""
    step = manager.restore(state_dict, step)
    cursor = manager.manifest(step).get("user_data", {}).get(
        STREAM_CURSOR_KEY)
    if cursor is None:
        raise KeyError(
            f"generation step-{step} carries no {STREAM_CURSOR_KEY!r} — "
            f"was it written with save_stream_checkpoint()?")
    stream.load_state_dict(cursor)
    return step
