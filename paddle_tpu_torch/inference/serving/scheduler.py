"""Continuous-batching scheduler: join / evict BETWEEN decode steps.

Counterpart of ``paddle_tpu/inference/serving/scheduler.py``. The decode
batch has ``max_batch`` slots. Between two decode steps the scheduler
(1) evicts slots whose request completed (EOS / length) or ran out of TTL,
(2) expires queued requests past their deadline (typed RequestTimeout,
reserved pages returned), and (3) admits queued requests into free slots,
strict FIFO, gated on an all-or-nothing KV-page reservation covering the
request's whole lifetime (plus a speculative engine's verify scratch,
``reserve_extra_tokens``). Every per-slot quantity (offset, attention
length, cache row) is independent across the batch, so a join never
changes the tokens of a request already decoding. A prefix-sharing engine
wires its tree's ``evict`` in as ``reclaim``: a failed reservation frees
tree-only pages and retries once instead of wedging the queue.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import List, Tuple

from ...observability import trace
from .kv_pool import KVPagePool, PoolExhausted
from .request import Request, RequestState

__all__ = ["ContinuousBatchingScheduler"]


class ContinuousBatchingScheduler:
    def __init__(self, pool: KVPagePool, max_batch: int,
                 reserve_extra_tokens: int = 0):
        self.pool = pool
        self.max_batch = int(max_batch)
        # a speculative verify window may write spec_k positions past the
        # accepted cursor: those are reserved with the lifetime
        self.reserve_extra = int(reserve_extra_tokens)
        self._queue: deque[Request] = deque()
        self._running: dict[int, Request] = {}   # slot -> request
        self._free_slots = list(range(self.max_batch - 1, -1, -1))
        self._lock = threading.Lock()
        # reclaim(shortfall) -> pages freed; a positive return earns one
        # alloc retry (the prefix tree's evict)
        self.reclaim = None
        self.counters = {"submitted": 0, "admitted": 0, "finished": 0,
                         "timed_out": 0, "evicted": 0, "rejected": 0}

    def _pages_needed(self, req: Request) -> int:
        """Pages the request must own: its lifetime minus the shared prefix
        chain it already holds refs on."""
        return self.pool.pages_for(
            req.prompt.size + req.max_new_tokens + self.reserve_extra) \
            - len(req.shared_pages)

    def _alloc(self, need: int):
        """pool.alloc with one reclaim-assisted retry."""
        try:
            return self.pool.alloc(need)
        except PoolExhausted:
            if self.reclaim is None:
                raise
            if self.reclaim(need - self.pool.free_pages) <= 0:
                raise
            return self.pool.alloc(need)

    def _release_all(self, req: Request) -> None:
        """Give back the request's own reservation and its refs on the
        shared chain (the tree's own refs keep cached pages alive)."""
        if req.pages:
            self.pool.release(req.pages)
            req.pages = []
        if req.shared_pages:
            self.pool.release(req.shared_pages)
            req.shared_pages = []

    def submit(self, req: Request):
        """Enqueue; reserve KV pages eagerly when capacity allows. A
        request reserves only if everything ahead of it in the queue is
        reserved, so a small request behind a blocked head cannot pin the
        pages the head waits for."""
        need = self._pages_needed(req)
        if need > self.pool.total_pages:
            with self._lock:
                self.counters["rejected"] += 1
            raise PoolExhausted(need, self.pool.free_pages,
                                self.pool.total_pages, permanent=True)
        with self._lock:
            self.counters["submitted"] += 1
            if all(r.pages for r in self._queue):
                try:
                    req.pages = self._alloc(need)
                    req.scratch_reserved = self.reserve_extra > 0
                except PoolExhausted:
                    pass  # stays queued unreserved; retried at join passes
            self._queue.append(req)

    def schedule(self) -> Tuple[List[Request], List[Request]]:
        """-> (joined, evicted). Called by the engine before every decode
        step; all state transitions happen here, on the host."""
        joined, evicted = [], []
        with self._lock:
            # 1. evict completed / expired running slots
            for slot in sorted(self._running):
                req = self._running[slot]
                if req.finish_reason in ("eos", "length"):
                    req.finish(RequestState.FINISHED)
                    self.counters["finished"] += 1
                elif req.deadline.expired:
                    req.finish_reason = "ttl"
                    req.finish(RequestState.TIMED_OUT)
                    self.counters["timed_out"] += 1
                else:
                    continue
                del self._running[slot]
                self._free_slots.append(slot)
                self._release_all(req)
                self.counters["evicted"] += 1
                evicted.append(req)
                trace.event("scheduler.evict", rid=req.rid, slot=slot,
                            reason=req.finish_reason)
            # 2. expire queued requests (typed rejection, pages returned)
            still = deque()
            for req in self._queue:
                if req.deadline.expired:
                    self._release_all(req)
                    req.finish_reason = "ttl"
                    req.finish(RequestState.TIMED_OUT)
                    self.counters["timed_out"] += 1
                    evicted.append(req)
                    trace.event("scheduler.expire_queued", rid=req.rid)
                else:
                    still.append(req)
            self._queue = still
            # 3. join, strict FIFO so a big head request cannot starve
            while self._free_slots and self._queue:
                head = self._queue[0]
                if not head.pages:
                    try:
                        head.pages = self._alloc(self._pages_needed(head))
                        head.scratch_reserved = self.reserve_extra > 0
                    except PoolExhausted:
                        break
                self._queue.popleft()
                head.slot = self._free_slots.pop()
                head.state = RequestState.PREFILL
                self._running[head.slot] = head
                self.counters["admitted"] += 1
                joined.append(head)
                trace.event("scheduler.join", rid=head.rid, slot=head.slot,
                            pages=len(head.pages))
        return joined, evicted

    def backlog_tokens(self) -> int:
        """Tokens still owed to everything queued or running."""
        with self._lock:
            queued = sum(r.max_new_tokens for r in self._queue)
            running = sum(max(0, r.max_new_tokens - len(r.output_tokens))
                          for r in self._running.values())
            return queued + running

    def shed_reserve_extra(self) -> int:
        """Ladder level 2: stop reserving verify scratch for new requests
        and give back the whole pages it added to every reservation held
        (running or queued). A request whose scratch went back is marked
        ``scratch_reserved=False``, so the engine never runs a verify that
        would write past capacity it no longer owns. Returns pages freed."""
        freed = 0
        with self._lock:
            extra, self.reserve_extra = self.reserve_extra, 0
            if not extra:
                return 0
            for req in list(self._running.values()) + list(self._queue):
                if not req.pages or not req.scratch_reserved:
                    continue
                total = int(req.prompt.size) + req.max_new_tokens
                n = min(self.pool.pages_for(total + extra)
                        - self.pool.pages_for(total), len(req.pages))
                if n > 0:
                    # the tail of the reservation: prompt-front pages may
                    # be committed into the prefix tree, scratch never is
                    tail, req.pages = req.pages[-n:], req.pages[:-n]
                    self.pool.release(tail)
                    freed += n
                req.scratch_reserved = False
        return freed

    def restore_reserve_extra(self, extra: int) -> None:
        """Leaving level 2: future reservations cover verify scratch again
        (requests admitted meanwhile keep ``scratch_reserved=False``)."""
        with self._lock:
            self.reserve_extra = int(extra)

    def running(self) -> dict:
        with self._lock:
            return dict(self._running)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def active(self) -> int:
        with self._lock:
            return len(self._running)

    @property
    def idle(self) -> bool:
        with self._lock:
            return not self._running and not self._queue

    def info(self) -> dict:
        with self._lock:
            return {**self.counters, "active": len(self._running),
                    "queued": len(self._queue),
                    "free_slots": len(self._free_slots)}
