"""Paged KV-cache pool: capacity accounting for the serving engine.

Counterpart of ``paddle_tpu/inference/serving/kv_pool.py``. The physical
layout is the dense per-layer cache ``[B, S_max, H_kv, D]``, one row per
batch slot. The pool manages the CAPACITY of that layout: each slot's
S_max positions are cut into fixed-size pages, and a request must hold
pages for its whole lifetime (prompt + max_new_tokens) before it may take a
slot. Admission is all-or-nothing, so an admitted request never stalls
mid-decode waiting for memory. (The ref-counted sharing of committed pages
belongs to prefix sharing, which waits for a later slice.)
"""
from __future__ import annotations

import threading
from typing import List

from ...observability import trace

__all__ = ["PageUncommitted", "PoolExhausted", "Page", "KVPagePool"]


class PageUncommitted(RuntimeError):
    """Typed rejection of ``share()`` on a page whose KV rows an in-flight
    prefill is still writing: only committed full pages may enter the
    prefix tree, or a borrower would fork onto half-written rows."""

    def __init__(self, page: "Page"):
        self.page = page
        super().__init__(
            f"page {page.pid} is not committed (an in-flight prefill is "
            f"still writing it) — only committed full pages are shareable")


class PoolExhausted(RuntimeError):
    """Admission failed: not enough free KV pages for the reservation.

    ``permanent=True`` means the reservation exceeds the pool's TOTAL
    capacity: no amount of waiting admits it, and the caller must not
    retry."""

    def __init__(self, need: int, free: int, total: int,
                 permanent: bool = False):
        self.need, self.free, self.total = need, free, total
        self.permanent = permanent
        tail = ("exceeds total capacity — the request can NEVER be "
                "admitted; resize the pool/engine"
                if permanent else
                "request stays queued until capacity returns")
        super().__init__(
            f"KV page pool exhausted: need {need} page(s), {free} free of "
            f"{total} total — {tail}")


class Page:
    """One fixed-size span of KV positions; identity is the unit of
    accounting. ``committed`` is set once the prefill that filled its rows
    has completed."""

    __slots__ = ("pid", "refs", "committed")

    def __init__(self, pid: int):
        self.pid = pid
        self.refs = 0
        self.committed = False

    def __repr__(self):
        return (f"Page({self.pid}, refs={self.refs}"
                f"{', committed' if self.committed else ''})")


class KVPagePool:
    """Free-list of ``total_pages`` pages of ``page_size`` tokens each."""

    def __init__(self, total_pages: int, page_size: int):
        if total_pages < 1 or page_size < 1:
            raise ValueError("KVPagePool: total_pages/page_size must be >= 1")
        self.total_pages = int(total_pages)
        self.page_size = int(page_size)
        self._free: List[Page] = [Page(i) for i in range(total_pages)]
        self._lock = threading.Lock()
        self._allocs = 0
        self._releases = 0
        self._shared = 0
        self._peak_active = 0

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` KV positions."""
        return -(-max(int(n_tokens), 1) // self.page_size)

    def alloc(self, n: int) -> List[Page]:
        """Take ``n`` pages off the free list at refcount 1, or raise the
        typed PoolExhausted without taking any (all-or-nothing)."""
        with self._lock:
            if n > len(self._free):
                trace.event("pool.exhausted", need=n, free=len(self._free),
                            total=self.total_pages)
                raise PoolExhausted(n, len(self._free), self.total_pages)
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                p.refs = 1
            self._allocs += n
            active = self.total_pages - len(self._free)
            self._peak_active = max(self._peak_active, active)
            return pages

    def retain(self, pages: List[Page]):
        """Add a holder to already-allocated pages."""
        with self._lock:
            for p in pages:
                if p.refs < 1:
                    raise ValueError(f"retain of a free page: {p!r}")
                p.refs += 1

    def share(self, pages: List[Page]):
        """``retain()`` restricted to committed pages, all or nothing: a
        page an in-flight prefill still writes raises the typed
        PageUncommitted and no ref is taken."""
        with self._lock:
            for p in pages:
                if p.refs < 1:
                    raise ValueError(f"share of a free page: {p!r}")
                if not p.committed:
                    raise PageUncommitted(p)
            for p in pages:
                p.refs += 1
            self._shared += len(pages)

    def commit(self, pages: List[Page]):
        """Mark pages' KV rows complete (their prefill finished): from here
        on ``share()`` accepts them. Idempotent."""
        with self._lock:
            for p in pages:
                if p.refs < 1:
                    raise ValueError(f"commit of a free page: {p!r}")
                p.committed = True

    def release(self, pages: List[Page]):
        """Drop one holder; pages return to the free list at refcount 0 and
        lose their committed mark."""
        with self._lock:
            for p in pages:
                if p.refs < 1:
                    raise ValueError(f"double release: {p!r}")
                p.refs -= 1
                if p.refs == 0:
                    p.committed = False
                    self._free.append(p)
                    self._releases += 1

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def info(self) -> dict:
        with self._lock:
            free = len(self._free)
            return {"total_pages": self.total_pages,
                    "page_size": self.page_size,
                    "free_pages": free,
                    "active_pages": self.total_pages - free,
                    "allocs": self._allocs,
                    "releases": self._releases,
                    "shared": self._shared,
                    "peak_active": self._peak_active}
