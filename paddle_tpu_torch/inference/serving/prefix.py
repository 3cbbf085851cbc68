"""Prefix sharing: a radix tree over committed KV pages.

Counterpart of ``paddle_tpu/inference/serving/prefix.py``. After a
request's prefill commits, its prompt's full pages enter a radix tree
keyed by page-sized token chunks; each node holds the pool page (the tree
takes its own ref through ``pool.share()``: committed pages only, the
typed ``PageUncommitted`` guards the fork-during-prefill race) and the
page's KV rows as the engine stored them (on the engine's device).

A new request walks the tree with its prompt: every matched chunk is one
full page of prefill it skips. It takes refs on the shared chain and
prefills only its tail through the window step. The match stops at
``plen - 1``, so every request prefills at least its last token (the
logits of its first generated token).

Eviction honours refcounts: a node is evictable only as a leaf whose page
the tree alone holds (refcount 1). ``evict()`` frees the least recently
shared leaves first and is the scheduler's reclaim hook, so admission
pressure trims the tree instead of wedging the queue.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .kv_pool import KVPagePool, Page

__all__ = ["PrefixCache"]


class _Node:
    """One full page of a cached prompt prefix."""

    __slots__ = ("key", "page", "kv", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], page: Page, kv,
                 parent: Optional["_Node"]):
        self.key = key          # the page's token chunk (len == page_size)
        self.page = page        # pool page; the tree holds one ref on it
        self.kv = kv            # the page's KV rows, as the engine keeps them
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    """Radix tree over committed KV pages, shared by one engine's pool."""

    def __init__(self, pool: KVPagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._nodes = 0
        self._lock = threading.Lock()
        self._clock = itertools.count(1)
        self.counters = {"lookups": 0, "hits": 0, "pages_shared": 0,
                         "pages_inserted": 0, "pages_evicted": 0}

    # ------------------------------------------------------------------
    def _chunks(self, prompt: np.ndarray, limit: int):
        """Page-sized token chunks of `prompt` wholly inside [0, limit)."""
        ps = self.page_size
        for p in range(0, limit - ps + 1, ps):
            yield tuple(int(t) for t in prompt[p:p + ps])

    def _walk(self, prompt: np.ndarray) -> List[_Node]:
        """The matched chain for `prompt` (caller holds the lock): whole
        committed pages only, capped at plen - 1 — the last token is
        always the borrower's to prefill (copy-on-write at the fork)."""
        nodes: List[_Node] = []
        level = self._root
        for key in self._chunks(prompt, int(prompt.size) - 1):
            node = level.get(key)
            if node is None:
                break
            nodes.append(node)
            level = node.children
        return nodes

    def share(self, prompt: np.ndarray):
        """Walk the tree and take one ref per matched page (pool.share —
        committed pages only, typed PageUncommitted otherwise; walk and
        ref-take share one lock hold, so a concurrent eviction can never
        leave the chain dangling). Returns (pages, kv_chain, shared_len);
        the caller owns the refs and must release them with the request's
        lifetime."""
        with self._lock:
            nodes = self._walk(prompt)
            self.counters["lookups"] += 1
            if not nodes:
                return [], [], 0
            self.counters["hits"] += 1
            pages = [n.page for n in nodes]
            self.pool.share(pages)  # all-or-nothing; typed on uncommitted
            tick = next(self._clock)
            for n in nodes:
                n.last_used = tick
            self.counters["pages_shared"] += len(pages)
            return pages, [n.kv for n in nodes], len(nodes) * self.page_size

    def insert(self, prompt: np.ndarray, shared_len: int,
               own_pages: List[Page], kv_of_page) -> int:
        """Commit a prefilled prompt's full pages into the tree. Chunks
        below `shared_len` (a page multiple) are the chain the request
        borrowed — they are already in the tree and stay the donor's.
        Chunk i at or past it is backed by ``own_pages[i - base]`` (the
        request's own pages covering [shared_len, ...) in order) and its
        host KV rows come from ``kv_of_page(i)``. Already-present chunks
        are kept (first writer wins — rows are bitwise-interchangeable by
        the sharing contract); each NEW node takes the tree's own ref via
        pool.share(), so the request releasing its pages later never frees
        a cached page. Returns the number of nodes inserted."""
        ps = self.page_size
        base = int(shared_len) // ps
        added = 0
        with self._lock:
            level = self._root
            parent = None
            for i, key in enumerate(self._chunks(prompt, int(prompt.size))):
                node = level.get(key)
                if node is None:
                    if i < base or i - base >= len(own_pages):
                        break  # borrowed chain evaporated / out of pages:
                        # nothing of ours to pin here — stop extending
                    page = own_pages[i - base]
                    self.pool.share([page])  # tree's ref; typed if uncommitted
                    node = _Node(key, page, kv_of_page(i), parent)
                    level[key] = node
                    self._nodes += 1
                    added += 1
                    self.counters["pages_inserted"] += 1
                node.last_used = next(self._clock)
                parent = node
                level = node.children
        return added

    def evict(self, need: int) -> int:
        """Free up to `need` pages by dropping least-recently-shared LEAF
        nodes whose page is held ONLY by the tree (refcount 1). Returns
        pages actually freed. Never touches a page a live request shares —
        eviction happens only when refcounts release. One tree scan per
        ROUND, evicting every eligible leaf oldest-first; a further round
        runs only when freeing leaves exposed their parents (so the work
        is O(nodes x depth) worst case, not O(nodes x need))."""
        freed = 0
        need = max(0, int(need))
        with self._lock:
            while freed < need:
                leaves = []
                stack = list(self._root.values())
                while stack:
                    n = stack.pop()
                    if n.children:
                        stack.extend(n.children.values())
                    elif n.page.refs == 1:
                        leaves.append(n)
                if not leaves:
                    break
                leaves.sort(key=lambda n: n.last_used)
                for victim in leaves[:need - freed]:
                    level = victim.parent.children \
                        if victim.parent is not None else self._root
                    level.pop(victim.key, None)
                    self._nodes -= 1
                    self.pool.release([victim.page])
                    self.counters["pages_evicted"] += 1
                    freed += 1
        return freed

    def clear(self) -> int:
        """Drop every tree-only page (engine shutdown); returns freed."""
        return self.evict(self._nodes)

    # ------------------------------------------------------------------
    def info(self) -> dict:
        with self._lock:
            held = self._nodes
            c = dict(self.counters)
        return {"nodes": held, "pages_held": held, **c}
