"""Audited module-state containers: a locked bounded LRU and a lazy
singleton.

Counterpart of ``paddle_tpu/utils/memo.py`` (the port keeps its own copy:
it imports nothing of the JAX package). State lives on instances, never
on module-level dicts, and every write happens under the instance lock.
Users here: the logger registry (``utils/log.py``) and the 2:4 mask
registry of ``incubate/asp.py``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

__all__ = ["LockedLRU", "Lazy"]


class LockedLRU:
    """Thread-safe bounded LRU map.

    ``maxsize=None`` disables eviction (an audited registry rather than a
    cache, for bounded keyspaces such as logger names). ``evictions``
    counts the entries dropped."""

    __slots__ = ("_d", "_lock", "_maxsize", "evictions")

    def __init__(self, maxsize: Optional[int] = 128):
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self._maxsize = maxsize
        self.evictions = 0

    @property
    def maxsize(self) -> Optional[int]:
        return self._maxsize

    def set_maxsize(self, maxsize: Optional[int]):
        with self._lock:
            self._maxsize = maxsize
            self._shrink_locked()

    def _shrink_locked(self):
        if self._maxsize is None:
            return
        while len(self._d) > self._maxsize:
            self._d.popitem(last=False)
            self.evictions += 1

    def get(self, key, default=None):
        with self._lock:
            try:
                v = self._d[key]
            except KeyError:
                return default
            self._d.move_to_end(key)
            return v

    def put(self, key, value):
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            self._shrink_locked()

    def get_or_create(self, key, factory: Callable[[], Any]):
        """The cached value, made by ``factory()`` on first use. The
        factory runs outside the lock; if two threads race, the first
        stored value wins and both callers get it."""
        with self._lock:
            try:
                v = self._d[key]
                self._d.move_to_end(key)
                return v
            except KeyError:
                pass
        created = factory()
        with self._lock:
            v = self._d.setdefault(key, created)
            self._d.move_to_end(key)
            self._shrink_locked()
            return v

    def pop(self, key, default=None):
        with self._lock:
            return self._d.pop(key, default)

    def clear(self):
        with self._lock:
            self._d.clear()

    def items(self):
        with self._lock:
            return list(self._d.items())

    def __len__(self):
        with self._lock:
            return len(self._d)

    def __contains__(self, key):
        with self._lock:
            return key in self._d


class Lazy:
    """Thread-safe memoised zero-argument factory: the value is made once,
    on the first call."""

    __slots__ = ("_factory", "_lock", "_value", "_ready")

    def __init__(self, factory: Callable[[], Any]):
        self._factory = factory
        self._lock = threading.Lock()
        self._value = None
        self._ready = False

    def __call__(self):
        if self._ready:
            return self._value
        with self._lock:
            if not self._ready:
                self._value = self._factory()
                self._ready = True
        return self._value
