"""Thread-safe LRU for the fused-fragment cache.

The port's copy of `matrixone_tpu/utils/lru.py`: lock + recency refresh
+ eviction past a budget, with an env-tunable size (and an eviction by
the caller's own measure, `evict_oldest_while`).  The caller keeps
its own entry shape and metric accounting.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict


def env_entries(var: str, default: int) -> int:
    """Cache-size knob: the env var when it parses, else the default."""
    try:
        return int(os.environ.get(var, "") or default)
    except ValueError:
        return default


class LruCache:
    def __init__(self, max_entries: int):
        self.max_entries = max(int(max_entries), 8)
        self._lock = threading.Lock()
        self._entries: "OrderedDict" = OrderedDict()

    def lookup(self, key):
        """-> resident entry or None, refreshing recency."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
            return e

    def insert(self, key, value):
        """Idempotent insert (a concurrently-created entry wins) +
        eviction past the budget; returns the resident entry."""
        with self._lock:
            e = self._entries.setdefault(key, value)
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
            return e

    def evict_oldest_while(self, over, pinned=lambda entry: False) -> list:
        """Evict least recently used entries, never the newest nor a
        pinned one, while `over(entries)` holds; returns the evicted
        entries."""
        out = []
        with self._lock:
            for key in list(self._entries)[:-1]:
                if not over(self._entries.values()):
                    break
                if not pinned(self._entries[key]):
                    out.append(self._entries.pop(key))
        return out

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def snapshot(self) -> list:
        """Point-in-time list of entries (stats introspection)."""
        with self._lock:
            return list(self._entries.values())
