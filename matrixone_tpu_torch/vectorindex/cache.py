"""Device-resident index cache with a memory budget.

Reference analogue: `pkg/vectorindex/cache/cache.go:158 VectorIndexCache`
— the CN keeps built vector indexes in memory under a byte budget and
evicts least-recently-used ones.  The port of
`matrixone_tpu/vectorindex/cache.py`: an index is a dataclass of
tensors on its device (`IvfFlatIndex`, `IvfPqIndex`, `FulltextIndex`)
or an HNSW graph in host memory, counted as 0 bytes; eviction drops the
meta's reference to it, which frees its device memory once no query
holds it, and marks the meta dirty so the next query rebuilds it.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

import torch


def index_nbytes(index_obj) -> int:
    """Bytes of every tensor field of an index on its device: 0 for an
    HNSW graph, which is host memory."""
    if not dataclasses.is_dataclass(index_obj):
        return 0                       # the native graph's handle
    return sum(v.numel() * v.element_size()
               for v in (getattr(index_obj, f.name)
                         for f in dataclasses.fields(index_obj))
               if isinstance(v, torch.Tensor))


class IndexCache:
    """LRU over IndexMeta entries; evicting drops index_obj (device
    memory) and re-marks the meta dirty for on-demand rebuild."""

    def __init__(self, budget_bytes: int = 8 << 30):
        self.budget = budget_bytes
        self._lock = threading.Lock()
        self._lru: "OrderedDict[str, tuple]" = OrderedDict()  # name -> (meta, nbytes)
        self.used = 0
        self.evictions = 0

    def put(self, meta) -> None:
        nbytes = index_nbytes(meta.index_obj)
        with self._lock:
            old = self._lru.pop(meta.name, None)
            if old is not None:
                self.used -= old[1]
            self._lru[meta.name] = (meta, nbytes)
            self.used += nbytes
            while self.used > self.budget and len(self._lru) > 1:
                name, (m, sz) = self._lru.popitem(last=False)
                self.used -= sz
                self.evictions += 1
                m.index_obj = None      # free device memory
                m.options.pop("_sharded", None)   # and its sharded repack
                m.dirty = True          # rebuild on next use
            # a single index larger than the whole budget stays resident:
            # evicting the only copy would thrash every query

    def touch(self, meta) -> None:
        with self._lock:
            if meta.name in self._lru:
                self._lru.move_to_end(meta.name)

    def drop(self, name: str) -> None:
        with self._lock:
            old = self._lru.pop(name, None)
            if old is not None:
                self.used -= old[1]

    def stats(self) -> dict:
        with self._lock:
            return {"used": self.used, "budget": self.budget,
                    "entries": len(self._lru),
                    "evictions": self.evictions}
