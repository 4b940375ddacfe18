"""The counters the port increments.

Counterpart of the vector-search part of `matrixone_tpu/utils/metrics.py`
(same metric names, same labels), as a minimal thread-safe registry of
its own: the port keeps no dependency on the JAX package's registry.
`agg_chunks` is the port's own: which path each input chunk of a
grouped aggregate took.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: Dict[Tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def get(self, **labels) -> float:
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)


vector_build_seconds = Counter(
    "mo_vector_build_seconds_total",
    "IVF build wall seconds by stage (kmeans/assign/pack; IVF-PQ: "
    "kmeans/assign/pq)")
vector_search_queries = Counter(
    "mo_vector_search_queries_total", "queries entering ivf search")
vector_search_pad_rows = Counter(
    "mo_vector_search_pad_rows_total",
    "pad rows added by the internal power-of-two batch bucketing")
vector_search_seconds = Counter(
    "mo_vector_search_seconds_total",
    "IVF search wall seconds by stage (probe/score/merge), filled by "
    "ivf_flat.search_profiled")
vector_batch_rows = Counter(
    "mo_vector_batch_rows_total",
    "worker micro-batcher: real query rows dispatched to the device")
vector_batch_coalesced = Counter(
    "mo_vector_batch_coalesced_total",
    "worker micro-batcher: requests that rode another request's dispatch")
agg_chunks = Counter(
    "mo_agg_chunks_total",
    "grouped-aggregate input chunks by path (dense: the small-key dense "
    "accumulator; general: hash, sort and segment scatter)")
