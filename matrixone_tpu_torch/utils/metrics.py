"""The counters the port increments.

Counterpart of the vector-search part of `matrixone_tpu/utils/metrics.py`
and of its fusion and key-auditor parts (same metric names, same
labels), as a minimal thread-safe registry of its own: the port keeps no
dependency on the JAX package's registry.  `agg_chunks` is the port's
own: which path each input chunk of a grouped aggregate took; so are
`fusion_graphs`, the CUDA graphs captured and replayed by the fused
fragments (vm/graphs.py), `fusion_batches`, the batches they took, and
the spills' `agg_spills`, `spill_partitions`, `spill_bytes` and
`spill_seconds` (`join_spills` is the JAX package's name), and the
storage counters `pk_check_seconds`, `pk_bloom_suspects` and
`scan_segments`.  The object store's (`mo_blockcache_*`,
`mo_object_*`), the scan read-ahead's (`mo_scan_prefetch_*`), the
merges' (`mo_merge_*`) and the restart's (`mo_recovery_*`) keep the
JAX package's names.
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

# ---- whole-plan fusion (vm/fusion.py)
fusion_dispatch = Counter(
    "mo_fusion_dispatch_total",
    "fused-fragment step executions by kind (step = one step function "
    "per batch: a graph replay on the card, the eager step on the CPU; "
    "eager = degraded per-op evaluation)")
fusion_compile = Counter(
    "mo_fusion_compile_total",
    "fragment compile-cache lookups by outcome (hit/miss/trace_fail)")
fusion_trace_seconds = Counter(
    "mo_fusion_trace_seconds_total",
    "seconds spent warming up and capturing fused fragment graphs")
fusion_exec = Counter(
    "mo_fusion_exec_total",
    "fragment executions by mode (fused/eager/fallback/degraded)")
fusion_step_seconds = Counter(
    "mo_fusion_step_seconds_total",
    "fused step wall seconds by kind (device vs host bookkeeping; "
    "filled under MO_FUSION_PROFILE=1 diagnostic runs)")
fusion_graphs = Counter(
    "mo_fusion_graphs_total",
    "CUDA graphs of fused fragment steps by event (capture/replay/"
    "evict: a graph dropped with its cache entry to keep what the "
    "cached graphs hold under the cache's byte bound)")
fusion_batches = Counter(
    "mo_fusion_batches_total",
    "source batches that entered a fused step (a probe batch re-run "
    "for duplicate fan-out counts once)")

# ---- trace-capture / cache-key auditor (utils/keys.py)
key_captures = Counter(
    "mo_key_captures_total",
    "capture content hashes recorded at compile time by the armed "
    "key auditor (one per dep per first-sighted cache key)")
key_audits = Counter(
    "mo_key_audits_total",
    "cache-hit re-hash audits by outcome (ok/mismatch)")
key_findings = Counter(
    "mo_key_findings_total",
    "capture-content mismatches under a colliding cache key, by "
    "audited site label (fragment/joinbuild/joinprobe)")

# ---- Grace spills (vm/join.py, vm/operators.py)
join_spills = Counter(
    "mo_join_spill_total", "joins whose build side Grace-spilled to host")
agg_spills = Counter(
    "mo_agg_spill_total",
    "grouped aggregates whose group table Grace-spilled to host")
spill_partitions = Counter(
    "mo_spill_partitions_total",
    "partitions a spill drained, by kind (join/agg)")
spill_bytes = Counter(
    "mo_spill_bytes_total",
    "bytes of the .npz chunks spills wrote, by kind (join/agg)")
spill_seconds = Counter(
    "mo_spill_seconds_total",
    "host seconds of the spills by kind (join/agg) and stage (partition: "
    "hash, partition ids and copies to the host; write: the .npz "
    "chunks; replay: reading them back onto the device)")

# ---- storage (storage/engine.py)
pk_check_seconds = Counter(
    "mo_pk_check_seconds_total",
    "host seconds of the commits' primary-key checks (bloom probe, then "
    "the exact test of its suspects)")
pk_bloom_suspects = Counter(
    "mo_pk_bloom_suspects_total",
    "inserted keys the primary-key bloom filter could not clear (each "
    "paid the exact test against the live rows)")
scan_segments = Counter(
    "mo_scan_segments_total",
    "segments a scan visited by outcome (read, or pruned: a partition "
    "its filters exclude)")

# ---- object-backed segments (storage/blockcache.py, storage/objectio.py)
blockcache_ops = Counter(
    "mo_blockcache_ops_total", "decoded-column cache lookups by outcome")
blockcache_bytes = Counter(
    "mo_blockcache_fetch_bytes_total",
    "decoded bytes brought into the block cache on misses")
blockcache_device_ops = Counter(
    "mo_blockcache_device_ops_total",
    "device-tier cache lookups: hit (no upload), upload (host hit, "
    "re-staged), miss (decode required)")
blockcache_upload_bytes = Counter(
    "mo_blockcache_upload_bytes_total",
    "host-to-device bytes staged for cached columns (a warm scan adds 0)")
decode_seconds = Counter(
    "mo_object_decode_seconds_total",
    "seconds spent fetching and decoding object column blocks (misses)")
object_write_seconds = Counter(
    "mo_object_write_seconds_total",
    "seconds spent encoding and writing objects")
scan_prefetch = Counter(
    "mo_scan_prefetch_total",
    "scan read-ahead outcomes: chunks served ready vs waited on")
scan_prefetch_wait_seconds = Counter(
    "mo_scan_prefetch_wait_seconds_total",
    "seconds the scan consumer blocked waiting on the read-ahead")

# ---- merges (storage/engine.py merge_table, storage/merge_sched.py)
merge_tasks = Counter(
    "mo_merge_tasks_total",
    "merge-scheduler task outcomes by kind (compact/checkpoint/gc) and "
    "outcome (ok/noop/deferred/failed)")
merge_rows = Counter(
    "mo_merge_rows_total", "live rows rewritten into merged segments")
merge_segments = Counter(
    "mo_merge_segments_total", "pre-merge segments compacted by merges")
merge_seconds = Counter(
    "mo_merge_seconds_total",
    "merge seconds by phase (rewrite: the concat and the object write "
    "without the commit lock; swap: the publish under it)")
merge_fences_released = Counter(
    "mo_merge_fences_released_total",
    "snapshot fences released by gc_fences")
merge_gc_objects = Counter(
    "mo_merge_gc_objects_total",
    "pre-merge object files deleted by gc_fences")

# ---- restart (Engine.open)
recovery_frames = Counter(
    "mo_recovery_frames_total",
    "intact WAL frames replayed by Engine.open restarts")
recovery_torn_bytes = Counter(
    "mo_recovery_torn_bytes_total",
    "torn-tail bytes discarded at the end of the WAL during a restart")
recovery_orphans = Counter(
    "mo_recovery_orphans_total",
    "orphaned *.tmp files deleted by Engine.open")
