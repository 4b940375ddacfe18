"""The port's metrics registry: counters, gauges and histograms with a
Prometheus text form.

The port's copy of `matrixone_tpu/utils/metrics.py` (`Counter`,
`Gauge`, `Histogram`, `histogram_delta_quantile`, `Registry` with
`render()` and `snapshot()`, the process-global `REGISTRY`), with plain
`threading` locks.  Every metric the port increments keeps the JAX
package's name, help and labels: the statement latency
(`query_seconds`), the scans' rows, the commits, the serving layer's
plan and result caches and admission, the tracing plane
(`trace_spans`, `trace_traces`, `trace_ring_dropped`), the fault
points (`fault_fired`), the vector search, the fusion counters, the
key auditor, the merges and the restart.  The port's own are
`agg_chunks` (which path each input chunk of a grouped aggregate
took), `fusion_graphs` (the CUDA graphs captured and replayed by the
fused fragments, vm/graphs.py), `fusion_batches` (the batches they
took), the spills' `agg_spills`, `spill_partitions`, `spill_bytes` and
`spill_seconds` (`join_spills` is the JAX package's name), and the
storage counters `pk_check_seconds`, `pk_bloom_suspects` and
`scan_segments`.  The object store's (`mo_blockcache_*`,
`mo_object_*`), the scan read-ahead's (`mo_scan_prefetch_*`), the
merges' (`mo_merge_*`), the restart's (`mo_recovery_*`) and the RPC
fabric's (`mo_rpc_*`) keep the JAX package's names; the host-peer
fragments' `fragment_wire_bytes` and `fragment_pushed_rows` are the
port's own.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple


def _escape_label(v) -> str:
    """Prometheus text-format label value escaping (\\ " and newline)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


class Counter:
    kind = "counter"

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

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            snapshot = dict(self._values)
        for key, v in sorted(snapshot.items()):
            lbl = ",".join(f'{k}="{_escape_label(val)}"'
                           for k, val in key)
            lines.append(f"{self.name}{{{lbl}}} {v}" if lbl
                         else f"{self.name} {v}")
        return lines

    def snapshot(self) -> dict:
        with self._lock:
            snapshot = dict(self._values)
        return {"type": self.kind, "help": self.help,
                "values": [{"labels": dict(key), "value": v}
                           for key, v in sorted(snapshot.items())]}


class Gauge(Counter):
    """A value that can go up and down (cache entries, queue depth)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value


class Histogram:
    _BUCKETS = [1e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60]

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self.counts = [0] * (len(self._BUCKETS) + 1)
        self.sum = 0.0
        self.total = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.sum += v
            self.total += 1
            for i, b in enumerate(self._BUCKETS):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def time(self):
        h = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *a):
                h.observe(time.perf_counter() - self.t0)
        return _Timer()

    def render(self) -> List[str]:
        """Prometheus text format: cumulative `_bucket` lines, `+Inf`,
        `_sum`, `_count`, read under the lock so a scrape never shows
        the count ahead of the buckets."""
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            counts = list(self.counts)
            total, sum_ = self.total, self.sum
        acc = 0
        for b, c in zip(self._BUCKETS, counts):
            acc += c
            lines.append(f'{self.name}_bucket{{le="{b}"}} {acc}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {total}')
        lines.append(f"{self.name}_sum {sum_}")
        lines.append(f"{self.name}_count {total}")
        return lines

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self.counts)
            total, sum_ = self.total, self.sum
        return {"type": "histogram", "help": self.help,
                "sum": sum_, "count": total,
                "buckets": [{"le": b, "count": c}
                            for b, c in zip(self._BUCKETS, counts)]
                           + [{"le": "+Inf", "count": counts[-1]}]}

    def quantile(self, q: float) -> float:
        """Approximate quantile: the upper bound of the bucket holding
        the q-th observation."""
        with self._lock:
            counts = list(self.counts)
            total = self.total
        if total <= 0:
            return 0.0
        target = q * total
        acc = 0
        for b, c in zip(self._BUCKETS, counts):
            acc += c
            if acc >= target:
                return b
        return float(self._BUCKETS[-1])


def histogram_delta_quantile(before: dict, after: dict,
                             q: float) -> float:
    """Approximate quantile of the observations made between two
    `Histogram.snapshot()` captures (the bucket counts' difference), so
    a measured phase reports its own p50/p99 without the earlier
    history of the process-global histogram."""
    diffs = []
    b_by_le = {b["le"]: b["count"] for b in before["buckets"]}
    for b in after["buckets"]:
        if b["le"] == "+Inf":
            continue
        diffs.append((b["le"], b["count"] - b_by_le.get(b["le"], 0)))
    total = after["count"] - before["count"]
    if total <= 0:
        return 0.0
    target = q * total
    acc = 0
    for le, c in diffs:
        acc += c
        if acc >= target:
            return le
    return float(diffs[-1][0]) if diffs else 0.0


class Registry:
    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help_: str):
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = cls(name, help_)
            return self._metrics[name]

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def histogram(self, name: str, help_: str = "") -> Histogram:
        return self._get(Histogram, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def render(self) -> str:
        """Prometheus text exposition format (`mo_ctl('metrics','dump')`):
        every family carries # HELP and # TYPE, histograms cumulative
        `_bucket`/`_sum`/`_count`, label values escaped."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines: List[str] = []
        for _name, m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def expose(self) -> str:
        """Alias of render()."""
        return self.render()

    def snapshot(self) -> Dict[str, dict]:
        """Point-in-time view of every metric: the programmatic read API
        (chip_smoke.py), so callers never read `_values` or `counts`."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in metrics}


#: process-global registry
REGISTRY = Registry()

query_seconds = REGISTRY.histogram(
    "mo_query_duration_seconds", "SQL statement execution latency")
rows_scanned = REGISTRY.counter(
    "mo_scan_rows_total", "rows scanned by table scans")
txn_commits = REGISTRY.counter(
    "mo_txn_commit_total", "transaction commits by outcome")
fault_fired = REGISTRY.counter(
    "mo_fault_triggered_total", "armed fault points that fired, by point")

# ---- serving layer (serving/)
plan_cache_ops = REGISTRY.counter(
    "mo_plan_cache_ops_total",
    "plan cache lookups by outcome (hit/miss/uncacheable/invalidated/"
    "bypass)")
plan_cache_entries = REGISTRY.gauge(
    "mo_plan_cache_entries", "resident plan cache entries")
result_cache_ops = REGISTRY.counter(
    "mo_result_cache_ops_total",
    "result cache lookups by outcome (hit/miss/stale/bypass)")
result_cache_entries = REGISTRY.gauge(
    "mo_result_cache_entries", "resident result cache entries")
result_cache_bytes = REGISTRY.gauge(
    "mo_result_cache_bytes", "bytes held by cached result sets")
result_cache_evictions = REGISTRY.counter(
    "mo_result_cache_evictions_total",
    "result entries evicted by the byte-budget LRU")
admission_total = REGISTRY.counter(
    "mo_admission_total",
    "admission decisions by lane and outcome (admitted/shed_capacity/"
    "shed_timeout/shed_deadline/killed)")
admission_queue_seconds = REGISTRY.histogram(
    "mo_admission_queue_seconds",
    "time admitted statements spent waiting for a slot")
admission_running = REGISTRY.gauge(
    "mo_admission_running", "statements currently holding a slot")
admission_queued = REGISTRY.gauge(
    "mo_admission_queued", "statements waiting in the admission queue")

# ---- tracing plane (utils/motrace.py)
trace_spans = REGISTRY.counter(
    "mo_trace_spans_total",
    "completed motrace spans landed in this process's ring, by the "
    "span's origin process")
trace_traces = REGISTRY.counter(
    "mo_trace_traces_total",
    "root-span head-sampling decisions (sampled/unsampled)")
trace_ring_dropped = REGISTRY.counter(
    "mo_trace_ring_dropped_total",
    "spans evicted from the bounded trace ring (raise MO_TRACE_RING)")

vector_build_seconds = REGISTRY.counter(
    "mo_vector_build_seconds_total",
    "IVF build wall seconds by stage (kmeans/assign/pack; IVF-PQ: "
    "kmeans/assign/pq)")
vector_search_queries = REGISTRY.counter(
    "mo_vector_search_queries_total", "queries entering ivf search")
vector_search_pad_rows = REGISTRY.counter(
    "mo_vector_search_pad_rows_total",
    "pad rows added by the internal power-of-two batch bucketing")
vector_search_seconds = REGISTRY.counter(
    "mo_vector_search_seconds_total",
    "IVF search wall seconds by stage (probe/score/merge), filled by "
    "ivf_flat.search_profiled")
vector_batch_rows = REGISTRY.counter(
    "mo_vector_batch_rows_total",
    "worker micro-batcher: real query rows dispatched to the device")
vector_batch_coalesced = REGISTRY.counter(
    "mo_vector_batch_coalesced_total",
    "worker micro-batcher: requests that rode another request's dispatch")
agg_chunks = REGISTRY.counter(
    "mo_agg_chunks_total",
    "grouped-aggregate input chunks by path (dense: the small-key dense "
    "accumulator; general: hash, sort and segment scatter)")

# ---- whole-plan fusion (vm/fusion.py)
fusion_dispatch = REGISTRY.counter(
    "mo_fusion_dispatch_total",
    "fused-fragment step executions by kind (step = one step function "
    "per batch: a graph replay on the card, the eager step on the CPU; "
    "eager = degraded per-op evaluation)")
fusion_compile = REGISTRY.counter(
    "mo_fusion_compile_total",
    "fragment compile-cache lookups by outcome (hit/miss/trace_fail)")
fusion_trace_seconds = REGISTRY.counter(
    "mo_fusion_trace_seconds_total",
    "seconds spent warming up and capturing fused fragment graphs")
fusion_exec = REGISTRY.counter(
    "mo_fusion_exec_total",
    "fragment executions by mode (fused/eager/fallback/degraded)")
fusion_step_seconds = REGISTRY.counter(
    "mo_fusion_step_seconds_total",
    "fused step wall seconds by kind (device vs host bookkeeping; "
    "filled under MO_FUSION_PROFILE=1 diagnostic runs)")
fusion_graphs = REGISTRY.counter(
    "mo_fusion_graphs_total",
    "CUDA graphs of fused fragment steps by event (capture/replay/"
    "evict: a graph dropped with its cache entry to keep what the "
    "cached graphs hold under the cache's byte bound)")
fusion_batches = REGISTRY.counter(
    "mo_fusion_batches_total",
    "source batches that entered a fused step (a probe batch re-run "
    "for duplicate fan-out counts once)")

# ---- trace-capture / cache-key auditor (utils/keys.py)
key_captures = REGISTRY.counter(
    "mo_key_captures_total",
    "capture content hashes recorded at compile time by the armed "
    "key auditor (one per dep per first-sighted cache key)")
key_audits = REGISTRY.counter(
    "mo_key_audits_total",
    "cache-hit re-hash audits by outcome (ok/mismatch)")
key_findings = REGISTRY.counter(
    "mo_key_findings_total",
    "capture-content mismatches under a colliding cache key, by "
    "audited site label (fragment/joinbuild/joinprobe)")

# ---- Grace spills (vm/join.py, vm/operators.py)
join_spills = REGISTRY.counter(
    "mo_join_spill_total", "joins whose build side Grace-spilled to host")
agg_spills = REGISTRY.counter(
    "mo_agg_spill_total",
    "grouped aggregates whose group table Grace-spilled to host")
spill_partitions = REGISTRY.counter(
    "mo_spill_partitions_total",
    "partitions a spill drained, by kind (join/agg)")
spill_bytes = REGISTRY.counter(
    "mo_spill_bytes_total",
    "bytes of the .npz chunks spills wrote, by kind (join/agg)")
spill_seconds = REGISTRY.counter(
    "mo_spill_seconds_total",
    "host seconds of the spills by kind (join/agg) and stage (partition: "
    "hash, partition ids and copies to the host; write: the .npz "
    "chunks; replay: reading them back onto the device)")

# ---- storage (storage/engine.py)
pk_check_seconds = REGISTRY.counter(
    "mo_pk_check_seconds_total",
    "host seconds of the commits' primary-key checks (bloom probe, then "
    "the exact test of its suspects)")
pk_bloom_suspects = REGISTRY.counter(
    "mo_pk_bloom_suspects_total",
    "inserted keys the primary-key bloom filter could not clear (each "
    "paid the exact test against the live rows)")
scan_segments = REGISTRY.counter(
    "mo_scan_segments_total",
    "segments a scan visited by outcome (read, or pruned: a partition "
    "its filters exclude)")

# ---- object-backed segments (storage/blockcache.py, storage/objectio.py)
blockcache_ops = REGISTRY.counter(
    "mo_blockcache_ops_total", "decoded-column cache lookups by outcome")
blockcache_bytes = REGISTRY.counter(
    "mo_blockcache_fetch_bytes_total",
    "decoded bytes brought into the block cache on misses")
blockcache_device_ops = REGISTRY.counter(
    "mo_blockcache_device_ops_total",
    "device-tier cache lookups: hit (no upload), upload (host hit, "
    "re-staged), miss (decode required)")
blockcache_upload_bytes = REGISTRY.counter(
    "mo_blockcache_upload_bytes_total",
    "host-to-device bytes staged for cached columns (a warm scan adds 0)")
decode_seconds = REGISTRY.counter(
    "mo_object_decode_seconds_total",
    "seconds spent fetching and decoding object column blocks (misses)")
object_write_seconds = REGISTRY.counter(
    "mo_object_write_seconds_total",
    "seconds spent encoding and writing objects")
scan_prefetch = REGISTRY.counter(
    "mo_scan_prefetch_total",
    "scan read-ahead outcomes: chunks served ready vs waited on")
scan_prefetch_wait_seconds = REGISTRY.counter(
    "mo_scan_prefetch_wait_seconds_total",
    "seconds the scan consumer blocked waiting on the read-ahead")

# ---- merges (storage/engine.py merge_table, storage/merge_sched.py)
merge_tasks = REGISTRY.counter(
    "mo_merge_tasks_total",
    "merge-scheduler task outcomes by kind (compact/checkpoint/gc) and "
    "outcome (ok/noop/deferred/failed)")
merge_rows = REGISTRY.counter(
    "mo_merge_rows_total", "live rows rewritten into merged segments")
merge_segments = REGISTRY.counter(
    "mo_merge_segments_total", "pre-merge segments compacted by merges")
merge_seconds = REGISTRY.counter(
    "mo_merge_seconds_total",
    "merge seconds by phase (rewrite: the concat and the object write "
    "without the commit lock; swap: the publish under it)")
merge_fences_released = REGISTRY.counter(
    "mo_merge_fences_released_total",
    "snapshot fences released by gc_fences")
merge_gc_objects = REGISTRY.counter(
    "mo_merge_gc_objects_total",
    "pre-merge object files deleted by gc_fences")

# ---- restart (Engine.open)
recovery_frames = REGISTRY.counter(
    "mo_recovery_frames_total",
    "intact WAL frames replayed by Engine.open restarts")
recovery_torn_bytes = REGISTRY.counter(
    "mo_recovery_torn_bytes_total",
    "torn-tail bytes discarded at the end of the WAL during a restart")
recovery_orphans = REGISTRY.counter(
    "mo_recovery_orphans_total",
    "orphaned *.tmp files deleted by Engine.open")

# ---- ingest (storage/csvread.py, storage/external.py)
external_parses = REGISTRY.counter(
    "mo_external_parses_total",
    "CSV files an external table read and parsed, by table (a scan "
    "served from the decoded-chunk cache parses nothing)")

# ---- user-defined functions (udf/)
udf_calls = REGISTRY.counter(
    "mo_udf_calls_total",
    "UDF evaluations by tier (jit/row/aggregate)")
udf_rows = REGISTRY.counter(
    "mo_udf_rows_total", "rows processed by UDF evaluations, by tier")
udf_compile = REGISTRY.counter(
    "mo_udf_compile_total",
    "UDF compile-cache lookups by outcome (hit/miss/trace_fail)")

# ---- materialized views (mview/)
mview_apply = REGISTRY.counter(
    "mo_mview_apply_total",
    "materialized-view maintenance applications by tier "
    "(dense/general/recompute/init/error)")
mview_rows = REGISTRY.counter(
    "mo_mview_rows_total",
    "delta rows processed by materialized-view maintenance")
mview_apply_seconds = REGISTRY.counter(
    "mo_mview_apply_seconds_total",
    "seconds spent in view maintenance by kind (delta/full)")

# ---- the padding canary (utils/qa.py)
qa_queries = REGISTRY.counter(
    "mo_qa_queries_total",
    "queries run under a differential check")
qa_oracle_checks = REGISTRY.counter(
    "mo_qa_oracle_checks_total",
    "differential verdicts by oracle")
qa_findings = REGISTRY.counter(
    "mo_qa_findings_total",
    "findings by kind (canary-in-result/canary-in-carry/...)")

# ---- device-shard exchanges (parallel/dist_query.py shard executor)
exchange_shuffle_rows = REGISTRY.counter(
    "mo_exchange_shuffle_rows_total",
    "rows that crossed a hash exchange (vm/operators._hash_route row "
    "routing; co-partitioned reads that resolve structurally count 0)")
exchange_broadcast_bytes = REGISTRY.counter(
    "mo_exchange_broadcast_bytes_total",
    "bytes replicated to the non-owning shards by broadcast join "
    "builds (materialized once, bytes x (n_shards - 1))")
exchange_partial_merge = REGISTRY.counter(
    "mo_exchange_partial_merge_total",
    "cross-shard partial-result merges by kind "
    "(dense/general/scalar/topk/join)")
vector_shard_imbalance = REGISTRY.gauge(
    "mo_vector_shard_imbalance",
    "sharded IVF row imbalance: max shard rows / mean shard rows")

# ---- the RPC fabric (cluster/rpc.py; the JAX package's names)
rpc_attempts = REGISTRY.counter(
    "mo_rpc_attempts_total", "RPC send attempts by op")
rpc_retries = REGISTRY.counter(
    "mo_rpc_retries_total", "RPC attempts that were retries, by op")
rpc_errors = REGISTRY.counter(
    "mo_rpc_errors_total",
    "RPC calls that failed after all attempts, by error kind")
rpc_seconds = REGISTRY.histogram(
    "mo_rpc_call_seconds", "successful RPC round-trip latency")
rpc_breaker_state = REGISTRY.gauge(
    "mo_rpc_breaker_state",
    "per-peer circuit breaker state (0 closed, 1 half-open, 2 open)")
rpc_breaker_transitions = REGISTRY.counter(
    "mo_rpc_breaker_transitions_total",
    "circuit breaker state transitions, by peer and new state")
# ---- host-peer fragments (parallel/fragments.py)
fragment_wire_bytes = REGISTRY.counter(
    "mo_fragment_wire_bytes_total",
    "bytes of fragment results and shuffle buckets on the fabric, by "
    "kind (result/shuffle)")
fragment_pushed_rows = REGISTRY.counter(
    "mo_fragment_pushed_rows_total",
    "rows a shuffle scan pushed to another peer")
