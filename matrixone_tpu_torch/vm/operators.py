"""Physical operators: host-driven loops over device batches.

The port of the per-operator path of `matrixone_tpu/vm/operators.py`
(reference analogue: `pkg/sql/colexec` + the `vm.Operator` pull loop):
Scan (pushed filters, zonemap pruning and the runtime filters joins
inject), Values, Filter, Project, the streaming grouped and scalar
aggregate, Sort, TopK, Limit, Distinct, Union, Sample and Fill.  Operators yield ExecBatch
(device tensors + mask): filters produce masks, not compacted rows;
group-by is the sort/segment kernel (ops/agg) with a streaming partial
merge into a bounded device-resident group table.

Grouped aggregates over small dictionary-coded or BOOL keys (the TPC-H
Q1 shape) take the reference's dense accumulator: mixed-radix group
ids, no hash and no sort, float sums in f64.  DISTINCT dedups by the
same group ids.

These operators are also the fused fragments' degradation ladder
(vm/fusion.py): a fragment that cannot run fused re-enters its original
chain of them.

A group table that would outgrow `max_device_groups` Grace-spills to
the host (`_AggSpill`): the rows and the partial state are
hash-partitioned by group key into `.npz` chunks, and each partition is
aggregated on its own, its groups streamed out partition by partition.

The scan reads object-backed segments' columns from the block cache's
device tier (`storage/engine.resolve_chunk`) and, when a scan is cold,
runs a read-ahead thread (`_ChunkPrefetcher`) that decodes the next
chunks' columns into the host tier while the current chunk computes.

The device-shard executor (`parallel/dist_query.py`) reads through the
same scan: `shard=(s, n)` keeps every n-th chunk, `hash_shard=(col, s,
n)` keeps the rows whose splitmix64(col) % n is s (`_hash_route`, on
the card where the chunk is already there), and the aggregate hands
back its partial state before finalizing (`AggOp.partial_state`,
`partial_scalar_state`).  `MaterializedOp` feeds host arrays (a merged
cross-shard result) back into a plan.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from matrixone_tpu_torch.container import device as dev
from matrixone_tpu_torch.container import dtypes as dt
from matrixone_tpu_torch.container.device import (DeviceBatch, DeviceColumn,
                                                  bucket_length)
from matrixone_tpu_torch.container.dtypes import DType, TypeOid
from matrixone_tpu_torch.ops import agg as A, encodings as ENC
from matrixone_tpu_torch.ops import filter as F, scalar as S
from matrixone_tpu_torch.ops import sort as msort
from matrixone_tpu_torch.sql import plan as P
from matrixone_tpu_torch.sql.expr import AggCall, BoundExpr, BoundLiteral
from matrixone_tpu_torch.sql.parser import BIT_AGGS, STDDEV_AGGS
from matrixone_tpu_torch.utils import metrics
from matrixone_tpu_torch.utils.fault import INJECTOR
from matrixone_tpu_torch.vm.exprs import (EvalError, ExecBatch, _dict_of,
                                          eval_expr, lut_gather)


class Operator:
    def execute(self) -> Iterator[ExecBatch]:
        raise NotImplementedError

    schema: List


# ------------------------------------------------------------------- scan

def chunk_to_execbatch(arrays, validity, table_dicts, n, columns, schema,
                       device) -> ExecBatch:
    """Host chunk -> padded device ExecBatch, renaming raw table columns to
    the plan's qualified names and tagging varlen columns.  Only
    dictionary-coded columns are narrowed: the row-id column (`ROWID`,
    int64, negative for a transaction's own rows) reaches the device
    as it is."""
    qnames = [nm for nm, _ in schema]
    arr2, val2, dicts2, dtypes = {}, {}, {}, {}
    for qn, col, dtype in zip(qnames, columns, [d for _, d in schema]):
        arr2[qn] = arrays[col]
        val2[qn] = validity[col]
        dtypes[qn] = dt.INT32 if dtype.is_varlen else dtype
        if col in table_dicts:
            dicts2[qn] = table_dicts[col]
            # narrow dict codes to the smallest signed width the
            # dictionary fits (lossless — hash/compare/gather are
            # width-invariant); from_numpy preserves the narrow dtype
            arr2[qn] = ENC.narrow_codes(arr2[qn], len(table_dicts[col]))
    db = dev.from_numpy(arr2, dtypes, val2, n_rows=n, device=device)
    for qn, (_, dtype) in zip(qnames, schema):
        if dtype.is_varlen:
            c = db.columns[qn]
            db.columns[qn] = DeviceColumn(c.data, c.validity, dtype)
    return ExecBatch(batch=db, dicts=dicts2, mask=db.row_mask())


class _ChunkPrefetcher:
    """Bounded read-ahead over a chunk iterator (reference: the CN
    reader's merged-IO pipelining, `pkg/fileservice/io_merger.go` role).

    A worker thread pulls chunk N+1, which for object-backed segments
    fetches and decodes their columns into the block cache's HOST tier,
    while the consumer computes over chunk N.  The worker never touches
    the device: the consumer uploads, between its steps, so no copy of
    this thread can land inside a CUDA graph being captured.  Errors
    propagate to the consumer; closing stops the worker and closes the
    source generator."""

    _DONE, _ITEM, _ERR = 0, 1, 2

    def __init__(self, gen, depth: int):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(gen,), daemon=True,
            name="mo-scan-prefetch")
        self._thread.start()

    def _run(self, gen) -> None:
        try:
            for item in gen:
                while True:
                    if self._stop.is_set():
                        gen.close()
                        return
                    try:
                        self._q.put((self._ITEM, item), timeout=0.1)
                        break
                    except queue.Full:
                        continue
            self._q.put((self._DONE, None))
        except BaseException as e:                    # noqa: BLE001
            # deliver the error with the same patience as items: a full
            # queue must never swallow it
            while not self._stop.is_set():
                try:
                    self._q.put((self._ERR, e), timeout=0.1)
                    return
                except queue.Full:
                    continue

    def __iter__(self):
        while True:
            ready = not self._q.empty()
            t0 = 0.0 if ready else time.perf_counter()
            kind, payload = self._q.get()
            if kind == self._DONE:
                return
            if kind == self._ERR:
                raise payload
            metrics.scan_prefetch.inc(outcome="ready" if ready
                                      else "waited")
            if not ready:
                metrics.scan_prefetch_wait_seconds.inc(
                    time.perf_counter() - t0)
            yield payload

    def close(self) -> None:
        self._stop.set()
        while not self._q.empty():     # unblock a Full worker
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5)


def prefetch_depth(rel, columns) -> int:
    """The scan's read-ahead depth: `MO_SCAN_PREFETCH` when set (0
    disables), else 2 for a scan that will decode cold object blocks
    and 0 for a warm one (a handoff thread is pure overhead there)."""
    try:
        return int(os.environ.get("MO_SCAN_PREFETCH"))
    except (TypeError, ValueError):     # unset / "auto": cold only
        is_cold = getattr(rel, "scan_is_cold", None)
        return 2 if is_cold is not None and is_cold(columns) else 0


class ScanOp(Operator):
    """Table scan with filter pushdown + zonemap chunk pruning
    (reference: colexec/table_scan + readutil block pruning).  It reads
    the context's view (the statement's frontier, or a transaction's
    snapshot plus its workspace; `AS OF` overrides both), and each chunk
    reaches the context's device: uploaded from host memory, or, for an
    object-backed segment, taken from the block cache's device tier;
    with the read-ahead (`prefetch_depth`) on a cold scan."""

    def __init__(self, node: P.Scan, relation, ctx,
                 batch_rows: int = 1 << 20):
        self.node = node
        self.rel = relation
        self.batch_rows = batch_rows
        self.schema = node.schema
        self.ctx = ctx
        # filters injected at run time by upstream joins (build-side key
        # ranges — reference: vm/message/runtimeFilterMsg.go); they ride
        # the same zonemap-pruning + early-mask path as planned filters
        self.runtime_filters: List[BoundExpr] = []

    def execute(self) -> Iterator[ExecBatch]:
        return self._batches(apply_mask=True)

    def _batches(self, apply_mask: bool = True) -> Iterator[ExecBatch]:
        """Chunk iterator.  With apply_mask=False the pushed filters
        still prune chunks by zonemap, but are not evaluated as an early
        row mask: a fused fragment (vm/fusion.py) evaluates them in its
        step instead."""
        INJECTOR.trigger("scan.before")
        read_args = self.ctx.table_read_args(self.node.table)
        if self.node.as_of_ts is not None:
            # time travel: a historical read, independent of the txn view
            read_args = {"snapshot_ts": self.node.as_of_ts}
        filters = self.node.filters + self.runtime_filters
        batch_rows = int((self.ctx.variables or {}).get("batch_rows",
                                                        self.batch_rows))
        qnames = [n for n, _ in self.node.schema]
        device = self.ctx.device
        depth = prefetch_depth(self.rel, self.node.columns)
        if getattr(self.rel, "scan_is_cold", None) is not None:
            read_args = dict(read_args, device=device,
                             read_ahead=depth > 0)
        shard = self.node.shard
        hs = self.node.hash_shard
        hs_aligned = False
        if hs is not None:
            # read-side hash exchange: a table hash-partitioned on the
            # shuffle column with the same fan-out is read by segment
            # (only_part) and no row moves; the row route below stays on
            # for any segment without a part id
            pspec = getattr(getattr(self.rel, "meta", None), "partition",
                            None)
            hs_aligned = (pspec is not None and pspec.kind == "hash"
                          and pspec.column == hs[0]
                          and pspec.n_parts == hs[2])
            if hs_aligned:
                read_args = dict(read_args, only_part=hs[1])
        chunks = self.rel.iter_chunks(
            self.node.columns, batch_rows, filters=filters,
            qualified_names=qnames, **read_args)
        prefetcher = None
        if depth > 0:
            prefetcher = _ChunkPrefetcher(chunks, depth)
            chunks = iter(prefetcher)
        from matrixone_tpu_torch.storage.engine import resolve_chunk
        try:
            for ci, (arrays, validity, dicts, n) in enumerate(chunks):
                if shard is not None and ci % shard[1] != shard[0]:
                    # a shard reads every n-th chunk of the same chunk
                    # sequence (same snapshot, same filters, same pruning)
                    continue
                arrays, validity = resolve_chunk(arrays, validity, device)
                if hs is not None:
                    arrays, validity, n, moved = _hash_route(
                        arrays, validity, n, hs, hs_aligned)
                    if n == 0:
                        continue
                    if moved:
                        metrics.exchange_shuffle_rows.inc(moved)
                metrics.rows_scanned.inc(n, table=self.node.table)
                ex = chunk_to_execbatch(arrays, validity, dicts, n,
                                        self.node.columns,
                                        self.node.schema, device)
                # evaluate pushed filters as an early mask (zonemap
                # pruning already dropped fully-excluded chunks host-side)
                if apply_mask:
                    for f in filters:
                        pred = eval_expr(f, ex)
                        ex.mask = ex.mask & F.predicate_mask(pred, ex.batch)
                yield ex
        finally:
            if prefetcher is not None:
                prefetcher.close()


def _route_keep(key, valid, n_shards: int, idx: int):
    """Rows shard `idx` owns: splitmix64(key) % n_shards == idx, NULL to
    shard 0, as `storage.partition.assign_partitions` places them.  A
    tensor key is routed where it lies (on the card: `ops/hash.py`'s
    int64 bit patterns, reduced modulo n as unsigned); a numpy key by
    the host library's hash."""
    if isinstance(key, torch.Tensor):
        from matrixone_tpu_torch.ops import hash as H
        pid = H.unsigned_mod(H.splitmix64(key.to(torch.int64)), n_shards)
        if valid is not None:
            pid = torch.where(valid.to(torch.bool), pid,
                              torch.zeros_like(pid))
        return pid == idx
    from matrixone_tpu_torch import native
    key = np.asarray(key)
    pid = (native.hash64(key.astype(np.int64))
           % np.uint64(n_shards)).astype(np.int64)
    if valid is not None:
        pid = np.where(np.asarray(valid, bool), pid, 0)
    return pid == idx


def _hash_route(arrays, validity, n: int, hs, aligned: bool):
    """Keep only the rows this shard owns under the hash exchange
    `hash_shard=(column, idx, n_shards)` (`_route_keep`), so a
    partitioned table and an implicit repartition agree on every row's
    home.  -> (arrays, validity, n_kept, n_moved); n_moved counts the
    rows that crossed the exchange (0 for a co-partitioned read, whose
    segments were selected structurally)."""
    col, idx, n_shards = hs
    key = arrays.get(col)
    if key is None:
        raise EvalError(f"hash_shard column {col!r} not in scan columns")
    kdt = key.dtype
    integer = (not kdt.is_floating_point and not kdt.is_complex
               and kdt != torch.bool) if isinstance(key, torch.Tensor) \
        else np.issubdtype(np.asarray(key).dtype, np.integer)
    if not integer:
        raise EvalError(f"hash_shard column {col!r} must be int-backed, "
                        f"got {kdt}")
    keep = _route_keep(key, validity.get(col), n_shards, idx)
    kept = int(keep.sum())
    moved = 0 if aligned else kept
    if kept == n:
        return arrays, validity, n, moved

    def take(a):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a[torch.as_tensor(keep, device=a.device)]
        return np.asarray(a)[keep.cpu().numpy()
                             if isinstance(keep, torch.Tensor) else keep]

    return ({c: take(a) for c, a in arrays.items()},
            {c: take(v) for c, v in validity.items()}, kept, moved)


class MaterializedOp(Operator):
    """Host arrays as a plan input (P.Materialized): the merged cross-
    shard result re-enters the local operator tree here."""

    def __init__(self, node, ctx):
        self.node = node
        self.schema = node.schema
        self.ctx = ctx

    def execute(self) -> Iterator[ExecBatch]:
        arrays, validity, dicts = {}, {}, {}
        n = None
        for name, dtype in self.node.schema:
            a = self.node.arrays[name]
            if dtype.is_varlen and name in self.node.dicts:
                arrays[name] = np.asarray(a, np.int32)
                dicts[name] = self.node.dicts[name]
            elif dtype.is_varlen and isinstance(a, list):
                d: List[str] = []
                lut: Dict[str, int] = {}
                codes = np.zeros(len(a), np.int32)
                for i, s_ in enumerate(a):
                    if s_ is None:
                        continue
                    code = lut.get(s_)
                    if code is None:
                        code = len(d)
                        lut[s_] = code
                        d.append(s_)
                    codes[i] = code
                arrays[name] = codes
                dicts[name] = d
            else:
                arrays[name] = np.asarray(a)
            v = self.node.validity.get(name)
            validity[name] = (np.asarray(v, bool) if v is not None
                              else np.ones(len(arrays[name]), np.bool_))
            n = len(arrays[name])
        if n is None or n == 0:
            return
        yield chunk_to_execbatch(arrays, validity, dicts, n,
                                 [c for c, _ in self.node.schema],
                                 self.node.schema, self.ctx.device)


class ValuesOp(Operator):
    def __init__(self, node: P.Values, ctx):
        self.node = node
        self.schema = node.schema
        self.ctx = ctx

    def execute(self) -> Iterator[ExecBatch]:
        arrays, dtypes = {}, {}
        for i, (name, dtype) in enumerate(self.node.schema):
            vals = [row[i] for row in self.node.rows]
            arrays[name] = np.asarray(vals, dtype=dtype.np_dtype)
            dtypes[name] = dtype
        db = dev.from_numpy(arrays, dtypes, n_rows=len(self.node.rows),
                            device=self.ctx.device)
        yield ExecBatch(batch=db, dicts={}, mask=db.row_mask())


# ----------------------------------------------------------------- filter

class FilterOp(Operator):
    def __init__(self, node: P.Filter, child: Operator):
        self.node = node
        self.child = child
        self.schema = node.schema

    def execute(self) -> Iterator[ExecBatch]:
        for ex in self.child.execute():
            pred = eval_expr(self.node.pred, ex)
            ex.mask = ex.mask & F.predicate_mask(pred, ex.batch)
            yield ex


class ProjectOp(Operator):
    def __init__(self, node: P.Project, child: Operator):
        self.node = node
        self.child = child
        self.schema = node.schema

    def execute(self) -> Iterator[ExecBatch]:
        for ex in self.child.execute():
            cols: Dict[str, DeviceColumn] = {}
            dicts: Dict[str, List[str]] = {}
            for (name, dtype), e in zip(self.node.schema, self.node.exprs):
                col = eval_expr(e, ex)
                cols[name] = col
                src_dict = _expr_dict(e, ex)
                if src_dict is not None:
                    dicts[name] = src_dict
            db = DeviceBatch(columns=cols, n_rows=ex.batch.n_rows)
            yield ExecBatch(batch=db, dicts=dicts, mask=ex.mask)


def _expr_dict(e: BoundExpr, ex: ExecBatch):
    if isinstance(e, BoundLiteral) and e.dtype.is_varlen:
        return [str(e.value)]
    return _dict_of(e, ex)


# -------------------------------------------------------------- aggregate

class _NeedSpill(Exception):
    """Internal: the group table outgrew the device budget mid-stream."""


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class _AggSpill:
    """Grace-hash spill for group-by (reference: colexec/spillutil +
    spill_threshold.go, re-expressed host-side): when the group table
    would outgrow the device budget, incoming rows AND the current partial
    state are hash-partitioned by group key and parked as npz chunks in a
    temp dir; each partition is then aggregated independently — its group
    table is ~1/P of the total, and partitions have disjoint key sets so
    results stream out per partition."""

    def __init__(self, n_partitions: int, device):
        self.P = n_partitions
        self.device = device
        self.dir = tempfile.mkdtemp(prefix="mo_agg_spill_")
        self.raw_chunks: List[List[str]] = [[] for _ in range(self.P)]
        self.state_chunks: List[List[str]] = [[] for _ in range(self.P)]
        #: the aggregates' argument dtypes, from the first parked batch
        self.value_dtypes: Optional[list] = None
        self._seq = 0

    def _path(self) -> str:
        self._seq += 1
        return os.path.join(self.dir, f"c{self._seq}.npz")

    def _partitions(self, kdata, kvalid) -> np.ndarray:
        from matrixone_tpu_torch.ops import hash as mohash
        h = mohash.hash_columns(list(kdata), list(kvalid))
        # second-level mix so partition bits are independent of the group
        # bits used inside each partition's sort: the logical h >> 17 of
        # the uint64 hash, which is non-negative, so `%` is the reference's
        return _host(mohash._shr(h, 17) % self.P)

    def _save(self, blob: dict) -> str:
        t0 = time.perf_counter()
        path = self._path()
        np.savez(path, **blob)
        metrics.spill_bytes.inc(os.path.getsize(path), kind="agg")
        metrics.spill_seconds.inc(time.perf_counter() - t0, kind="agg",
                                  stage="write")
        return path

    def add_raw(self, kdata, kvalid, mask, values) -> None:
        """Park one input batch (keys + pre-evaluated agg args), compressed
        to live rows. `values[j]` is a DeviceColumn or None (count(*))."""
        t0 = time.perf_counter()
        live = _host(mask)
        if not live.any():
            return
        if self.value_dtypes is None:
            self.value_dtypes = [None if v is None else v.dtype
                                 for v in values]
        parts = self._partitions(kdata, kvalid)
        kd = [_host(a) for a in kdata]
        kv = [_host(a) for a in kvalid]
        vals = [(_host(v.data), _host(v.validity)) if v is not None
                else None for v in values]
        metrics.spill_seconds.inc(time.perf_counter() - t0, kind="agg",
                                  stage="partition")
        for p in range(self.P):
            rows = np.nonzero(live & (parts == p))[0]
            if not len(rows):
                continue
            blob = {}
            for i, (d, v) in enumerate(zip(kd, kv)):
                blob[f"k{i}_d"], blob[f"k{i}_v"] = d[rows], v[rows]
            for j, dv in enumerate(vals):
                if dv is not None:
                    blob[f"a{j}_d"], blob[f"a{j}_v"] = \
                        dv[0][rows], dv[1][rows]
            self.raw_chunks[p].append(self._save(blob))

    def add_state(self, state) -> None:
        """Park a partial group table (keys + per-agg partial fields)."""
        t0 = time.perf_counter()
        present = _host(state["present"])
        if not present.any():
            return
        parts = self._partitions(state["keys"], state["kvalid"])
        kd = [_host(a) for a in state["keys"]]
        kv = [_host(a) for a in state["kvalid"]]
        partials = [{f: _host(arr) for f, arr in part.items()}
                    for part in state["partials"]]
        metrics.spill_seconds.inc(time.perf_counter() - t0, kind="agg",
                                  stage="partition")
        for p in range(self.P):
            rows = np.nonzero(present & (parts == p))[0]
            if not len(rows):
                continue
            blob = {}
            for i, (d, v) in enumerate(zip(kd, kv)):
                blob[f"k{i}_d"], blob[f"k{i}_v"] = d[rows], v[rows]
            for j, part in enumerate(partials):
                for f, arr in part.items():
                    blob[f"p{j}_{f}"] = arr[rows]
            self.state_chunks[p].append(self._save(blob))

    def _load(self, path: str):
        """-> (the chunk's arrays padded to their bucket as device
        tensors, its row count)."""
        t0 = time.perf_counter()
        with np.load(path) as z:
            n = z["k0_d"].shape[0]
            padded = bucket_length(n)
            out = {}
            for f in z.files:
                a = z[f]
                full = np.zeros((padded,) + a.shape[1:], a.dtype)
                full[:n] = a
                out[f] = torch.from_numpy(full).to(self.device)
        metrics.spill_seconds.inc(time.perf_counter() - t0, kind="agg",
                                  stage="replay")
        return out, n

    def _present(self, n: int, padded: int) -> torch.Tensor:
        return torch.arange(padded, device=self.device) < n

    def iter_raw(self, p: int, nkeys: int, naggs: int):
        """Yield (kdata, kvalid, mask, values) per parked chunk, padded to
        the bucket. values[j] = a DeviceColumn or None."""
        for path in self.raw_chunks[p]:
            z, n = self._load(path)
            kdata = [z[f"k{i}_d"] for i in range(nkeys)]
            kvalid = [z[f"k{i}_v"] for i in range(nkeys)]
            mask = self._present(n, kdata[0].shape[0])
            values = []
            for j in range(naggs):
                if f"a{j}_d" in z:
                    values.append(DeviceColumn(z[f"a{j}_d"], z[f"a{j}_v"],
                                               self.value_dtypes[j]))
                else:
                    values.append(None)
            yield kdata, kvalid, mask, values

    def iter_state(self, p: int, nkeys: int, naggs: int):
        """Yield parked partial states as state dicts (padded)."""
        for path in self.state_chunks[p]:
            z, n = self._load(path)
            keys = [z[f"k{i}_d"] for i in range(nkeys)]
            kvalid = [z[f"k{i}_v"] for i in range(nkeys)]
            partials = []
            for j in range(naggs):
                prefix = f"p{j}_"
                partials.append({f[len(prefix):]: a for f, a in z.items()
                                 if f.startswith(prefix)})
            yield {"keys": keys, "kvalid": kvalid,
                   "present": self._present(n, keys[0].shape[0]),
                   "partials": partials,
                   "n": torch.tensor(n, dtype=torch.int32,
                                     device=self.device)}

    def cleanup(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


class AggOp(Operator):
    """Streaming group-by: per-batch partial agg folded into a device-
    resident group table (colexec/group + mergegroup, re-expressed).

    The group table grows adaptively (quantized x4, as the reference
    grows its hash table); past `max_device_groups` it Grace-spills to
    the host (see _AggSpill).  `use_pallas` is the reference's
    per-call-site routing of float32 grouped sums to the segment-sum
    kernel (vm/compile passes what the reference resolves on its TPU:
    on)."""

    def __init__(self, node: P.Aggregate, child: Operator, ctx,
                 max_groups: int = 4096,
                 max_device_groups: int = 1 << 21,
                 spill_partitions: int = 16,
                 use_pallas: bool = False):
        self.node = node
        self.child = child
        self.ctx = ctx
        self.schema = node.schema
        self.max_groups = self.initial_max_groups = max_groups
        self.max_device_groups = max(max_groups, max_device_groups)
        self.spill_partitions = spill_partitions
        self.use_pallas = use_pallas
        self._spill: Optional[_AggSpill] = None

    def _grow(self, needed: int, allow_spill: bool) -> None:
        nxt = self.max_groups
        while nxt < needed:
            nxt *= 4
        nxt = min(nxt, self.max_device_groups)
        if nxt < needed:
            if allow_spill:
                raise _NeedSpill
            raise EvalError(
                f"group count {needed} exceeds the device budget "
                f"({self.max_device_groups}) even within one spill "
                f"partition; raise spill_partitions ({self.spill_partitions})")
        self.max_groups = nxt

    def execute(self) -> Iterator[ExecBatch]:
        if not self.node.group_keys:
            yield from self._scalar_agg()
            return
        yield from self._grouped_agg()

    # ---- scalar (no GROUP BY)
    def _scalar_agg(self):
        states = [None] * len(self.node.aggs)
        tracker = _AggDictTracker(self.node.aggs)
        for ex in self.child.execute():
            tracker.observe(ex)
            for i, a in enumerate(self.node.aggs):
                states[i] = _scalar_step_host(a, ex, states[i])
        yield self._scalar_result(states, tracker, self.ctx.device)

    def _scalar_result(self, states, tracker, device) -> ExecBatch:
        cols = {}
        out_dicts: Dict[str, list] = {}
        for (name, dtype), a, st in zip(
                self.node.schema[len(self.node.group_keys):],
                self.node.aggs, states):
            col = _scalar_final(a, st, dtype, device)
            d = tracker.dicts.get(a.out_name)
            if d is not None and dtype.is_varlen:
                col = _rank_to_code(col, d, dtype)
                out_dicts[name] = d
            cols[name] = col
        db = DeviceBatch(columns=cols,
                         n_rows=torch.tensor(1, dtype=torch.int32,
                                             device=device))
        return ExecBatch(batch=db, dicts=out_dicts,
                         mask=torch.ones((1,), dtype=torch.bool,
                                         device=device))

    # ---- grouped
    def _grouped_agg(self, seed=None, seed_dicts=None):
        """`seed`/`seed_dicts`: a partial group-table state handed over
        by a fused fragment that had to degrade mid-stream (a key
        dictionary grew); the remaining batches continue on the general
        path with the fused partials already folded in."""
        nkeys = len(self.node.group_keys)
        key_dicts: List[Optional[List[str]]] = \
            list(seed_dicts) if seed_dicts is not None else [None] * nkeys
        if not hasattr(self, "_agg_tracker") or seed is None:
            self._agg_tracker = _AggDictTracker(self.node.aggs)
        try:
            yield from self._grouped_agg_inner(nkeys, key_dicts,
                                               seed=seed)
        finally:
            if self._spill is not None:     # drained, or an exception
                self._spill.cleanup()
                self._spill = None

    def _grouped_agg_inner(self, nkeys, key_dicts, seed=None):
        state = seed   # dict: keys:[tensors], kvalid:[tensors], partials per agg
        dense = None       # small-key dense accumulator (no hash, no sort)
        # a seeded state is already in general form: the dense fast path
        # cannot absorb it, so it stays off for the remaining stream
        dense_checked = seed is not None
        for ex in self.child.execute():
            self._agg_tracker.observe(ex)
            keys = [eval_expr(k, ex) for k in self.node.group_keys]
            for i, (k_ast, k) in enumerate(zip(self.node.group_keys, keys)):
                d = _expr_dict(k_ast, ex)
                if d is not None:
                    key_dicts[i] = d
            kdata = [_broadcast_full(k, ex.padded_len).data for k in keys]
            kvalid = [_broadcast_full(k, ex.padded_len).validity
                      for k in keys]
            values = [None if (a.func == "count" and a.arg is None)
                      else _agg_value(a, ex) for a in self.node.aggs]
            if not dense_checked:
                dense_checked = True
                dense = self._dense_init(ex)
            if dense is not None:
                if self._dense_sizes(ex) == list(dense["sizes"]):
                    self._dense_step(dense, kdata, kvalid, ex.mask, values)
                    continue
                # a key dictionary grew mid-stream (concurrent insert /
                # union arm): the dense key space is stale — convert the
                # partials to a standard group table and continue general
                state = self._dense_to_state(dense)
                dense = None
            metrics.agg_chunks.inc(path="general")
            if self._spill is not None:
                self._spill.add_raw(kdata, kvalid, ex.mask, values)
                continue
            try:
                part = self._partial_vals(kdata, kvalid, ex.mask, values,
                                          allow_spill=True)
                state = part if state is None else \
                    self._merge(state, part, allow_spill=True)
            except _NeedSpill:
                metrics.agg_spills.inc()
                self._spill = _AggSpill(self.spill_partitions, ex.device)
                if state is not None:
                    self._spill.add_state(state)
                    state = None
                self._spill.add_raw(kdata, kvalid, ex.mask, values)
        if dense is not None:
            yield self._finalize(self._dense_to_state(dense), key_dicts)
            return
        if self._spill is None:
            if state is None:
                state = self._empty_state(self.ctx.device)
            yield self._finalize(state, key_dicts)
            return
        # spill drain: each partition has a disjoint key set
        spill = self._spill
        naggs = len(self.node.aggs)
        metrics.spill_partitions.inc(spill.P, kind="agg")
        for p in range(spill.P):
            pstate = None
            for kdata, kvalid, mask, values in spill.iter_raw(
                    p, nkeys, naggs):
                part = self._partial_vals(kdata, kvalid, mask, values,
                                          allow_spill=False)
                pstate = part if pstate is None else \
                    self._merge(pstate, part, allow_spill=False)
            for st in spill.iter_state(p, nkeys, naggs):
                pstate = st if pstate is None else \
                    self._merge(pstate, st, allow_spill=False)
            if pstate is not None and int(pstate["n"]):
                yield self._finalize(pstate, key_dicts)

    # ---- dense small-key fast path (the Q1 shape: GROUP BY two dict-
    # coded columns with additive aggregates). Group ids come from a
    # mixed-radix expansion over the key dictionaries instead of
    # hash+argsort, and the deduplicated partial lanes fold per dtype
    # class (ops/agg.dense_lane_partials: int lanes in one index_add_,
    # float lanes as block sums over the rows sorted by slot); the
    # cross-chunk merge is an elementwise add of (G,)-sized partials —
    # no re-grouping sort.
    def _dense_sizes(self, ex) -> Optional[List[int]]:
        """Per-key dense domain sizes, or None when a key has no bounded
        code space (numeric keys, computed strings without a dict)."""
        sizes = []
        for k in self.node.group_keys:
            d = _expr_dict(k, ex)
            if d is not None:
                sizes.append(max(len(d), 1))
            elif k.dtype.oid == TypeOid.BOOL:
                sizes.append(2)
            else:
                return None
        return sizes

    @staticmethod
    def _dense_fields(a: AggCall) -> List[tuple]:
        """(class, field) layout of one aggregate's partial state —
        shared by the per-chunk step and the state converter so the two
        can never disagree on stack order."""
        if a.func == "count":
            return [("int", "count")]
        if a.func in ("sum", "avg"):
            cls = "float" if a.arg.dtype.is_float else "int"
            return [(cls, "sum"), ("int", "count")]
        return [("float", "sum"), ("float", "sumsq"), ("int", "count")]

    def _dense_init(self, ex) -> Optional[dict]:
        if os.environ.get("MO_DENSE_GROUPS") == "0":
            return None
        dense_funcs = {"count", "sum", "avg"} | STDDEV_AGGS
        for a in self.node.aggs:
            # min/max/bit partials don't merge additively; distinct
            # needs per-group key sets — all take the general path
            if a.distinct or a.func not in dense_funcs:
                return None
        sizes = self._dense_sizes(ex)
        if sizes is None:
            return None
        g = 1
        n_fields = 1
        for s in sizes:
            g *= s + 1
        for a in self.node.aggs:
            n_fields += len(self._dense_fields(a))
        if g > int(os.environ.get("MO_DENSE_GROUPS_MAX", "256")) \
                or g * n_fields > 4096:
            # the engine's cap on the dense table (the reference's
            # bound on its unrolled G x fields reductions)
            return None
        # accumulators live at FULL (NULL-slotted) granularity; all-valid
        # chunks compute in the compact key space and scatter into the
        # matching full slots
        device = self.ctx.device
        partials = []
        for a in self.node.aggs:
            partials.append({f: torch.zeros((g,), dtype=(
                torch.int64 if c == "int" else torch.float64),
                device=device) for c, f in self._dense_fields(a)})
        return {"sizes": tuple(sizes), "partials": partials,
                "rows": torch.zeros((g,), dtype=torch.int64,
                                    device=device)}

    def _dense_step(self, dense, kdata, kvalid, mask, values) -> None:
        metrics.agg_chunks.inc(path="dense")
        # ONE host sync answers every 'no NULLs here?' question for the
        # chunk: all-valid keys shrink the key space (no NULL slots) and
        # all-valid agg args collapse their count field into the shared
        # rows lane
        checks = list(kvalid)
        vidx = {}
        for v in values:
            if v is not None and id(v.validity) not in vidx:
                vidx[id(v.validity)] = len(checks)
                checks.append(v.validity)
        flags = torch.stack([c.all() for c in checks]).cpu().numpy()
        keys_allvalid = bool(flags[:len(kvalid)].all())
        with_null = not keys_allvalid
        # build deduplicated lanes: plain-column agg args share their
        # DeviceColumn object (eval_expr returns the batch column), so
        # sum(l_quantity) and avg(l_quantity) collapse to ONE lane;
        # counts over all-valid args collapse into the rows lane
        int_vals, int_masks, float_vals, float_masks = [], [], [], []
        lane_of = {}                    # dedupe key -> ("int"|"float", idx)
        fieldmap = []                   # per agg: [(field, lane-or-"rows")]
        for a, v in zip(self.node.aggs, values):
            allv = v is None or bool(flags[vidx[id(v.validity)]])
            mkey = "rows" if allv else id(v.validity)
            mval = None if allv else v.validity
            x = None
            fm = []
            for cls, field in self._dense_fields(a):
                if field == "count" and mkey == "rows":
                    fm.append((field, "rows"))
                    continue
                if cls == "float" and field != "count" \
                        and a.func in STDDEV_AGGS and x is None:
                    x = _float_of(v)
                val = (None if field == "count"
                       else x * x if field == "sumsq"
                       else x if x is not None else v.data)
                key = (cls, field == "sumsq",
                       None if field == "count" else id(v.data), mkey)
                lane = lane_of.get(key)
                if lane is None:
                    if cls == "int":
                        lane = ("int", len(int_vals))
                        int_vals.append(val)
                        int_masks.append(mval)
                    else:
                        lane = ("float", len(float_vals))
                        float_vals.append(val)
                        float_masks.append(mval)
                    lane_of[key] = lane
                fm.append((field, lane))
            fieldmap.append(fm)
        ints, floats, rows = A.dense_lane_partials(
            kdata, kvalid, mask, int_vals, int_masks, float_vals,
            float_masks, sizes=dense["sizes"], with_null=with_null)
        # scatter the chunk's compact-space results into the full-space
        # accumulators (identity when the chunk used NULL slots)
        pos = self._dense_positions(dense, with_null)
        for fm, part in zip(fieldmap, dense["partials"]):
            for field, lane in fm:
                add = (rows if lane == "rows"
                       else ints[lane[1]] if lane[0] == "int"
                       else floats[lane[1]])
                part[field].index_add_(0, pos, add.to(part[field].dtype))
        dense["rows"].index_add_(0, pos, rows)

    def _dense_positions(self, dense, with_null: bool) -> torch.Tensor:
        """Full-space slot of each compact-space slot (cached)."""
        key = ("pos", with_null)
        pos = dense.get(key)
        if pos is None:
            sizes = dense["sizes"]
            strides_c, g_eff = A.dense_slot_strides(
                sizes, null_slots=with_null)
            strides_f, _g_full = A.dense_slot_strides(sizes)
            pos = np.zeros(g_eff, np.int64)
            for slot in range(g_eff):
                full, rem = 0, slot
                for stc, stf in zip(strides_c, strides_f):
                    digit = rem // stc
                    rem = rem % stc
                    full += digit * stf
                pos[slot] = full
            pos = torch.from_numpy(pos).to(dense["rows"].device)
            dense[key] = pos
        return pos

    def _dense_to_state(self, dense) -> dict:
        """Dense accumulator -> the standard state dict. `present` is
        scattered over the G slots (not front-packed); every consumer —
        _merge's re-group, _finalize's output mask, the session's
        mask-compacting host copy — works off the mask, so that's
        fine."""
        sizes = dense["sizes"]
        strides, g = A.dense_slot_strides(sizes)
        present = dense["rows"] > 0
        slots = torch.arange(g, dtype=torch.int32, device=present.device)
        keys, kvalid = [], []
        for k_ast, s, st in zip(self.node.group_keys, sizes, strides):
            code = torch.div(slots, st, rounding_mode="floor") % (s + 1)
            keys.append(code.to(torch.int32 if k_ast.dtype.is_varlen
                                else k_ast.dtype.torch_dtype))
            kvalid.append(code < s)
        n = present.to(torch.int32).sum().to(torch.int32)
        return {"keys": keys, "kvalid": kvalid, "present": present,
                "partials": [dict(p) for p in dense["partials"]],
                "n": n}

    def _partial_vals(self, kdata, kvalid, mask, values,
                      allow_spill: bool = False):
        while True:
            mg = self.max_groups
            gi = A.group_ids(kdata, kvalid, mask, mg)
            ng = int(gi.num_groups)
            if ng <= mg:
                break
            self._grow(ng, allow_spill)
        rep_k, rep_v = A.gather_keys(kdata, kvalid, gi.rep_rows)
        present = torch.arange(mg, dtype=torch.int32,
                               device=mask.device) < gi.num_groups
        partials = []
        for a, v in zip(self.node.aggs, values):
            partials.append(_grouped_step(a, gi, v, mask, mg,
                                          use_pallas=self.use_pallas))
        return {"keys": rep_k, "kvalid": rep_v, "present": present,
                "partials": partials, "n": gi.num_groups}

    def _merge(self, s1, s2, allow_spill: bool = False):
        """Merge two partial group tables by concatenating their rows and
        re-grouping (mergegroup)."""
        keys = [torch.cat([a, b]) for a, b in zip(s1["keys"], s2["keys"])]
        kvalid = [torch.cat([a, b])
                  for a, b in zip(s1["kvalid"], s2["kvalid"])]
        mask = torch.cat([s1["present"], s2["present"]])
        while True:
            mg = self.max_groups
            gi = A.group_ids(keys, kvalid, mask, mg)
            ng = int(gi.num_groups)
            if ng <= mg:
                break
            self._grow(ng, allow_spill)
        rep_k, rep_v = A.gather_keys(keys, kvalid, gi.rep_rows)
        present = torch.arange(mg, dtype=torch.int32,
                               device=mask.device) < gi.num_groups
        partials = []
        for a, p1, p2 in zip(self.node.aggs, s1["partials"], s2["partials"]):
            partials.append(_grouped_merge(a, p1, p2, gi, mask, mg))
        return {"keys": rep_k, "kvalid": rep_v, "present": present,
                "partials": partials, "n": gi.num_groups}

    def _empty_state(self, device):
        mg = self.max_groups
        keys, kvalid = [], []
        for k in self.node.group_keys:
            keys.append(torch.zeros((mg,), dtype=(
                torch.int32 if k.dtype.is_varlen else k.dtype.torch_dtype),
                device=device))
            kvalid.append(torch.zeros((mg,), dtype=torch.bool,
                                      device=device))
        partials = [_grouped_empty(a, mg, device) for a in self.node.aggs]
        return {"keys": keys, "kvalid": kvalid,
                "present": torch.zeros((mg,), dtype=torch.bool,
                                       device=device),
                "partials": partials,
                "n": torch.tensor(0, dtype=torch.int32, device=device)}

    def _finalize(self, state, key_dicts) -> ExecBatch:
        nkeys = len(self.node.group_keys)
        cols: Dict[str, DeviceColumn] = {}
        dicts: Dict[str, List[str]] = {}
        for i, ((name, dtype), k) in enumerate(zip(self.node.schema[:nkeys],
                                                   self.node.group_keys)):
            cols[name] = DeviceColumn(state["keys"][i], state["kvalid"][i],
                                      k.dtype)
            if key_dicts[i] is not None:
                dicts[name] = key_dicts[i]
        for (name, dtype), a, part in zip(self.node.schema[nkeys:],
                                          self.node.aggs, state["partials"]):
            col = _grouped_final(a, part, dtype)
            d = self._agg_tracker.dicts.get(a.out_name)
            if d is not None and dtype.is_varlen:
                col = _rank_to_code(col, d, dtype)
                dicts[name] = d
            cols[name] = col
        db = DeviceBatch(columns=cols, n_rows=state["n"])
        return ExecBatch(batch=db, dicts=dicts, mask=state["present"])

    # ---- cross-shard partials (parallel/dist_query.py shard executor)
    def partial_state(self, seed=None, seed_dicts=None):
        """The grouped accumulation loop stopped BEFORE finalize: the raw
        partial group table for a cross-shard merge.  The dense fast
        path stays live (its partials add across shards).  -> (kind,
        payload, key_dicts, tracker):

          kind "dense"   -> payload = the dense accumulator dict
          kind "general" -> payload = the state dict (keys/kvalid/
                            present/partials/n), max_groups rows
          kind "empty"   -> payload None (this shard saw no rows)

        Spill is off: a shard whose group table outgrows the device
        budget raises ShardDegrade (the statement runs on one device,
        where it may spill).  `seed`/`seed_dicts` continue a fused
        fragment's partials that had to leave the dense path."""
        nkeys = len(self.node.group_keys)
        key_dicts: List[Optional[list]] = \
            list(seed_dicts) if seed_dicts is not None else [None] * nkeys
        tracker = _AggDictTracker(self.node.aggs)
        state = seed
        dense = None
        dense_checked = seed is not None
        for ex in self.child.execute():
            tracker.observe(ex)
            keys = [eval_expr(k, ex) for k in self.node.group_keys]
            for i, k_ast in enumerate(self.node.group_keys):
                d = _expr_dict(k_ast, ex)
                if d is not None:
                    key_dicts[i] = d
            kdata = [_broadcast_full(k, ex.padded_len).data for k in keys]
            kvalid = [_broadcast_full(k, ex.padded_len).validity
                      for k in keys]
            values = [None if (a.func == "count" and a.arg is None)
                      else _agg_value(a, ex) for a in self.node.aggs]
            if not dense_checked:
                dense_checked = True
                dense = self._dense_init(ex)
            if dense is not None:
                if self._dense_sizes(ex) == list(dense["sizes"]):
                    self._dense_step(dense, kdata, kvalid, ex.mask, values)
                    continue
                state = self._dense_to_state(dense)
                dense = None
            metrics.agg_chunks.inc(path="general")
            try:
                part = self._partial_vals(kdata, kvalid, ex.mask, values,
                                          allow_spill=True)
                state = part if state is None else \
                    self._merge(state, part, allow_spill=True)
            except _NeedSpill:
                from matrixone_tpu_torch.parallel.merge_exec import \
                    ShardDegrade
                raise ShardDegrade(
                    f"a shard's group table outgrew the device budget "
                    f"({self.max_device_groups} groups)") from None
        if dense is not None:
            return "dense", dense, key_dicts, tracker
        if state is not None:
            return "general", state, key_dicts, tracker
        return "empty", None, key_dicts, tracker

    def partial_scalar_state(self):
        """Scalar (no GROUP BY) counterpart of partial_state: the per-
        aggregate partial tuples and the string-dictionary tracker."""
        states = [None] * len(self.node.aggs)
        tracker = _AggDictTracker(self.node.aggs)
        for ex in self.child.execute():
            tracker.observe(ex)
            for i, a in enumerate(self.node.aggs):
                states[i] = _scalar_step_host(a, ex, states[i])
        return states, tracker


def _broadcast_full(col: DeviceColumn, n: int) -> DeviceColumn:
    if col.data.shape[0] == n:
        return col
    return DeviceColumn(col.data.expand((n,) + tuple(col.data.shape[1:])),
                        col.validity.expand(n), col.dtype)


# agg kernels: per-batch partial, merge, finalize -------------------------

def _agg_value(a: AggCall, ex: ExecBatch):
    if a.func in ("min", "max") and a.arg.dtype.is_varlen:
        # aggregate over collation ranks so min/max follow string order,
        # not dictionary insertion order; finalize maps rank -> string
        if _expr_dict(a.arg, ex) is None:
            raise EvalError(
                f"{a.func}() over computed strings without a dictionary "
                f"is not supported yet")
        return _broadcast_full(_sort_key_col(a.arg, ex), ex.padded_len)
    col = eval_expr(a.arg, ex)
    return _broadcast_full(col, ex.padded_len)


def _rank_to_code(col: DeviceColumn, d: list, dtype) -> DeviceColumn:
    """Invert collation rank back to a dictionary code (string min/max
    finalize; shared by the scalar and grouped paths)."""
    order = np.argsort(np.asarray(d, dtype=object)).astype(np.int32)
    return DeviceColumn(lut_gather(order, col.data), col.validity, dtype)


class _AggDictTracker:
    """Captures the dictionary behind each string min/max argument and
    REJECTS mid-stream growth: collation ranks are only comparable across
    batches when the dictionary is frozen."""

    def __init__(self, aggs):
        self.watch = [a for a in aggs
                      if a.func in ("min", "max") and a.arg is not None
                      and a.arg.dtype.is_varlen]
        self.dicts: Dict[str, list] = {}
        self._sizes: Dict[str, int] = {}

    def observe(self, ex: ExecBatch):
        for a in self.watch:
            d = _expr_dict(a.arg, ex)
            if d is None:
                continue
            prev = self.dicts.get(a.out_name)
            if prev is None:
                self.dicts[a.out_name] = d
                self._sizes[a.out_name] = len(d)
            elif prev is not d or len(d) != self._sizes[a.out_name]:
                raise EvalError(
                    f"{a.func}() over strings from a growing dictionary "
                    f"(union / multi-source) is not supported yet")


_BIT_IDENT = {"bit_and": -1, "bit_or": 0, "bit_xor": 0}
_BIT_UFUNC = {"bit_and": np.bitwise_and, "bit_or": np.bitwise_or,
              "bit_xor": np.bitwise_xor}


def _host_bit_reduce(func: str, data, gids, mask, mg: int):
    """Grouped bitwise reduce on the host: no segment and/or/xor exists
    on the device, and the identity values make ufunc.at both exact and
    merge-transparent."""
    d = data.cpu().numpy().astype(np.int64)
    g = gids.cpu().numpy()
    m = mask.cpu().numpy()
    out = np.full(mg, _BIT_IDENT[func], np.int64)
    _BIT_UFUNC[func].at(out, g[m], d[m])
    return torch.from_numpy(out).to(data.device)


def _grouped_step(a: AggCall, gi, col: Optional[DeviceColumn],
                  row_mask, mg: int, use_pallas: bool = False):
    """Per-batch partial for one aggregate over PRE-EVALUATED values
    (col = _agg_value(...); None for count(*))."""
    if a.func == "count" and a.arg is None:
        return {"count": A.seg_count(gi.gids, row_mask, mg)}
    m = row_mask & col.validity
    if a.func == "count":
        return {"count": A.seg_count(gi.gids, m, mg)}
    if a.func == "sum":
        return {"sum": A.seg_sum(col.data, gi.gids, m, mg,
                                 use_pallas=use_pallas),
                "count": A.seg_count(gi.gids, m, mg)}
    if a.func == "avg":
        return {"sum": A.seg_sum(col.data.to(torch.float64)
                                 if col.dtype.is_float else col.data,
                                 gi.gids, m, mg),
                "count": A.seg_count(gi.gids, m, mg)}
    if a.func == "min":
        return {"min": A.seg_min(col.data, gi.gids, m, mg),
                "count": A.seg_count(gi.gids, m, mg)}
    if a.func == "max":
        return {"max": A.seg_max(col.data, gi.gids, m, mg),
                "count": A.seg_count(gi.gids, m, mg)}
    if a.func in STDDEV_AGGS:
        x = _float_of(col)
        return {"sum": A.seg_sum(x, gi.gids, m, mg),
                "sumsq": A.seg_sum(x * x, gi.gids, m, mg),
                "count": A.seg_count(gi.gids, m, mg)}
    if a.func in BIT_AGGS:
        return {"bits": _host_bit_reduce(a.func, col.data, gi.gids, m,
                                         mg),
                "count": A.seg_count(gi.gids, m, mg)}
    raise EvalError(f"unsupported aggregate {a.func}")


def _float_of(col: DeviceColumn):
    x = col.data.to(torch.float64)
    if col.dtype.oid == TypeOid.DECIMAL64:
        x = S.div_by(x, 10.0 ** col.dtype.scale)
    return x


def _grouped_merge(a: AggCall, p1, p2, gi, mask, mg: int):
    out = {}
    for field in p1:
        vals = torch.cat([p1[field], p2[field]])
        if field in ("sum", "count", "sumsq"):
            out[field] = A.seg_sum(vals, gi.gids, mask, mg)
        elif field == "min":
            out[field] = A.seg_min(vals, gi.gids, mask, mg)
        elif field == "max":
            out[field] = A.seg_max(vals, gi.gids, mask, mg)
        elif field == "bits":
            out[field] = _host_bit_reduce(a.func, vals, gi.gids, mask, mg)
    return out


def _grouped_empty(a: AggCall, mg: int, device):
    def zeros(t):
        return torch.zeros((mg,), dtype=t, device=device)
    z64 = zeros(torch.int64)
    if a.func == "count":
        return {"count": z64}
    vt = a.arg.dtype.torch_dtype
    if a.func == "sum":
        return {"sum": zeros(vt if a.arg.dtype.is_float else torch.int64),
                "count": z64}
    if a.func == "avg":
        return {"sum": zeros(torch.float64 if a.arg.dtype.is_float
                             else torch.int64), "count": z64}
    if a.func in ("min", "max"):
        return {a.func: zeros(vt), "count": z64}
    if a.func in STDDEV_AGGS:
        zf = zeros(torch.float64)
        return {"sum": zf, "sumsq": zf, "count": z64}
    if a.func in BIT_AGGS:
        return {"bits": torch.full((mg,), _BIT_IDENT[a.func],
                                   dtype=torch.int64, device=device),
                "count": z64}
    raise EvalError(a.func)


def _grouped_final(a: AggCall, part, dtype: DType) -> DeviceColumn:
    valid = part["count"] > 0
    if a.func == "count":
        return DeviceColumn(part["count"], torch.ones_like(valid), dt.INT64)
    if a.func == "sum":
        s = part["sum"]
        if dtype.oid == TypeOid.DECIMAL64:
            s = s.to(torch.int64)
        return DeviceColumn(s.to(dtype.torch_dtype), valid, dtype)
    if a.func == "avg":
        s = part["sum"].to(torch.float64)
        if a.arg.dtype.oid == TypeOid.DECIMAL64:
            s = S.div_by(s, 10.0 ** a.arg.dtype.scale)
        c = torch.clamp(part["count"], min=1).to(torch.float64)
        return DeviceColumn(s / c, valid, dt.FLOAT64)
    if a.func in ("min", "max"):
        return DeviceColumn(part[a.func], valid, dtype)
    if a.func in STDDEV_AGGS:
        c = part["count"].to(torch.float64)
        mean = part["sum"] / torch.clamp(c, min=1.0)
        var_pop = torch.clamp(
            part["sumsq"] / torch.clamp(c, min=1.0) - mean * mean, min=0.0)
        if a.func in ("stddev_samp", "var_samp"):
            var = var_pop * c / torch.clamp(c - 1.0, min=1.0)
            ok = part["count"] > 1
        else:
            var = var_pop
            ok = part["count"] > 0
        out = var if a.func in ("variance", "var_pop", "var_samp") \
            else torch.sqrt(var)
        return DeviceColumn(out, ok, dt.FLOAT64)
    if a.func in BIT_AGGS:
        # MySQL: the neutral value, never NULL
        return DeviceColumn(part["bits"].to(torch.uint64),
                            torch.ones_like(valid), dt.UINT64)
    raise EvalError(a.func)


def _scalar_step_host(a: AggCall, ex: ExecBatch, state):
    """Per-batch scalar partial including the host-side families
    (bitwise aggregates reduce via numpy ufuncs)."""
    if a.func in BIT_AGGS:
        col = _agg_value(a, ex)
        m = ex.mask & col.validity
        d = col.data.cpu().numpy().astype(np.int64)
        mm = m.cpu().numpy()
        v = _BIT_UFUNC[a.func].reduce(d[mm]) if mm.any() \
            else _BIT_IDENT[a.func]
        c = A.scalar_count(m)
        if state is None:
            return (torch.tensor(int(v), dtype=torch.int64,
                                 device=ex.device), c)
        merged = _BIT_UFUNC[a.func](np.int64(state[0].item()), np.int64(v))
        return (torch.tensor(int(merged), dtype=torch.int64,
                             device=ex.device), state[1] + c)
    return _scalar_step(a, ex, state)


def _scalar_step(a: AggCall, ex: ExecBatch, state):
    if a.func == "count" and a.arg is None:
        v = A.scalar_count(ex.mask)
        return v if state is None else state + v
    col = _agg_value(a, ex)
    m = ex.mask & col.validity
    if a.func == "count":
        v = A.scalar_count(m)
        return v if state is None else state + v
    if a.func in ("sum", "avg"):
        s = A.scalar_sum(col.data.to(torch.float64)
                         if (a.func == "avg" and col.dtype.is_float)
                         else col.data, m)
        c = A.scalar_count(m)
        if state is None:
            return (s, c)
        return (state[0] + s, state[1] + c)
    if a.func == "min":
        v = A.scalar_min(col.data, m)
        c = A.scalar_count(m)
        return (v, c) if state is None else (torch.minimum(state[0], v),
                                             state[1] + c)
    if a.func == "max":
        v = A.scalar_max(col.data, m)
        c = A.scalar_count(m)
        return (v, c) if state is None else (torch.maximum(state[0], v),
                                             state[1] + c)
    if a.func in STDDEV_AGGS:
        x = _float_of(col)
        s = A.scalar_sum(x, m)
        s2 = A.scalar_sum(x * x, m)
        c = A.scalar_count(m)
        if state is None:
            return (s, s2, c)
        return (state[0] + s, state[1] + s2, state[2] + c)
    raise EvalError(a.func)


def _scalar_final(a: AggCall, state, dtype: DType, device) -> DeviceColumn:
    one = torch.ones((1,), dtype=torch.bool, device=device)
    if a.func == "count":
        v = (torch.zeros((), dtype=torch.int64, device=device)
             if state is None else state)
        return DeviceColumn(v[None].to(torch.int64), one, dt.INT64)
    if a.func in BIT_AGGS:
        v = (torch.tensor(_BIT_IDENT[a.func], dtype=torch.int64,
                          device=device) if state is None else state[0])
        return DeviceColumn(v[None].to(torch.uint64), one, dt.UINT64)
    if a.func in STDDEV_AGGS:
        if state is None:
            return DeviceColumn.const_null(dt.FLOAT64, device)
        s, s2, c = state
        cf = torch.clamp(c.to(torch.float64), min=1.0)
        mean = s / cf
        var_pop = torch.clamp(s2 / cf - mean * mean, min=0.0)
        if a.func in ("stddev_samp", "var_samp"):
            var = var_pop * cf / torch.clamp(cf - 1.0, min=1.0)
            ok = c > 1
        else:
            var = var_pop
            ok = c > 0
        out = var if a.func in ("variance", "var_pop", "var_samp") \
            else torch.sqrt(var)
        return DeviceColumn(out[None], ok[None], dt.FLOAT64)
    if state is None:
        return DeviceColumn.const_null(dtype, device)
    if a.func == "sum":
        s, c = state
        return DeviceColumn(s[None].to(dtype.torch_dtype), (c > 0)[None],
                            dtype)
    if a.func == "avg":
        s, c = state
        sf = s.to(torch.float64)
        if a.arg.dtype.oid == TypeOid.DECIMAL64:
            sf = S.div_by(sf, 10.0 ** a.arg.dtype.scale)
        return DeviceColumn((sf / torch.clamp(c, min=1))[None],
                            (c > 0)[None], dt.FLOAT64)
    v, c = state
    return DeviceColumn(v[None], (c > 0)[None], dtype)


# ------------------------------------------------------------------ union

class UnionOp(Operator):
    """UNION ALL: stream children, renaming to the union schema and
    re-encoding string columns into one dictionary for the whole union
    (children's dictionaries are per-table and must not collide).  The
    dictionary starts empty on every execution."""

    def __init__(self, node: P.Union, children: List[Operator]):
        self.node = node
        self.children = children
        self.schema = node.schema
        self._union_dicts: Dict[str, List[str]] = {}
        self._union_lut: Dict[str, Dict[str, int]] = {}

    def _remap_strings(self, name: str, col: DeviceColumn, src_dict):
        d = self._union_dicts.setdefault(name, [])
        lut = self._union_lut.setdefault(name, {})
        remap = np.empty(max(len(src_dict), 1), np.int32)
        for i, s_ in enumerate(src_dict):
            if s_ not in lut:
                lut[s_] = len(d)
                d.append(s_)
            remap[i] = lut[s_]
        return lut_gather(remap, col.data)

    def execute(self) -> Iterator[ExecBatch]:
        self._union_dicts = {}
        self._union_lut = {}
        for child in self.children:
            child_names = [n for n, _ in child.schema]
            for ex in child.execute():
                cols = {}
                for cn, (out_name, out_t) in zip(child_names, self.schema):
                    col = ex.batch.columns[cn]
                    if out_t.is_varlen:
                        src = ex.dicts.get(cn, [])
                        col = DeviceColumn(
                            self._remap_strings(out_name, col, src),
                            col.validity, out_t)
                    elif col.dtype.torch_dtype != out_t.torch_dtype \
                            and out_t.is_numeric:
                        col = S.cast(col, out_t)
                    cols[out_name] = col
                db = DeviceBatch(columns=cols, n_rows=ex.batch.n_rows)
                yield ExecBatch(batch=db, dicts=dict(self._union_dicts),
                                mask=ex.mask)


# ------------------------------------------------------------- sort / topk

def _sort_key_col(expr: BoundExpr, ex: ExecBatch) -> DeviceColumn:
    """Evaluate an ORDER BY key; dictionary-coded strings are translated
    code -> collation rank so the sort follows string order, not insertion
    order of the dictionary."""
    col = _broadcast_full(eval_expr(expr, ex), ex.padded_len)
    d = _expr_dict(expr, ex)
    if d is not None and col.dtype.is_varlen:
        ranks = np.empty(len(d), dtype=np.int32)
        ranks[np.argsort(np.asarray(d, dtype=object))] = np.arange(len(d))
        return DeviceColumn(lut_gather(ranks, col.data), col.validity,
                            dt.INT32)
    return col


def _concat_batches(batches: List[ExecBatch], schema) -> ExecBatch:
    if len(batches) == 1:
        return batches[0]
    names = [n for n, _ in schema]
    cols = {}
    for n in names:
        datas, valids = [], []
        for ex in batches:
            c = _broadcast_full(ex.batch.columns[n], ex.padded_len)
            datas.append(c.data)
            valids.append(c.validity)
        first = batches[0].batch.columns[n]
        cols[n] = DeviceColumn(torch.cat(datas), torch.cat(valids),
                               first.dtype)
    mask = torch.cat([ex.mask for ex in batches])
    n_rows = torch.stack([ex.batch.n_rows for ex in batches]).sum()
    dicts = {}
    for ex in batches:
        dicts.update(ex.dicts)
    db = DeviceBatch(columns=cols, n_rows=n_rows.to(torch.int32))
    return ExecBatch(batch=db, dicts=dicts, mask=mask)


class SortOp(Operator):
    def __init__(self, node: P.Sort, child: Operator):
        self.node = node
        self.child = child
        self.schema = node.schema

    def execute(self) -> Iterator[ExecBatch]:
        batches = list(self.child.execute())
        if not batches:
            return
        ex = _concat_batches(batches, self.schema)
        cols = [_sort_key_col(k, ex) for k in self.node.keys]
        order = msort.sort_indices([c.data for c in cols],
                                   [c.validity for c in cols],
                                   self.node.descendings, ex.mask)
        n_out = ex.mask.to(torch.int32).sum()
        out = F.gather(ex.batch, order, n_out)
        yield ExecBatch(batch=out, dicts=ex.dicts, mask=out.row_mask())


class TopKOp(Operator):
    def __init__(self, node: P.TopK, child: Operator):
        self.node = node
        self.child = child
        self.schema = node.schema

    def execute(self) -> Iterator[ExecBatch]:
        batches = list(self.child.execute())
        if not batches:
            return
        ex = _concat_batches(batches, self.schema)
        want = self.node.k + self.node.offset
        if len(self.node.keys) == 1:
            key = _sort_key_col(self.node.keys[0], ex)
            k = min(want, ex.padded_len)
            idx, count = msort.top_k_indices(key.data, key.validity,
                                             self.node.descendings[0],
                                             ex.mask, k)
            out = F.gather(ex.batch, idx, torch.clamp(count, max=k))
            ex2 = ExecBatch(batch=out, dicts=ex.dicts, mask=out.row_mask())
            # top_k gives the right SET; restore exact ORDER via sort of k rows
            key2 = _sort_key_col(self.node.keys[0], ex2)
            order = msort.sort_indices([key2.data], [key2.validity],
                                       [self.node.descendings[0]], ex2.mask)
            out2 = F.gather(ex2.batch, order, out.n_rows)
        else:
            cols = [_sort_key_col(kx, ex) for kx in self.node.keys]
            order = msort.sort_indices([c.data for c in cols],
                                       [c.validity for c in cols],
                                       self.node.descendings, ex.mask)
            n_out = torch.clamp(ex.mask.to(torch.int32).sum(), max=want)
            out2 = F.gather(ex.batch, order[:max(bucket_length(want), 1)],
                            n_out)
        if self.node.offset:
            out2 = _apply_offset(out2, self.node.offset, self.node.k)
        yield ExecBatch(batch=out2, dicts=ex.dicts, mask=out2.row_mask())


def _apply_offset(db: DeviceBatch, offset: int, k: Optional[int]) -> DeviceBatch:
    n = db.padded_len
    device = db.n_rows.device
    idx = torch.clamp(torch.arange(n, device=device) + offset, 0, n - 1)
    remaining = torch.clamp(db.n_rows - offset, min=0)
    if k is not None:
        remaining = torch.clamp(remaining, max=k)
    return F.gather(db, idx, remaining)


class UdfAggregateOp(Operator):
    """Whole-relation aggregate UDFs (plan.UdfAggregate): every call's
    argument columns compacted on the host (the batch mask AND every
    argument's validity: a row with a NULL argument is skipped, as the
    builtin aggregates skip NULLs), then each body run ONCE over the
    concatenated arrays.  One output row."""

    def __init__(self, node: P.UdfAggregate, child: Operator, device):
        self.node = node
        self.child = child
        self.schema = node.schema
        self.device = device

    def execute(self) -> Iterator[ExecBatch]:
        from matrixone_tpu_torch.udf.executor import (_broadcast,
                                                      eval_udf_aggregate)
        parts: List[List[list]] = [[[] for _ in c.args]
                                   for c in self.node.calls]
        for ex in self.child.execute():
            n = ex.padded_len
            for ci, call in enumerate(self.node.calls):
                cols = [eval_expr(a, ex) for a in call.args]
                keep = ex.mask
                datas = []
                for col in cols:
                    datas.append(_broadcast(col.data, n))
                    keep = keep & _broadcast(col.validity, n)
                for ai, d in enumerate(datas):
                    arr = d[keep].cpu().numpy()
                    if len(arr):
                        parts[ci][ai].append(arr)
        cols_out: Dict[str, DeviceColumn] = {}
        for ci, call in enumerate(self.node.calls):
            arrays = [np.concatenate(p) if p
                      else np.zeros(0, call.arg_types[ai].np_dtype)
                      for ai, p in enumerate(parts[ci])]
            v = eval_udf_aggregate(call, arrays, device=self.device)
            name, dtype = self.schema[ci]
            cols_out[name] = (
                DeviceColumn.const_null(dtype, self.device) if v is None
                else DeviceColumn.const(v, dtype, self.device))
        db = DeviceBatch(columns=cols_out,
                         n_rows=torch.tensor(1, dtype=torch.int32,
                                             device=self.device))
        yield ExecBatch(batch=db, dicts={},
                        mask=torch.ones((1,), dtype=torch.bool,
                                        device=self.device))


class SampleOp(Operator):
    """Random sampling (reference: colexec/sample).  PERCENT is a
    streaming per-row Bernoulli mask; N ROWS is a single-pass reservoir
    expressed as top-N over per-row random keys.  The keys are drawn on
    the host, `np.random.default_rng(node.seed).random(padded_len,
    float32)` per batch, as the reference draws them, so a sample
    depends on the padded batch lengths (`bucket_length`)."""

    def __init__(self, node: P.Sample, child: Operator):
        self.node = node
        self.child = child
        self.schema = node.schema

    def execute(self) -> Iterator[ExecBatch]:
        rng = np.random.default_rng(self.node.seed)
        if self.node.percent is not None:
            p = self.node.percent / 100.0
            for ex in self.child.execute():
                u = torch.from_numpy(rng.random(ex.padded_len,
                                                dtype=np.float32))
                ex.mask = ex.mask & (u.to(ex.device) < p)
                yield ex
            return
        n = self.node.n_rows
        schema_k = list(self.schema) + [("__sample_key", dt.FLOAT32)]
        winners = None        # running k-row reservoir: O(k + batch) device
        for ex in self.child.execute():
            u = torch.from_numpy(rng.random(ex.padded_len,
                                            dtype=np.float32)).to(ex.device)
            key = torch.where(ex.mask, u, float("inf"))
            ex.batch.columns["__sample_key"] = DeviceColumn(
                key, torch.ones_like(ex.mask), dt.FLOAT32)
            merged = ex if winners is None else _concat_batches(
                [winners, ex], schema_k)
            key = merged.batch.columns["__sample_key"]
            k = min(n, merged.padded_len)
            idx, count = msort.top_k_indices(key.data, key.validity, False,
                                             merged.mask, k)
            out = F.gather(merged.batch, idx, torch.clamp(count, max=k))
            winners = ExecBatch(batch=out, dicts=dict(merged.dicts),
                                mask=out.row_mask())
        if winners is None:
            return
        del winners.batch.columns["__sample_key"]
        yield winners


class FillOp(Operator):
    """Null-fill of grouped output (reference: colexec/fill), on the
    host in numpy: materializes the (small, post-aggregate) child,
    orders rows by the first group key, and fills NULLs in non-key
    columns: PREV carries the last non-null value forward, LINEAR
    interpolates between the surrounding non-null values on the order
    axis, VALUE writes a constant."""

    def __init__(self, node: P.Fill, child: Operator):
        self.node = node
        self.child = child
        self.schema = node.schema

    def execute(self) -> Iterator[ExecBatch]:
        batches = list(self.child.execute())
        if not batches:
            return
        ex = _concat_batches(batches, self.schema)
        mask = ex.mask.cpu().numpy()
        host, val = {}, {}
        for name, _dtype in self.schema:
            c = _broadcast_full(ex.batch.columns[name], ex.padded_len)
            host[name] = c.data.cpu().numpy()[mask]
            val[name] = c.validity.cpu().numpy()[mask]
        ocol = self.node.order_col
        if dict(self.schema)[ocol].is_varlen:
            # order by decoded strings, not dict codes (insertion order)
            d = ex.dicts.get(ocol, [])
            decoded = np.array([d[c] if 0 <= c < len(d) else ""
                                for c in host[ocol]], dtype=object)
            order = np.argsort(decoded, kind="stable")
            # LINEAR has no numeric axis over strings: use row positions
            x = np.arange(len(order), dtype=np.float64)
        else:
            order = np.argsort(host[ocol], kind="stable")
            x = host[ocol][order].astype(np.float64)
        keyset = set(self.node.key_cols)
        for name, dtype in self.schema:
            a = host[name][order].copy()
            v = val[name][order].copy()
            if name not in keyset and (~v).any():
                a, v = self._fill(dtype, a, v, x)
            host[name] = a
            val[name] = v
        dtypes = {n: (dt.INT32 if d.is_varlen else d)
                  for n, d in self.schema}
        db = dev.from_numpy(host, dtypes, val, n_rows=len(order),
                            device=ex.device)
        for name, dtype in self.schema:
            if dtype.is_varlen:
                c = db.columns[name]
                db.columns[name] = DeviceColumn(c.data, c.validity, dtype)
        yield ExecBatch(batch=db, dicts=dict(ex.dicts), mask=db.row_mask())

    def _fill(self, dtype, a, v, x):
        miss = ~v
        if self.node.mode == "value":
            if dtype.is_varlen:
                raise EvalError("FILL(VALUE) on string column")
            cv = self.node.const
            if dtype.oid == TypeOid.DECIMAL64:
                cv = round(cv * 10 ** dtype.scale)
            a[miss] = np.asarray(cv).astype(a.dtype)
            v[:] = True
        elif self.node.mode == "prev":
            idx = np.maximum.accumulate(np.where(v, np.arange(len(a)), -1))
            ok = idx >= 0
            a[ok] = a[np.maximum(idx[ok], 0)]
            v = ok
        elif self.node.mode == "linear":
            if dtype.is_varlen:
                raise EvalError("FILL(LINEAR) on string column")
            good = np.nonzero(v)[0]
            if len(good) >= 2:
                # outside the known range np.interp clamps — FILL(LINEAR)'s
                # edge-hold behavior
                interp = np.interp(x, x[good], a[good].astype(np.float64))
                a[miss] = interp[miss].astype(a.dtype)
                v = np.ones_like(v)
        return a, v


class LimitOp(Operator):
    def __init__(self, node: P.Limit, child: Operator):
        self.node = node
        self.child = child
        self.schema = node.schema

    def execute(self) -> Iterator[ExecBatch]:
        seen = 0
        off = self.node.offset
        n = self.node.n
        for ex in self.child.execute():
            rank = torch.cumsum(ex.mask.to(torch.int64), 0) + seen
            keep = ex.mask
            if off:
                keep = keep & (rank > off)
            if n is not None:
                keep = keep & (rank <= off + n)
            seen += int(ex.mask.to(torch.int64).sum())
            ex.mask = keep
            yield ex
            if n is not None and seen >= off + n:
                return


class DistinctOp(Operator):
    """SELECT DISTINCT / the dedup under COUNT(DISTINCT): one row per
    group of the whole row, by the aggregate's group ids."""

    def __init__(self, node: P.Distinct, child: Operator,
                 max_groups: int = 65536):
        self.node = node
        self.child = child
        self.schema = node.schema
        self.max_groups = max_groups

    def execute(self) -> Iterator[ExecBatch]:
        batches = list(self.child.execute())
        if not batches:
            return
        ex = _concat_batches(batches, self.schema)
        cols = [_broadcast_full(ex.batch.columns[n], ex.padded_len)
                for n, _ in self.schema]
        gi = A.group_ids([c.data for c in cols], [c.validity for c in cols],
                         ex.mask, self.max_groups)
        if int(gi.num_groups) > self.max_groups:
            raise EvalError("DISTINCT cardinality exceeds max_groups")
        out = F.gather(ex.batch, gi.rep_rows, gi.num_groups)
        yield ExecBatch(batch=out, dicts=ex.dicts, mask=out.row_mask())
