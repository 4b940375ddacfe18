"""MVCC storage engine: versioned segments, tombstones, a WAL,
checkpoints to objects, merges.

The port's copy of `matrixone_tpu/storage/engine.py`: the catalog, MVCC
tables of committed numpy segments with table-global string
dictionaries, row deletes as tombstones (commit ts, global row ids), the
single-writer commit pipeline (first-committer-wins conflict check on
deletes, NOT NULL and primary-key uniqueness over live rows, a
hybrid-logical-clock commit ts, the WAL append, deletes applied before
inserts, then the read frontier `committed_ts` advances), snapshot scans
that merge a transaction's workspace (`extra_segments`,
`extra_deletes`) into the rows visible at its snapshot and can carry
each row's id (`ROWID`), named snapshots with `restore_table`,
auto-increment counters and the pessimistic lock service
(`lockservice`).

Durability rides a file service (`storage/fileservice.py`; `MemoryFS`
unless the caller passes one): every catalog change and commit is
appended to the WAL (`storage/wal.py`) before it is applied;
`checkpoint` writes each segment once as an object (`storage/
objectio.py`, the port's own format) plus a JSON manifest, then
truncates the WAL; `Engine.open` loads the manifest and replays the WAL
tail.  A segment loaded from (or demoted to) an object is LAZY: its
columns come through the process block cache (`storage/blockcache.py`),
whose device tier serves a warm scan with no upload, and a scan prunes
it by the zonemaps stored in the manifest before fetching a byte.
`merge_table` rewrites a table's live rows into one segment (capture,
rewrite without the lock, swap), fencing the pre-merge view so AS OF
reads stay bit-identical; `gc_fences` releases fences nothing can
reach (`storage/merge_sched.py` drives both).

The primary-key check probes a bloom filter over the table's keys first
(reference: colexec/fuzzyfilter): only its suspects pay the exact
membership test against the live rows.  A scan builds its dead set once
as a roaring bitmap and tests each chunk's contiguous gid range against
it.  Both live in the port's host library (`matrixone_tpu_torch/native`).
A partitioned table (`storage/partition.py`) splits every insert so one
segment holds one partition's rows, and a scan skips the segments of
the partitions its filters exclude.

The fault points `commit.before`, `merge.rewrite` and `merge.swap`
(utils/fault.py) sit where the reference's do; `Engine.open` runs
under an `engine.recover` span annotated with the recovery summary, and
`close()` flushes the statement recorder.

Secondary indexes (`IndexMeta`, `register_index`, `indexes_on`) live in
the catalog as the reference keeps them: a commit, a merge and a WAL
replay mark the table's indexes dirty, dropping a table drops its
indexes and frees their `index_cache` entries (vectorindex/cache.py),
and, as in the reference, indexes are not persisted (no WAL record, no
manifest entry): `indexing.py` builds them again on demand.

Stages (named external locations) and external tables
(`storage/external.py`: CSV read in place) ride the catalog, the WAL and
the manifest as the reference's do.

The logtail funnel: `subscribe(fn)` registers a subscriber that every
commit calls under the commit lock as `fn(commit_ts, table, kind,
payload)`, deletes ("delete", the global row ids) before inserts
("insert", the new Segment), and WAL replay calls the same way.  After
a commit has fully applied and the lock is released,
`_notify_post_commit` drives the materialized-view maintenance service
(`mview/maintain.py`), created at the first commit of an engine that
has a `system_mview` catalog.  A commit that touches `system_udf` or
`system_mview` is catalog shape and bumps `ddl_gen`.

Not ported yet (ROADMAP.md, section A): the CN bootstrap
(`open_checkpoint`), external parquet and iceberg tables,
publications, sources and dynamic tables, CDC sinks and the
co-partitioned shard read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from matrixone_tpu_torch import native
from matrixone_tpu_torch.container.dtypes import DType, TypeOid
from matrixone_tpu_torch.sql.expr import BoundCol, BoundExpr, BoundFunc, \
    BoundLiteral
from matrixone_tpu_torch.storage import blockcache, objectio
from matrixone_tpu_torch.storage import wal as walmod
from matrixone_tpu_torch.storage.fileservice import FileService, MemoryFS
from matrixone_tpu_torch.txn.hlc import HLC
from matrixone_tpu_torch.utils import metrics, motrace
from matrixone_tpu_torch.utils.fault import INJECTOR

Schema = List[Tuple[str, DType]]

#: the pseudo-column a scan fills with each row's global id (int64;
#: rows of a transaction's workspace have negative ids)
ROWID = "__rowid"


def schema_to_json(schema: Schema) -> list:
    """One canonical (de)serialization for table schemas (the JAX
    package's WAL and checkpoint format; `convert.tables_from_numpy`
    carries schemas across with it)."""
    return [[c, d.oid.value, d.width, d.scale, d.dim] for c, d in schema]


def schema_from_json(rows) -> Schema:
    return [(c, DType(TypeOid(o), width=w, scale=s, dim=dm))
            for c, o, w, s, dm in rows]


@dataclasses.dataclass
class TableMeta:
    name: str
    schema: Schema
    primary_key: List[str]
    auto_increment: Optional[str] = None   # column name (incrservice)
    not_null: List[str] = dataclasses.field(default_factory=list)
    # partitionservice: segments are split per partition on insert
    partition: "object" = None             # Optional[partition.PartitionSpec]


@dataclasses.dataclass
class IndexMeta:
    name: str
    table: str
    columns: List[str]
    algo: str
    options: dict
    index_obj: object = None
    dirty: bool = False        # table changed since build -> lazy rebuild


@dataclasses.dataclass
class Segment:
    seg_id: int
    commit_ts: int                       # 0 for a workspace segment
    #: a RAM dict (fresh commits) or `blockcache.LazyColumns` (an
    #: object-backed segment, its columns fetched through the block
    #: cache): both map a column to its host array
    arrays: Dict[str, np.ndarray]        # varchar columns as int32 codes
    validity: Dict[str, np.ndarray]
    n_rows: int
    base_gid: int
    part_id: int = -1                    # -1 = unpartitioned table
    #: the object this segment was checkpointed to, and its stored
    #: zonemaps {col: [min, max, null_count]} for fetch-free pruning
    obj_path: Optional[str] = None
    zonemaps: Optional[dict] = None

    @property
    def is_lazy(self) -> bool:
        return not isinstance(self.arrays, dict)


@dataclasses.dataclass
class MergeFence:
    """The COMPLETE pre-merge view of one table, pinned when
    `merge_table` rewrote it: the live segments and tombstones at the
    swap, with their commit ts, so AS OF reads below `merge_ts` stay
    exact.  Gid ranges are never reused, so a fenced gid resolves to
    one historical segment.  `Engine.gc_fences` releases fences oldest
    first once nothing can reach them."""
    merge_ts: int
    segments: List[Segment]
    tombstones: List[Tuple[int, np.ndarray]]


class _ChunkKeep:
    """A chunk's keep mask (its rows not tombstoned), moved to a device
    once however many columns it selects."""

    def __init__(self, mask: np.ndarray):
        self.mask = mask
        self._on = {}

    def on(self, device):
        import torch
        key = str(device)
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = torch.from_numpy(self.mask).to(device)
        return t


class DeviceRef:
    """One column's slice of one chunk of an object-backed segment, to be
    served from the block cache's device tier by `resolve` on the
    scan's own thread (the read-ahead thread never touches the device).
    Tombstoned rows go through a device keep mask: a boolean index,
    which syncs, outside any CUDA graph."""

    __slots__ = ("view", "col", "start", "end", "keep", "pair")

    def __init__(self, view, col: str, start: int, end: int,
                 keep: Optional[_ChunkKeep], pair=None):
        self.view, self.col = view, col
        self.start, self.end, self.keep = start, end, keep
        self.pair = pair            # what the read-ahead decoded, if any

    def resolve(self, device):
        t = self.view.device(self.col, device, self.pair)[
            self.start:self.end]
        return t if self.keep is None else t[self.keep.on(device)]


def resolve_chunk(arrays: dict, validity: dict, device) -> tuple:
    """A chunk of `iter_chunks(device=...)` with its `DeviceRef`s served
    as tensors on `device`."""
    out_a, out_v = {}, {}
    for c, a in arrays.items():          # data then validity, column by
        v = validity[c]                  # column, as the host path reads
        out_a[c] = a.resolve(device) if isinstance(a, DeviceRef) else a
        out_v[c] = v.resolve(device) if isinstance(v, DeviceRef) else v
    return out_a, out_v


class ConflictError(RuntimeError):
    pass


class DuplicateKeyError(RuntimeError):
    pass


class ConstraintError(RuntimeError):
    pass


class MVCCTable:
    """Versioned columnar table; readers see a snapshot, writers buffer in
    a transaction's workspace until the engine commits them."""

    #: wired by Engine.create_table
    engine: "Engine" = None

    def __init__(self, meta: TableMeta):
        self.meta = meta
        self.segments: List[Segment] = []
        self.tombstones: List[Tuple[int, np.ndarray]] = []  # (commit_ts, gids)
        #: commit TS of the last data change applied to THIS table
        self.last_commit_ts = 0
        #: the last merge_table's ts (the fences carry the history)
        self.last_merge_ts = 0
        #: snapshot fences, ascending merge_ts (released by
        #: Engine.gc_fences, oldest first)
        self.fences: List[MergeFence] = []
        #: merge_ts of the newest released fence
        self.delta_floor = 0
        self.next_gid = 0
        self.next_seg = 0
        self.dicts: Dict[str, List[str]] = {
            c: [] for c, d in meta.schema if d.is_varlen}
        self._dict_idx: Dict[str, Dict[str, int]] = {c: {} for c in self.dicts}
        self.next_auto = 1
        # PK dedup (reference: colexec/fuzzyfilter): a bloom over existing
        # keys answers "definitely new" cheaply; only bloom-positive
        # suspects pay the exact membership check
        self._pk_bloom = None
        self._pk_vals: Dict[int, np.ndarray] = {}   # seg_id -> its keys
        self._pk_col: Optional[str] = None
        self._pk_cols: List[str] = []     # composite: hashed key columns
        sd = dict(meta.schema)

        def keyable(d):
            # integer columns directly; varchar via its table-global
            # dictionary codes (stable ints)
            return d is not None and (d.is_integer or d.is_varlen)
        if len(meta.primary_key) == 1:
            if keyable(sd.get(meta.primary_key[0])):
                self._pk_col = meta.primary_key[0]
        elif len(meta.primary_key) > 1:
            if all(keyable(sd.get(c)) for c in meta.primary_key):
                self._pk_cols = list(meta.primary_key)

    def allocate_auto(self, n: int) -> np.ndarray:
        """Allocate n auto_increment values (the reference's cached range
        allocator, single-process form), serialized by the commit lock."""
        with self.engine._commit_lock:
            base = self.next_auto
            self.next_auto += n
        return np.arange(base, base + n, dtype=np.int64)

    def observe_auto(self, values: np.ndarray) -> None:
        if len(values):
            with self.engine._commit_lock:
                self.next_auto = max(self.next_auto,
                                     int(values.max()) + 1)

    @property
    def schema(self) -> Schema:
        return self.meta.schema

    @property
    def n_rows(self) -> int:
        """Committed row count net of tombstones (latest snapshot)."""
        total = sum(s.n_rows for s in self.segments)
        dead = sum(len(g) for _, g in self.tombstones)
        return total - dead

    # -------------------------------------------------------- dict encode
    # Both encoders run under the engine commit lock: the check-then-
    # append on the dictionary must not interleave between two writers.
    def encode_strings_list(self, col: str, values) -> np.ndarray:
        with self.engine._commit_lock:
            lut, d = self._dict_idx[col], self.dicts[col]
            out = np.zeros(len(values), dtype=np.int32)
            for i, s in enumerate(values):
                if s is None:
                    continue
                code = lut.get(s)
                if code is None:
                    code = len(d)
                    lut[s] = code
                    d.append(s)
                out[i] = code
            return out

    def encode_dict_encoded(self, col: str, de) -> np.ndarray:
        """A batch-local `wal.DictEncoded` in table-global codes:
        O(strings) Python under the commit lock, O(n) numpy."""
        if not de.cats:
            return np.zeros(len(de.codes), np.int32)
        enc = self.encode_strings_list(col, de.cats)
        return np.asarray(enc, np.int32)[np.asarray(de.codes, np.int64)]

    def remap_codes(self, col: str, codes: np.ndarray, cats: List[str]
                    ) -> np.ndarray:
        with self.engine._commit_lock:
            lut, d = self._dict_idx[col], self.dicts[col]
            remap = np.empty(len(cats), dtype=np.int32)
            for i, s in enumerate(cats):
                code = lut.get(s)
                if code is None:
                    code = len(d)
                    lut[s] = code
                    d.append(s)
                remap[i] = code
            return remap[np.asarray(codes, dtype=np.int64)]

    def batch_to_arrays(self, batch):
        """A host `Batch` in the table's schema -> (arrays, validity),
        varchar columns encoded into the table's dictionaries."""
        arrays, validity = {}, {}
        for col, dtype in self.meta.schema:
            vec = batch.columns[col]
            validity[col] = vec.valid_mask().copy()
            if dtype.is_varlen:
                arrays[col] = self.encode_strings_list(col, list(vec.strings))
            else:
                arrays[col] = np.asarray(vec.data, dtype=dtype.np_dtype)
        return arrays, validity

    # ------------------------------------------------------------ pk dedup
    def pk_key_values(self, arrays: Dict[str, np.ndarray]
                      ) -> Optional[np.ndarray]:
        """The (possibly synthetic) int64 key array for PK checking: the
        column itself (varchar via dict codes), or the splitmix-combined
        hash of a composite key — composite hash matches are verified
        against the REAL tuples in check_pk_unique before rejecting."""
        if self._pk_col is not None:
            if self._pk_col not in arrays:
                return None
            return np.asarray(arrays[self._pk_col], np.int64)
        if self._pk_cols and all(c in arrays for c in self._pk_cols):
            h = None
            with np.errstate(over="ignore"):
                for c in self._pk_cols:
                    hc = native.hash64(np.asarray(arrays[c], np.int64))
                    h = hc if h is None else native._splitmix_np(
                        h ^ (hc + native._GOLDEN + (h << np.uint64(6))
                             + (h >> np.uint64(2))))
            return h.view(np.int64)
        return None

    def check_pk_unique(self, arrays: Dict[str, np.ndarray],
                        extra_deletes: Optional[np.ndarray] = None,
                        validity: Optional[np.ndarray] = None) -> None:
        """Raise DuplicateKeyError if the batch collides with existing live
        PK values or contains internal duplicates (fuzzyfilter analogue).
        A row that is tombstoned, or deleted by the same transaction
        (`extra_deletes`), holds no key.  NULL primary keys are rejected
        outright (PK implies NOT NULL).  The key bloom filter answers
        first; only its suspects are looked up among the live rows."""
        t0 = time.perf_counter()
        try:
            self._check_pk_unique(arrays, extra_deletes, validity)
        finally:
            metrics.pk_check_seconds.inc(time.perf_counter() - t0)

    def _check_pk_unique(self, arrays, extra_deletes, validity) -> None:
        new = self.pk_key_values(arrays)
        if new is None:
            return
        c = self._pk_col or "+".join(self._pk_cols)
        if validity is not None and not validity.all():
            raise DuplicateKeyError(
                f"primary key {self.meta.name!r}.{c} cannot be NULL")
        uniq, counts = np.unique(new, return_counts=True)
        if (counts > 1).any():
            shown = (int(uniq[counts > 1][0]) if self._pk_col is not None
                     and not dict(self.meta.schema)[c].is_varlen
                     else "")
            raise DuplicateKeyError(
                f"duplicate key {shown} within the insert batch for "
                f"{self.meta.name!r}.{c}".replace("key  ", "key "))
        if self._pk_bloom is None:
            self._rebuild_pk_bloom()
        suspects = new[self._pk_bloom.probe_int64(new)]
        metrics.pk_bloom_suspects.inc(len(suspects))
        if len(suspects) == 0:
            return
        dead = np.unique(self._dead_gids(None, extra_deletes))
        for seg in self.segments:
            vals = self._segment_keys(seg)
            # the rows holding a suspect's key, then those still alive
            rows = np.nonzero(np.isin(vals, suspects))[0]
            if len(dead) and len(rows):
                g = rows + seg.base_gid
                pos = np.minimum(np.searchsorted(dead, g), len(dead) - 1)
                rows = rows[dead[pos] != g]
            collide = suspects[np.isin(suspects, vals[rows])]
            for k in collide:
                if self._pk_col is not None:
                    shown = int(k)
                    if dict(self.meta.schema)[c].is_varlen:
                        d = self.dicts.get(c, [])
                        if 0 <= int(k) < len(d):
                            shown = repr(d[int(k)])
                    raise DuplicateKeyError(
                        f"duplicate key {shown} for "
                        f"{self.meta.name!r}.{c}")
                # composite keys are routed by HASH: verify the real tuple
                # before rejecting (a 2^-64 collision must not block an
                # unrelated insert)
                in_row = int(np.nonzero(new == k)[0][0])
                for r in rows[vals[rows] == k]:
                    if all(int(seg.arrays[cc][r]) == int(arrays[cc][in_row])
                           for cc in self._pk_cols):
                        shown = tuple(int(seg.arrays[cc][r])
                                      for cc in self._pk_cols)
                        raise DuplicateKeyError(
                            f"duplicate key {shown} for "
                            f"{self.meta.name!r}.{c}")

    def _segment_keys(self, seg: Segment) -> Optional[np.ndarray]:
        """`pk_key_values` of a committed segment, kept: a segment's rows
        never change, and a composite key's hash costs a pass over them."""
        vals = self._pk_vals.get(seg.seg_id)
        if vals is None:
            vals = self._pk_vals[seg.seg_id] = self.pk_key_values(
                seg.arrays)
        return vals

    def _rebuild_pk_bloom(self) -> None:
        n_live = sum(s.n_rows for s in self.segments)
        # headroom so incremental adds don't saturate immediately
        cap = max(n_live * 2, 4096)
        bloom = native.BloomFilter(cap)
        for seg in self.segments:
            vals = self._segment_keys(seg)
            if vals is not None:
                bloom.add_int64(vals)
        self._pk_bloom = bloom
        self._pk_bloom_cap = cap
        self._pk_bloom_items = n_live

    def _pk_bloom_add(self, seg: Segment) -> None:
        if self._pk_bloom is None:
            return
        vals = self._segment_keys(seg)
        if vals is None:
            return
        self._pk_bloom_items += len(vals)
        if self._pk_bloom_items > self._pk_bloom_cap:
            self._pk_bloom = None   # saturated: lazy rebuild with headroom
            return
        self._pk_bloom.add_int64(vals)

    # ----------------------------------------------------------- segments
    def make_segment(self, arrays, validity, commit_ts: int) -> Segment:
        n = len(next(iter(arrays.values())))
        seg = Segment(seg_id=self.next_seg, commit_ts=commit_ts,
                      arrays=arrays, validity=validity, n_rows=n,
                      base_gid=self.next_gid)
        self.next_seg += 1
        self.next_gid += n
        return seg

    def apply_segment(self, seg: Segment) -> None:
        self.segments.append(seg)
        self.last_commit_ts = max(self.last_commit_ts, seg.commit_ts)

    def insert_segments(self, arrays, validity, commit_ts: int
                        ) -> List[Segment]:
        """Apply an insert batch, splitting rows per partition so each
        segment holds exactly one partition (partitionservice role —
        pruning becomes a structural per-segment skip)."""
        from matrixone_tpu_torch.storage.partition import split_by_partition
        if self.meta.partition is None:
            seg = self.make_segment(arrays, validity, commit_ts)
            self.apply_segment(seg)
            return [seg]
        segs = []
        for pid, pa, pv in split_by_partition(self.meta.partition,
                                              arrays, validity):
            seg = self.make_segment(pa, pv, commit_ts)
            seg.part_id = pid
            self.apply_segment(seg)
            segs.append(seg)
        return segs

    def apply_tombstones(self, commit_ts: int, gids: np.ndarray) -> None:
        if len(gids):
            self.tombstones.append((commit_ts, np.asarray(gids, np.int64)))
            self.last_commit_ts = max(self.last_commit_ts, commit_ts)

    # --------------------------------------------------------------- read
    def _view_at(self, snapshot_ts: Optional[int]):
        """(segments, tombstones) source lists for a read at snapshot_ts.
        A fence's segments ARE the table at its merge point, so a read
        below a fence uses the oldest such fence, then the ordinary
        commit_ts <= ts filter: AS OF reads stay bit-identical across a
        merge."""
        if snapshot_ts is None:
            return self.segments, self.tombstones
        for f in self.fences:              # ascending merge_ts
            if snapshot_ts < f.merge_ts:
                return f.segments, f.tombstones
        return self.segments, self.tombstones

    def _gid_fence_segment(self, gid: int) -> Optional[Segment]:
        """The segment of a gid no live segment covers (a merge compacted
        it away): gid ranges are never reused, so one fenced segment at
        most holds it."""
        for f in reversed(self.fences):
            for s in f.segments:           # ascending base_gid
                if s.base_gid > gid:
                    break
                if gid < s.base_gid + s.n_rows:
                    return s
        return None

    def _dead_gids(self, snapshot_ts: Optional[int],
                   extra_deletes: Optional[np.ndarray],
                   tombstones: Optional[list] = None) -> np.ndarray:
        src = self.tombstones if tombstones is None else tombstones
        parts = [g for ts, g in src
                 if snapshot_ts is None or ts <= snapshot_ts]
        if extra_deletes is not None and len(extra_deletes):
            parts.append(np.asarray(extra_deletes, np.int64))
        if not parts:
            return np.zeros(0, np.int64)
        return np.concatenate(parts)

    def iter_chunks(self, columns: List[str], batch_rows: int,
                    filters: Optional[List[BoundExpr]] = None,
                    qualified_names: Optional[List[str]] = None,
                    snapshot_ts: Optional[int] = None,
                    extra_segments: Optional[List[Segment]] = None,
                    extra_deletes: Optional[np.ndarray] = None,
                    device=None, read_ahead: bool = False,
                    only_part: Optional[int] = None) -> Iterator[tuple]:
        """Yield (arrays, validity, dicts, n) chunks of at most batch_rows
        rows: the segments committed at or before snapshot_ts, then a
        transaction's own segments, without the rows tombstoned at
        snapshot_ts or deleted by the transaction, skipping the segments
        whose stored zonemaps, and the chunks whose values, exclude a
        filter.  `ROWID` among the columns yields each row's global id.

        With `device`, an object-backed segment's columns come as
        `DeviceRef`s for the device tier (`resolve_chunk` serves them);
        the chunk zonemaps are still evaluated on the host tier's arrays,
        so the same chunks survive as on the host path.  `read_ahead`
        (this generator runs on the scan's read-ahead thread) decodes
        each such segment's cold columns into the host tier first.
        `only_part` (a co-partitioned shard read, vm/operators
        `_hash_route`) keeps that partition's segments and the ones
        without a part id, which the caller routes row by row."""
        want_rowid = ROWID in columns
        data_cols = [c for c in columns if c != ROWID]
        schema = dict(self.meta.schema)
        qmap = dict(zip(qualified_names or columns, columns))
        zm_cols = ({raw for raw, _op, _c, _l in _zm_predicates(filters, qmap)}
                   & set(data_cols)) if filters else set()
        src_segs, src_tombs = self._view_at(snapshot_ts)
        dead = self._dead_gids(snapshot_ts, extra_deletes, src_tombs)
        dead_filter = None
        if len(dead):
            # tombstones as a compressed bitmap built ONCE per scan: a
            # chunk's gids are a contiguous range, so the per-chunk
            # membership test is one container walk (reference:
            # cgo/croaring.c docfilter role)
            dead_filter = native.RoaringBitmap(dead)
        segs = [s for s in src_segs
                if snapshot_ts is None or s.commit_ts <= snapshot_ts]
        segs = segs + list(extra_segments or [])
        allowed_parts = None
        if self.meta.partition is not None and filters:
            from matrixone_tpu_torch.storage import partition as partmod
            allowed_parts = partmod.prune(self.meta.partition, filters,
                                          qmap)
        for seg in segs:
            if allowed_parts is not None and seg.part_id >= 0 \
                    and seg.part_id not in allowed_parts:
                metrics.scan_segments.inc(outcome="pruned")
                continue
            if only_part is not None and seg.part_id >= 0 \
                    and seg.part_id != only_part:
                continue
            # object-backed segments: prune on the STORED zonemaps before
            # any column fetch (readutil block-list prune)
            if filters and seg.zonemaps is not None and \
                    _seg_zonemap_excludes(filters, seg.zonemaps,
                                          seg.n_rows, qmap):
                metrics.scan_segments.inc(outcome="pruned")
                continue
            metrics.scan_segments.inc(outcome="read")
            lazy = device is not None and seg.is_lazy
            warmed = {}
            if lazy and read_ahead:
                warmed = {c: seg.arrays.warm(c) for c in data_cols}
            for start in range(0, seg.n_rows, batch_rows):
                end = min(start + batch_rows, seg.n_rows)
                lo = seg.base_gid + start
                keep = None
                if dead_filter is not None:
                    keep = ~dead_filter.test_range(lo, seg.base_gid + end)
                    if not keep.any():
                        continue
                    if keep.all():
                        keep = None
                n = (end - start) if keep is None else int(keep.sum())
                arrays, validity = {}, {}
                if lazy:
                    ck = None if keep is None else _ChunkKeep(keep)
                    for c in data_cols:
                        pair = warmed.pop(c, None)   # the first chunk's
                        arrays[c] = DeviceRef(seg.arrays, c, start, end, ck,
                                              pair)
                        validity[c] = DeviceRef(seg.validity, c, start, end,
                                                ck, pair)
                    # the chunk zonemaps read the host tier, uncounted
                    zm_a, zm_v = {}, {}
                    for c in zm_cols:
                        a = seg.arrays.host(c, count=False)[start:end]
                        v = seg.validity.host(c, count=False)[start:end]
                        zm_a[c], zm_v[c] = ((a, v) if keep is None
                                            else (a[keep], v[keep]))
                else:
                    for c in data_cols:
                        a = seg.arrays[c][start:end]
                        v = seg.validity[c][start:end]
                        if keep is not None:
                            a, v = a[keep], v[keep]
                        arrays[c] = a
                        validity[c] = v
                    zm_a, zm_v = arrays, validity
                if want_rowid:
                    g = np.arange(lo, seg.base_gid + end, dtype=np.int64)
                    arrays[ROWID] = g if keep is None else g[keep]
                    validity[ROWID] = np.ones(n, np.bool_)
                if n == 0 or not (data_cols or want_rowid):
                    continue
                if filters and _zonemap_excludes(filters, zm_a, zm_v,
                                                 qmap, schema):
                    continue
                yield arrays, validity, self.dicts, n

    def scan_is_cold(self, columns: List[str]) -> bool:
        """True when a scan of `columns` would miss the block cache for at
        least one object-backed segment: the scan turns its read-ahead
        on only then (a warm scan should not pay a thread)."""
        cols = [c for c in columns if c != ROWID]
        for seg in self.segments:
            if seg.is_lazy and seg.arrays.cold_columns(cols):
                return True
        return False

    def visible_gids(self, gids: np.ndarray,
                     snapshot_ts: Optional[int] = None,
                     extra_deletes: Optional[np.ndarray] = None) -> np.ndarray:
        """Filter gids to rows visible at the snapshot: owning segment
        committed <= ts and not tombstoned (incl. txn-local deletes)."""
        gids = np.asarray(gids, np.int64)
        if len(gids) == 0:
            return gids
        src_segs, src_tombs = self._view_at(snapshot_ts)
        bases = np.array([s.base_gid for s in src_segs], np.int64)
        seg_ts = np.array([s.commit_ts for s in src_segs], np.int64)
        si = np.searchsorted(bases, gids, side="right") - 1
        ok = si >= 0
        if snapshot_ts is not None:
            ok = ok & (seg_ts[np.clip(si, 0, None)] <= snapshot_ts)
        dead = self._dead_gids(snapshot_ts, extra_deletes, src_tombs)
        if len(dead):
            ok = ok & ~np.isin(gids, dead)
        return gids[ok]

    def fetch_rows(self, gids: np.ndarray, columns: List[str]):
        """Host gather of rows by global id.  Returns (arrays, validity)
        in gid order.  Gids a merge compacted out of the live list
        resolve through the snapshot fences."""
        gids = np.asarray(gids, np.int64)
        bases = np.array([s.base_gid for s in self.segments], np.int64)
        seg_idx = np.searchsorted(bases, gids, side="right") - 1
        owners: List[Segment] = []
        for gi, si in zip(gids, seg_idx):
            seg = self.segments[si] if si >= 0 else None
            if seg is None or gi >= seg.base_gid + seg.n_rows:
                seg = self._gid_fence_segment(int(gi))
            if seg is None:
                raise KeyError(f"gid {int(gi)} not found in "
                               f"{self.meta.name!r} (live or fenced)")
            owners.append(seg)
        arrays = {c: [] for c in columns}
        validity = {c: [] for c in columns}
        for c in columns:
            dtype = dict(self.meta.schema)[c]
            parts_a, parts_v = [], []
            for gi, seg in zip(gids, owners):
                off = int(gi - seg.base_gid)
                parts_a.append(seg.arrays[c][off])
                parts_v.append(seg.validity[c][off])
            if parts_a:
                arrays[c] = np.stack(parts_a) if np.ndim(parts_a[0]) \
                    else np.asarray(parts_a)
                validity[c] = np.asarray(parts_v, np.bool_)
            else:
                shape = (0, dtype.dim) if dtype.is_vector else (0,)
                np_t = np.int32 if dtype.is_varlen else dtype.np_dtype
                arrays[c] = np.zeros(shape, np_t)
                validity[c] = np.zeros(0, np.bool_)
        return arrays, validity

    def read_texts(self, col: str):
        """Decoded visible strings (None for NULL) plus the gid of each,
        of a varchar column (the full-text index build).  An
        object-backed segment is read through its host tier."""
        dead = self._dead_gids(None, None)
        d = self.dicts[col]
        texts, gids = [], []
        for seg in self.segments:
            g = np.arange(seg.base_gid, seg.base_gid + seg.n_rows,
                          dtype=np.int64)
            codes = np.asarray(seg.arrays[col])
            val = np.asarray(seg.validity[col])
            if len(dead):
                keep = ~np.isin(g, dead)
                g, codes, val = g[keep], codes[keep], val[keep]
            texts.extend(d[c] if v else None
                         for c, v in zip(codes.tolist(), val.tolist()))
            gids.append(g)
        return texts, (np.concatenate(gids) if gids
                       else np.zeros(0, np.int64))

    def read_column_f32(self, col: str):
        """Dense f32 matrix of VISIBLE rows (tombstones excluded) plus the
        gid of each matrix row: index builds must not index deleted rows,
        and search results map back to rows via the gids.  An
        object-backed segment is read through its host tier."""
        d = dict(self.meta.schema)[col].dim
        dead = self._dead_gids(None, None)
        mats, gids = [], []
        for seg in self.segments:
            g = np.arange(seg.base_gid, seg.base_gid + seg.n_rows,
                          dtype=np.int64)
            keep = ~np.isin(g, dead) if len(dead) else None
            m = seg.arrays[col]
            if keep is not None and not keep.all():
                m, g = m[keep], g[keep]
            mats.append(m)
            gids.append(g)
        if not mats:
            return np.zeros((0, d), np.float32), np.zeros(0, np.int64)
        return (np.concatenate(mats).astype(np.float32, copy=False),
                np.concatenate(gids))

    # -------------------------------------------------- convenience write
    def insert_batch(self, batch) -> int:
        arrays, validity = self.batch_to_arrays(batch)
        return self.engine.commit_write(self.meta.name, arrays, validity)

    def insert_numpy(self, arrays, validity=None, strings=None) -> int:
        strings = strings or {}
        full, val = {}, {}
        n = None
        for col, dtype in self.meta.schema:
            if dtype.is_varlen:
                codes, cats = strings[col]
                arr = self.remap_codes(col, codes, cats)
            else:
                arr = np.asarray(arrays[col], dtype=dtype.np_dtype)
            if n is None:
                n = len(arr)
            full[col] = arr
            v = None if validity is None else validity.get(col)
            val[col] = v.copy() if v is not None else np.ones(n, np.bool_)
        return self.engine.commit_write(self.meta.name, full, val)


def _zm_predicates(filters, qmap):
    """Extract (raw_col, op, col_expr, lit) zonemap-usable predicates."""
    out = []
    for f in filters:
        if not (isinstance(f, BoundFunc) and f.op in
                ("lt", "le", "gt", "ge", "eq") and len(f.args) == 2):
            continue
        a, b = f.args
        if isinstance(a, BoundCol) and isinstance(b, BoundLiteral):
            col, lit, op = a, b, f.op
        elif isinstance(b, BoundCol) and isinstance(a, BoundLiteral):
            col, lit = b, a
            op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                  "eq": "eq"}[f.op]
        else:
            continue
        if col.dtype.is_varlen:
            continue
        out.append((qmap.get(col.name, col.name), op, col, lit))
    return out


def _zm_normalize_lit(col, lit):
    """Literal in the column's STORED units (decimals live scaled);
    None when the comparison can't ride the zonemap."""
    lv = lit.value
    if col.dtype.oid == TypeOid.DECIMAL64:
        lit_scale = (lit.dtype.scale
                     if lit.dtype.oid == TypeOid.DECIMAL64 else 0)
        if lit.dtype.oid == TypeOid.DECIMAL64 or lit.dtype.is_integer:
            lv = lv * 10 ** (col.dtype.scale - lit_scale)
        else:
            return None   # float vs decimal column: kernel decides
    elif lit.dtype.oid == TypeOid.DECIMAL64:
        # decimal literal vs non-decimal column: compare in real units
        lv = lv / 10 ** lit.dtype.scale
    return lv if isinstance(lv, (int, float)) else None


def _zm_range_excludes(op, lo, hi, lv) -> bool:
    if op == "lt":
        return not (lo < lv)
    if op == "le":
        return not (lo <= lv)
    if op == "gt":
        return not (hi > lv)
    if op == "ge":
        return not (hi >= lv)
    return not (lo <= lv <= hi)   # eq


def _seg_zonemap_excludes(filters, zonemaps, n_rows, qmap) -> bool:
    """Segment-level prune on STORED zonemaps {col: [min, max,
    null_count]}: whether to fetch the object's columns at all."""
    if not zonemaps:
        return False
    for raw, op, col, lit in _zm_predicates(filters, qmap):
        zm = zonemaps.get(raw)
        if zm is None:
            continue
        lo, hi, nulls = zm[0], zm[1], zm[2]
        if lo is None or hi is None:
            if nulls >= n_rows:
                return True    # an all-NULL column satisfies no comparison
            continue
        lv = _zm_normalize_lit(col, lit)
        if lv is None:
            continue
        if _zm_range_excludes(op, lo, hi, lv):
            return True
    return False


def _zonemap_excludes(filters, arrays, validity, qmap, schema) -> bool:
    for raw, op, col, lit in _zm_predicates(filters, qmap):
        if raw not in arrays:
            continue
        v = validity[raw]
        vals = arrays[raw] if v.all() else arrays[raw][v]
        if len(vals) == 0:
            return True
        if vals.ndim != 1:
            continue
        lv = _zm_normalize_lit(col, lit)
        if lv is None:
            continue
        if _zm_range_excludes(op, vals.min(), vals.max(), lv):
            return True
    return False


def _segment_entry(seg: Segment) -> dict:
    return {"path": seg.obj_path, "seg_id": seg.seg_id,
            "base_gid": seg.base_gid, "commit_ts": seg.commit_ts,
            "part_id": seg.part_id, "n_rows": seg.n_rows,
            "zonemaps": seg.zonemaps}


def _tombstones_json(tombs) -> list:
    return [[ts, g.tolist()] for ts, g in tombs]


def _tombstones_from_json(rows) -> list:
    return [(ts, np.asarray(g, np.int64)) for ts, g in rows]


class Engine:
    """Catalog + single-writer commit service + WAL + checkpoint/replay."""

    def __init__(self, fs: Optional[FileService] = None, wal=None):
        from matrixone_tpu_torch.lockservice import LockService
        from matrixone_tpu_torch.vectorindex.cache import IndexCache
        self.fs = fs if fs is not None else MemoryFS()
        #: anything with append/truncate/replay: the local CRC log by
        #: default
        self.wal = wal if wal is not None else walmod.WalWriter(self.fs)
        self.hlc = HLC()
        self.tables: Dict[str, MVCCTable] = {}
        self.indexes: Dict[str, IndexMeta] = {}
        #: budgeted residency of the built indexes on their devices
        self.index_cache = IndexCache()
        # reentrant: table helpers called under a commit take it again
        self._commit_lock = threading.RLock()
        #: catalog-shape generation: bumped on every DDL
        self.ddl_gen = 0
        self._ckpt_ts = 0
        self.snapshots: Dict[str, int] = {}      # named points in time
        #: named external locations (pkg/stage): name -> URL
        self.stages: Dict[str, str] = {}
        #: last FULLY applied commit: readers snapshot here so a commit
        #: mid-apply (tombstones in, segments not yet) can never tear a read
        self.committed_ts = self.hlc.now()
        self.locks = LockService()     # pessimistic mode (pkg/lockservice)
        self.active_txns = 0           # open explicit txns (merge guard)
        self._pending_merge_records: Dict[str, int] = {}   # name -> ts
        #: serializes merge_table's capture -> rewrite -> swap (commits
        #: never take it)
        self._merge_lock = threading.Lock()
        #: delta-consumer watermarks: key -> (table, callable returning
        #: its watermark ts or None); a fence stays while any consumer of
        #: its table sits below its merge point
        self._watermarks: Dict[str, Tuple[str, Callable]] = {}
        #: the last restart's recovery report (Engine.open fills it)
        self.recovery_summary: Optional[dict] = None
        #: logtail subscribers: fn(commit_ts, table, kind, payload),
        #: called under the commit lock
        self._subscribers: List[Callable] = []
        #: materialized views: the maintenance service, made at the first
        #: commit once a system_mview catalog exists (mview/maintain.py)
        self._has_mview_catalog = False
        self._mview_service = None

    # ----------------------------------------------------------- catalog
    def create_table(self, meta: TableMeta, if_not_exists=False,
                     log=True) -> None:
        if meta.name in self.tables:
            if if_not_exists:
                return
            raise ValueError(f"table {meta.name} already exists")
        t = MVCCTable(meta)
        t.engine = self
        self.tables[meta.name] = t
        self.ddl_gen += 1
        from matrixone_tpu_torch.mview.catalog import is_mview_table
        if is_mview_table(meta.name):
            self._has_mview_catalog = True
        if log:
            self.wal.append({"op": "create_table", "name": meta.name,
                             "ts": self.hlc.now(),
                             "pk": meta.primary_key,
                             "auto": meta.auto_increment,
                             "not_null": meta.not_null,
                             "partition": (meta.partition.to_json()
                                           if meta.partition is not None
                                           else None),
                             "schema": schema_to_json(meta.schema)})

    def drop_table(self, name: str, if_exists=False, log=True) -> None:
        if name not in self.tables:
            if if_exists:
                return
            raise ValueError(f"no such table {name}")
        # free the cache's budget, and forget the merged-away segments'
        # objects too: a table re-created under this name writes the
        # same object paths again
        t = self.tables[name]
        release = getattr(t, "release_cache", None)
        if release is not None:       # external tables free their cache
            release()
        for seg in t.segments + [s for f in t.fences for s in f.segments]:
            if seg.obj_path is not None:
                blockcache.CACHE.drop_path(seg.obj_path)
        del self.tables[name]
        self.ddl_gen += 1
        for k, v in list(self.indexes.items()):
            if v.table == name:
                del self.indexes[k]
                self.index_cache.drop(k)    # free device residency + budget
        if log:
            self.wal.append({"op": "drop_table", "name": name,
                             "ts": self.hlc.now()})

    def create_external(self, meta: TableMeta, location: str, fmt: str,
                        log: bool = True, if_not_exists: bool = False,
                        snapshot=None):
        """Register an external (scan-in-place, read-only) table:
        storage/external.py."""
        from matrixone_tpu_torch.storage.external import ExternalTable
        if meta.name in self.tables:
            if if_not_exists:
                return
            raise ValueError(f"table {meta.name} already exists")
        t = ExternalTable(meta, location, fmt, engine=self,
                          snapshot=snapshot)
        self.tables[meta.name] = t
        self.ddl_gen += 1
        if log:
            self.wal.append({"op": "create_external", "name": meta.name,
                             "ts": self.hlc.now(), "snapshot": snapshot,
                             "location": location, "fmt": fmt,
                             "schema": schema_to_json(meta.schema)})

    def create_stage(self, name: str, url: str, log: bool = True) -> None:
        """Durable named external location (pkg/stage analogue)."""
        self.stages[name] = url
        # stage URLs are resolved at bind time: a cached plan built
        # against the old mapping would scan the wrong location
        self.ddl_gen += 1
        if log:
            self.wal.append({"op": "create_stage", "name": name,
                             "url": url, "ts": self.hlc.now()})

    def drop_stage(self, name: str, log: bool = True) -> None:
        if name not in self.stages:
            raise ValueError(f"no such stage {name}")
        del self.stages[name]
        self.ddl_gen += 1
        if log:
            self.wal.append({"op": "drop_stage", "name": name,
                             "ts": self.hlc.now()})

    def alter_partition_drop(self, table: str, part: str,
                             log: bool = True) -> None:
        """Remove a RANGE partition definition (rows are tombstoned by the
        caller via a normal delete commit; this only shrinks the spec)."""
        t = self.get_table(table)
        spec = t.meta.partition
        if spec is None or part not in spec.names:
            return
        pid = spec.names.index(part)
        spec.names.pop(pid)
        spec.bounds.pop(pid)
        self.ddl_gen += 1
        # part_ids above the dropped slot shift down; the dropped slot's
        # segments (all rows tombstoned by the caller) become unpartitioned
        # so they are never structurally pruned against the new layout
        for seg in t.segments:
            if seg.part_id == pid:
                seg.part_id = -1
            elif seg.part_id > pid:
                seg.part_id -= 1
        if log:
            self.wal.append({"op": "alter_partition_drop", "table": table,
                             "part": part, "ts": self.hlc.now()})

    def get_table(self, name: str) -> MVCCTable:
        if name not in self.tables:
            raise ValueError(f"no such table {name}")
        return self.tables[name]

    def register_index(self, meta: IndexMeta) -> None:
        """Catalog an index meta (sessions go through this rather than
        mutating `indexes` directly)."""
        self.indexes[meta.name] = meta
        self.ddl_gen += 1

    def indexes_on(self, table: str) -> List[IndexMeta]:
        return [ix for ix in self.indexes.values() if ix.table == table]

    # --------------------------------------------------- snapshots / PITR
    def create_snapshot(self, name: str) -> int:
        """A named point in time (CREATE SNAPSHOT)."""
        ts = self.hlc.now()
        self.snapshots[name] = ts
        self.ddl_gen += 1
        self.wal.append({"op": "create_snapshot", "name": name, "ts": ts})
        return ts

    def drop_snapshot(self, name: str) -> None:
        self.snapshots.pop(name, None)
        self.ddl_gen += 1
        self.wal.append({"op": "drop_snapshot", "name": name,
                         "ts": self.hlc.now()})

    def restore_table(self, table: str, ts: int) -> int:
        """RESTORE ... FROM SNAPSHOT: one commit replaces the current
        visible rows with the rows visible at ts."""
        t = self.get_table(table)
        parts_a, parts_v = [], []
        cols = [c for c, _ in t.meta.schema]
        for arrays, validity, _dicts, _n in t.iter_chunks(
                cols, 1 << 20, snapshot_ts=ts):
            parts_a.append(arrays)
            parts_v.append(validity)
        # all currently-visible rows go away
        current = [arrays[ROWID] for arrays, _v, _d, _n
                   in t.iter_chunks([ROWID], 1 << 20)]
        cur_gids = (np.concatenate(current) if current
                    else np.zeros(0, np.int64))
        if parts_a:
            merged = {c: np.concatenate([p[c] for p in parts_a])
                      for c in cols}
            merged_v = {c: np.concatenate([p[c] for p in parts_v])
                        for c in cols}
            inserts = {table: [(merged, merged_v)]}
        else:
            inserts = {}
        return self.commit_txn(None, inserts, {table: cur_gids})

    # ------------------------------------------------------- txn registry
    def txn_opened(self, txn_id: int) -> None:
        """An explicit transaction opened against this engine (merges
        defer while any is open)."""
        with self._commit_lock:
            self.active_txns += 1

    def txn_closed(self, txn_id: int) -> None:
        with self._commit_lock:
            self.active_txns -= 1

    def subscribe(self, fn: Callable) -> None:
        """Register a logtail subscriber: fn(commit_ts, table, kind,
        payload), kind "insert" (payload: the new Segment) or "delete"
        (the global row ids), called under the commit lock."""
        self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable) -> None:
        self._subscribers = [f for f in self._subscribers if f is not fn]

    # -------------------------------------- delta-consumer watermarks
    def register_watermark(self, key: str, table: str,
                           fn: Callable) -> None:
        """Register a delta consumer: `fn()` returns its replay watermark
        ts (or None while unseeded); gc_fences keeps the table's fences
        while it sits below them."""
        with self._commit_lock:
            self._watermarks[key] = (table, fn)

    def unregister_watermark(self, key: str) -> None:
        with self._commit_lock:
            self._watermarks.pop(key, None)

    def min_watermark(self, table: str) -> Optional[int]:
        """The lowest registered watermark on `table`; None when no
        consumer constrains it."""
        vals = []
        for tbl, fn in list(self._watermarks.values()):
            if tbl != table:
                continue
            try:
                v = fn()
            except Exception:   # noqa: BLE001 — a dead consumer must
                v = None        # not wedge GC; treat as unconstrained
            if v is not None:
                vals.append(int(v))
        return min(vals) if vals else None

    # ------------------------------------------------------------ commit
    def commit_write(self, table: str, arrays, validity) -> int:
        """Autocommit a single-table insert."""
        return self.commit_txn(
            snapshot_ts=None,
            inserts={table: [(arrays, validity)]}, deletes={})

    def commit_txn(self, snapshot_ts: Optional[int],
                   inserts: Dict[str, list],
                   deletes: Dict[str, np.ndarray]) -> int:
        """The commit pipeline (tae/rpc/handle.go:547 HandleCommit):
        conflict check -> constraints -> commit ts -> WAL -> apply ->
        frontier.  Returns rows affected."""
        if INJECTOR.trigger("commit.before") == "fail":
            metrics.txn_commits.inc(outcome="fault")
            raise RuntimeError("injected commit failure")
        with self._commit_lock:
            # write-write conflict: someone deleted my victim after my
            # snapshot (first-committer-wins)
            if snapshot_ts is not None:
                for tname, gids in deletes.items():
                    t = self.get_table(tname)
                    mine = np.asarray(gids, np.int64)
                    if len(mine) and snapshot_ts < t.last_merge_ts:
                        # my victims' row ids are those a merge rewrote
                        # after my snapshot (a CN replica that had not
                        # applied the merge): they name no row any more
                        metrics.txn_commits.inc(outcome="conflict")
                        raise ConflictError(
                            f"write-write conflict on {tname}: a merge "
                            f"rewrote its row ids after the snapshot")
                    newer = [g for ts, g in t.tombstones if ts > snapshot_ts]
                    if newer and len(np.intersect1d(
                            mine, np.concatenate(newer))):
                        metrics.txn_commits.inc(outcome="conflict")
                        raise ConflictError(
                            f"write-write conflict on {tname}")
            # NOT NULL constraints (PK columns are implicitly NOT NULL
            # via the uniqueness check's NULL rejection)
            for tname, segs in inserts.items():
                t = self.get_table(tname)
                for col in t.meta.not_null:
                    for _a, v in segs:
                        if col in v and not v[col].all():
                            raise ConstraintError(
                                f"column {tname!r}.{col} cannot be NULL")
            # PK uniqueness before anything is applied; all of a txn's
            # batches are checked as ONE key set, against the rows left
            # alive once the txn's own deletes land
            for tname, segs in inserts.items():
                t = self.get_table(tname)
                extra = deletes.get(tname)
                pk_cols = ([t._pk_col] if t._pk_col else t._pk_cols)
                if pk_cols and segs:
                    have = [(a, v) for a, v in segs
                            if all(c in a for c in pk_cols)]
                    if have:
                        combined = {c: np.concatenate(
                            [np.asarray(a[c], np.int64) for a, _v in have])
                            for c in pk_cols}
                        val = np.concatenate([
                            np.logical_and.reduce(
                                [v[c] for c in pk_cols if c in v])
                            if any(c in v for c in pk_cols)
                            else np.ones(len(next(iter(a.values()))),
                                         np.bool_)
                            for a, v in have])
                        t.check_pk_unique(combined, extra_deletes=extra,
                                          validity=val)
            commit_ts = self.hlc.now()
            affected = 0
            # WAL first; varchar columns are logged dictionary-encoded
            # (batch-local codes + their strings) so a replay re-encodes
            # them into the table dictionary as it then stands
            for tname, segs in inserts.items():
                t = self.get_table(tname)
                varlen = {c for c, d in t.meta.schema if d.is_varlen}
                for arrays, validity in segs:
                    wal_arrays = {
                        c: (walmod.to_dict_encoded(t.dicts[c], a,
                                                   validity[c])
                            if c in varlen else a)
                        for c, a in arrays.items()}
                    fields, blob = walmod.arrays_to_payload(wal_arrays,
                                                            validity)
                    self.wal.append({"op": "insert", "table": tname,
                                     "ts": commit_ts, **fields}, blob)
            for tname, gids in deletes.items():
                if len(gids):
                    g = np.ascontiguousarray(gids, dtype="<i8")
                    self.wal.append({"op": "delete", "table": tname,
                                     "ts": commit_ts, "n": len(g)},
                                    g.tobytes())
            self.wal.append({"op": "commit", "ts": commit_ts})
            # apply: deletes BEFORE inserts — an UPDATE is delete+insert at
            # one commit ts
            for tname, gids in deletes.items():
                t = self.get_table(tname)
                t.apply_tombstones(commit_ts, np.asarray(gids, np.int64))
                affected += len(gids)
                for fn in self._subscribers:
                    fn(commit_ts, tname, "delete", gids)
            for tname, segs in inserts.items():
                t = self.get_table(tname)
                for arrays, validity in segs:
                    for seg in t.insert_segments(arrays, validity,
                                                 commit_ts):
                        t._pk_bloom_add(seg)
                        affected += seg.n_rows
                        for fn in self._subscribers:
                            fn(commit_ts, tname, "insert", seg)
            touched = set(list(inserts) + list(deletes))
            self._mark_touched(touched)
            # max(): a view's maintenance commit, nested off a post-commit
            # hook, mints a newer ts than the commit that triggered it;
            # the read frontier must never retreat
            self.committed_ts = max(self.committed_ts, commit_ts)
            metrics.txn_commits.inc(outcome="ok")
        # outside the commit lock: view maintenance commits into this same
        # engine, and doing that mid-apply would tear reads
        self._notify_post_commit(commit_ts, touched)
        return affected

    def _mark_touched(self, touched) -> None:
        """After a commit or its replay: the tables' indexes go dirty,
        and a commit to the UDF or view catalog is DDL (the serving
        caches must not outlive the functions and views they were
        planned against)."""
        from matrixone_tpu_torch.mview.catalog import is_mview_table
        from matrixone_tpu_torch.udf.catalog import is_udf_table
        for tname in touched:
            for ix in self.indexes_on(tname):
                ix.dirty = True
            if is_udf_table(tname) or is_mview_table(tname):
                self.ddl_gen += 1

    def _notify_post_commit(self, commit_ts: int, touched: set) -> None:
        """Drive the materialized-view maintenance after a commit has
        fully applied.  An engine without a system_mview catalog pays one
        attribute read per commit."""
        svc = self._mview_service
        if svc is None:
            if not self._has_mview_catalog:
                return
            from matrixone_tpu_torch.mview.maintain import service_for
            svc = service_for(self)
        if self._commit_lock._is_owned():
            # a caller still holds the commit lock (a commit nested in
            # a locked section): maintaining now would take the service's
            # lock under the commit lock.  The subscriber has queued the
            # delta; the next unlocked commit drains it
            return
        svc.on_commit(commit_ts, touched)

    # ---------------------------------------------------------- compaction
    def merge_table(self, name: str, min_segments: int = 2,
                    checkpoint: bool = True) -> int:
        """Rewrite a table's visible rows into ONE segment (per
        partition), fencing the pre-merge view so AS OF reads below the
        merge stay exact (gc_fences releases the fence once nothing can
        reach it).

        Three phases, so foreground commits are never wedged: capture
        (brief commit lock: pin the segment/tombstone prefix) -> rewrite
        (no lock: concat the live rows, write the merged object) -> swap
        (brief commit lock: publish the merged segment and the fence).

        Returns the live rows kept, or -1 (too few segments), -2 (open
        transactions: their workspaces hold pre-merge gids), -3 (lost the
        race: a concurrent commit deleted a captured row or replaced the
        table; callers retry, the foreground always wins)."""
        with self._merge_lock:
            return self._merge_table_locked(name, min_segments, checkpoint)

    def _merge_table_locked(self, name, min_segments, checkpoint) -> int:
        # --- capture (brief lock): pin the prefix the rewrite covers
        with self._commit_lock:
            if self.active_txns > 0:
                return -2
            t = self.get_table(name)
            if len(t.segments) < min_segments:
                return -1
            cap_segs = list(t.segments)
            cap_tombs = list(t.tombstones)
            cap_gid = t.next_gid
        # --- rewrite (no lock): captured segments and tombstones are
        # immutable once committed; concurrent commits only APPEND
        t0 = time.perf_counter()
        if INJECTOR.trigger("merge.rewrite"):
            raise RuntimeError("injected fault: merge.rewrite")
        cols = [c for c, _ in t.meta.schema]
        parts_a = {c: [] for c in cols}
        parts_v = {c: [] for c in cols}
        dead = t._dead_gids(None, None, cap_tombs)
        dead_filter = native.RoaringBitmap(dead) if len(dead) else None
        kept = 0
        for seg in cap_segs:
            keep = ~dead_filter.test_range(
                seg.base_gid, seg.base_gid + seg.n_rows) \
                if dead_filter is not None else np.ones(seg.n_rows,
                                                        np.bool_)
            if not keep.any():
                continue
            for c in cols:
                parts_a[c].append(np.asarray(seg.arrays[c])[keep])
                parts_v[c].append(np.asarray(seg.validity[c])[keep])
            kept += int(keep.sum())
        arrays = validity = None
        obj_path = zms_json = None
        if kept:
            arrays = {c: np.concatenate(parts_a[c]) for c in cols}
            validity = {c: np.concatenate(parts_v[c]) for c in cols}
            if t.meta.partition is None:
                # write the merged object BEFORE the swap publishes it:
                # the heavy IO runs outside the commit lock (rewrite
                # durable -> swap -> manifest).  Partitioned tables
                # re-split at the swap and stay in RAM until the next
                # checkpoint.
                obj_path, zms_json = self._merge_write_object(
                    name, arrays, validity)
        metrics.merge_seconds.inc(time.perf_counter() - t0,
                                  phase="rewrite")
        # --- swap (brief lock): publish the merged segment + the fence
        t0 = time.perf_counter()
        if INJECTOR.trigger("merge.swap"):
            raise RuntimeError("injected fault: merge.swap")
        with self._commit_lock:
            if self.tables.get(name) is not t:
                return -3          # dropped or replaced during the rewrite
            if self.active_txns > 0:
                return -2
            if len(t.segments) < len(cap_segs) or any(
                    a is not b for a, b in zip(t.segments, cap_segs)):
                return -3          # the prefix was rewritten (restore)
            new_tombs = t.tombstones[len(cap_tombs):]
            if any(len(g) and int(g.min()) < cap_gid
                   for _, g in new_tombs):
                # a concurrent commit deleted a row the rewrite kept as
                # live: the rewrite is stale; defer (the scheduler retries)
                return -3
            merge_ts = self.hlc.now()
            # the fence pins the COMPLETE pre-swap view: the captured
            # segments plus any committed during the rewrite (those stay
            # live too)
            fence = MergeFence(merge_ts=merge_ts,
                               segments=list(t.segments),
                               tombstones=list(t.tombstones))
            post = t.segments[len(cap_segs):]
            t.segments = list(post)
            t.tombstones = list(new_tombs)
            if kept:
                if t.meta.partition is None:
                    seg = t.make_segment(arrays, validity, merge_ts)
                    seg.obj_path = obj_path
                    seg.zonemaps = zms_json
                    t.apply_segment(seg)
                else:
                    # partitioned tables re-split: one partition per
                    # segment stays the structural pruning invariant
                    t.insert_segments(arrays, validity, merge_ts)
            t.fences.append(fence)
            t.last_commit_ts = max(t.last_commit_ts, merge_ts)
            t.last_merge_ts = merge_ts
            t._pk_bloom = None     # rebuilt lazily over the merged rows
            t._pk_vals = {}
            self.committed_ts = max(self.committed_ts, merge_ts)
            for ix in self.indexes_on(name):
                ix.dirty = True       # gids changed: indexes must rebuild
            self._pending_merge_records[name] = merge_ts
            # durability: the merged state IS the new truth; checkpoint
            # so a replay never resurrects pre-merge rows (the fence rides
            # the manifest)
            if checkpoint:
                self._checkpoint_locked()
        metrics.merge_seconds.inc(time.perf_counter() - t0, phase="swap")
        metrics.merge_rows.inc(kept)
        metrics.merge_segments.inc(len(cap_segs))
        return kept

    def _merge_write_object(self, name: str, arrays, validity):
        """Write the merged rows as a durable object before the swap
        references them."""
        zms = objectio.compute_zonemaps(arrays, validity)
        n = len(next(iter(arrays.values())))
        meta = objectio.ObjectMeta(
            table=name, object_id=f"merge{self.hlc.now()}",
            n_rows=n, commit_ts=0, zonemaps=zms)
        path = objectio.write_object(self.fs, meta, arrays, validity)
        return path, {c: [z.min, z.max, z.null_count]
                      for c, z in zms.items()}

    def gc_fences(self, tables: Optional[List[str]] = None) -> dict:
        """Release the snapshot fences nothing can reach: a fence is held
        while any named snapshot or registered watermark of its table
        sits below its merge point; releases go oldest first.  The
        fence-free manifest is made durable FIRST and the old objects
        deleted after, so a crash in between leaks files but never
        leaves a manifest naming a deleted object."""
        released: List[Tuple[str, MergeFence]] = []
        with self._commit_lock:
            names = list(self.tables) if tables is None else tables
            for name in names:
                t = self.tables.get(name)
                if t is None or not t.fences:
                    continue
                wm = self.min_watermark(name)
                while t.fences:
                    f = t.fences[0]
                    if any(ts < f.merge_ts
                           for ts in self.snapshots.values()):
                        break          # snapshot-pinned
                    if wm is not None and wm < f.merge_ts:
                        break          # a consumer still replays below
                    t.fences.pop(0)
                    t.delta_floor = max(t.delta_floor, f.merge_ts)
                    released.append((name, f))
            if not released:
                return {"released": 0, "objects_deleted": 0}
            # paths still referenced by live segments or surviving fences
            # must survive
            live_paths = {s.obj_path for t2 in self.tables.values()
                          for s in t2.segments}
            live_paths |= {s.obj_path for t2 in self.tables.values()
                           for f2 in t2.fences for s in f2.segments}
            dead_paths = sorted(
                {s.obj_path for _, f in released for s in f.segments
                 if s.obj_path is not None} - live_paths)
            if self.fs.exists("meta/manifest.json") or \
                    self._pending_merge_records:
                self._checkpoint_locked()
        n_del = 0
        for p in dead_paths:
            blockcache.CACHE.drop_path(p)
            if self.fs.exists(p):
                self.fs.delete(p)
                n_del += 1
        metrics.merge_fences_released.inc(len(released))
        metrics.merge_gc_objects.inc(n_del)
        return {"released": len(released), "objects_deleted": n_del}

    # ------------------------------------------------- checkpoint / open
    def checkpoint(self, demote: Optional[bool] = None) -> None:
        """Write all committed state as objects + a manifest, then
        truncate the WAL (tae/db/checkpoint/runner.go), under the commit
        lock so no commit slips between the manifest and the truncation.

        demote=True turns the freshly written RAM segments into
        object-backed views served through the block cache (default:
        `MO_LAZY_SEGMENTS=1`)."""
        with self._commit_lock:
            self._checkpoint_locked(demote=demote)

    def _write_segment_object(self, name: str, seg: Segment) -> None:
        zms = objectio.compute_zonemaps(seg.arrays, seg.validity)
        meta = objectio.ObjectMeta(
            table=name, object_id=f"seg{seg.seg_id}", n_rows=seg.n_rows,
            commit_ts=seg.commit_ts, zonemaps=zms)
        seg.obj_path = objectio.write_object(self.fs, meta, seg.arrays,
                                             seg.validity)
        seg.zonemaps = {c: [z.min, z.max, z.null_count]
                        for c, z in zms.items()}

    def _checkpoint_locked(self, demote: Optional[bool] = None) -> None:
        if demote is None:
            demote = os.environ.get("MO_LAZY_SEGMENTS") == "1"
        manifest = {"ckpt_ts": self.hlc.now(), "tables": {},
                    "snapshots": dict(self.snapshots),
                    "stages": dict(self.stages), "externals": {}}
        for name, t in self.tables.items():
            if getattr(t, "is_external", False):
                manifest["externals"][name] = {
                    "location": t.location, "fmt": t.fmt,
                    "snapshot": t.snapshot,
                    "schema": schema_to_json(t.meta.schema)}
                continue
            cols = [c for c, _ in t.meta.schema]
            objs = []
            for seg in t.segments:
                if seg.obj_path is None:
                    # a fresh segment: its object is written ONCE, later
                    # checkpoints reuse it (incremental checkpoints; a
                    # full rewrite would also pull every cold block back
                    # through the cache)
                    self._write_segment_object(name, seg)
                    if demote:
                        # the writer's RAM is then bounded by the block
                        # cache too
                        seg.arrays, seg.validity = blockcache.lazy_pair(
                            self.fs, seg.obj_path, cols)
                objs.append(_segment_entry(seg))
            # snapshot fences ride the manifest: pre-merge history stays
            # reachable across a restart until gc_fences releases it
            fences = []
            for f in t.fences:
                for seg in f.segments:
                    if seg.obj_path is None:
                        self._write_segment_object(name, seg)
                fences.append({"merge_ts": f.merge_ts,
                               "objects": [_segment_entry(s)
                                           for s in f.segments],
                               "tombstones": _tombstones_json(
                                   f.tombstones)})
            manifest["tables"][name] = {
                "schema": schema_to_json(t.meta.schema),
                "pk": t.meta.primary_key,
                "auto": t.meta.auto_increment,
                "not_null": t.meta.not_null,
                "dicts": t.dicts,
                "objects": objs,
                "tombstones": _tombstones_json(t.tombstones),
                "next_gid": t.next_gid, "next_seg": t.next_seg,
                "next_auto": t.next_auto,
                "partition": (t.meta.partition.to_json()
                              if t.meta.partition is not None else None),
                "fences": fences,
                "delta_floor": t.delta_floor,
            }
        self.fs.write("meta/manifest.json", json.dumps(manifest).encode())
        self.wal.truncate()
        self._ckpt_ts = manifest["ckpt_ts"]
        # merges are announced once their post-merge manifest is durable
        for nm, ts in self._pending_merge_records.items():
            self.wal.append({"op": "merge_table", "name": nm, "ts": ts})
        self._pending_merge_records = {}

    @classmethod
    def open(cls, fs: FileService, wal=None) -> "Engine":
        """Restart: load the last checkpoint, then replay the WAL tail
        (tae/db/replay.go).  `recovery_summary` reports the frames
        replayed, the torn-tail bytes discarded, the checkpoint ts and
        the orphaned tmp files deleted (also as `mo_recovery_*`)."""
        eng = cls(fs, wal=wal)
        with motrace.root_span("engine.recover"):
            with eng._commit_lock:
                eng._load_checkpoint()
                wal_stats = eng._replay_wal()
            # a writer that died between its tmp fsync and the atomic
            # replace left an orphan no reader sees: delete it now, the
            # one moment no writer can be mid-protocol
            orphans = eng.fs.orphans()
            for p in orphans:
                eng.fs.delete(p)
            eng.recovery_summary = {
                "frames_replayed": wal_stats.get("frames", 0),
                "torn_bytes": wal_stats.get("torn_bytes", 0),
                "ckpt_ts": eng._ckpt_ts,
                "orphans_gcd": len(orphans)}
            metrics.recovery_frames.inc(wal_stats.get("frames", 0))
            metrics.recovery_torn_bytes.inc(wal_stats.get("torn_bytes", 0))
            metrics.recovery_orphans.inc(len(orphans))
            motrace.annotate(**eng.recovery_summary)
        eng.committed_ts = eng.hlc.now()
        return eng

    @classmethod
    def open_checkpoint(cls, fs: FileService) -> "Engine":
        """A CN replica's bootstrap: the last checkpoint's manifest and
        objects only, with a null WAL.  The WAL tail is the TN's and
        reaches a CN as the logtail stream (cluster/cn.py), which applies
        it record by record with `WalApplier`, as a restart replays it;
        a replica never logs."""
        eng = cls(fs, wal=NullWal())
        with eng._commit_lock:
            eng._load_checkpoint()
        eng.committed_ts = max(eng._ckpt_ts, eng.committed_ts)
        return eng

    def close(self) -> None:
        """Orderly shutdown: flush the statement recorder's tail (its
        64-statement buffering would otherwise drop the last statements
        of a session).  Idempotent; safe on an engine that never
        recorded anything."""
        rec = getattr(self, "stmt_recorder", None)
        if rec is not None:
            rec.flush()

    def _load_checkpoint(self) -> None:
        if not self.fs.exists("meta/manifest.json"):
            return
        manifest = json.loads(self.fs.read("meta/manifest.json").decode())
        self._ckpt_ts = manifest.get("ckpt_ts", 0)
        self.snapshots = dict(manifest.get("snapshots", {}))
        self.stages = dict(manifest.get("stages", {}))
        self.hlc.update(self._ckpt_ts)
        for name, ex in manifest.get("externals", {}).items():
            self.create_external(
                TableMeta(name, schema_from_json(ex["schema"]), []),
                ex["location"], ex["fmt"], log=False,
                snapshot=ex.get("snapshot"))
        for name, tm in manifest["tables"].items():
            self._load_manifest_table(name, tm)

    def _lazy_segment(self, ob: dict, cols) -> Segment:
        arrays, validity = blockcache.lazy_pair(self.fs, ob["path"], cols)
        return Segment(seg_id=ob["seg_id"], commit_ts=ob["commit_ts"],
                       arrays=arrays, validity=validity,
                       n_rows=ob["n_rows"], base_gid=ob["base_gid"],
                       part_id=ob.get("part_id", -1),
                       obj_path=ob["path"], zonemaps=ob.get("zonemaps"))

    def _load_manifest_table(self, name: str, tm: dict,
                             replace: bool = False) -> None:
        """One table from its manifest entry: its segments object-backed
        (lazy: column bytes come through the block cache on demand).
        `replace`: a CN replica's resync after a TN merge rewrote the
        table's row ids."""
        from matrixone_tpu_torch.storage.partition import PartitionSpec
        schema = schema_from_json(tm["schema"])
        if replace:
            self.tables.pop(name, None)
        self.create_table(
            TableMeta(name, schema, tm["pk"],
                      auto_increment=tm.get("auto"),
                      not_null=tm.get("not_null", []),
                      partition=PartitionSpec.from_json(
                          tm.get("partition"))),
            log=False)
        t = self.get_table(name)
        t.dicts = {k: list(v) for k, v in tm["dicts"].items()}
        t._dict_idx = {k: {s_: i for i, s_ in enumerate(v)}
                       for k, v in t.dicts.items()}
        cols = [c for c, _ in schema]
        for ob in tm["objects"]:
            t.apply_segment(self._lazy_segment(ob, cols))
        t.tombstones = _tombstones_from_json(tm["tombstones"])
        for fj in tm.get("fences", []):
            t.fences.append(MergeFence(
                merge_ts=fj["merge_ts"],
                segments=[self._lazy_segment(ob, cols)
                          for ob in fj["objects"]],
                tombstones=_tombstones_from_json(fj["tombstones"])))
        t.delta_floor = tm.get("delta_floor", 0)
        t.next_gid = tm["next_gid"]
        t.next_seg = tm["next_seg"]
        t.next_auto = tm["next_auto"]

    def _replay_wal(self) -> dict:
        stats: dict = {"frames": 0, "torn_bytes": 0}
        ap = WalApplier(self, skip_ts=self._ckpt_ts)
        for header, blob in self.wal.replay(stats=stats):
            ap.apply(header, blob)
        self.hlc.update(ap.max_ts)
        return stats


class WalApplier:
    """Applies WAL records to an engine one at a time (the restart
    replay).  Inserts and deletes buffer until their commit record;
    catalog records apply at once.  `apply` returns the commit ts when
    a commit was applied, else None."""

    def __init__(self, eng: "Engine", skip_ts: int = 0):
        self.eng = eng
        self.skip_ts = skip_ts
        self.pending: List[tuple] = []
        self.max_ts = skip_ts

    def apply(self, header: dict, blob=b""):
        eng = self.eng
        op = header["op"]
        # frames at or before the checkpoint are in the manifest already
        # (a crash between the manifest write and the WAL truncation)
        hts = header.get("ts", 0)
        if hts and hts <= self.skip_ts:
            return None
        if op == "create_table":
            from matrixone_tpu_torch.storage.partition import PartitionSpec
            eng.create_table(
                TableMeta(header["name"], schema_from_json(header["schema"]),
                          header["pk"], auto_increment=header.get("auto"),
                          not_null=header.get("not_null", []),
                          partition=PartitionSpec.from_json(
                              header.get("partition"))),
                log=False, if_not_exists=True)
        elif op == "drop_table":
            eng.drop_table(header["name"], if_exists=True, log=False)
        elif op == "alter_partition_drop":
            eng.alter_partition_drop(header["table"], header["part"],
                                     log=False)
        elif op == "create_external":
            eng.create_external(
                TableMeta(header["name"], schema_from_json(header["schema"]),
                          []),
                header["location"], header["fmt"], log=False,
                if_not_exists=True, snapshot=header.get("snapshot"))
        elif op == "create_stage":
            eng.create_stage(header["name"], header["url"], log=False)
        elif op == "drop_stage":
            if header["name"] in eng.stages:     # replay-idempotent
                eng.drop_stage(header["name"], log=False)
        elif op == "create_snapshot":
            # direct: create_snapshot() mints a fresh ts and logs
            eng.snapshots[header["name"]] = header["ts"]
            eng.ddl_gen += 1
        elif op == "drop_snapshot":
            if header["name"] in eng.snapshots:
                del eng.snapshots[header["name"]]
                eng.ddl_gen += 1
        elif op in ("insert", "delete"):
            self.pending.append((op, header, blob))
        elif op == "commit":
            ts = header["ts"]
            self.max_ts = max(self.max_ts, ts)
            # deletes BEFORE inserts, as commit_txn applies them
            ordered = ([p for p in self.pending if p[0] == "delete"]
                       + [p for p in self.pending if p[0] == "insert"])
            for kind, h, b in ordered:
                t = eng.get_table(h["table"])
                if kind == "insert":
                    arrays, validity = walmod.payload_to_arrays(h, b)
                    arrays = {c: (t.encode_dict_encoded(c, a)
                                  if isinstance(a, walmod.DictEncoded)
                                  else np.array(a))
                              for c, a in arrays.items()}
                    validity = {c: np.array(v) for c, v in validity.items()}
                    for seg in t.insert_segments(arrays, validity, ts):
                        for fn in eng._subscribers:
                            fn(ts, h["table"], "insert", seg)
                    ac = t.meta.auto_increment
                    if ac and ac in arrays:
                        t.observe_auto(arrays[ac][validity[ac]])
                else:
                    gids = np.frombuffer(b, dtype="<i8").astype(np.int64)
                    t.apply_tombstones(ts, gids)
                    for fn in eng._subscribers:
                        fn(ts, h["table"], "delete", gids)
            eng._mark_touched({h["table"] for _k, h, _b in ordered})
            self.pending = []
            return ts
        return None


class NullWal:
    """The WAL of a CN replica: it never logs.  Durability is the TN's;
    every mutation of a replica arrives from the TN's log."""

    def append(self, header: dict, blob=b"") -> None:
        pass

    def truncate(self) -> None:
        pass


#: the catalog role is played by the engine itself
Catalog = Engine
