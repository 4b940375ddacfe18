"""MVCC storage engine, in-memory: versioned segments + tombstones.

The port's copy of the in-memory half of `matrixone_tpu/storage/engine.py`:
the catalog, MVCC tables of committed numpy segments with table-global
string dictionaries, row deletes as tombstones (commit ts, global row
ids), the single-writer commit pipeline (first-committer-wins conflict
check on deletes, NOT NULL and primary-key uniqueness over live rows,
a hybrid-logical-clock commit ts, deletes applied before inserts, then
the read frontier `committed_ts` advances), snapshot scans that merge a
transaction's workspace (`extra_segments`, `extra_deletes`) into the
rows visible at its snapshot and can carry each row's id (`ROWID`),
named snapshots with `restore_table`, auto-increment counters and the
pessimistic lock service (`lockservice`).

The primary-key check probes a bloom filter over the table's keys first
(reference: colexec/fuzzyfilter): only its suspects pay the exact
membership test against the live rows.  A scan builds its dead set once
as a roaring bitmap and tests each chunk's contiguous gid range against
it.  Both live in the port's host library (`matrixone_tpu_torch/native`).
A partitioned table (`storage/partition.py`) splits every insert so one
segment holds one partition's rows, and a scan skips the segments of
the partitions its filters exclude.

Not ported yet (ROADMAP.md, section A): the WAL, checkpoints and the
object store (they need `pyarrow`, which the card machine lacks),
merges and their snapshot fences, the logtail subscribers (CDC), the
index cache and the co-partitioned shard read.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from matrixone_tpu_torch import native
from matrixone_tpu_torch.container.dtypes import DType, TypeOid
from matrixone_tpu_torch.sql.expr import BoundCol, BoundExpr, BoundFunc, \
    BoundLiteral
from matrixone_tpu_torch.txn.hlc import HLC
from matrixone_tpu_torch.utils import metrics

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
class Segment:
    seg_id: int
    commit_ts: int                       # 0 for a workspace segment
    arrays: Dict[str, np.ndarray]        # varchar columns as int32 codes
    validity: Dict[str, np.ndarray]
    n_rows: int
    base_gid: int
    part_id: int = -1                    # -1 = unpartitioned table


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
        """(segments, tombstones) source lists for a read at snapshot_ts:
        the live lists (no merges, so no snapshot fences yet)."""
        return self.segments, self.tombstones

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
                    extra_deletes: Optional[np.ndarray] = None
                    ) -> Iterator[tuple]:
        """Yield (arrays, validity, dicts, n) chunks of at most batch_rows
        rows: the segments committed at or before snapshot_ts, then a
        transaction's own segments, without the rows tombstoned at
        snapshot_ts or deleted by the transaction, skipping chunks whose
        zonemaps exclude a filter.  `ROWID` among the columns yields each
        row's global id."""
        want_rowid = ROWID in columns
        data_cols = [c for c in columns if c != ROWID]
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
        qmap = dict(zip(qualified_names or columns, columns))
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
            metrics.scan_segments.inc(outcome="read")
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
                arrays, validity = {}, {}
                for c in data_cols:
                    a = seg.arrays[c][start:end]
                    v = seg.validity[c][start:end]
                    if keep is not None:
                        a, v = a[keep], v[keep]
                    arrays[c] = a
                    validity[c] = v
                if want_rowid:
                    g = np.arange(lo, seg.base_gid + end, dtype=np.int64)
                    arrays[ROWID] = g if keep is None else g[keep]
                    validity[ROWID] = np.ones(len(arrays[ROWID]), np.bool_)
                n = len(next(iter(arrays.values()))) if arrays else 0
                if n == 0:
                    continue
                if filters and _zonemap_excludes(filters, arrays, validity,
                                                 qmap, dict(self.meta.schema)):
                    continue
                yield arrays, validity, self.dicts, n

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
        in gid order."""
        gids = np.asarray(gids, np.int64)
        bases = np.array([s.base_gid for s in self.segments], np.int64)
        seg_idx = np.searchsorted(bases, gids, side="right") - 1
        owners: List[Segment] = []
        for gi, si in zip(gids, seg_idx):
            seg = self.segments[si] if si >= 0 else None
            if seg is None or gi >= seg.base_gid + seg.n_rows:
                raise KeyError(f"gid {int(gi)} not found in "
                               f"{self.meta.name!r}")
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


class Engine:
    """Catalog + single-writer commit service (in memory)."""

    def __init__(self):
        from matrixone_tpu_torch.lockservice import LockService
        self.hlc = HLC()
        self.tables: Dict[str, MVCCTable] = {}
        # reentrant: table helpers called under a commit take it again
        self._commit_lock = threading.RLock()
        #: catalog-shape generation: bumped on every DDL
        self.ddl_gen = 0
        self.snapshots: Dict[str, int] = {}      # named points in time
        #: last FULLY applied commit: readers snapshot here so a commit
        #: mid-apply (tombstones in, segments not yet) can never tear a read
        self.committed_ts = self.hlc.now()
        self.locks = LockService()     # pessimistic mode (pkg/lockservice)

    # ----------------------------------------------------------- catalog
    def create_table(self, meta: TableMeta, if_not_exists=False) -> None:
        if meta.name in self.tables:
            if if_not_exists:
                return
            raise ValueError(f"table {meta.name} already exists")
        t = MVCCTable(meta)
        t.engine = self
        self.tables[meta.name] = t
        self.ddl_gen += 1

    def drop_table(self, name: str, if_exists=False) -> None:
        if name not in self.tables:
            if if_exists:
                return
            raise ValueError(f"no such table {name}")
        del self.tables[name]
        self.ddl_gen += 1

    def alter_partition_drop(self, table: str, part: str) -> None:
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

    def get_table(self, name: str) -> MVCCTable:
        if name not in self.tables:
            raise ValueError(f"no such table {name}")
        return self.tables[name]

    def indexes_on(self, table: str) -> list:
        """Secondary indexes of a table: none, until indexes are ported
        (the plan rewrites of sql/optimize.py ask)."""
        return []

    # --------------------------------------------------- snapshots / PITR
    def create_snapshot(self, name: str) -> int:
        """A named point in time (CREATE SNAPSHOT)."""
        ts = self.hlc.now()
        self.snapshots[name] = ts
        self.ddl_gen += 1
        return ts

    def drop_snapshot(self, name: str) -> None:
        self.snapshots.pop(name, None)
        self.ddl_gen += 1

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
        conflict check -> constraints -> commit ts -> apply -> frontier.
        Returns rows affected."""
        with self._commit_lock:
            # write-write conflict: someone deleted my victim after my
            # snapshot (first-committer-wins)
            if snapshot_ts is not None:
                for tname, gids in deletes.items():
                    t = self.get_table(tname)
                    mine = np.asarray(gids, np.int64)
                    newer = [g for ts, g in t.tombstones if ts > snapshot_ts]
                    if newer and len(np.intersect1d(
                            mine, np.concatenate(newer))):
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
            # apply: deletes BEFORE inserts — an UPDATE is delete+insert at
            # one commit ts
            for tname, gids in deletes.items():
                t = self.get_table(tname)
                t.apply_tombstones(commit_ts, np.asarray(gids, np.int64))
                affected += len(gids)
            for tname, segs in inserts.items():
                t = self.get_table(tname)
                for arrays, validity in segs:
                    for seg in t.insert_segments(arrays, validity,
                                                 commit_ts):
                        t._pk_bloom_add(seg)
                        affected += seg.n_rows
            # max(): the read frontier must never retreat
            self.committed_ts = max(self.committed_ts, commit_ts)
        return affected


#: the catalog role is played by the engine itself
Catalog = Engine
