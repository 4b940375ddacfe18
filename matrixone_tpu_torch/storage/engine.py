"""MVCC storage engine, in-memory subset: versioned segments + commit ts.

The port's copy of the in-memory half of `matrixone_tpu/storage/engine.py`:
the catalog, MVCC tables of committed numpy segments with table-global
string dictionaries, the single-writer commit pipeline for inserts
(NOT NULL and primary-key uniqueness checked before anything is applied,
a hybrid-logical-clock commit ts, apply, then the read frontier
`committed_ts` advances), and snapshot scans that read each segment
committed at or before the reader's ts, pruned by per-chunk zonemaps.

Not ported yet (ROADMAP.md, section A): the WAL, checkpoints and the
object store (they need `pyarrow`, which the card machine lacks),
merges and their snapshot fences, deletes, updates and transactions
(so no tombstones and no row ids), partitions, auto-increment, the lock
service, the index cache and the primary-key bloom filter (the
uniqueness check here is the same exact membership test, unfiltered).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from matrixone_tpu_torch.container.dtypes import DType, TypeOid
from matrixone_tpu_torch.sql.expr import BoundCol, BoundExpr, BoundFunc, \
    BoundLiteral
from matrixone_tpu_torch.txn.hlc import HLC

Schema = List[Tuple[str, DType]]


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
    not_null: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Segment:
    seg_id: int
    commit_ts: int                       # committed segments only
    arrays: Dict[str, np.ndarray]        # varchar columns as int32 codes
    validity: Dict[str, np.ndarray]
    n_rows: int
    base_gid: int


class DuplicateKeyError(RuntimeError):
    pass


class ConstraintError(RuntimeError):
    pass


_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _splitmix_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 over uint64 (host), as ops/hash.py computes it."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint64) + _GOLDEN
        x = (x ^ (x >> np.uint64(30))) * _M1
        x = (x ^ (x >> np.uint64(27))) * _M2
        return x ^ (x >> np.uint64(31))


class MVCCTable:
    """Versioned columnar table; readers see a snapshot, writers go
    through the engine's commit pipeline."""

    #: wired by Engine.create_table
    engine: "Engine" = None

    def __init__(self, meta: TableMeta):
        self.meta = meta
        self.segments: List[Segment] = []
        #: (commit_ts, gids) of deleted rows: always empty until deletes
        #: are ported; the statistics and the row count read it
        self.tombstones: List[Tuple[int, np.ndarray]] = []
        #: commit TS of the last data change applied to THIS table
        self.last_commit_ts = 0
        self.next_gid = 0
        self.next_seg = 0
        self.dicts: Dict[str, List[str]] = {
            c: [] for c, d in meta.schema if d.is_varlen}
        self._dict_idx: Dict[str, Dict[str, int]] = {c: {} for c in self.dicts}
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

    @property
    def schema(self) -> Schema:
        return self.meta.schema

    @property
    def n_rows(self) -> int:
        """Committed row count net of tombstones (latest snapshot)."""
        return sum(s.n_rows for s in self.segments)

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
                    hc = _splitmix_np(np.ascontiguousarray(
                        arrays[c], np.int64).view(np.uint64))
                    h = hc if h is None else _splitmix_np(
                        h ^ (hc + _GOLDEN + (h << np.uint64(6))
                             + (h >> np.uint64(2))))
            return h.view(np.int64)
        return None

    def check_pk_unique(self, arrays: Dict[str, np.ndarray],
                        validity: Optional[np.ndarray] = None) -> None:
        """Raise DuplicateKeyError if the batch collides with existing live
        PK values or contains internal duplicates (fuzzyfilter analogue).
        NULL primary keys are rejected outright (PK implies NOT NULL)."""
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
        for seg in self.segments:
            vals = self.pk_key_values(seg.arrays)
            collide = new[np.isin(new, vals)]
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
                seg_rows = np.nonzero(vals == k)[0]
                for r in seg_rows:
                    if all(int(seg.arrays[cc][r]) == int(arrays[cc][in_row])
                           for cc in self._pk_cols):
                        shown = tuple(int(seg.arrays[cc][r])
                                      for cc in self._pk_cols)
                        raise DuplicateKeyError(
                            f"duplicate key {shown} for "
                            f"{self.meta.name!r}.{c}")

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

    # --------------------------------------------------------------- read
    def iter_chunks(self, columns: List[str], batch_rows: int,
                    filters: Optional[List[BoundExpr]] = None,
                    qualified_names: Optional[List[str]] = None,
                    snapshot_ts: Optional[int] = None) -> Iterator[tuple]:
        """Yield (arrays, validity, dicts, n) chunks of at most batch_rows
        rows from the segments committed at or before snapshot_ts,
        skipping chunks whose zonemaps exclude a filter."""
        segs = [s for s in self.segments
                if snapshot_ts is None or s.commit_ts <= snapshot_ts]
        qmap = dict(zip(qualified_names or columns, columns))
        for seg in segs:
            for start in range(0, seg.n_rows, batch_rows):
                end = min(start + batch_rows, seg.n_rows)
                arrays = {c: seg.arrays[c][start:end] for c in columns}
                validity = {c: seg.validity[c][start:end] for c in columns}
                if filters and _zonemap_excludes(filters, arrays, validity,
                                                 qmap, dict(self.meta.schema)):
                    continue
                yield arrays, validity, self.dicts, end - start

    # -------------------------------------------------- convenience write
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
        self.hlc = HLC()
        self.tables: Dict[str, MVCCTable] = {}
        # reentrant: table helpers called under a commit take it again
        self._commit_lock = threading.RLock()
        #: catalog-shape generation: bumped on every DDL
        self.ddl_gen = 0
        #: last FULLY applied commit: readers snapshot here so a commit
        #: mid-apply can never tear a read
        self.committed_ts = self.hlc.now()

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

    def get_table(self, name: str) -> MVCCTable:
        if name not in self.tables:
            raise ValueError(f"no such table {name}")
        return self.tables[name]

    def indexes_on(self, table: str) -> list:
        """Secondary indexes of a table: none, until indexes are ported
        (the plan rewrites of sql/optimize.py ask)."""
        return []

    # ------------------------------------------------------------ commit
    def commit_write(self, table: str, arrays, validity) -> int:
        """Autocommit a single-table insert."""
        return self.commit_txn(
            snapshot_ts=None,
            inserts={table: [(arrays, validity)]}, deletes={})

    def commit_txn(self, snapshot_ts: Optional[int],
                   inserts: Dict[str, list],
                   deletes: Dict[str, np.ndarray]) -> int:
        """The commit pipeline (tae/rpc/handle.go:547 HandleCommit) for
        inserts: constraint checks -> commit ts -> apply -> frontier.
        Returns rows affected."""
        if any(len(g) for g in deletes.values()):
            raise NotImplementedError(
                "deletes are not ported yet (ROADMAP.md, section A)")
        with self._commit_lock:
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
            # batches are checked as ONE key set
            for tname, segs in inserts.items():
                t = self.get_table(tname)
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
                        t.check_pk_unique(combined, validity=val)
            commit_ts = self.hlc.now()
            affected = 0
            for tname, segs in inserts.items():
                t = self.get_table(tname)
                for arrays, validity in segs:
                    seg = t.make_segment(arrays, validity, commit_ts)
                    t.apply_segment(seg)
                    affected += seg.n_rows
            self.committed_ts = max(self.committed_ts, commit_ts)
        return affected


#: the catalog role is played by the engine itself
Catalog = Engine
