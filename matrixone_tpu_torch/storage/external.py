"""External tables and stages: scan CSV files in place, no ingest.

The port's copy of `matrixone_tpu/storage/external.py` (reference
analogue: `pkg/sql/colexec/external/external.go` and `pkg/stage`).  An
ExternalTable quacks like MVCCTable's READ surface (`iter_chunks` with
pushed filters and a per-chunk zonemap skip, table-level string
dictionaries), so ScanOp and the whole device pipeline work unchanged;
the scan uploads each chunk to the session's device.  Writes are
refused.  Location URLs:

    /abs/path or file:///abs/path   host filesystem
    fs://rel/path                   the engine's file service
    stage://name/rel/path           resolved through the stage registry

The port reads CSV through its own reader (`storage/csvread.py`); the
reference's parquet and iceberg tables need pyarrow, which the port
never imports, so those formats raise NotImplementedError when read.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Union

import numpy as np

from matrixone_tpu_torch.storage import csvread
from matrixone_tpu_torch.storage.engine import ROWID, TableMeta, \
    _zonemap_excludes
from matrixone_tpu_torch.utils import metrics


class ExternalError(RuntimeError):
    pass


def resolve_location(url: str, stages: Dict[str, str]) -> str:
    """Expand stage:// references (one level of indirection, like the
    reference's stage URL rewrite)."""
    if url.startswith("stage://"):
        rest = url[len("stage://"):]
        name, _, rel = rest.partition("/")
        if name not in stages:
            raise ExternalError(f"no such stage {name!r}")
        base = stages[name].rstrip("/")
        out = f"{base}/{rel}" if rel else base
        if out.startswith("stage://"):
            raise ExternalError("stage URLs cannot nest")
        return out
    return url


def open_location(engine, url: str) -> Union[str, bytes]:
    """A location URL as a local path, or the file's bytes for fs://.
    Shared by external tables, LOAD DATA, and load_file() datalinks."""
    if engine is not None:
        url = resolve_location(url, getattr(engine, "stages", {}))
    if url.startswith("fs://"):
        if engine is None:
            raise ExternalError("fs:// location needs an engine")
        return engine.fs.read(url[len("fs://"):])
    if url.startswith("file://"):
        url = url[len("file://"):]
    if not os.path.exists(url):
        raise ExternalError(f"external file not found: {url}")
    return url


def read_datalink(engine, url: str) -> str:
    """load_file(datalink): the file's TEXT content; documents
    (.pdf/.docx) are extracted, everything else decodes as UTF-8
    (reference: pkg/datalink document readers + load_file)."""
    from matrixone_tpu_torch.storage.doctext import extract_text
    src = open_location(engine, url)
    if isinstance(src, bytes):
        blob = src
    else:
        with open(src, "rb") as f:
            blob = f.read()
    try:
        return extract_text(url, blob)
    except Exception as e:               # noqa: BLE001 — malformed
        # document: a SQL-level error, never a raw BadZipFile/XML
        # traceback out of the binder's const-fold
        raise ExternalError(
            f"cannot extract text from {url!r}: "
            f"{type(e).__name__}: {e}") from None


class ExternalTable:
    """Read-only table over a CSV file (colexec/external role)."""

    is_external = True

    def __init__(self, meta: TableMeta, location: str, fmt: str,
                 engine=None, snapshot=None):
        if fmt not in ("parquet", "csv", "iceberg"):
            raise ExternalError(f"unsupported external format {fmt!r}")
        self.meta = meta
        self.location = location
        self.fmt = fmt
        #: iceberg time travel: pinned snapshot id (None = current)
        self.snapshot = snapshot
        self.engine = engine
        self.dicts: Dict[str, List[str]] = {
            c: [] for c, d in meta.schema if d.is_varlen}
        self._dict_idx: Dict[str, Dict[str, int]] = {
            c: {} for c in self.dicts}
        # MVCCTable-shape stubs so generic catalog walks don't trip
        self.segments: list = []
        self.tombstones: list = []
        self.fences: list = []
        self.last_merge_ts = 0
        self.delta_floor = 0
        self.next_gid = 0
        self._pk_col = None
        self._pk_cols: list = []
        self._n_rows: Optional[int] = None
        # scans encode strings at READ time: concurrent scans must not
        # race the append-only dictionary
        self._dict_lock = threading.Lock()
        # decoded-chunk cache: (stat_sig, chunks, bytes) for a local file
        # under the byte budget, invalidated by mtime/size
        self._cache: Optional[tuple] = None
        self._cache_lock = threading.Lock()
        self._populate_lock = threading.Lock()

    # ------------------------------------------------------------- plumbing
    @property
    def schema(self):
        return self.meta.schema

    @property
    def n_rows(self) -> int:
        if self._n_rows is None:
            self._n_rows = sum(n for _a, _v, _d, n in
                               self.iter_chunks(
                                   [self.meta.schema[0][0]], 1 << 20))
        return self._n_rows

    def _open(self):
        return open_location(self.engine, self.location)

    def _read_file(self) -> csvread.CsvTable:
        """The whole file split and inferred (the reference's
        `pacsv.read_csv(src)`); counted by `mo_external_parses_total`."""
        if self.fmt != "csv":
            raise NotImplementedError(
                f"external {self.fmt} tables need pyarrow, which the port "
                f"does not use (ROADMAP.md, section A: not queued)")
        tbl = csvread.read_csv(self._open())
        metrics.external_parses.inc(1, table=self.meta.name)
        return tbl

    def _encode(self, col: str, strings) -> np.ndarray:
        out = np.zeros(len(strings), dtype=np.int32)
        with self._dict_lock:
            lut, d = self._dict_idx[col], self.dicts[col]
            for i, s in enumerate(strings):
                if s is None:
                    continue
                code = lut.get(s)
                if code is None:
                    code = len(d)
                    lut[s] = code
                    d.append(s)
                out[i] = code
        return out

    # --------------------------------------------------------- file cache
    #: PROCESS-WIDE decoded-bytes budget across every external table
    #: (read at call time so the env var works whenever it is set)
    _cache_used = 0
    _cache_acct_lock = threading.Lock()

    @staticmethod
    def _cache_budget() -> int:
        return int(os.environ.get("MO_EXTERNAL_CACHE_MB", "256")) << 20

    def _stat_sig(self):
        """(mtime_ns, size) of the backing LOCAL file, or None when the
        location is not statable (fs://, stage->fs): those stream."""
        try:
            url = resolve_location(self.location,
                                   getattr(self.engine, "stages", {})
                                   if self.engine is not None else {})
        except ExternalError:
            return None
        if url.startswith("file://"):
            url = url[len("file://"):]
        if url.startswith("fs://") or not os.path.exists(url):
            return None
        st = os.stat(url)
        return (st.st_mtime_ns, st.st_size)

    def _cached_full(self, populate: bool):
        """All schema columns decoded once, reused across queries while
        the file is unchanged and under the byte budget (of DECODED
        bytes).  `populate` gates cold materialization: only an
        unfiltered scan pays the full read."""
        sig = self._stat_sig()
        budget = self._cache_budget()
        with self._cache_lock:              # brief: hit/negative check
            if self._cache is not None and self._cache[0] != sig:
                self._drop_cache_locked()   # file changed: free budget
            if sig is None or sig[1] > budget:
                return None
            if self._cache is not None and self._cache[0] == sig:
                return self._cache if self._cache[1] is not None else None
            if not populate:
                # streaming readers must never wait on a cold decode
                return None
        # cold populate serialized on its OWN lock so concurrent first
        # queries don't each decode the file, and filtered readers
        # above never block on it
        with self._populate_lock:
            with self._cache_lock:
                if self._cache is not None and self._cache[0] == sig:
                    return (self._cache if self._cache[1] is not None
                            else None)
            cols = [c for c, _ in self.meta.schema]
            chunks = []
            # reserve into the PROCESS-WIDE budget chunk by chunk, so two
            # tables populating at once cannot jointly overshoot it
            decoded = 0                     # bytes THIS populate holds
            try:
                for arrays, validity, _d, n in self._iter_stream(
                        cols, 1 << 20, None, {}):
                    step = sum(a.nbytes for a in arrays.values()) \
                        + sum(v.nbytes for v in validity.values())
                    with ExternalTable._cache_acct_lock:
                        over = (ExternalTable._cache_used + step > budget)
                        if not over:
                            ExternalTable._cache_used += step
                    if over:
                        # decoded form over the budget: roll back our
                        # reservation, remember NOT to retry every
                        # query, and stream
                        with ExternalTable._cache_acct_lock:
                            ExternalTable._cache_used -= decoded
                        decoded = 0
                        with self._cache_lock:
                            self._drop_cache_locked()
                            self._cache = (sig, None, 0)
                        return None
                    decoded += step
                    chunks.append((arrays, validity, n))
            except BaseException:   # noqa: BLE001 — byte-accounting
                # rollback only, always re-raised
                with ExternalTable._cache_acct_lock:
                    ExternalTable._cache_used -= decoded
                raise
            with self._cache_lock:
                self._drop_cache_locked()
                self._cache = (sig, chunks, decoded)
                return self._cache

    def _drop_cache_locked(self) -> None:
        """Release the old entry's global accounting (file changed /
        table dropped)."""
        if self._cache is not None and self._cache[1] is not None:
            with ExternalTable._cache_acct_lock:
                ExternalTable._cache_used -= self._cache[2]
        self._cache = None

    def release_cache(self) -> None:
        """DROP TABLE hook: give the decoded bytes back to the
        process-wide budget."""
        with self._cache_lock:
            self._drop_cache_locked()

    # ----------------------------------------------------------- read path
    def iter_chunks(self, columns: List[str], batch_rows: int,
                    filters=None, qualified_names=None, **_txn_kwargs):
        """MVCCTable.iter_chunks-compatible read (txn kwargs ignored: an
        external file has no versions).  Zonemap pruning applies per
        chunk exactly as on internal segments; repeat queries of a local
        file serve from the decoded cache."""
        sd = dict(self.meta.schema)
        want = [c for c in columns if c != ROWID]
        qmap = dict(zip(qualified_names or columns, columns))
        cached = self._cached_full(populate=not filters)
        if cached is not None:
            base = 0
            for call, vall, cn in cached[1]:
                # honor the caller's chunk size (session batch_rows):
                # cached chunks may be larger than the device budget
                for off in range(0, cn, batch_rows):
                    n = min(batch_rows, cn - off)
                    start = base + off
                    arrays = {c: call[c][off:off + n] for c in want}
                    validity = {c: vall[c][off:off + n] for c in want}
                    if ROWID in columns:
                        arrays[ROWID] = np.arange(start, start + n,
                                                  dtype=np.int64)
                        validity[ROWID] = np.ones(n, np.bool_)
                    if filters and _zonemap_excludes(
                            filters, arrays, validity, qmap, sd):
                        continue
                    yield arrays, validity, self.dicts, n
                base += cn
            return
        yield from self._iter_stream(columns, batch_rows, filters, qmap)

    def _iter_stream(self, columns: List[str], batch_rows: int,
                     filters, qmap):
        sd = dict(self.meta.schema)
        want = [c for c in columns if c != ROWID]
        tbl = self._read_file()
        missing = [c for c in want if c not in tbl.columns]
        if missing:
            # the reference's `Table.select(want)` of absent columns
            raise KeyError(f"Field \"{missing[0]}\" does not exist in "
                           f"schema")
        for base_gid in range(0, tbl.n_rows, batch_rows):
            stop = min(base_gid + batch_rows, tbl.n_rows)
            n = stop - base_gid
            arrays, validity = {}, {}
            for c in want:
                if sd[c].is_varlen:
                    arrays[c], validity[c] = tbl.columns[c].dict_codes(
                        lambda s, c=c: self._encode(c, s), base_gid, stop)
                else:
                    vec = tbl.columns[c].to_vector(sd[c], base_gid, stop)
                    arrays[c] = np.asarray(vec.data)
                    validity[c] = vec.valid_mask().copy()
            if ROWID in columns:
                arrays[ROWID] = np.arange(base_gid, stop, dtype=np.int64)
                validity[ROWID] = np.ones(n, np.bool_)
            if filters and _zonemap_excludes(filters, arrays, validity,
                                             qmap, sd):
                continue
            yield arrays, validity, self.dicts, n

    # --------------------------------------------------------- write guard
    def _refuse(self, *_a, **_k):
        raise ExternalError(
            f"table {self.meta.name!r} is EXTERNAL (read-only); "
            f"LOAD it into an internal table to modify rows")

    insert_batch = _refuse
    insert_segments = _refuse
    apply_tombstones = _refuse
    allocate_auto = _refuse
