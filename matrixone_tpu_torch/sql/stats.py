"""Table/column statistics feeding the cost-based optimizer.

Reference analogue: `pkg/sql/plan/stats.go` (BuildPlan-time table stats:
row counts, NDVs, min/max per column, used by `query_builder.go`'s join
ordering and shuffle decisions) and the stats cache invalidated by logtail
updates (`pkg/sql/plan/stats_cache.go`).  Redesign: stats are computed
host-side straight from the engine's committed numpy segments (the engine
IS the stats source — no separate stats objects on S3), cached per table
and invalidated by a cheap fingerprint (segment count, next_gid, tombstone
count), and refreshed explicitly by `ANALYZE TABLE`.

Values are in *raw storage units*: dates as epoch days, DECIMAL64 as the
scaled int64, varchar as dictionary codes (NDV only — range order over
codes is insertion order, not collation, so lo/hi are not exposed for
varchar).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

import numpy as np

# rows sampled per column before switching to scaled estimation
SAMPLE_CAP = 262144


@dataclasses.dataclass
class ColumnStats:
    ndv: float               # estimated number of distinct non-null values
    lo: Optional[float]      # min in raw units (None: varchar/vector)
    hi: Optional[float]
    null_frac: float


@dataclasses.dataclass
class TableStats:
    row_count: int
    cols: Dict[str, ColumnStats]


def _estimate_ndv(sample_d: int, sample_n: int, total_n: int) -> float:
    """Scale sample NDV to the full table.  Low distinct fraction in the
    sample means a categorical domain that is (almost) fully observed;
    high fraction means a near-unique column that grows with the table —
    the same two-regime heuristic the reference's calcNdv uses."""
    if sample_n == 0:
        return 0.0
    if sample_n >= total_n:
        return float(sample_d)
    frac = sample_d / sample_n
    if frac < 0.1:
        return float(sample_d)
    return min(float(total_n), sample_d * (total_n / sample_n))


def collect_table_stats(table) -> TableStats:
    """Compute stats for an MVCCTable from its committed segments.
    Tombstones are ignored (estimates, not answers); the row count is the
    net live count so join/filter cardinalities stay honest after deletes."""
    total = sum(s.n_rows for s in table.segments)
    live = table.n_rows
    cols: Dict[str, ColumnStats] = {}
    for col, dtype in table.meta.schema:
        if dtype.is_vector:
            continue
        # spread the sample budget across ALL segments proportionally
        # (a prefix of the earliest segments biases NDV/lo/hi for
        # time-correlated inserts)
        parts = []
        vparts = []
        for seg in table.segments:
            if total <= SAMPLE_CAP:
                take = seg.n_rows
            else:
                take = max(1, (SAMPLE_CAP * seg.n_rows) // total)
            parts.append(seg.arrays[col][:take])
            vparts.append(seg.validity[col][:take])
        if not parts:
            cols[col] = ColumnStats(0.0, None, None, 0.0)
            continue
        a = np.concatenate(parts)
        v = np.concatenate(vparts)
        valid = a[v] if not v.all() else a
        null_frac = 1.0 - (len(valid) / max(len(a), 1))
        if len(valid) == 0:
            cols[col] = ColumnStats(0.0, None, None, 1.0)
            continue
        d = len(np.unique(valid))
        # sample size = VALID values only (d counts distinct over valid);
        # scale to the non-null population, not the raw row count
        total_valid = max(1, round(total * (1.0 - null_frac)))
        ndv = _estimate_ndv(d, len(valid), total_valid)
        if dtype.is_varlen:
            lo = hi = None
        else:
            lo, hi = float(valid.min()), float(valid.max())
        cols[col] = ColumnStats(ndv=min(ndv, float(max(live, 1))),
                                lo=lo, hi=hi, null_frac=null_frac)
    return TableStats(row_count=live, cols=cols)


class StatsProvider:
    """Cached per-table stats with fingerprint invalidation.  Attach one
    per Engine (see `frontend.session`); `ANALYZE TABLE` calls refresh()."""

    # recollect only past this relative row-count drift — per-commit
    # recollection would put O(table) host work on every query of a
    # write-heavy workload (reference: stats_cache.go update threshold)
    STALE_FRAC = 0.1

    def __init__(self, catalog):
        self.catalog = catalog
        # name -> (fingerprint, stats, live_rows_at_collect)
        self._cache: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _fingerprint(table) -> tuple:
        return (len(table.segments), table.next_gid,
                sum(len(g) for _, g in table.tombstones))

    def table(self, name: str) -> Optional[TableStats]:
        try:
            t = self.catalog.get_table(name)
        except (KeyError, ValueError):   # unknown/concurrently-dropped
            return None
        if getattr(t, "is_external", False):
            return None     # no segment stats for scan-in-place files
        fp = self._fingerprint(t)
        with self._lock:
            hit = self._cache.get(name)
            if hit is not None:
                if hit[0] == fp:
                    return hit[1]
                base = hit[2]
                if base > 0 and abs(t.n_rows - base) <= self.STALE_FRAC * base:
                    return hit[1]       # drifted < threshold: estimates hold
        st = collect_table_stats(t)
        with self._lock:
            self._cache[name] = (fp, st, st.row_count)
        return st

    def refresh(self, name: str) -> TableStats:
        with self._lock:
            self._cache.pop(name, None)
        st = self.table(name)
        if st is None:
            raise KeyError(f"no such table {name!r}")
        # fresh stats can change CBO join orders: orphan cached plans
        # built against the old estimates (serving/plan_cache.py keys
        # on stats_gen)
        host = getattr(self.catalog, "_inner", self.catalog)
        try:
            host.stats_gen = getattr(host, "stats_gen", 0) + 1
        except Exception:     # noqa: BLE001 — read-only facade: plans
            pass              # just won't invalidate on ANALYZE there
        return st


def provider_for(catalog) -> StatsProvider:
    """One StatsProvider per engine, created lazily."""
    sp = getattr(catalog, "_stats_provider", None)
    if sp is None:
        sp = StatsProvider(catalog)
        try:
            catalog._stats_provider = sp
        except AttributeError:    # slotted/proxy catalogs refuse attrs
            pass
    return sp
