"""Statement tracing into a queryable system table.

The port's copy of `matrixone_tpu/utils/trace.py` (reference:
pkg/util/trace + motrace, statement records bulk-written into
`system.statement_info`).  A StatementRecorder buffers one row per
statement (text, status, duration, rows, the cache that served it, its
admission wait and its span summary) and flushes them into the
`system_statement_info` table of the same engine every 64 statements,
at `mo_ctl('flush')`, when a statement names the table, and at
`Engine.close()`, so

    SELECT ... FROM system_statement_info ORDER BY duration_us DESC

works as in the reference.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from matrixone_tpu_torch.container import dtypes as dt

STMT_TABLE = "system_statement_info"

_SCHEMA = [
    ("stmt_id", dt.INT64),
    ("statement", dt.TEXT),
    ("status", dt.varchar(16)),
    ("duration_us", dt.INT64),
    ("rows_out", dt.INT64),
    ("error", dt.TEXT),
    ("ts", dt.INT64),
    # serving forensics: which cache served it (plan/result/none) and how
    # long it sat in the admission queue — duration_us minus
    # queue_wait_ms is true execute time
    ("cache_hit", dt.varchar(8)),
    ("queue_wait_ms", dt.INT64),
    # motrace span forensics (utils/motrace.py): the statement's trace
    # id, how many spans closed under it, per-layer milliseconds as
    # JSON ({"parse": .., "rpc.call": .., ...}), and — for statements
    # over MO_TRACE_SLOW_MS — the FULL span tree, so a slow query's
    # breakdown survives in the system table after the ring rotates
    ("trace_id", dt.varchar(32)),
    ("span_count", dt.INT64),
    ("span_summary", dt.TEXT),
    ("span_tree", dt.TEXT),
]


class StatementRecorder:
    def __init__(self, engine, flush_every: int = 64):
        self.engine = engine
        self.flush_every = flush_every
        self._buf: List[tuple] = []
        self._next_id = 1
        self._lock = threading.Lock()
        self._ensure_table()

    def _ensure_table(self):
        """Idempotent; also called per flush — a CN replica resync
        (rep.tables = {}) wipes the in-memory stmt table, and the next
        flush must recreate it instead of failing the user's
        statement."""
        from matrixone_tpu_torch.storage.engine import TableMeta
        if STMT_TABLE in self.engine.tables:
            have = [c for c, _ in
                    self.engine.tables[STMT_TABLE].meta.schema]
            if "cache_hit" not in have or "trace_id" not in have:
                # pre-serving / pre-motrace data dir: trace rows are
                # observability data — recreate with the widened schema
                # rather than fail every flush
                self.engine.drop_table(STMT_TABLE, if_exists=True,
                                       log=False)
        if STMT_TABLE not in self.engine.tables:
            self.engine.create_table(
                TableMeta(STMT_TABLE, list(_SCHEMA), ["stmt_id"]),
                if_not_exists=True, log=False)

    def record(self, statement: str, status: str, duration_s: float,
               rows_out: int, error: Optional[str] = None,
               cache_hit: str = "none", queue_wait_ms: int = 0,
               trace_id: str = "", span_count: int = 0,
               span_summary: str = "", span_tree: str = ""):
        with self._lock:
            rec = (self._next_id, statement[:4096], status,
                   int(duration_s * 1e6), rows_out, error or "",
                   time.time_ns() // 1000, cache_hit,
                   int(queue_wait_ms), trace_id, int(span_count),
                   span_summary, span_tree)
            self._next_id += 1
            self._buf.append(rec)
            need_flush = len(self._buf) >= self.flush_every
        if need_flush:
            self.flush()

    def flush(self):
        with self._lock:
            buf, self._buf = self._buf, []
        if not buf:
            return
        import numpy as np
        self._ensure_table()
        t = self.engine.get_table(STMT_TABLE)
        cols = list(zip(*buf))
        arrays = {
            "stmt_id": np.asarray(cols[0], np.int64),
            "duration_us": np.asarray(cols[3], np.int64),
            "rows_out": np.asarray(cols[4], np.int64),
            "ts": np.asarray(cols[6], np.int64),
            "queue_wait_ms": np.asarray(cols[8], np.int64),
            "span_count": np.asarray(cols[10], np.int64),
        }
        strings = {
            "statement": t.encode_strings_list("statement", list(cols[1])),
            "status": t.encode_strings_list("status", list(cols[2])),
            "error": t.encode_strings_list("error", list(cols[5])),
            "cache_hit": t.encode_strings_list("cache_hit", list(cols[7])),
            "trace_id": t.encode_strings_list("trace_id", list(cols[9])),
            "span_summary": t.encode_strings_list("span_summary",
                                                  list(cols[11])),
            "span_tree": t.encode_strings_list("span_tree",
                                               list(cols[12])),
        }
        arrays.update(strings)
        validity = {c: np.ones(len(buf), np.bool_) for c in arrays}
        # bypass the WAL for observability data (reference uses the ETL
        # fileservice, not the txn path) — but segment allocation must still
        # respect the single-writer invariant
        with self.engine._commit_lock:
            ts = self.engine.hlc.now()
            seg = t.make_segment(arrays, validity, ts)
            t.apply_segment(seg)
            # advance the read frontier so snapshot reads see trace rows
            self.engine.committed_ts = max(self.engine.committed_ts, ts)
