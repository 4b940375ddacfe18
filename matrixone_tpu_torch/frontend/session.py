"""Session: SQL text in, result batches out.

The port of `matrixone_tpu/frontend/session.py` (reference analogue: the
frontend's doComQuery -> buildPlan -> Compile -> Run chain).  A SELECT
goes

    parse -> _prepare_select (decorrelate, inline uncorrelated
    subqueries) -> Binder.bind_statement -> cost-based join reordering
    -> index rewrites -> compile_plan (with the fusion pass, on unless
    `SET plan_fusion = 0`) -> pull loop on the device -> host Batch

DDL, DML and transaction control run against the engine: CREATE/DROP
TABLE, INSERT (VALUES or SELECT, AUTO_INCREMENT and LAST_INSERT_ID()),
UPDATE and DELETE (a plan that returns each target row's `__rowid`,
run on the session's device, then a delete of those rows and, for an
UPDATE, an insert of the new rows in one commit), BEGIN/COMMIT/ROLLBACK
over the MVCC engine (snapshot isolation, a transaction's workspace,
first-committer-wins; `set txn_mode = 'pessimistic'` takes row locks
through the lock service), SET/SHOW VARIABLES, SHOW TABLES/CREATE
TABLE/COLUMNS, CREATE/DROP/SHOW SNAPSHOT, RESTORE TABLE, CREATE TABLE
... PARTITION BY, ALTER TABLE ... TRUNCATE/DROP PARTITION, SHOW
PARTITIONS and EXPLAIN of a SELECT (which marks each fused node
`fragment=fN`).  A UNION [ALL] runs as a statement, a derived table or a
CTE.

The catalog is an `Engine`: `Session(catalog=Engine(LocalFS(dir)))`
makes every DDL statement and commit durable in the engine's WAL,
PARTITION BY specs and snapshots included, and `Engine.open(fs)`
restarts from it.

`execute(sql, params)` is the serving path (matrixone_tpu_torch/serving):
a statement is normalized (literals become parameters), a repeated one
is served from the plan cache, which keeps the bound, optimized plan
and the compiled operator tree of its last execution (the new values
are patched into the tree's literals and `vm/compile.retarget_tree`
resets its per-execution state), and, when it is on, from the result
cache, keyed by the versions of the tables the plan reads.  Workload
statements pass admission control when it is armed; every statement is
a motrace `statement` span (parse, plan, run, ...), observed in
`query_seconds` and recorded in `system_statement_info`.  The
operations surface: KILL [QUERY] n, SHOW PROCESSLIST, SHOW TRACE,
ANALYZE TABLE, SET fault_point / fault_point_clear, EXPLAIN ANALYZE
(rows, batches and time per operator, and each fused fragment's mode,
step calls, trace and capture milliseconds and cache outcome), and
`select mo_ctl(...)` with checkpoint, merge, flush, fault, serving,
fusion, trace, metrics, keys and rpc (the fabric's circuit breakers and
a CN's logtail breaker).

Distribution: `SET query_shards = N` runs a qualifying statement's
lower fragment on N slots of the device mesh (parallel/dist_query.py);
a catalog whose `dist_peers` names fragment servers (cluster/cn.py)
runs it on those host peers (parallel/fragments.py).  The session runs
unchanged over a CN replica (`cluster.RemoteCatalog`).

Secondary indexes: CREATE INDEX ... USING ivfflat | ivfpq | hnsw
(op_type vector_l2_ops, vector_cosine_ops or vector_ip_ops; neither
ivfpq nor hnsw with ip) and USING fulltext over one or more text
columns build the index (on the session's device; an HNSW graph in
host memory) and register it in the engine's catalog and index cache;
SHOW INDEXES lists them.  Outside transactions a SELECT of the form
`ORDER BY <distance>(col, '[...]') LIMIT k` is rewritten to a
VectorTopK source (`vm/vector_scan.py`) and one of the form
`ORDER BY MATCH(cols) AGAINST ('...') DESC LIMIT k` to a FulltextTopK
source (`vm/fulltext_scan.py`), both by `sql/optimize.apply_indices`.

Ingest: LOAD DATA INFILE (a local path, file://, fs:// or stage://)
and `load_csv` read CSV through the port's own reader
(`storage/csvread.py`; the port never imports pyarrow), each load one
transaction; CREATE/DROP/SHOW STAGE name locations; CREATE EXTERNAL
TABLE over a CSV file scans it in place (`storage/external.py`); and
`load_file()` reads a datalink's text at bind time.

Materialized views (`mview/`): CREATE / DROP / SHOW / REFRESH
MATERIALIZED VIEW, a view's backing table refused to INSERT, UPDATE,
DELETE, LOAD and DROP TABLE, EXPLAIN marking its scan `mview=
incremental|full`, and `mo_ctl('mview', 'status'|'refresh:<v>')`.
User-defined functions (`udf/`): CREATE [OR REPLACE] [AGGREGATE]
FUNCTION ... LANGUAGE PYTHON, DROP FUNCTION, SHOW FUNCTIONS, EXPLAIN's
`UdfCall f [jit|row|aggregate]` and `mo_ctl('udf', 'status'|'clear')`;
nondeterministic UDFs bypass both serving caches.

Not ported yet (ROADMAP.md, section A): parquet and iceberg (they need
pyarrow), dynamic tables, accounts, the mo_ctl commands over modules
the port lacks (lint, san, qa, crash), and every other statement,
which raises NotImplementedError.  The session
runs on `device` (CUDA unless the caller names the CPU); every scan
uploads its chunks there.
"""

from __future__ import annotations

import contextvars
import copy
import dataclasses
import datetime
import json
import os
import re
import time
import types
from typing import List, Optional

import numpy as np

from matrixone_tpu_torch import resolve_device
from matrixone_tpu_torch.container import Batch, Vector, dtypes as dt, \
    from_device
from matrixone_tpu_torch.container.dtypes import TypeOid
from matrixone_tpu_torch.ops import filter as F
from matrixone_tpu_torch.sql import ast, plan as P
from matrixone_tpu_torch.sql.binder import Binder, BindError, Scope, \
    type_from_name
from matrixone_tpu_torch.sql.expr import BoundCol
from matrixone_tpu_torch.sql.parser import parse, parse_one
from matrixone_tpu_torch.queryservice import QueryKilled, registry_for
from matrixone_tpu_torch.serving import serving_for
from matrixone_tpu_torch.serving.plan_cache import iter_plan_values
from matrixone_tpu_torch.storage.engine import ROWID, Engine, IndexMeta, \
    TableMeta
from matrixone_tpu_torch.txn.client import TxnClient
from matrixone_tpu_torch.utils import keys as keyaudit
from matrixone_tpu_torch.utils import metrics as M, motrace
from matrixone_tpu_torch.utils.fault import INJECTOR, parse_spec
from matrixone_tpu_torch.utils.trace import STMT_TABLE, StatementRecorder
from matrixone_tpu_torch.vm.compile import compile_plan, retarget_tree
from matrixone_tpu_torch.vm.process import ExecContext

#: the session currently executing a statement on this thread — info
#: functions (connection_id()/user()/last_insert_id()/...) resolve
#: against it at bind time
_CURRENT_SESSION: contextvars.ContextVar = contextvars.ContextVar(
    "mo_torch_current_session", default=None)


def current_session():
    return _CURRENT_SESSION.get()


@dataclasses.dataclass
class Result:
    batch: Optional[Batch] = None        # SELECT and SHOW results
    affected: int = 0                    # DML row count
    text: Optional[str] = None           # EXPLAIN output

    def rows(self) -> List[tuple]:
        if self.batch is None:
            return []
        names = list(self.batch.columns)
        cols = [self.batch.columns[n].to_pylist() for n in names]
        return [tuple(vals) for vals in zip(*cols)] if cols else []

    @property
    def column_names(self) -> List[str]:
        return list(self.batch.columns) if self.batch is not None else []


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, section A)")


class Session:
    """One client session: a catalog, a device, session variables and
    the open explicit transaction, if any."""

    def __init__(self, catalog: Optional[Engine] = None, device=None):
        self.catalog = catalog if catalog is not None else Engine()
        self.device = resolve_device(device)
        self.txn_client = TxnClient(self.catalog)
        self.txn = None                 # active explicit transaction
        self.last_insert_id = 0         # MySQL LAST_INSERT_ID()
        # SET query_shards = N runs eligible statements' fragments on N
        # slots of the mesh (parallel/dist_query.py); the environment
        # default serves deployments that always shard
        self.variables = {"batch_rows": 1 << 20,
                          "query_shards": int(os.environ.get(
                              "MO_QUERY_SHARDS", "0") or 0)}
        self._procs = registry_for(self.catalog)
        self._admission_depth = 0      # re-entrant execute() guard
        self.conn_id = self._procs.register("root")  # no accounts yet

    def close(self) -> None:
        """End the session: roll back its open transaction, if any (the
        engine's count of open transactions defers merges), and release
        its process-registry slot."""
        if self.txn is not None:
            self.txn.rollback()
            self.txn = None
        self._procs.unregister(self.conn_id)

    def _ctx(self, frozen_ts: Optional[int] = None) -> ExecContext:
        if frozen_ts is None and self.txn is None:
            frozen_ts = self.catalog.committed_ts
        return ExecContext(catalog=self.catalog, txn=self.txn,
                           variables=self.variables,
                           frozen_ts=(None if self.txn is not None
                                      else frozen_ts),
                           device=self.device)

    def _index_skip_tables(self) -> frozenset:
        """Index rewrites serve only frontier (autocommit) reads: an open
        txn reads an older snapshot + workspace that a frontier-built
        index cannot realize."""
        if self.txn is not None:
            return frozenset(self.catalog.tables)
        return frozenset()

    # ------------------------------------------------------------ execute
    def execute(self, sql: str, params: Optional[list] = None) -> Result:
        """Run one or more statements; `params` fill the `?` placeholders
        in order (ints, floats, strings, bools, None, dates)."""
        # the statement is the trace boundary: parse, cache lookups,
        # admission wait, plan, fragment capture and replay and commit
        # are its children (a re-entrant execute nests as a child span)
        with motrace.statement_span(sql):
            return self._execute_traced(sql, params)

    def _execute_traced(self, sql: str,
                        params: Optional[list] = None) -> Result:
        if not hasattr(self.catalog, "stmt_recorder"):
            self.catalog.stmt_recorder = StatementRecorder(self.catalog)
        if STMT_TABLE in sql:
            self.catalog.stmt_recorder.flush()
        # serving layer: normalize the statement and route repeated
        # shapes through the plan and result caches; the raw parse path
        # serves whatever is off-template
        sv = self._serving_prepare(sql, params)
        stmts = sv.make_stmts() if sv is not None else None
        if stmts is None:
            # raw path: first occurrence of a template (or an unusable
            # one): the result cache still takes part through sv, the
            # plan cache does not
            if sv is not None:
                sv.template_mode = False
                if not sv.result_enabled():
                    sv = None
            with motrace.span("parse"):
                stmts = parse(sql)
            if params is not None:
                stmts = [_substitute_params(st, params) for st in stmts]
        tok = _CURRENT_SESSION.set(self)
        try:
            return self._execute_stmts(stmts, sql, sv)
        finally:
            _CURRENT_SESSION.reset(tok)

    def _serving_prepare(self, sql: str, params):
        """-> _ServingCtx when this statement may use the serving caches
        (one statement, autocommit, deterministic, plain parameters)."""
        if self.txn is not None:
            return None
        state = serving_for(self.catalog)
        if not (state.plan_cache.enabled or state.result_cache.enabled):
            return None
        # nondeterministic UDFs bypass both caches as now() and rand() do
        from matrixone_tpu_torch.udf.catalog import sync_serving
        sync_serving(self.catalog, state)
        norm = state.plan_cache.normalized(sql)
        if norm is None or norm.n_stmts != 1 or norm.nondet:
            return None
        try:
            full = norm.full_params(params)
        except (IndexError, TypeError, ValueError):
            return None            # arity mismatch: the raw path raises it
        for p in full:
            if not isinstance(p, (int, float, str, bool, type(None),
                                  datetime.date)):
                return None
        return _ServingCtx(state, norm, full, self._acct())

    def _execute_stmts(self, stmts, sql: str, serving=None) -> Result:
        adm = serving_for(self.catalog).admission
        results = []
        # per-statement span attribution in a multi-statement text: each
        # statement records only the spans past the previous one's mark
        # (the first one's window starts at 0, so it owns `parse`)
        tr_mark = 0
        for st in stmts:
            if self._procs.is_terminated(self.conn_id):
                raise QueryKilled(f"connection {self.conn_id} was killed")
            t0 = time.perf_counter()
            self._procs.start_query(self.conn_id, sql)
            self._liid_set = False     # last_insert_id(): per statement
            ann = {"cache_hit": "none", "queue_wait_ms": 0}
            self._exec_ann = ann
            ticket = None
            try:
                with motrace.span("run", stmt=type(st).__name__):
                    if adm.enabled and self._admission_gated(st):
                        lane = ("background" if str(self.variables.get(
                            "query_priority", "")).lower() == "background"
                            else "interactive")
                        ticket = adm.acquire(account=self._acct(),
                                             lane=lane,
                                             conn_id=self.conn_id,
                                             registry=self._procs)
                        self._admission_depth += 1
                        ann["queue_wait_ms"] = int(
                            ticket.queue_wait_s * 1000)
                    r = self._execute_stmt(st, serving)
                    motrace.annotate(cache_hit=ann["cache_hit"])
            except Exception as e:   # noqa: BLE001 — recorded, re-raised
                dt_ = time.perf_counter() - t0
                M.query_seconds.observe(dt_)
                tr_id, n_sp, summ, tree = motrace.statement_record(
                    dt_ * 1000.0, since=tr_mark)
                self.catalog.stmt_recorder.record(
                    sql, "error", dt_, 0, error=str(e)[:1024],
                    cache_hit=ann["cache_hit"],
                    queue_wait_ms=ann["queue_wait_ms"],
                    trace_id=tr_id, span_count=n_sp,
                    span_summary=summ, span_tree=tree)
                raise
            finally:
                if ticket is not None:
                    self._admission_depth -= 1
                    ticket.release()
                self._procs.end_query(self.conn_id)
            dt_ = time.perf_counter() - t0
            M.query_seconds.observe(dt_)
            rows_out = len(r.batch) if r.batch is not None else r.affected
            # slow-query hook: past MO_TRACE_SLOW_MS the full span tree
            # goes into the statement table (motrace.statement_record)
            tr_id, n_sp, summ, tree = motrace.statement_record(
                dt_ * 1000.0, since=tr_mark)
            tr_mark += n_sp
            self.catalog.stmt_recorder.record(
                sql, "ok", dt_, rows_out, cache_hit=ann["cache_hit"],
                queue_wait_ms=ann["queue_wait_ms"],
                trace_id=tr_id, span_count=n_sp, span_summary=summ,
                span_tree=tree)
            results.append(r)
        return results[-1] if results else Result()

    def _admission_gated(self, st: ast.Node) -> bool:
        """Workload statements pass admission; control statements (SET,
        transaction control, KILL, SHOW, mo_ctl) never queue: an
        operator must always be able to inspect and kill.  A re-entrant
        execute inside an admitted statement bypasses too, or a 1-slot
        server would deadlock against itself."""
        if self._admission_depth > 0:
            return False
        if isinstance(st, (ast.Select, ast.Union)):
            return not self._is_ctl_select(st)
        return isinstance(st, (ast.Insert, ast.Update, ast.Delete,
                               ast.LoadData))

    @staticmethod
    def _is_ctl_select(st: ast.Node) -> bool:
        return (isinstance(st, ast.Select) and st.from_ is None
                and len(st.items) == 1
                and isinstance(st.items[0].expr, ast.FuncCall)
                and st.items[0].expr.name == "mo_ctl")

    def _acct(self) -> str:
        """The account the session belongs to: accounts are not ported
        yet, every session is the sys account's."""
        return "sys"

    def plan(self, sql: str):
        """The bound, cost-optimized and index-rewritten plan of one
        SELECT: the tree `execute` compiles (EXPLAIN's tree)."""
        return self.plan_select(parse_one(sql))

    def _execute_stmt(self, stmt: ast.Node, serving=None) -> Result:
        if isinstance(stmt, (ast.Select, ast.Union)):
            return self._select(stmt, serving=serving)
        if isinstance(stmt, ast.CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, ast.DropTable):
            from matrixone_tpu_torch.mview import catalog as vcat
            if vcat.lookup(self.catalog, stmt.name) is not None:
                raise BindError(
                    f"{stmt.name!r} is a materialized view; use DROP "
                    f"MATERIALIZED VIEW")
            self.catalog.drop_table(stmt.name, stmt.if_exists)
            return Result()
        if isinstance(stmt, ast.CreateIndex):
            return self._create_index(stmt)
        if isinstance(stmt, ast.CreateFunction):
            return self._create_function(stmt)
        if isinstance(stmt, ast.DropFunction):
            return self._drop_function(stmt)
        if isinstance(stmt, ast.ShowFunctions):
            return self._show_functions()
        if isinstance(stmt, ast.CreateMaterializedView):
            return self._create_materialized_view(stmt)
        if isinstance(stmt, ast.DropMaterializedView):
            return self._drop_materialized_view(stmt)
        if isinstance(stmt, ast.ShowMaterializedViews):
            return self._show_materialized_views()
        if isinstance(stmt, ast.RefreshMaterializedView):
            return Result(affected=self._refresh_mview(stmt.name))
        if isinstance(stmt, ast.Insert):
            return self._insert(stmt)
        if isinstance(stmt, ast.Delete):
            return self._delete(stmt)
        if isinstance(stmt, ast.Update):
            return self._update(stmt)
        if isinstance(stmt, ast.Explain):
            if not isinstance(stmt.stmt, (ast.Select, ast.Union)):
                raise BindError("EXPLAIN supports SELECT only for now")
            node = self.plan_select(stmt.stmt)
            if stmt.analyze:
                return Result(text=self._explain_analyze(node))
            anns = [a for a in (self._fragment_annotator(node),
                                self._exchange_annotator(node),
                                self._mview_annotator()) if a is not None]
            annotate = (None if not anns else
                        (lambda pn: "".join(a(pn) for a in anns)))
            return Result(text=P.explain(node, annotate=annotate))
        if isinstance(stmt, ast.ShowTables):
            return _show({"Tables": sorted(self.catalog.tables)})
        if isinstance(stmt, ast.ShowCreateTable):
            t = self.catalog.get_table(stmt.name)
            cols = []
            for c, d in t.meta.schema:
                extra = (" auto_increment" if c == t.meta.auto_increment
                         else "")
                cols.append(f"  `{c}` {d}{extra}")
            if t.meta.primary_key:
                cols.append("  primary key ("
                            + ", ".join(t.meta.primary_key) + ")")
            ddl = (f"create table `{stmt.name}` (\n" + ",\n".join(cols)
                   + "\n)")
            return _show({"Table": [stmt.name], "Create Table": [ddl]},
                         {"Create Table": dt.TEXT})
        if isinstance(stmt, ast.ShowColumns):
            t = self.catalog.get_table(stmt.name)
            return _show({"Field": [c for c, _ in t.meta.schema],
                          "Type": [str(d) for _, d in t.meta.schema],
                          "Key": ["PRI" if c in t.meta.primary_key else ""
                                  for c, _ in t.meta.schema]})
        if isinstance(stmt, ast.ShowIndexes):
            ixs = self.catalog.indexes_on(stmt.name)
            return _show({"Key_name": [ix.name for ix in ixs],
                          "Algo": [ix.algo for ix in ixs],
                          "Columns": [",".join(ix.columns) for ix in ixs],
                          "Dirty": [int(ix.dirty) for ix in ixs]},
                         {"Dirty": dt.INT64})
        if isinstance(stmt, ast.ShowVariables):
            names = sorted(self.variables)
            if stmt.like:
                # SQL LIKE: only % and _ are wildcards; everything
                # else (incl. regex/fnmatch metachars) is literal
                pat = "".join(".*" if ch == "%" else "." if ch == "_"
                              else re.escape(ch) for ch in stmt.like)
                rx = re.compile(f"^{pat}$")
                names = [n for n in names if rx.match(n)]
            return _show({"Variable_name": names,
                          "Value": [str(self.variables[n]) for n in names]})
        if isinstance(stmt, ast.SetVariable):
            if isinstance(stmt.value, ast.Literal):
                value = stmt.value.value
                # fault injection control (reference: mo_ctl
                # addfaultpoint)
                if stmt.name == "fault_point" and isinstance(value, str):
                    try:
                        INJECTOR.add(**parse_spec(value))
                    except ValueError as e:
                        raise BindError(str(e))
                elif stmt.name == "fault_point_clear":
                    INJECTOR.remove(str(value))
                else:
                    self.variables[stmt.name] = value
            return Result()
        if isinstance(stmt, ast.ShowProcesslist):
            pl = self._procs.processlist()
            return _show({"Id": [p["Id"] for p in pl],
                          "User": [p["User"] for p in pl],
                          "State": [p["State"] for p in pl],
                          "Time": [p["Time"] for p in pl],
                          "Query": [p["Query"] for p in pl]},
                         {"Id": dt.INT64, "Time": dt.FLOAT64,
                          "Query": dt.TEXT})
        if isinstance(stmt, ast.Kill):
            if self._procs.owner_account(stmt.conn_id) is None \
                    or not self._procs.kill(stmt.conn_id,
                                            query_only=stmt.query_only):
                raise BindError(f"no connection {stmt.conn_id}")
            return Result()
        if isinstance(stmt, ast.LoadData):
            return self._load_data(stmt)
        if isinstance(stmt, ast.CreateStage):
            self.catalog.create_stage(stmt.name, stmt.url)
            return Result()
        if isinstance(stmt, ast.DropStage):
            self.catalog.drop_stage(stmt.name)
            return Result()
        if isinstance(stmt, ast.ShowStages):
            names = sorted(self.catalog.stages)
            return _show({"Stage": names,
                          "URL": [self.catalog.stages[n] for n in names]})
        if isinstance(stmt, ast.CreateExternalTable):
            schema = [(c.name, type_from_name(c.type_name, c.type_args))
                      for c in stmt.columns]
            fmt = _resolve_format(stmt.fmt, stmt.location)
            if stmt.snapshot is not None and fmt != "iceberg":
                raise BindError("SNAPSHOT applies to FORMAT iceberg only")
            self.catalog.create_external(
                TableMeta(stmt.name, schema, []), stmt.location, fmt,
                snapshot=stmt.snapshot)
            return Result()
        if isinstance(stmt, ast.AnalyzeTable):
            from matrixone_tpu_torch.sql.stats import provider_for
            if getattr(self.catalog.get_table(stmt.name), "is_external",
                       False):
                raise BindError(
                    f"{stmt.name!r} is an external table; it has no "
                    f"segment statistics to analyze")
            st = provider_for(self.catalog).refresh(stmt.name)
            return _show({"table": [stmt.name], "rows": [st.row_count],
                          "columns": [len(st.cols)]},
                         {"rows": dt.INT64, "columns": dt.INT64})
        if isinstance(stmt, ast.ShowTrace):
            # recent traces from the motrace ring, oldest first
            ts = motrace.TRACER.traces()
            return _show({"TraceId": [t["trace_id"] for t in ts],
                          "Root": [t["root"] for t in ts],
                          "Procs": [t["procs"] for t in ts],
                          "Spans": [t["spans"] for t in ts],
                          "StartUs": [t["ts_us"] for t in ts],
                          "DurationMs": [t["dur_ms"] for t in ts]},
                         {"Spans": dt.INT64, "StartUs": dt.INT64,
                          "DurationMs": dt.FLOAT64})
        if isinstance(stmt, ast.CreateSnapshot):
            self.catalog.create_snapshot(stmt.name)
            return Result()
        if isinstance(stmt, ast.DropSnapshot):
            self.catalog.drop_snapshot(stmt.name)
            return Result()
        if isinstance(stmt, ast.ShowSnapshots):
            names = sorted(self.catalog.snapshots)
            return _show({"Snapshot": names,
                          "Timestamp": [self.catalog.snapshots[n]
                                        for n in names]},
                         {"Timestamp": dt.INT64})
        if isinstance(stmt, ast.AlterPartition):
            return self._alter_partition(stmt)
        if isinstance(stmt, ast.ShowPartitions):
            return self._show_partitions(stmt)
        if isinstance(stmt, ast.RestoreTable):
            snaps = self.catalog.snapshots
            if stmt.snapshot not in snaps:
                raise BindError(f"no such snapshot {stmt.snapshot!r}")
            n = self.catalog.restore_table(stmt.table, snaps[stmt.snapshot])
            return Result(affected=n)
        if isinstance(stmt, ast.BeginTxn):
            if self.txn is not None:
                old, self.txn = self.txn, None
                old.commit()            # MySQL: BEGIN commits the open txn
            self.txn = self.txn_client.begin()
            return Result()
        if isinstance(stmt, ast.CommitTxn):
            if self.txn is not None:
                old, self.txn = self.txn, None   # clear even on conflict
                return Result(affected=old.commit())
            return Result()
        if isinstance(stmt, ast.RollbackTxn):
            if self.txn is not None:
                self.txn.rollback()
                self.txn = None
            return Result()
        raise _not_ported(f"{type(stmt).__name__} statements")

    # ---------------------------------------------------- subqueries
    def _run_subquery(self, sel):
        """Execute a nested subquery with a nesting bound (clean
        BindError instead of a RecursionError deep in the engine)."""
        d = getattr(self, "_subq_depth", 0)
        if d > 64:
            raise BindError("subquery nesting too deep")
        self._subq_depth = d + 1
        try:
            return self._select(sel)
        finally:
            self._subq_depth = d

    def _inline_subqueries(self, node, ctes=None):
        """Execute uncorrelated subqueries once and inline the results
        (reference: the planner turns these into joins; execute-once has
        identical semantics for the uncorrelated case)."""
        import dataclasses as dc
        if isinstance(node, ast.Subquery):
            if ctes:
                node.select.ctes = list(ctes) + list(node.select.ctes)
            r = self._run_subquery(node.select)
            rows = r.rows()
            if len(r.column_names) != 1:
                raise BindError("scalar subquery must return one column")
            if len(rows) > 1:
                raise BindError("scalar subquery returned more than one row")
            v = rows[0][0] if rows else None
            return _param_literal(v)
        if isinstance(node, ast.Exists):
            inner_limit = (1 if node.select.limit is None
                           else min(1, node.select.limit))
            sub = dc.replace(node.select, limit=inner_limit)
            if ctes:
                sub.ctes = list(ctes) + list(sub.ctes)
            r = self._run_subquery(sub)
            has = len(r.rows()) > 0
            return ast.Literal(has != node.negated, "bool")
        if isinstance(node, ast.InList) and len(node.items) == 1 \
                and isinstance(node.items[0], ast.Subquery):
            if ctes:
                node.items[0].select.ctes = \
                    list(ctes) + list(node.items[0].select.ctes)
            r = self._run_subquery(node.items[0].select)
            if len(r.column_names) != 1:
                raise BindError("IN subquery must return one column")
            vals = [row[0] for row in r.rows()]
            if node.negated and any(v is None for v in vals):
                # NOT IN with NULLs is never TRUE (SQL ternary logic)
                return ast.Literal(False, "bool")
            vals = [v for v in vals if v is not None]
            if not vals:
                return ast.Literal(bool(node.negated), "bool")
            return ast.InList(node.expr,
                              [_param_literal(v) for v in vals],
                              node.negated)
        if dc.is_dataclass(node) and isinstance(node, ast.Node) \
                and not isinstance(node, (ast.SubqueryRef,)):
            for f in dc.fields(node):
                v = getattr(node, f.name)
                if isinstance(v, ast.Node):
                    setattr(node, f.name,
                            self._inline_subqueries(v, ctes))
                elif isinstance(v, list):
                    setattr(node, f.name, [
                        self._inline_subqueries(x, ctes)
                        if isinstance(x, ast.Node) else
                        tuple(self._inline_subqueries(y, ctes)
                              if isinstance(y, ast.Node) else y
                              for y in x) if isinstance(x, tuple) else x
                        for x in v])
        return node

    def _prepare_select(self, sel) -> None:
        """Inline uncorrelated subqueries in WHERE/HAVING/select items
        (not derived tables — those bind as plans)."""
        if isinstance(sel, ast.Union):
            for arm in sel.selects:
                self._prepare_select(arm)
            return
        if not isinstance(sel, ast.Select):
            return
        ctes = sel.ctes   # WITH scope is visible inside subqueries
        for i, (_name, sub) in enumerate(ctes):
            # a CTE body sees only EARLIER ctes
            if isinstance(sub, ast.Select) and not sub.ctes:
                sub.ctes = list(ctes[:i])
            self._prepare_select(sub)

        def prep_from(f):
            if isinstance(f, ast.SubqueryRef):
                if getattr(f.select, "_mo_prepared", False):
                    return
                if isinstance(f.select, ast.Select) and not f.select.ctes:
                    f.select.ctes = list(ctes)
                self._prepare_select(f.select)
            elif isinstance(f, ast.Join):
                prep_from(f.left)
                prep_from(f.right)
        prep_from(sel.from_)
        # decorrelate correlated EXISTS / scalar-agg subqueries into joins
        # (reference: plan builder subquery flattening); uncorrelated ones
        # are inlined below by executing once
        from matrixone_tpu_torch.sql.decorrelate import decorrelate_select
        decorrelate_select(sel, self.catalog, dict(ctes))
        for sj in sel.semijoins:
            self._prepare_select(sj.select)
        prep_from(sel.from_)   # derived tables ADDED by decorrelation
        for it in sel.items:
            it.expr = self._inline_subqueries(it.expr, ctes=ctes)
        if sel.where is not None:
            sel.where = self._inline_subqueries(sel.where, ctes=ctes)
        if sel.having is not None:
            sel.having = self._inline_subqueries(sel.having, ctes=ctes)
        sel._mo_prepared = True

    def _try_mo_ctl(self, sel) -> Optional[Result]:
        """`select mo_ctl('cmd'[, 'arg'])`: the operations commands,
        answered by the session before binding (reference: plan/function
        ctl mo_ctl)."""
        if not (isinstance(sel, ast.Select) and sel.from_ is None
                and len(sel.items) == 1):
            return None
        e = sel.items[0].expr
        if not (isinstance(e, ast.FuncCall) and e.name == "mo_ctl"):
            return None
        args = [a.value for a in e.args if isinstance(a, ast.Literal)]
        cmd = str(args[0]).lower() if args else ""
        arg = str(args[1]) if len(args) > 1 else ""
        if cmd == "checkpoint":
            self.catalog.checkpoint()
            out = "checkpoint done"
        elif cmd == "merge":
            out = self._mo_ctl_merge(arg)
        elif cmd == "flush":
            if hasattr(self.catalog, "stmt_recorder"):
                self.catalog.stmt_recorder.flush()
            out = "flushed"
        elif cmd == "fault":
            # status | clear | arm:<spec>
            if arg in ("", "status"):
                out = json.dumps(INJECTOR.describe(), sort_keys=True)
            elif arg == "clear":
                INJECTOR.clear()
                out = "faults cleared"
            elif arg.startswith("arm:"):
                try:
                    INJECTOR.add(**parse_spec(arg[4:]))
                except ValueError as err:
                    raise BindError(str(err))
                out = f"armed {arg[4:].split(':', 1)[0]}"
            else:
                raise BindError(f"unknown fault subcommand {arg!r}; "
                                "use status | clear | arm:<spec>")
        elif cmd == "serving":
            out = self._mo_ctl_serving(arg)
        elif cmd == "fusion":
            from matrixone_tpu_torch.vm import fusion
            if arg in ("", "status"):
                out = json.dumps(fusion.stats(), sort_keys=True)
            elif arg == "clear":
                fusion.CACHE.clear()
                out = "fusion compile cache cleared"
            else:
                raise BindError(f"unknown fusion subcommand {arg!r}; "
                                "use status | clear")
        elif cmd == "keys":
            if arg in ("", "status"):
                out = json.dumps(dict(keyaudit.report(), static=None),
                                 sort_keys=True, default=str)
            elif arg == "clear":
                keyaudit.clear()
                out = "key-audit records and findings cleared"
            elif arg == "audit:on":
                keyaudit.arm()
                out = "key audit armed"
            elif arg == "audit:off":
                keyaudit.disarm()
                out = "key audit disarmed"
            else:
                raise BindError(f"unknown keys subcommand {arg!r}; "
                                "use status | clear | audit:on | "
                                "audit:off")
        elif cmd == "trace":
            out = self._mo_ctl_trace(arg)
        elif cmd == "metrics":
            if arg in ("", "dump"):
                out = M.REGISTRY.render()
            elif arg == "snapshot":
                out = json.dumps(M.REGISTRY.snapshot(), sort_keys=True)
            else:
                raise BindError(f"unknown metrics subcommand {arg!r}; "
                                "use dump | snapshot")
        elif cmd == "udf":
            from matrixone_tpu_torch import udf as U
            from matrixone_tpu_torch.udf import catalog as ucat
            if arg in ("", "status"):
                st = U.stats()
                st["functions"] = len(ucat.registry_for(self.catalog))
                out = json.dumps(st, sort_keys=True)
            elif arg == "clear":
                U.COMPILE_CACHE.clear()
                out = "udf compile cache cleared"
            else:
                raise BindError(f"unknown udf subcommand {arg!r}; "
                                "use status | clear")
        elif cmd == "mview":
            from matrixone_tpu_torch import mview as MV
            if arg in ("", "status"):
                out = json.dumps(MV.stats(self.catalog), sort_keys=True,
                                 default=str)
            elif arg.startswith("refresh:"):
                name = arg.split(":", 1)[1]
                n = self._refresh_mview(name)
                out = f"refreshed {name}: {n} rows"
            else:
                raise BindError(f"unknown mview subcommand {arg!r}; "
                                "use status | refresh:<view>")
        elif cmd == "rpc":
            # every peer's circuit breaker, and a CN's logtail breaker
            from matrixone_tpu_torch.cluster.cn import rpc_status
            out = json.dumps(rpc_status(self.catalog), sort_keys=True)
        elif cmd in _MO_CTL_NOT_PORTED:
            raise BindError(f"mo_ctl('{cmd}') is not ported yet: it needs "
                            f"{_MO_CTL_NOT_PORTED[cmd]} (ROADMAP.md, "
                            f"section A)")
        else:
            raise BindError(f"unknown mo_ctl command {cmd!r}")
        return _show({"mo_ctl": [out]})

    def _mo_ctl_merge(self, arg: str) -> str:
        def describe(code):
            if code == -1:
                return "skipped (too few segments)"
            if code == -2:
                return "deferred (open transactions)"
            if code == -3:
                return "deferred (lost race with a concurrent write — retry)"
            return f"kept {code} rows"
        if arg in ("status", "run", "pause", "resume", "gc"):
            # the background merge scheduler (storage/merge_sched)
            from matrixone_tpu_torch.storage import merge_sched
            sched = merge_sched.scheduler_for(self.catalog)
            if arg == "status":
                return json.dumps(sched.status(), sort_keys=True,
                                  default=str)
            if arg == "run":
                return json.dumps(sched.run_cycle(), sort_keys=True,
                                  default=str)
            if arg == "gc":
                return json.dumps(self.catalog.gc_fences(), sort_keys=True)
            if arg == "pause":
                sched.pause()
                return "merge scheduler paused"
            sched.resume()
            return "merge scheduler resumed"
        if arg:
            return f"merge {arg}: " + describe(self.catalog.merge_table(arg))
        results = []
        for name in list(self.catalog.tables):
            if not name.startswith("system_"):
                r = self.catalog.merge_table(name, checkpoint=False)
                if r >= 0:
                    results.append(f"{name}: {describe(r)}")
        if results:
            self.catalog.checkpoint()
        return "; ".join(results) or "nothing to merge"

    def _mo_ctl_serving(self, arg: str) -> str:
        """The serving layer: the plan and result caches and admission."""
        sv = serving_for(self.catalog)
        if arg in ("", "status"):
            return json.dumps(sv.status(), sort_keys=True, default=str)
        if arg == "clear":
            sv.clear()
            return "serving caches cleared"
        if arg.startswith("slots:"):
            try:
                sv.admission.slots = int(arg.split(":", 1)[1])
            except ValueError:
                raise BindError(f"bad slot count in {arg!r}")
            return f"admission slots = {sv.admission.slots}"
        if arg.startswith("account_slots:"):
            try:
                sv.admission.account_slots = int(arg.split(":", 1)[1])
            except ValueError:
                raise BindError(f"bad account slot count in {arg!r}")
            return f"admission account_slots = {sv.admission.account_slots}"
        if arg in ("plan:on", "plan:off"):
            sv.plan_cache.enabled = arg.endswith(":on")
            if not sv.plan_cache.enabled:
                sv.plan_cache.clear()
            return f"plan cache {'on' if sv.plan_cache.enabled else 'off'}"
        if arg.startswith("result:"):
            sub = arg.split(":", 1)[1]
            if sub == "off":
                sv.result_cache.max_bytes = 0
                sv.result_cache.clear()
            elif sub == "on":
                if sv.result_cache.max_bytes <= 0:
                    sv.result_cache.max_bytes = 64 << 20
            else:
                try:
                    mb = int(sub)
                except ValueError:
                    raise BindError(f"unknown result subcommand {sub!r}; "
                                    f"use on | off | <mb>")
                # shrinking evicts now: a read-hot workload never calls
                # put(), so its eviction loop would not run
                sv.result_cache.set_max_bytes(mb << 20)
                if sv.result_cache.max_bytes <= 0:
                    sv.result_cache.clear()
            return f"result cache {sv.result_cache.max_bytes >> 20} MB"
        raise BindError(
            f"unknown serving subcommand {arg!r}; use status | clear | "
            f"slots:<n> | account_slots:<n> | plan:<on|off> | "
            f"result:<on|off|mb>")

    def _mo_ctl_trace(self, arg: str) -> str:
        """status | on | off | clear | sample:<f> | slow:<ms> |
        dump:<path>"""
        tr = motrace.TRACER
        if arg in ("", "status"):
            return json.dumps(tr.status(), sort_keys=True)
        if arg == "on":
            tr.arm()
            return "trace armed"
        if arg == "off":
            tr.disarm()
            return "trace disarmed"
        if arg == "clear":
            tr.clear()
            return "trace ring cleared"
        if arg.startswith("sample:"):
            try:
                tr.sample = float(arg.split(":", 1)[1])
            except ValueError:
                raise BindError(f"bad sample fraction in {arg!r}")
            return f"trace sample = {tr.sample}"
        if arg.startswith("slow:"):
            try:
                tr.slow_ms = float(arg.split(":", 1)[1])
            except ValueError:
                raise BindError(f"bad slow threshold in {arg!r}")
            return f"trace slow_ms = {tr.slow_ms}"
        if arg.startswith("dump:"):
            paths = motrace.dump(arg.split(":", 1)[1])
            return (f"dumped {len(paths)} trace(s) -> "
                    + (paths[0].rsplit('/', 1)[0] if paths
                       else "nothing to dump"))
        raise BindError(f"unknown trace subcommand {arg!r}; use status | "
                        f"on | off | clear | sample:<f> | slow:<ms> | "
                        f"dump:<path>")

    def _cbo(self, node):
        """Stats-driven join reordering (reference: plan/query_builder.go
        determineJoinOrder). `cbo = 0` in the variables disables it."""
        if str(self.variables.get("cbo", 1)) in ("0", "off", "false"):
            return node
        from matrixone_tpu_torch.sql.cbo import optimize_plan
        return optimize_plan(node, self.catalog)

    # ------------------------------------------------------------- select
    def _select(self, sel, serving=None) -> Result:
        ctl = self._try_mo_ctl(sel)
        if ctl is not None:
            return ctl
        sv = serving if (serving is not None and self.txn is None) else None
        lazy = sv is not None and sv.owns_pristine(sel)
        if sv is not None and not sv.usable_for(sel):
            sv = None
        if sv is None and lazy:
            # the caches declined but the caller handed over the pristine
            # template: bind a private substituted copy, never the shared
            # template itself
            sel = serving.instantiate(raise_errors=True)
            lazy = False
        ann = getattr(self, "_exec_ann", None)
        # ---- result cache: serve the whole statement if every scanned
        # table is still at the version the entry was stored under
        if sv is not None and sv.result_enabled():
            hit = sv.state.result_cache.get(sv.result_key(),
                                            self._recompute_versions)
            if hit is not None:
                if ann is not None:
                    ann["cache_hit"] = "result"
                return Result(batch=hit[0])
        # ---- plan cache: skip prepare, bind and optimize on a hit (in
        # template mode only: raw-path literals carry no parameter tags)
        node = None
        plan_missed = False
        gens = self._serving_gens()
        if sv is not None and sv.template_mode and sv.plan_enabled():
            outcome, node = sv.state.plan_cache.lookup(
                sv.plan_key(), gens[0], gens[1], sv.full)
            plan_missed = outcome == "miss"
            if node is not None and ann is not None \
                    and ann["cache_hit"] == "none":
                ann["cache_hit"] = "plan"
        if node is None:
            if lazy:
                # instantiate the template only now: a plan-cache hit
                # above never pays the AST deepcopy
                sel = sv.instantiate(raise_errors=True)
            with motrace.span("plan"):
                node = self.plan_select(sel)
            if sv is not None and sv.template_mode \
                    and sv.plan_enabled() and plan_missed:
                # stored under the gens captured at lookup: a DDL racing
                # the bind orphans this entry
                sv.state.plan_cache.store(
                    sv.plan_key(), node, len(sv.full), gens[0], gens[1])
        # versions and the execution snapshot are captured in ONE hold
        # of the engine's commit lock (a commit moves table versions
        # before it advances committed_ts); execution is then frozen at
        # the captured ts
        versions = frozen = None
        if sv is not None and sv.result_enabled():
            versions, frozen = self._capture_versions(node)
        ctx = self._ctx(frozen_ts=frozen)
        node2 = self._maybe_distribute(node, ctx)
        # ---- compiled-tree reuse: the tree of the last completed
        # execution rides the plan-cache entry (pop semantics: a
        # concurrent execution finds none and compiles its own); a
        # statement whose fragment ran on the mesh has a plan of its own
        op = cached = None
        tree_cacheable = (sv is not None and sv.template_mode
                          and sv.plan_enabled() and node2 is node)
        tree_vars = self._tree_vars_sig() if tree_cacheable else None
        if tree_cacheable:
            if keyaudit.armed():
                # each build-time knob re-read independently of the
                # signature: one that steers tree construction without
                # riding it mismatches here
                keyaudit.audit(
                    "serving/plan_cache.py:tree",
                    (sv.plan_key(), gens[0], gens[1], tree_vars),
                    self._tree_vars_deps())
            cached = sv.state.plan_cache.take_tree(
                sv.plan_key(), gens[0], gens[1], tree_vars)
            if cached is not None:
                op = sv.state.plan_cache.rebind_tree(cached, sv.full)
                if op is not None:
                    retarget_tree(op, ctx)
                    # the tree's plan nodes are this execution's (the
                    # parameters were patched into them in place)
                    node = cached["plan"]
        if op is None:
            node = node2
            op = compile_plan(node, ctx)
            built = {"op": op, "plan": node} if tree_cacheable else None
        else:
            built = cached
        out_batches = []
        batches = op.execute()
        try:
            for ex in batches:
                # KILL lands between device batches: the pull loop is
                # the executor's preemption point
                self._procs.check_killed(self.conn_id)
                out_batches.append(self._to_host(ex, node.schema))
        finally:
            # a killed or failed run closes the operators' generators
            # now: their fragments release the graphs they own
            batches.close()
        if built is not None:
            sv.state.plan_cache.put_tree(sv.plan_key(), built, gens[0],
                                         gens[1], tree_vars)
        if not out_batches:
            empty = {n: Vector.from_values([], d) for n, d in node.schema}
            result = Result(batch=Batch(empty))
        elif len(out_batches) == 1:
            result = Result(batch=out_batches[0])
        else:
            # concatenate host batches
            result = Result(batch=Batch({
                n: Vector.concat([b.columns[n] for b in out_batches], d)
                for n, d in node.schema}))
        if versions is not None and result.batch is not None:
            # a host batch (`_to_host` copies every column off the card),
            # never a view of a graph's output buffers
            sv.state.result_cache.put(sv.result_key(), result.batch,
                                      versions)
        return result

    def _tree_vars_sig(self) -> tuple:
        """Session state baked into a compiled operator tree at build
        time (everything else is re-read through the ExecContext at
        execute time), derived from `_tree_vars_deps` so the signature
        and the audited set cannot drift."""
        return tuple(self._tree_vars_deps().values())

    def _tree_vars_deps(self) -> dict:
        """Every knob a compiled tree of the port bakes, named: the
        fusion switches the planner consults while building fragments,
        the session's join build budget (JoinOp reads it at
        construction), the session's device and the narrow-encoding
        policy of that device.  The port has no `use_pallas` switch.
        Adding a build-time knob means adding a row here (append: the
        order is part of the signature)."""
        from matrixone_tpu_torch.ops import encodings as ENC
        from matrixone_tpu_torch.vm import fusion
        return {
            "plan_fusion": fusion.enabled(self._ctx()),
            "fusion_join": fusion.join_fusion_enabled(),
            "fusion_window": fusion.window_fusion_enabled(),
            "fusion_topk": fusion.topk_fusion_enabled(),
            "join_build_budget": self.variables.get("join_build_budget"),
            "device": str(self.device),
            "encodings": ENC.signature(self.device),
        }

    # ------------------------------------------------- serving versions
    def _serving_gens(self):
        return (getattr(self.catalog, "ddl_gen", 0),
                getattr(self.catalog, "stats_gen", 0))

    def _capture_versions(self, node):
        """-> ((ddl_gen, per-scan table versions), frozen_ts) for the
        result cache, under the engine's commit lock so the version
        tuple and the snapshot ts are one consistent point."""
        lock = self.catalog._commit_lock
        scans = set()
        for v in iter_plan_values(node):
            if isinstance(v, P.Scan):
                scans.add((v.table, v.as_of_ts))
        with lock:
            ts0 = self.catalog.committed_ts
            entries = []
            for table, as_of in sorted(scans,
                                       key=lambda x: (x[0], x[1] or -1)):
                t = self.catalog.tables.get(table)
                if t is None or getattr(t, "is_external", False):
                    # raced drop, or a file that changes outside any
                    # commit: bypass
                    return None, None
                if as_of is not None and as_of <= ts0:
                    # strictly in the committed past: immutable (every
                    # later commit gets a ts past committed_ts >= as_of);
                    # a future-dated AS OF still sees later commits and
                    # versions like a live read
                    entries.append((table, "asof", as_of))
                    continue
                entries.append((table, t.last_commit_ts, len(t.segments),
                                len(t.tombstones)))
            return (self.catalog.ddl_gen, tuple(entries)), ts0

    def _recompute_versions(self, stored):
        """A stored entry's version tuple re-read from the live catalog
        under the commit lock; a dropped table never matches."""
        with self.catalog._commit_lock:
            entries = []
            for ent in stored[1]:
                if ent[1] == "asof":
                    entries.append(ent)          # immutable past
                    continue
                t = self.catalog.tables.get(ent[0])
                if t is None:
                    return None
                entries.append((ent[0], t.last_commit_ts, len(t.segments),
                                len(t.tombstones)))
            return (self.catalog.ddl_gen, tuple(entries))

    def _explain_analyze(self, node) -> str:
        """Run the plan, recording each operator's batches, rows and
        seconds (reference: EXPLAIN ANALYZE via process.Analyzer).  Each
        batch's device work is settled (`torch.cuda.synchronize` on its
        device) before the operator is stamped, so a heavy step's time
        is not billed to whichever operator above first touches it; no
        capture is open on this thread between two batches."""
        import torch
        from matrixone_tpu_torch.vm.fusion import FusedFragmentOp
        op = compile_plan(node, self._ctx())
        stats = {}

        def wrap(o):
            orig = o.execute
            st = stats.setdefault(id(o), {"op": type(o).__name__,
                                          "batches": 0, "rows": 0,
                                          "seconds": 0.0})

            def timed():
                it = orig()
                while True:
                    t0 = time.perf_counter()
                    try:
                        ex = next(it)
                    except StopIteration:
                        st["seconds"] += time.perf_counter() - t0
                        return
                    if ex.device.type == "cuda":
                        torch.cuda.synchronize(ex.device)
                    st["seconds"] += time.perf_counter() - t0
                    st["batches"] += 1
                    st["rows"] += int(ex.mask.sum())
                    yield ex
            o.execute = timed
            for attr in ("child", "left", "right"):
                c = getattr(o, attr, None)
                if c is not None:
                    wrap(c)
            for c in getattr(o, "children", []) or []:
                wrap(c)
        wrap(op)
        for _ in op.execute():
            pass

        def render(o, indent=0):
            st = stats[id(o)]
            node = getattr(o, "node", None)
            notes = P._udf_call_notes(node) if node is not None else ""
            out = ["  " * indent + f"{st['op']}{notes}  rows={st['rows']} "
                   f"batches={st['batches']} "
                   f"time={st['seconds'] * 1000:.1f}ms"]
            if isinstance(o, FusedFragmentOp):
                fs = o.last_stats
                build = ("" if "build_dispatches" not in fs else
                         f" build_dispatches={fs['build_dispatches']}")
                out.append(
                    "  " * (indent + 1)
                    + f"fragment f{o.fragment_id} [{o.describe()}] "
                      f"mode={fs['mode']} dispatches={fs['dispatches']} "
                      f"trace_ms={fs['trace_ms']:.1f} "
                      f"compile_cache={fs['cache']}" + build)
            if notes:
                # a UDF call rides its operator's pull loop: its rows and
                # batches are the operator's
                out.append("  " * (indent + 1)
                           + f"{notes.strip()}  rows={st['rows']} "
                             f"batches={st['batches']}")
            for attr in ("child", "left", "right"):
                c = getattr(o, attr, None)
                if c is not None:
                    out.extend(render(c, indent + 1))
            for c in getattr(o, "children", []) or []:
                out.extend(render(c, indent + 1))
            return out
        return "\n".join(render(op))

    def _maybe_distribute(self, node, ctx):
        """Distributed execution (reference: the compiler's Magic: Remote
        decision, compile/types.go:162).  Device shards first: under
        `SET query_shards = N` (MO_QUERY_SHARDS) a qualifying plan runs
        its lower fragment on N slots of the mesh (parallel/
        dist_query.py).  Then host peers: with the catalog's
        `dist_peers` set (fragment servers, cluster/cn.py) it runs on
        them (parallel/fragments.py), `dist_batch_rows` rows a scan
        batch there.  Either re-enters here as a Materialized node.
        Never inside a transaction; `SET dist = 0` disables;
        `dist_min_rows` is the input size threshold."""
        if self.txn is not None:
            return node
        if str(self.variables.get("dist", 1)) in ("0", "off", "false"):
            return node
        min_rows = int(self.variables.get("dist_min_rows", 100_000))
        shards = int(self.variables.get("query_shards", 0) or 0)
        if shards >= 2:
            from matrixone_tpu_torch.parallel import dist_query as DQ
            rebuilt = DQ.try_shard(node, self.catalog, ctx, shards,
                                   min_rows=min_rows)
            if rebuilt is not None:
                return rebuilt
        if not getattr(self.catalog, "dist_peers", None):
            return node
        from matrixone_tpu_torch.parallel import fragments as FR
        rebuilt = FR.try_distribute(
            node, self.catalog, ctx, FR.pool_for(self.catalog),
            min_rows=min_rows,
            batch_rows=int(self.variables.get("dist_batch_rows", 1 << 16)))
        return rebuilt if rebuilt is not None else node

    def _exchange_annotator(self, node):
        """EXPLAIN decoration for the device-shard executor: each
        exchange the CBO planned, exchange=broadcast|shuffle|local on the
        spine joins and the probe scan (parallel/dist_query.py)."""
        shards = int(self.variables.get("query_shards", 0) or 0)
        if shards < 2:
            return None
        from matrixone_tpu_torch.parallel import dist_query as DQ
        modes = DQ.explain_exchanges(
            node, self.catalog, self._ctx(), shards,
            min_rows=int(self.variables.get("dist_min_rows", 100_000)))
        if not modes:
            return None
        return lambda n: (f" exchange={modes[id(n)]}"
                          if id(n) in modes else "")

    def _fragment_annotator(self, node):
        """EXPLAIN decoration: compile the operator tree (no execution)
        and mark which plan nodes fused into which fragment, with the
        role of a join, window or top-k node in its fragment."""
        from matrixone_tpu_torch.vm import fusion
        if not fusion.enabled(self._ctx()):
            return None
        op = compile_plan(node, self._ctx())
        fmap = fusion.fragment_map(op)
        if not fmap:
            return None
        roles = fusion.fragment_roles(op)
        return lambda n: ((f" fragment=f{fmap[id(n)]}"
                           + (f" {roles[id(n)]}" if id(n) in roles
                              else ""))
                          if id(n) in fmap else "")

    def plan_select(self, sel):
        from matrixone_tpu_torch.sql.optimize import apply_indices
        if not isinstance(sel, (ast.Select, ast.Union)):
            raise _not_ported(f"{type(sel).__name__} statements")
        from matrixone_tpu_torch.sql.decorrelate import statement_names
        with statement_names():
            self._prepare_select(sel)
        node = Binder(self.catalog).bind_statement(sel)
        node = self._cbo(node)
        return apply_indices(node, self.catalog,
                             nprobe=int(self.variables.get("ivf_nprobe", 8)),
                             skip_tables=self._index_skip_tables())

    def _to_host(self, ex, schema) -> Batch:
        # compact masked rows before leaving the device
        db = F.compact(ex.batch, ex.mask, ex.padded_len)
        return from_device(db, ex.dicts, schema=dict(schema))

    # --------------------------------------------------------------- ddl
    def _create_table(self, stmt: ast.CreateTable) -> Result:
        schema = [(c.name, type_from_name(c.type_name, c.type_args))
                  for c in stmt.columns]
        auto = [c.name for c in stmt.columns if c.auto_increment]
        if len(auto) > 1:
            raise BindError("only one AUTO_INCREMENT column allowed")
        not_null = [c.name for c in stmt.columns if c.not_null]
        part = None
        if stmt.partition_by is not None:
            from matrixone_tpu_torch.storage.partition import build_spec
            part = build_spec(stmt.partition_by, schema)
        self.catalog.create_table(
            TableMeta(stmt.name, schema, stmt.primary_key,
                      auto_increment=auto[0] if auto else None,
                      not_null=not_null, partition=part),
            if_not_exists=stmt.if_not_exists)
        return Result()

    def _live_partition_rows(self, t, pid: int) -> np.ndarray:
        """The gids of the live rows of partition pid."""
        dead = t._dead_gids(None, None)
        gids = []
        for seg in t.segments:
            if seg.part_id != pid:
                continue
            g = np.arange(seg.base_gid, seg.base_gid + seg.n_rows,
                          dtype=np.int64)
            if len(dead):
                g = g[~np.isin(g, dead)]
            gids.append(g)
        return np.concatenate(gids) if gids else np.zeros(0, np.int64)

    def _create_index(self, stmt: ast.CreateIndex) -> Result:
        from matrixone_tpu_torch import indexing
        table = self.catalog.get_table(stmt.table)
        algo = (stmt.using or "").lower()
        if algo == "fulltext":
            for col in stmt.columns:
                if not dict(table.meta.schema)[col].is_varlen:
                    raise BindError(
                        f"fulltext index requires text columns ({col})")
            meta = IndexMeta(stmt.name, stmt.table, stmt.columns,
                             "fulltext", dict(stmt.options), dirty=True)
        elif algo in ("ivfflat", "ivf_flat", "ivfpq", "ivf_pq", "hnsw"):
            col = stmt.columns[0]
            coltype = dict(table.meta.schema)[col]
            if not coltype.is_vector:
                raise BindError(f"{algo} index requires a vecf32 column")
            op_type = stmt.options.get("op_type", "vector_l2_ops")
            metric = {"vector_l2_ops": "l2", "vector_cosine_ops": "cosine",
                      "vector_ip_ops": "ip"}.get(op_type, "l2")
            algo_name = ("hnsw" if algo == "hnsw"
                         else "ivfpq" if "pq" in algo else "ivfflat")
            if algo_name == "ivfpq" and metric == "ip":
                raise BindError(
                    "ivfpq does not support vector_ip_ops; use ivfflat")
            meta = IndexMeta(stmt.name, stmt.table, stmt.columns,
                             algo_name, dict(stmt.options), dirty=True)
            meta.options["_metric"] = metric
        else:
            raise BindError(f"unsupported index algo {stmt.using!r}")
        try:
            indexing.BUILD_FNS[meta.algo](self.catalog, meta, self.device)
        except ValueError as e:
            raise BindError(str(e))
        self.catalog.register_index(meta)
        indexing.register_in_cache(self.catalog, meta)
        return Result()

    # ------------------------------------------------- materialized views
    def _derived_table_schema(self, sel) -> list:
        """Bind a stored SELECT and derive its backing table's schema
        (qualifiers stripped, names checked)."""
        self._prepare_select(sel)
        node = Binder(self.catalog).bind_statement(sel)
        schema = [(n.split(".")[-1], d) for n, d in node.schema]
        if len({c for c, _ in schema}) != len(schema):
            raise BindError("materialized view SELECT has duplicate "
                            "output names")
        for c, _ in schema:
            if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", c):
                raise BindError(
                    f"materialized view output {c!r} is not a valid "
                    f"column name; alias the expression (AS name)")
        return schema

    def _create_materialized_view(self, stmt: ast.CreateMaterializedView
                                  ) -> Result:
        """CREATE MATERIALIZED VIEW: a backing table and one system_mview
        row.  A maintainable shape runs incremental: the catalog row's
        own post-commit hook initializes the state and the first
        materialization.  Every other shape materializes once here and
        refreshes in full on demand."""
        from matrixone_tpu_torch import mview as MV
        from matrixone_tpu_torch.mview import catalog as vcat
        if self.txn is not None:
            raise BindError(
                "CREATE MATERIALIZED VIEW inside an explicit transaction "
                "is not supported (view DDL is autocommit)")
        # maintainability first, on a pristine copy (a genuinely broken
        # SELECT raises from the schema bind below)
        try:
            spec, _why = MV.analyze(copy.deepcopy(stmt.select),
                                    self.catalog)
        except BindError:
            spec = None
        schema = self._derived_table_schema(stmt.select)
        if vcat.lookup(self.catalog, stmt.name) is not None:
            raise BindError(
                f"materialized view {stmt.name!r} already exists")
        self.catalog.create_table(TableMeta(stmt.name, schema, []))
        vcat.ensure_table(self.catalog)
        d = vcat.MViewDef(
            name=stmt.name.lower(), sql=stmt.sql_text,
            mode="incremental" if spec is not None else "full",
            source=spec.source if spec is not None else "")
        t = self.catalog.get_table(vcat.MVIEW_TABLE)
        arrays, validity = t.batch_to_arrays(
            vcat.row_batch(d, time.time_ns() // 1000))
        txn = self.txn_client.begin()
        try:
            txn.write_batch(vcat.MVIEW_TABLE, arrays, validity)
            # the commit's post-commit hook initializes the incremental
            # state and the first materialization before this returns
            txn.commit()
        except BaseException:
            txn.rollback()
            self.catalog.drop_table(stmt.name, if_exists=True)
            raise
        if spec is None:
            try:
                n = self._rematerialize(stmt.name, stmt.sql_text)
            except Exception:
                # a failed CREATE leaves nothing behind
                self._drop_mview_row(stmt.name)
                self.catalog.drop_table(stmt.name, if_exists=True)
                raise
            return Result(affected=n)
        # the post-commit hook never raises (it must not fail another
        # writer's commit), but this statement's own init failure must.
        # Checkable only where the maintaining engine is local: on a CN
        # replica the TN maintains, and the backing rows arrive through
        # the logtail
        if not isinstance(self.catalog, Engine):
            return Result(affected=self.catalog.get_table(stmt.name).n_rows)
        svc = self.catalog._mview_service
        rt = svc.runtime(d.name) if svc is not None else None
        if rt is None or rt.watermark is None:
            self._drop_mview_row(stmt.name)
            self.catalog.drop_table(stmt.name, if_exists=True)
            raise BindError(
                f"materialized view {stmt.name!r} failed to initialize "
                f"(see mo_ctl('mview','status'))")
        return Result(affected=self.catalog.get_table(stmt.name).n_rows)

    def _rematerialize(self, name: str, sql: str) -> int:
        """Full rematerialization of a stored SELECT into its backing
        table: one transaction deletes the old rows and inserts the new
        ones."""
        b = self.execute(sql).batch
        cols = list(b.columns)
        pylists = {c: b.columns[c].to_pylist() for c in cols}
        n = len(b)
        # the refresh's own writes pass the view write guard
        self._mview_refresh = getattr(self, "_mview_refresh", 0) + 1
        try:
            self.execute("begin")
            try:
                self.execute(f"delete from {name}")
                if n:
                    rows = ["(" + ", ".join(_sql_literal(pylists[c][i])
                                            for c in cols) + ")"
                            for i in range(n)]
                    self.execute(f"insert into {name} ({', '.join(cols)}) "
                                 f"values " + ", ".join(rows))
                self.execute("commit")
            except Exception:
                self.execute("rollback")
                raise
        finally:
            self._mview_refresh -= 1
        return n

    def _drop_mview_row(self, name: str) -> None:
        from matrixone_tpu_torch.mview import catalog as vcat
        gids = vcat.gids_for_name(self.catalog, name)
        if not len(gids):
            return
        txn = self.txn_client.begin()
        try:
            txn.delete_rows(vcat.MVIEW_TABLE, gids)
            txn.commit()
        except BaseException:
            txn.rollback()
            raise

    def _drop_materialized_view(self, stmt: ast.DropMaterializedView
                                ) -> Result:
        from matrixone_tpu_torch.mview import catalog as vcat
        if vcat.lookup(self.catalog, stmt.name) is None:
            if stmt.if_exists:
                return Result()
            raise BindError(f"no such materialized view {stmt.name!r}")
        # the catalog row first: its commit's hook detaches the
        # maintainer before the backing table goes
        self._drop_mview_row(stmt.name)
        self.catalog.drop_table(stmt.name, if_exists=True)
        return Result()

    def _show_materialized_views(self) -> Result:
        from matrixone_tpu_torch.mview import catalog as vcat
        reg = vcat.registry_for(self.catalog)
        svc = self.catalog._mview_service
        names = sorted(reg)
        wms, rows = [], []
        for n in names:
            rt = svc.runtime(n) if svc is not None else None
            wms.append(rt.watermark if rt is not None else None)
            t = self.catalog.tables.get(n)
            rows.append(t.n_rows if t is not None else None)
        return _show({"Name": names,
                      "Mode": [reg[n].mode for n in names],
                      "Source": [reg[n].source or None for n in names],
                      "Watermark": wms, "Rows": rows,
                      "Definition": [reg[n].sql for n in names]},
                     {"Watermark": dt.INT64, "Rows": dt.INT64,
                      "Definition": dt.TEXT})

    def _refresh_mview(self, name: str) -> int:
        """REFRESH MATERIALIZED VIEW: an incremental view is maintained
        at every commit (refresh reports its rows); a full one is
        rematerialized."""
        from matrixone_tpu_torch.mview import catalog as vcat
        d = vcat.lookup(self.catalog, name)
        if d is None:
            raise BindError(f"no such materialized view {name!r}")
        if d.mode == "incremental":
            return self.catalog.get_table(name).n_rows
        return self._rematerialize(name, d.sql)

    def _reject_mview_write(self, table: str) -> None:
        """Direct DML against a view would be overwritten by its next
        maintenance or refresh: refuse it.  (Maintenance writes through
        `Engine.commit_txn`, never through a session.)"""
        if getattr(self, "_mview_refresh", 0):
            return            # the refresh's own writes
        from matrixone_tpu_torch.mview import catalog as vcat
        if vcat.lookup(self.catalog, table) is not None:
            raise BindError(
                f"{table!r} is a materialized view; it is maintained "
                f"from its source — write to the source table instead")

    def _mview_annotator(self):
        """EXPLAIN decoration: a scan of a view's backing table is marked
        with the view's maintenance mode."""
        from matrixone_tpu_torch.mview import catalog as vcat
        reg = vcat.registry_for(self.catalog)
        if not reg:
            return None

        def ann(n):
            t = getattr(n, "table", None)
            if isinstance(n, P.Scan) and isinstance(t, str) \
                    and t.lower() in reg:
                return f" mview={reg[t.lower()].mode}"
            return ""
        return ann

    # --------------------------------------------------------------- udf
    def _create_function(self, stmt: ast.CreateFunction) -> Result:
        """CREATE [OR REPLACE] FUNCTION: validate and trial-compile the
        body, then write one row of the system_udf catalog table through
        the ordinary commit pipeline (durability and restart replay ride
        it)."""
        from matrixone_tpu_torch import udf as U
        from matrixone_tpu_torch.udf import catalog as ucat
        if self.txn is not None:
            raise BindError(
                "CREATE FUNCTION inside an explicit transaction is not "
                "supported (function DDL is autocommit)")
        props = {str(k).lower(): str(v).lower()
                 for k, v in stmt.properties.items()}
        for k in props:
            if k not in ("deterministic", "vectorized"):
                raise BindError(f"unknown function property {k!r}; "
                                f"use 'deterministic' | 'vectorized'")
        meta = U.UdfMeta(
            name=stmt.name.lower(),
            kind="aggregate" if stmt.aggregate else "scalar",
            arg_names=[a for a, _t, _ta in stmt.args],
            arg_types=[type_from_name(t, ta) for _a, t, ta in stmt.args],
            ret_type=type_from_name(stmt.ret_type, stmt.ret_args),
            language=stmt.language, body=stmt.body,
            deterministic=props.get("deterministic", "true") != "false",
            vectorized=props.get("vectorized", "true") != "false")
        try:
            U.validate_meta(meta)
        except U.UdfError as e:
            raise BindError(str(e))
        ucat.ensure_table(self.catalog)
        existing = ucat.registry_for(self.catalog)
        if meta.name in existing and not stmt.or_replace:
            raise BindError(f"function {meta.name!r} already exists "
                            f"(use CREATE OR REPLACE FUNCTION)")
        t = self.catalog.get_table(ucat.UDF_TABLE)
        arrays, validity = t.batch_to_arrays(
            ucat.row_batch(meta, time.time_ns() // 1000))
        txn = self.txn_client.begin()
        try:
            if meta.name in existing:
                # OR REPLACE: the delete and the insert in one commit
                txn.delete_rows(ucat.UDF_TABLE, ucat.gids_for_name(
                    self.catalog, meta.name))
            txn.write_batch(ucat.UDF_TABLE, arrays, validity)
            txn.commit()
        except BaseException:
            txn.rollback()
            raise
        return Result()

    def _drop_function(self, stmt: ast.DropFunction) -> Result:
        from matrixone_tpu_torch.udf import catalog as ucat
        if self.txn is not None:
            raise BindError(
                "DROP FUNCTION inside an explicit transaction is not "
                "supported (function DDL is autocommit)")
        if ucat.registry_for(self.catalog).get(stmt.name.lower()) is None:
            if stmt.if_exists:
                return Result()
            raise BindError(f"no such function {stmt.name!r}")
        gids = ucat.gids_for_name(self.catalog, stmt.name)
        txn = self.txn_client.begin()
        try:
            txn.delete_rows(ucat.UDF_TABLE, gids)
            txn.commit()
        except BaseException:
            txn.rollback()
            raise
        return Result(affected=len(gids))

    def _show_functions(self) -> Result:
        from matrixone_tpu_torch.udf import catalog as ucat
        reg = ucat.registry_for(self.catalog)
        names = sorted(reg)
        return _show(
            {"Function": names,
             "Kind": [reg[n].kind for n in names],
             "Signature": [reg[n].signature() for n in names],
             "Language": [reg[n].language for n in names],
             "Deterministic": [int(reg[n].deterministic) for n in names],
             "Vectorized": [int(reg[n].vectorized) for n in names]},
            {"Signature": dt.TEXT, "Deterministic": dt.INT64,
             "Vectorized": dt.INT64})

    def _alter_partition(self, stmt: ast.AlterPartition) -> Result:
        """TRUNCATE/DROP PARTITION (partitionservice management ops):
        rows leave via an ordinary tombstone commit, so MVCC snapshots
        and time travel keep seeing the pre-truncate state."""
        t = self.catalog.get_table(stmt.table)
        spec = t.meta.partition
        if spec is None:
            raise BindError(f"table {stmt.table!r} is not partitioned")
        if stmt.part not in spec.names:
            raise BindError(f"no partition {stmt.part!r} on {stmt.table!r}")
        if stmt.action == "drop":
            # validate BEFORE the tombstone commit: a refused DROP must
            # not have already destroyed the partition's rows
            if spec.kind != "range":
                raise BindError("DROP PARTITION requires RANGE partitioning")
            if len(spec.names) == 1:
                raise BindError("cannot drop the last partition")
        gids = self._live_partition_rows(t, spec.names.index(stmt.part))
        if len(gids):
            self.catalog.commit_txn(None, {}, {stmt.table: gids})
        if stmt.action == "drop":
            self.catalog.alter_partition_drop(stmt.table, stmt.part)
        return _show({"partition": [stmt.part],
                      "rows_removed": [len(gids)]},
                     {"rows_removed": dt.INT64})

    def _show_partitions(self, stmt: ast.ShowPartitions) -> Result:
        t = self.catalog.get_table(stmt.name)
        spec = t.meta.partition
        if spec is None:
            raise BindError(f"table {stmt.name!r} is not partitioned")
        rows = [len(self._live_partition_rows(t, i))
                for i in range(spec.n_parts)]
        bounds = ([("MAXVALUE" if b is None else str(b))
                   for b in spec.bounds] if spec.kind == "range"
                  else [""] * spec.n_parts)
        return _show({"partition": list(spec.names),
                      "method": [spec.kind] * spec.n_parts,
                      "expr": [spec.column] * spec.n_parts,
                      "bound": bounds, "rows": rows},
                     {"rows": dt.INT64})

    # --------------------------------------------------------------- etl
    #: rows a LOAD casts and writes at a time (the reference's
    #: `to_batches(max_chunksize=1 << 20)`)
    LOAD_CHUNK_ROWS = 1 << 20

    def load_csv(self, table: str, path: str, **read_kwargs) -> int:
        """Bulk CSV load into the table's schema through the port's
        reader (`storage/csvread.py`, pyarrow's default CSV options)."""
        if read_kwargs:
            raise TypeError(
                f"load_csv() takes no reader options (got "
                f"{sorted(read_kwargs)}): the port's CSV reader has "
                f"pyarrow's defaults only")
        from matrixone_tpu_torch.storage import csvread
        return self._ingest(table, csvread.read_csv(path))

    def load_parquet(self, table: str, path: str) -> int:
        raise NotImplementedError(
            "parquet loads need pyarrow, which the port does not use "
            "(ROADMAP.md, section A: not queued)")

    def _load_data(self, stmt: ast.LoadData) -> Result:
        """LOAD DATA INFILE: the path may be local, file://, fs:// or
        stage://, resolved through the stage registry and the file
        service."""
        from matrixone_tpu_torch.storage import csvread
        from matrixone_tpu_torch.storage.external import open_location
        fmt = _resolve_format(stmt.fmt, stmt.path)
        if fmt == "iceberg":
            raise BindError(
                "LOAD DATA does not support FORMAT iceberg; create an "
                "external table over it and INSERT ... SELECT instead")
        self._reject_mview_write(stmt.table)
        src = open_location(self.catalog, stmt.path)
        if fmt == "parquet":
            return Result(affected=self.load_parquet(stmt.table, stmt.path))
        return Result(affected=self._ingest(stmt.table,
                                            csvread.read_csv(src)))

    def _ingest(self, table: str, tbl) -> int:
        """A read file (`csvread.CsvTable`) into `table`: one
        transaction, the session's own or one scoped to the statement,
        rolled back whole on any error or KILL."""
        t = self.catalog.get_table(table)
        auto_col = t.meta.auto_increment
        required = [c for c, _ in t.meta.schema if c != auto_col]
        missing = [c for c in required if c not in tbl.columns]
        if missing:
            raise BindError(
                f"load into {table!r}: file is missing columns {missing}; "
                f"file has {tbl.names}")
        # extra CSV columns are ignored; the auto_increment column may be
        # absent (values are allocated) or present (the counter advances
        # past its values)
        total = 0
        txn = self.txn or self.txn_client.begin()
        try:
            for start in range(0, tbl.n_rows, self.LOAD_CHUNK_ROWS):
                # KILL cancels a long LOAD DATA between chunks
                self._procs.check_killed(self.conn_id)
                stop = min(start + self.LOAD_CHUNK_ROWS, tbl.n_rows)
                arrays, validity = {}, {}
                for c, d in t.meta.schema:
                    if c not in tbl.columns:
                        # the absent auto_increment column: allocated
                        arrays[c] = np.asarray(t.allocate_auto(stop - start),
                                               d.np_dtype)
                        validity[c] = np.ones(stop - start, np.bool_)
                    elif d.is_varlen:
                        # strings into the table's dictionary, each
                        # distinct one once (`batch_to_arrays`' codes)
                        arrays[c], validity[c] = tbl.columns[c].dict_codes(
                            lambda s, c=c: t.encode_strings_list(c, s),
                            start, stop)
                    else:
                        vec = tbl.columns[c].to_vector(d, start, stop)
                        arrays[c] = np.asarray(vec.data, d.np_dtype)
                        validity[c] = vec.valid_mask().copy()
                if auto_col is not None and auto_col in tbl.columns:
                    t.observe_auto(arrays[auto_col].astype(np.int64))
                total += txn.write_batch(table, arrays, validity)
            if self.txn is None:
                txn.commit()
        except BaseException:  # noqa: BLE001 — rollback, then re-raised
            if self.txn is None:
                txn.rollback()
            raise
        return total

    # --------------------------------------------------------------- dml
    def _pessimistic(self, txn) -> bool:
        return (self.txn is not None
                and self.variables.get("txn_mode") == "pessimistic")

    def _maybe_lock(self, txn, table: str, gids) -> None:
        """Pessimistic mode (reference: colexec/lockop + lockservice.Lock):
        DML takes exclusive row locks before buffering the write; released
        at commit/rollback. `set txn_mode = 'pessimistic'` arms it. A
        deadlock victim is rolled back so its locks release at once and
        the survivor proceeds."""
        if not self._pessimistic(txn):
            return     # autocommit DML serializes through the commit lock
        from matrixone_tpu_torch.lockservice import DeadlockError
        committed = np.asarray(gids)[np.asarray(gids) >= 0]
        if len(committed):
            timeout = float(self.variables.get("lock_timeout", 10.0))
            try:
                self.catalog.locks.lock(txn.txn_id, table, committed,
                                        timeout=timeout)
            except DeadlockError:
                if self.txn is txn:
                    txn.rollback()
                    self.txn = None
                raise

    def _dml_read_ctx(self, txn) -> ExecContext:
        """Row-planning context for DML.  Pessimistic txns plan against the
        CURRENT frontier (MySQL 'current read'): after the lock wait, the
        statement must see the rows the lock winner left behind, not its
        own stale snapshot."""
        if self._pessimistic(txn):
            cur = types.SimpleNamespace(
                snapshot_ts=self.catalog.committed_ts,
                workspace=txn.workspace)
            return ExecContext(catalog=self.catalog, txn=cur,
                               variables=self.variables, device=self.device)
        return ExecContext(catalog=self.catalog, txn=txn,
                           variables=self.variables, device=self.device)

    def _plan_and_lock_rows(self, txn, table: str, run_plan):
        """run_plan(ctx) -> (gids, payload). In pessimistic mode: plan at
        the frontier, lock, re-plan (the frontier may have advanced while
        we waited) until the row set stabilizes."""
        result = run_plan(self._dml_read_ctx(txn))
        if not self._pessimistic(txn):
            return result
        for _ in range(5):
            self._maybe_lock(txn, table, result[0])
            again = run_plan(self._dml_read_ctx(txn))
            if set(np.asarray(again[0]).tolist()) == \
                    set(np.asarray(result[0]).tolist()):
                return again
            result = again
        return result

    def _dml_plan(self, table_name: str, where, extra_exprs=None,
                  extra_names=None):
        """Plan `SELECT __rowid [, extra...] FROM t WHERE ...` for DML."""
        table = self.catalog.get_table(table_name)
        scope = Scope()
        for col, dtype in table.meta.schema:
            scope.add(table_name, col, dtype)
        binder = Binder(self.catalog)
        scan_cols = [c for c, _ in table.meta.schema] + [ROWID]
        scan_schema = [(f"{table_name}.{c}", d)
                       for c, d in table.meta.schema] + [(ROWID, dt.INT64)]
        node = P.Scan(table_name, scan_cols, scan_schema)
        if where is not None:
            pred = binder.bind_expr(where, scope)
            node = P.Filter(node, pred, node.schema)
        exprs = [BoundCol(ROWID, dt.INT64)]
        names = [ROWID]
        out_types = [dt.INT64]
        for e, nm in zip(extra_exprs or [], extra_names or []):
            b = binder.bind_expr(e, scope)
            exprs.append(b)
            names.append(nm)
            out_types.append(b.dtype)
        return P.Project(node, exprs, list(zip(names, out_types)))

    def _run_dml_plan(self, proj, ctx, columns=()):
        """Run a DML plan on the session's device -> (row ids, {column:
        python values})."""
        op = compile_plan(proj, ctx)
        gids, new_cols = [], {c: [] for c in columns}
        for ex in op.execute():
            b = self._to_host(ex, proj.schema)
            gids.append(np.asarray(b.columns[ROWID].data, np.int64))
            for c in columns:
                new_cols[c].extend(b.columns[c].to_pylist())
        gids = np.concatenate(gids) if gids else np.zeros(0, np.int64)
        return gids, new_cols

    def _delete(self, stmt: ast.Delete) -> Result:
        self._reject_mview_write(stmt.table)
        txn = self.txn or self.txn_client.begin()
        proj = self._dml_plan(stmt.table, stmt.where)
        gids, _ = self._plan_and_lock_rows(
            txn, stmt.table, lambda ctx: self._run_dml_plan(proj, ctx))
        txn.delete_rows(stmt.table, gids)
        if self.txn is None:
            txn.commit()
        return Result(affected=len(gids))

    def _update(self, stmt: ast.Update) -> Result:
        self._reject_mview_write(stmt.table)
        txn = self.txn or self.txn_client.begin()
        table = self.catalog.get_table(stmt.table)
        schema = table.meta.schema
        assigned = dict(stmt.assignments)
        names = [c for c, _ in schema]
        proj = self._dml_plan(
            stmt.table, stmt.where,
            [assigned.get(c, ast.ColumnRef(c, stmt.table)) for c in names],
            names)
        gids, new_cols = self._plan_and_lock_rows(
            txn, stmt.table,
            lambda ctx: self._run_dml_plan(proj, ctx, names))
        if len(gids) == 0:
            return Result(affected=0)
        # rows must round-trip through the table's SQL types (e.g. the
        # assignment may produce float for a decimal column)
        batch = Batch.from_pydict(new_cols, dict(schema))
        arrays, validity = table.batch_to_arrays(batch)
        txn.delete_rows(stmt.table, gids)
        txn.write_batch(stmt.table, arrays, validity)
        if self.txn is None:
            txn.commit()
        return Result(affected=len(gids))

    def _insert(self, stmt: ast.Insert) -> Result:
        self._reject_mview_write(stmt.table)
        table = self.catalog.get_table(stmt.table)
        schema = table.meta.schema
        cols = stmt.columns or [c for c, _ in schema]
        if stmt.select is not None:
            sub = self._select(stmt.select)
            data = {c: sub.batch.columns[n].to_pylist()
                    for c, n in zip(cols, sub.column_names)}
        else:
            data = {c: [] for c in cols}
            for row in stmt.rows:
                if len(row) != len(cols):
                    raise BindError("INSERT arity mismatch")
                for c, v in zip(cols, row):
                    data[c].append(_literal_value(v))
        full = {}
        n = len(next(iter(data.values()))) if data else 0
        auto_col = table.meta.auto_increment
        for c, d in schema:
            vals = data.get(c, [None] * n)
            if c == auto_col:
                # row order matters: an explicit value advances the counter
                # for subsequent NULLs in the same statement (MySQL behavior)
                vals = list(vals)
                for i, v in enumerate(vals):
                    if v is None:
                        vals[i] = int(table.allocate_auto(1)[0])
                        # MySQL last_insert_id(): FIRST generated id
                        # of the statement
                        if not self._liid_set:
                            self.last_insert_id = vals[i]
                            self._liid_set = True
                    else:
                        table.observe_auto(np.asarray([v], np.int64))
            if d.oid == TypeOid.DATE:
                vals = [dt.epoch_days_from_iso(v)
                        if isinstance(v, str) else v for v in vals]
            elif d.oid in (TypeOid.DATETIME, TypeOid.TIMESTAMP):
                vals = [dt.epoch_micros_from_iso(v)
                        if isinstance(v, str) else v for v in vals]
            elif d.is_vector:
                vals = [[float(x) for x in v.strip()[1:-1].split(",")]
                        if isinstance(v, str) else v for v in vals]
                for v in vals:
                    if v is not None and len(v) != d.dim:
                        raise BindError(
                            f"vector literal has {len(v)} dimensions, "
                            f"column {c!r} expects {d.dim}")
            full[c] = vals
        batch = Batch.from_pydict(full, dict(schema))
        if self.txn is not None:
            arrays, validity = table.batch_to_arrays(batch)
            n = self.txn.write_batch(stmt.table, arrays, validity)
        else:
            n = table.insert_batch(batch)
        return Result(affected=n)


#: mo_ctl commands over modules the port lacks, and what each needs
_MO_CTL_NOT_PORTED = {
    "lint": "the molint tool of the JAX package",
    "san": "the concurrency sanitizer",
    "qa": "the moqa corpus runner (tools/moqa, which imports the JAX "
          "package; the padding canary itself is utils/qa.py)",
    "crash": "the crash-recovery sweep (mocrash)",
}


class _ServingCtx:
    """One normalized statement routed through the plan and result
    caches (matrixone_tpu_torch/serving).

    Two modes: `template_mode` (the template is active: the plan cache
    takes part and parameter literals are tagged) and raw mode (the first
    occurrence of a template: only the result cache takes part, and the
    statement runs through the ordinary parse path at no added cost)."""

    def __init__(self, state, norm, full_params, scope: str):
        self.state = state
        self.norm = norm
        self.full = full_params
        self.scope = scope
        self.template_mode = False
        self._pristine = None      # cached template AST (never mutated)
        self._usable = None        # computed lazily on the template AST

    def make_stmts(self):
        """-> [stmt] from the cached template AST, or None (raw path).
        A SELECT or UNION returns the pristine template (`_select`
        instantiates it lazily, so a plan-cache hit never pays the AST
        deepcopy); other statements instantiate at once (their executors
        mutate the AST)."""
        tpl = self.state.plan_cache.template_ast(self.norm.template)
        if tpl is None:
            return None
        # every `?` must surface as an ast.Param: a template whose
        # parameters the parser consumed structurally is unusable
        if _param_indexes(tpl) != set(range(len(self.full))):
            return None
        self.template_mode = True
        self._pristine = tpl
        if isinstance(tpl, (ast.Select, ast.Union)):
            return [tpl]
        st = self.instantiate()
        return None if st is None else [st]

    def owns_pristine(self, stmt) -> bool:
        return self._pristine is not None and stmt is self._pristine

    def instantiate(self, raise_errors: bool = False):
        """A fresh substituted copy of the template.  Bind-time parameter
        errors raise when `raise_errors`, else give None (the raw path
        reports them)."""
        st = copy.deepcopy(self._pristine)
        try:
            return _substitute_params(st, self.full)
        except BindError:
            if raise_errors:
                raise
            return None

    def usable_for(self, sel) -> bool:
        """The caches are safe only for statements whose execution is
        visible in the final plan: uncorrelated subqueries and EXISTS run
        at prepare time and fold to constants (their tables would escape
        the version key), and @@sysvars read session state."""
        if self._usable is None:
            self._usable = not _ast_has(
                sel, (ast.Subquery, ast.Exists, ast.SysVar))
        return self._usable

    def result_enabled(self) -> bool:
        return self.state.result_cache.enabled

    def plan_enabled(self) -> bool:
        return self.state.plan_cache.enabled

    def _vars_key(self):
        s = current_session()
        v = s.variables if s is not None else {}
        return (str(v.get("cbo", 1)), int(v.get("ivf_nprobe", 8) or 8),
                int(v.get("ivf_shards", 0) or 0),
                int(v.get("query_shards", 0) or 0))

    def plan_key(self) -> tuple:
        return ("plan", self.scope, self.norm.template,
                self.norm.sig_for(self.full), self._vars_key())

    def result_key(self) -> tuple:
        # the sig keeps numerically equal parameters of different types
        # apart: (1,) == (1.0,) but their results' types differ
        return ("result", self.scope, self.norm.template,
                self.norm.sig_for(self.full), tuple(self.full),
                self._vars_key())


def _param_indexes(node) -> set:
    """Every ast.Param index reachable in a statement."""
    return {x.index for x in iter_plan_values(node)
            if isinstance(x, ast.Param)}


def _ast_has(node, kinds) -> bool:
    return any(isinstance(x, kinds) for x in iter_plan_values(node))


def _substitute_params(node, params: list):
    """Replace the `?` placeholders (ast.Param) by literal values, each
    tagged with its parameter index (the tag survives into the
    BoundLiteral, so a cached plan can be re-parameterized)."""
    if isinstance(node, ast.Param):
        if node.index >= len(params):
            raise BindError(f"missing value for parameter {node.index + 1}")
        lit = _param_literal(params[node.index])
        lit._param_idx = node.index
        return lit
    if dataclasses.is_dataclass(node) and isinstance(node, ast.Node):
        def sub(x):
            if isinstance(x, ast.Node):
                return _substitute_params(x, params)
            if isinstance(x, tuple):
                return tuple(sub(y) for y in x)
            if isinstance(x, list):
                return [sub(y) for y in x]
            return x
        for f in dataclasses.fields(node):
            setattr(node, f.name, sub(getattr(node, f.name)))
    return node


def _show(data: dict, dtypes: Optional[dict] = None) -> Result:
    """A SHOW result: columns of Python values, VARCHAR unless named."""
    dtypes = dtypes or {}
    return Result(batch=Batch.from_pydict(
        data, {c: dtypes.get(c, dt.VARCHAR) for c in data}))


def _resolve_format(fmt: str, location: str) -> str:
    """LOAD and EXTERNAL format defaulting and validation (one place
    so the two paths cannot drift; always a BindError on bad input)."""
    if not fmt:
        fmt = "parquet" if location.endswith(".parquet") else "csv"
    if fmt not in ("csv", "parquet", "iceberg"):
        raise BindError(f"unsupported external format {fmt!r}")
    return fmt


def _sql_literal(v) -> str:
    """One Python value as a SQL literal (a full view refresh writes its
    rows as INSERT text)."""
    import math
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, datetime.datetime):
        epoch = datetime.datetime(1970, 1, 1)
        return str(int((v - epoch).total_seconds() * 1e6))
    if isinstance(v, datetime.date):
        return "'" + v.isoformat() + "'"
    if isinstance(v, float):
        # SQL has no nan/inf literals: NULL is the one value every
        # dialect round-trips for them
        if math.isnan(v) or math.isinf(v):
            return "null"
        return repr(v)
    return str(v)


def _param_literal(v) -> ast.Node:
    if v is None:
        return ast.Literal(None, "null")
    if isinstance(v, bool):
        return ast.Literal(v, "bool")
    if isinstance(v, int):
        return ast.Literal(v, "int")
    if isinstance(v, float):
        return ast.Literal(repr(v), "float")
    if isinstance(v, str):
        return ast.Literal(v, "str")
    if isinstance(v, datetime.date):
        return ast.DateLiteral((v - datetime.date(1970, 1, 1)).days)
    raise BindError(f"unsupported parameter type {type(v).__name__}")


def _literal_value(v: ast.Node):
    if isinstance(v, ast.Literal):
        if v.kind == "float":
            return float(v.value)
        return v.value
    if isinstance(v, ast.DateLiteral):
        return v.days
    if isinstance(v, ast.UnaryOp) and v.op == "-":
        inner = _literal_value(v.operand)
        return -inner
    if isinstance(v, ast.Cast):
        return _literal_value(v.expr)
    raise BindError("INSERT VALUES must be literals")
