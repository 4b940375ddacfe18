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

Not ported yet (ROADMAP.md, section A): the result and plan caches,
admission control, tracing, `mo_ctl`, the fault hooks, and every other
statement (LOAD DATA, indexes, materialized views, UDFs, accounts ...),
which raises NotImplementedError.  The session runs
on `device` (CUDA unless the caller names the CPU); every scan uploads
its chunks there.
"""

from __future__ import annotations

import contextvars
import dataclasses
import datetime
import re
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
from matrixone_tpu_torch.storage.engine import ROWID, Engine, TableMeta
from matrixone_tpu_torch.txn.client import TxnClient
from matrixone_tpu_torch.vm.compile import compile_plan
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
        self.variables = {"batch_rows": 1 << 20}

    def close(self) -> None:
        """End the session: roll back its open transaction, if any (the
        engine's count of open transactions defers merges)."""
        if self.txn is not None:
            self.txn.rollback()
            self.txn = None

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
    def execute(self, sql: str) -> Result:
        stmts = parse(sql)
        tok = _CURRENT_SESSION.set(self)
        try:
            results = []
            for st in stmts:
                self._liid_set = False     # last_insert_id(): per statement
                results.append(self._execute_stmt(st))
            return results[-1] if results else Result()
        finally:
            _CURRENT_SESSION.reset(tok)

    def plan(self, sql: str):
        """The bound, cost-optimized and index-rewritten plan of one
        SELECT: the tree `execute` compiles (EXPLAIN's tree)."""
        return self.plan_select(parse_one(sql))

    def _execute_stmt(self, stmt: ast.Node) -> Result:
        if isinstance(stmt, (ast.Select, ast.Union)):
            return self._select(stmt)
        if isinstance(stmt, ast.CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, ast.DropTable):
            self.catalog.drop_table(stmt.name, stmt.if_exists)
            return Result()
        if isinstance(stmt, ast.Insert):
            return self._insert(stmt)
        if isinstance(stmt, ast.Delete):
            return self._delete(stmt)
        if isinstance(stmt, ast.Update):
            return self._update(stmt)
        if isinstance(stmt, ast.Explain):
            if not isinstance(stmt.stmt, (ast.Select, ast.Union)):
                raise BindError("EXPLAIN supports SELECT only for now")
            if stmt.analyze:
                raise _not_ported("EXPLAIN ANALYZE")
            node = self.plan_select(stmt.stmt)
            return Result(text=P.explain(
                node, annotate=self._fragment_annotator(node)))
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
            if stmt.name in ("fault_point", "fault_point_clear"):
                raise _not_ported("fault injection (SET fault_point)")
            if isinstance(stmt.value, ast.Literal):
                self.variables[stmt.name] = stmt.value.value
            return Result()
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

    def _cbo(self, node):
        """Stats-driven join reordering (reference: plan/query_builder.go
        determineJoinOrder). `cbo = 0` in the variables disables it."""
        if str(self.variables.get("cbo", 1)) in ("0", "off", "false"):
            return node
        from matrixone_tpu_torch.sql.cbo import optimize_plan
        return optimize_plan(node, self.catalog)

    # ------------------------------------------------------------- select
    def _select(self, sel) -> Result:
        node = self.plan_select(sel)
        op = compile_plan(node, self._ctx())
        out_batches = [self._to_host(ex, node.schema)
                       for ex in op.execute()]
        if not out_batches:
            empty = {n: Vector.from_values([], d) for n, d in node.schema}
            return Result(batch=Batch(empty))
        if len(out_batches) == 1:
            return Result(batch=out_batches[0])
        # concatenate host batches
        cols = {}
        for n, d in node.schema:
            vals = []
            for b in out_batches:
                vals.extend(b.columns[n].to_pylist())
            cols[n] = Vector.from_values(vals, d)
        return Result(batch=Batch(cols))

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
        txn = self.txn or self.txn_client.begin()
        proj = self._dml_plan(stmt.table, stmt.where)
        gids, _ = self._plan_and_lock_rows(
            txn, stmt.table, lambda ctx: self._run_dml_plan(proj, ctx))
        txn.delete_rows(stmt.table, gids)
        if self.txn is None:
            txn.commit()
        return Result(affected=len(gids))

    def _update(self, stmt: ast.Update) -> Result:
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


def _show(data: dict, dtypes: Optional[dict] = None) -> Result:
    """A SHOW result: columns of Python values, VARCHAR unless named."""
    dtypes = dtypes or {}
    return Result(batch=Batch.from_pydict(
        data, {c: dtypes.get(c, dt.VARCHAR) for c in data}))


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
