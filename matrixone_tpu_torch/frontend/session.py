"""Session: SQL text in, result batches out — the SELECT subset.

The port of the SELECT pipeline of `matrixone_tpu/frontend/session.py`
(reference analogue: the frontend's doComQuery -> buildPlan -> Compile
-> Run chain):

    parse -> _prepare_select (decorrelate, inline uncorrelated
    subqueries) -> Binder.bind_statement -> cost-based join reordering
    -> index rewrites -> compile_plan -> pull loop on the device ->
    host Batch

without the result and plan caches, transactions, admission control,
tracing or `mo_ctl`.  Any statement other than SELECT (and UNION, which
the executor does not run yet) raises NotImplementedError: tables are
created and loaded through the engine (`create_table` + `insert_numpy`,
as `utils/tpch.py` does).  The session runs on `device` (CUDA unless the
caller names the CPU); every scan uploads its chunks there.
"""

from __future__ import annotations

import contextvars
import dataclasses
import datetime
from typing import List, Optional

from matrixone_tpu_torch import resolve_device
from matrixone_tpu_torch.container import Batch, Vector, from_device
from matrixone_tpu_torch.ops import filter as F
from matrixone_tpu_torch.sql import ast
from matrixone_tpu_torch.sql.binder import Binder, BindError
from matrixone_tpu_torch.sql.parser import parse, parse_one
from matrixone_tpu_torch.storage.engine import Engine
from matrixone_tpu_torch.vm.compile import compile_plan
from matrixone_tpu_torch.vm.process import ExecContext

#: the session currently executing a statement on this thread — info
#: functions (connection_id()/user()/...) resolve against it at bind time
_CURRENT_SESSION: contextvars.ContextVar = contextvars.ContextVar(
    "mo_torch_current_session", default=None)


def current_session():
    return _CURRENT_SESSION.get()


@dataclasses.dataclass
class Result:
    batch: Optional[Batch] = None        # SELECT results

    def rows(self) -> List[tuple]:
        if self.batch is None:
            return []
        names = list(self.batch.columns)
        cols = [self.batch.columns[n].to_pylist() for n in names]
        return [tuple(vals) for vals in zip(*cols)] if cols else []

    @property
    def column_names(self) -> List[str]:
        return list(self.batch.columns) if self.batch is not None else []


class Session:
    """One client session: a catalog, a device and session variables."""

    def __init__(self, catalog: Optional[Engine] = None, device=None):
        self.catalog = catalog if catalog is not None else Engine()
        self.device = resolve_device(device)
        self.variables = {"batch_rows": 1 << 20}

    def _ctx(self) -> ExecContext:
        return ExecContext(catalog=self.catalog, variables=self.variables,
                           frozen_ts=self.catalog.committed_ts,
                           device=self.device)

    # ------------------------------------------------------------ execute
    def execute(self, sql: str) -> Result:
        stmts = parse(sql)
        tok = _CURRENT_SESSION.set(self)
        try:
            result = Result()
            for st in stmts:
                if not isinstance(st, ast.Select):
                    raise NotImplementedError(
                        f"{type(st).__name__} statements are not ported "
                        f"yet: only SELECT runs (ROADMAP.md, section A)")
                result = self._select(st)
            return result
        finally:
            _CURRENT_SESSION.reset(tok)

    def plan(self, sql: str):
        """The bound, cost-optimized and index-rewritten plan of one
        SELECT: the tree `execute` compiles (EXPLAIN's tree)."""
        return self.plan_select(parse_one(sql))

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
    def _select(self, sel: ast.Select) -> Result:
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

    def plan_select(self, sel: ast.Select):
        from matrixone_tpu_torch.sql.optimize import apply_indices
        self._prepare_select(sel)
        node = Binder(self.catalog).bind_statement(sel)
        node = self._cbo(node)
        return apply_indices(node, self.catalog,
                             nprobe=int(self.variables.get("ivf_nprobe", 8)))

    def _to_host(self, ex, schema) -> Batch:
        # compact masked rows before leaving the device
        db = F.compact(ex.batch, ex.mask, ex.padded_len)
        return from_device(db, ex.dicts, schema=dict(schema))


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
