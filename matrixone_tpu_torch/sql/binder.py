"""Binder: AST -> typed logical plan.

Reference analogue: `pkg/sql/plan/query_builder.go:3555 bindSelect` +
`build.go:378 BuildPlan`, compressed to the passes that matter for a
vectorized TPU pipeline:

  bind FROM/joins -> WHERE -> two-phase aggregate binding -> HAVING ->
  projection -> DISTINCT -> ORDER BY (alias/ordinal/hidden-column) ->
  LIMIT; then: filter pushdown into Scan, ORDER BY+LIMIT -> TopK fusion,
  vector-index rewrite (apply_indices_ivfflat.go analogue, done in
  compile when an index exists).

Literal typing is MySQL-flavored: `0.05` is DECIMAL(_,2), not float, so
decimal comparisons and arithmetic stay in the exact int64 domain.
"""

from __future__ import annotations

import datetime
import itertools
from typing import Dict, List, Optional, Tuple

from matrixone_tpu_torch.container import dtypes as dt
from matrixone_tpu_torch.container.dtypes import DType, TypeOid
from matrixone_tpu_torch.sql import ast, plan
from matrixone_tpu_torch.sql.expr import (AggCall, BoundCase, BoundCast, BoundCol,
                                    BoundExpr, BoundFunc, BoundInList,
                                    BoundIsNull, BoundLike, BoundLiteral,
                                    and_all)

from matrixone_tpu_torch.sql.parser import (AGG_FUNCS, BASIC_AGGS, BIT_AGGS,
                                      STDDEV_AGGS)

def _udf_lookup(catalog, name: str):
    """The user-defined function named `name` in the catalog's
    system_udf table, or None (a builtin name always binds as the
    builtin)."""
    from matrixone_tpu_torch.udf import catalog as ucat
    return ucat.lookup(catalog, name)


# SAMPLE seeds: each bound Sample node (and each re-bind of the same
# query) draws an independent random stream
_sample_seed = itertools.count(1)
WINDOW_ONLY_FUNCS = {"row_number", "rank", "dense_rank", "ntile",
                     "lag", "lead", "first_value", "last_value",
                     "nth_value"}
#: rank family: no arguments, ignores frames
_RANK_FUNCS = {"row_number", "rank", "dense_rank"}
#: value functions: first arg is the value expression
_VALUE_FUNCS = {"lag", "lead", "first_value", "last_value", "nth_value"}

_TYPE_NAMES = {
    "bool": lambda a: dt.BOOL, "boolean": lambda a: dt.BOOL,
    "tinyint": lambda a: dt.INT8, "smallint": lambda a: dt.INT16,
    "int": lambda a: dt.INT32, "integer": lambda a: dt.INT32,
    "bigint": lambda a: dt.INT64,
    "float": lambda a: dt.FLOAT32, "double": lambda a: dt.FLOAT64,
    "real": lambda a: dt.FLOAT64,
    "decimal": lambda a: dt.decimal64(*(a or (18, 2))),
    "numeric": lambda a: dt.decimal64(*(a or (18, 2))),
    "date": lambda a: dt.DATE, "datetime": lambda a: dt.DATETIME,
    "timestamp": lambda a: dt.TIMESTAMP,
    "char": lambda a: dt.DType(dt.TypeOid.CHAR, width=(a[0] if a else 1)),
    "varchar": lambda a: dt.varchar(a[0] if a else 65535),
    "text": lambda a: dt.TEXT,
    "vecf32": lambda a: dt.vecf32(a[0] if a else 0),
    "vecf64": lambda a: dt.vecf64(a[0] if a else 0),
}


class BindError(ValueError):
    pass


def type_from_name(name: str, args: Tuple[int, ...]) -> DType:
    try:
        return _TYPE_NAMES[name](args)
    except KeyError:
        raise BindError(f"unknown type {name!r}")


class Scope:
    """Name resolution scope: (table_alias, column, dtype) entries."""

    def __init__(self):
        self.entries: List[Tuple[Optional[str], str, DType]] = []

    def add(self, table: Optional[str], col: str, dtype: DType):
        self.entries.append((table, col, dtype))

    def resolve(self, name: str, table: Optional[str]) -> Tuple[str, DType]:
        hits = [(t, c, d) for (t, c, d) in self.entries
                if c == name and (table is None or t == table)]
        if not hits:
            raise BindError(f"unknown column {table + '.' if table else ''}{name}")
        if len(hits) > 1:
            raise BindError(f"ambiguous column {name}")
        t, c, d = hits[0]
        return (f"{t}.{c}" if t else c), d

    def qualified_names(self) -> List[str]:
        # output column key used in DeviceBatch dicts
        return [f"{t}.{c}" if t else c for (t, c, _) in self.entries]


class Binder:
    def __init__(self, catalog):
        self.catalog = catalog
        #: name -> (definition_index, body) — index enforces that a CTE
        #: body only sees EARLIER ctes (no forward refs, standard WITH)
        self._ctes: Dict[str, tuple] = {}

    def bind_statement(self, stmt) -> plan.PlanNode:
        if isinstance(stmt, ast.Union):
            return self.bind_union(stmt)
        return self.bind_select(stmt)

    def bind_union(self, u: ast.Union) -> plan.PlanNode:
        children = [self.bind_select(s) for s in u.selects]
        base = children[0].schema
        for c in children[1:]:
            if len(c.schema) != len(base):
                raise BindError("UNION arms have different column counts")
        # output types: promote numerics column-wise
        out_schema = []
        for i, (name, d0) in enumerate(base):
            out_t = d0
            for c in children[1:]:
                d1 = c.schema[i][1]
                if d1.oid != out_t.oid:
                    if d1.is_numeric and out_t.is_numeric:
                        out_t = dt.promote(out_t, d1)
                    elif d1.is_varlen and out_t.is_varlen:
                        pass
                    else:
                        raise BindError(
                            f"UNION column {name}: incompatible types "
                            f"{out_t} vs {d1}")
            out_schema.append((name, out_t))
        # MySQL semantics: a plain UNION dedups everything up to and
        # including its position; UNION ALL arms AFTER the last plain
        # UNION append duplicates
        last_distinct = -1
        for i, is_all in enumerate(u.alls):
            if not is_all:
                last_distinct = i
        if last_distinct >= 0:
            head = children[:last_distinct + 2]
            node = plan.Distinct(plan.Union(head, out_schema), out_schema)
            tail = children[last_distinct + 2:]
            if tail:
                node = plan.Union([node] + tail, out_schema)
        else:
            node = plan.Union(children, out_schema)
        if u.order_by:
            keys, descs = [], []
            names = [n for n, _ in out_schema]
            for o in u.order_by:
                descs.append(o.descending)
                if isinstance(o.expr, ast.Literal) and o.expr.kind == "int":
                    idx = int(o.expr.value) - 1
                    if not 0 <= idx < len(names):
                        raise BindError("ORDER BY ordinal out of range")
                elif isinstance(o.expr, ast.ColumnRef) and \
                        o.expr.name in names:
                    idx = names.index(o.expr.name)
                else:
                    raise BindError(
                        "UNION ORDER BY supports output names/ordinals")
                keys.append(BoundCol(names[idx], out_schema[idx][1]))
            if u.limit is not None:
                node = plan.TopK(node, keys, descs, u.limit, u.offset or 0,
                                 out_schema)
            else:
                node = plan.Sort(node, keys, descs, out_schema)
        elif u.limit is not None or u.offset:
            node = plan.Limit(node, u.limit, u.offset or 0, out_schema)
        return node

    # ------------------------------------------------------------- select
    def bind_select(self, sel: ast.Select) -> plan.PlanNode:
        outer_ctes = dict(self._ctes)
        base = len(outer_ctes)
        for i, (name, sub) in enumerate(sel.ctes):
            if name in self._ctes and self._ctes[name][0] >= base:
                raise BindError(f"duplicate CTE name {name!r}")
            self._ctes[name] = (base + i, sub)
        try:
            return self._bind_select_inner(sel)
        finally:
            self._ctes = outer_ctes

    def _bind_select_inner(self, sel: ast.Select) -> plan.PlanNode:
        node, scope = self._bind_from(sel.from_)

        if sel.where is not None:
            pred = _coerce_bool(self.bind_expr(sel.where, scope))
            _require_bool(pred, "WHERE")
            node = plan.Filter(node, pred, node.schema)

        for sj in getattr(sel, "semijoins", ()):
            node = self._bind_semijoin(node, scope, sj)

        # expand stars early
        items: List[ast.SelectItem] = []
        for it in sel.items:
            if isinstance(it.expr, ast.Star):
                for (t, c, d) in scope.entries:
                    if it.expr.table is None or t == it.expr.table:
                        items.append(ast.SelectItem(
                            ast.ColumnRef(c, t), alias=c))
            else:
                items.append(it)

        if self._has_udf_agg(items):
            return self._bind_udf_aggregate(node, scope, sel, items)

        has_aggs = any(self._contains_agg(it.expr) for it in items) \
            or (sel.having is not None and self._contains_agg(sel.having)) \
            or any(self._contains_agg(o.expr) for o in sel.order_by) \
            or bool(sel.group_by)

        alias_map = {it.alias: it.expr for it in items if it.alias}

        if has_aggs:
            node, scope, agg_sub = self._bind_aggregate(
                node, scope, sel, items, alias_map)
        else:
            agg_sub = None
            if sel.having is not None:
                raise BindError("HAVING without aggregation")

        # GROUP BY ... FILL(mode): null-fill over the grouped output,
        # ordered by the first group key (reference: colexec/fill)
        if sel.fill is not None:
            agg_node = node
            while isinstance(agg_node, plan.Filter):
                agg_node = agg_node.child
            if not isinstance(agg_node, plan.Aggregate) \
                    or not agg_node.group_keys:
                raise BindError("FILL requires GROUP BY")
            nk = len(agg_node.group_keys)
            key_names = [n for n, _ in agg_node.schema[:nk]]
            mode, const = sel.fill
            node = plan.Fill(node, mode, const, key_names[0], key_names,
                             node.schema)

        # window functions: compute as hidden columns below the projection
        node, scope, win_map = self._bind_windows(node, scope, items,
                                                  agg_sub)

        # projection
        exprs, names = [], []
        for idx, it in enumerate(items):
            e = self._bind_item(it.expr, scope, agg_sub, win_map)
            exprs.append(e)
            names.append(it.alias or _expr_name(it.expr, idx))
        # batches are dict-keyed: disambiguate duplicate output labels
        seen: Dict[str, int] = {}
        taken = set(names)
        for i, n in enumerate(names):
            if n in seen:
                k = seen[n] + 1
                while f"{n}_{k}" in taken:
                    k += 1
                seen[n] = k
                names[i] = f"{n}_{k}"
                taken.add(names[i])
            else:
                seen[n] = 0
        out_schema = list(zip(names, [e.dtype for e in exprs]))
        node = plan.Project(node, exprs, out_schema)

        if sel.distinct:
            node = plan.Distinct(node, node.schema)

        # ORDER BY: resolve by ordinal, output alias, or expression
        n_visible = len(names)
        if sel.order_by:
            keys, descs = [], []
            for o in sel.order_by:
                descs.append(o.descending)
                k = self._bind_order_key(o.expr, node, names, exprs, scope,
                                         agg_sub, alias_map)
                keys.append(k)
            if sel.limit is not None:
                node = plan.TopK(node, keys, descs, sel.limit,
                                 sel.offset or 0, node.schema)
            else:
                node = plan.Sort(node, keys, descs, node.schema)
            if len(names) > n_visible:   # drop hidden sort columns
                vis = node.schema[:n_visible]
                node = plan.Project(
                    node, [BoundCol(n, d) for n, d in vis], list(vis))
        elif sel.limit is not None or sel.offset:
            node = plan.Limit(node, sel.limit, sel.offset or 0, node.schema)

        return self._pushdown_filters(node)

    # -------------------------------------------------------------- from
    def _bind_from(self, from_) -> Tuple[plan.PlanNode, Scope]:
        if from_ is None:
            # SELECT without FROM: single-row dual table
            sc = Scope()
            return plan.Values([[1]], [("__dual", dt.INT64)]), sc
        if isinstance(from_, ast.TableRef) and from_.name in self._ctes:
            if from_.snapshot is not None or from_.as_of_ts is not None:
                raise BindError(
                    f"cannot time-travel a CTE ({from_.name!r}); AS OF "
                    f"applies to stored tables")
            # CTE reference: bind the body as a derived table, visible
            # scope = strictly earlier CTEs (non-recursive, no forward refs)
            my_idx, sub = self._ctes[from_.name]
            alias = from_.alias or from_.name
            saved = self._ctes
            self._ctes = {k: v for k, v in saved.items() if v[0] < my_idx}
            try:
                return self._bind_from(ast.SubqueryRef(sub, alias))
            finally:
                self._ctes = saved
        if isinstance(from_, ast.TableRef):
            meta = self.catalog.get_table(from_.name)
            alias = from_.alias or from_.name
            sc = Scope()
            for col, dtype in meta.schema:
                sc.add(alias, col, dtype)
            as_of = from_.as_of_ts
            if from_.snapshot is not None:
                snaps = getattr(self.catalog, "snapshots", {})
                if from_.snapshot not in snaps:
                    raise BindError(f"no such snapshot {from_.snapshot!r}")
                as_of = snaps[from_.snapshot]
            scan = plan.Scan(from_.name,
                             [c for c, _ in meta.schema],
                             [(f"{alias}.{c}", d) for c, d in meta.schema],
                             as_of_ts=as_of)
            return scan, sc
        if isinstance(from_, ast.SubqueryRef):
            child = self.bind_statement(from_.select)
            sc = Scope()
            for col, dtype in child.schema:
                sc.add(from_.alias, col, dtype)
            # rename child outputs into alias namespace
            exprs = [BoundCol(c, d) for c, d in child.schema]
            schema = [(f"{from_.alias}.{c}", d) for c, d in child.schema]
            return plan.Project(child, exprs, schema), sc
        if isinstance(from_, ast.Join):
            lnode, lscope = self._bind_from(from_.left)
            rnode, rscope = self._bind_from(from_.right)
            sc = Scope()
            sc.entries = lscope.entries + rscope.entries
            schema = lnode.schema + rnode.schema
            kind = from_.kind
            if kind == "right":
                lnode, rnode = rnode, lnode
                lscope, rscope = rscope, lscope
                schema = lnode.schema + rnode.schema
                sc.entries = lscope.entries + rscope.entries
                kind = "left"
            lkeys, rkeys, residual = [], [], None
            if from_.on is not None:
                lkeys, rkeys, residual = self._split_join_on(
                    from_.on, lscope, rscope, sc)
            elif kind == "full":
                raise BindError("FULL OUTER JOIN requires an ON clause")
            elif kind != "cross":
                kind = "cross"
            if kind == "full" and not lkeys:
                raise BindError(
                    "FULL OUTER JOIN requires at least one equi-key")
            return plan.Join(kind, lnode, rnode, lkeys, rkeys, residual,
                             schema), sc
        if isinstance(from_, ast.SampleRef):
            child, sc = self._bind_from(from_.child)
            seed = next(_sample_seed)   # distinct stream per Sample node
            if from_.unit == "rows":
                node = plan.Sample(child, int(from_.value), None,
                                   child.schema, seed=seed)
            else:
                if not (0 < from_.value <= 100):
                    raise BindError("SAMPLE percent must be in (0, 100]")
                node = plan.Sample(child, None, float(from_.value),
                                   child.schema, seed=seed)
            return node, sc
        raise BindError(f"unsupported FROM clause {type(from_).__name__}")

    def _bind_semijoin(self, node, scope, sj: "ast.SemiJoinSpec"):
        """Bind a decorrelated [NOT] EXISTS as a semi/anti join: build side
        = the rewritten subquery plan (projects {alias}_k* key columns and
        {alias}_r* residual columns); probe side = the current plan."""
        subplan = self.bind_select(sj.select) if isinstance(
            sj.select, ast.Select) else self.bind_statement(sj.select)
        left_keys = [self.bind_expr(oe, scope) for oe in sj.outer_keys]
        right_keys = [BoundCol(n, d)
                      for n, d in subplan.schema[:sj.n_keys]]
        residual = None
        if sj.residual is not None:
            combined = Scope()
            combined.entries = list(scope.entries) + [
                (None, n, d) for n, d in subplan.schema]
            residual = self.bind_expr(sj.residual, combined)
            _require_bool(residual, "EXISTS residual")
        kind = "anti" if sj.negated else "semi"
        return plan.Join(kind, node, subplan, left_keys, right_keys,
                         residual, list(node.schema))

    def _split_join_on(self, on, lscope, rscope, full_scope):
        """Split ON into equi-key pairs + residual predicate."""
        conjuncts = _split_and(on)
        lkeys, rkeys, residual = [], [], []
        for c in conjuncts:
            if isinstance(c, ast.BinaryOp) and c.op == "=":
                try:
                    le = self.bind_expr(c.left, lscope)
                    re_ = self.bind_expr(c.right, rscope)
                    lkeys.append(le)
                    rkeys.append(re_)
                    continue
                except BindError:
                    pass
                try:
                    le = self.bind_expr(c.right, lscope)
                    re_ = self.bind_expr(c.left, rscope)
                    lkeys.append(le)
                    rkeys.append(re_)
                    continue
                except BindError:
                    pass
            residual.append(c)
        res = None
        if residual:
            e = residual[0]
            for r in residual[1:]:
                e = ast.BinaryOp("and", e, r)
            res = self.bind_expr(e, full_scope)
        return lkeys, rkeys, res

    # ----------------------------------------------------- aggregate UDFs
    def _udf_agg_of(self, e: ast.Node):
        if not (isinstance(e, ast.FuncCall) and e.window is None):
            return None
        u = _udf_lookup(self.catalog, e.name)
        return u if u is not None and u.kind == "aggregate" else None

    def _has_udf_agg(self, items) -> bool:
        return any(self._udf_agg_of(it.expr) is not None for it in items)

    def _bind_udf_aggregate(self, node, scope, sel, items):
        """SELECT agg_udf(expr), ... FROM t [WHERE ...] — every item must
        be an aggregate-UDF call; the whole (filtered) input reduces to
        one row.  GROUP BY with aggregate UDFs is not supported yet (the
        grouped kernels are built for the fixed aggregate algebra)."""
        if sel.group_by:
            raise BindError(
                "aggregate UDFs with GROUP BY are not supported yet")
        if sel.having is not None:
            raise BindError(
                "HAVING with aggregate UDFs is not supported yet")
        if sel.distinct:
            raise BindError(
                "DISTINCT with aggregate UDFs is not supported")
        calls, schema = [], []
        for idx, it in enumerate(items):
            u = self._udf_agg_of(it.expr)
            if u is None:
                raise BindError(
                    "a query using an aggregate UDF must select only "
                    "aggregate UDF calls")
            args = [self.bind_expr(a, scope) for a in it.expr.args]
            b = _bind_udf_call(u, args)
            calls.append(b)
            schema.append((it.alias or _expr_name(it.expr, idx),
                           b.dtype))
        out = plan.UdfAggregate(node, calls, schema)
        # the result is ONE row: LIMIT/OFFSET still apply (LIMIT 0 /
        # OFFSET 1 must yield zero rows); ORDER BY would need key
        # resolution against the reduced row — reject it rather than
        # silently ignoring the clause
        if sel.order_by:
            raise BindError(
                "ORDER BY with aggregate UDFs is not supported yet")
        if sel.limit is not None or sel.offset:
            out = plan.Limit(out, sel.limit, sel.offset or 0, out.schema)
        return self._pushdown_filters(out)

    # --------------------------------------------------------- aggregates
    def _contains_agg(self, e: ast.Node) -> bool:
        if isinstance(e, ast.FuncCall) and e.name in AGG_FUNCS \
                and e.window is None:
            return True
        for f in dataclasses_fields_values(e):
            if isinstance(f, ast.Node) and self._contains_agg(f):
                return True
            if isinstance(f, list):
                for x in f:
                    if isinstance(x, ast.Node) and self._contains_agg(x):
                        return True
                    if isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, ast.Node) and self._contains_agg(y):
                                return True
        return False

    def _bind_aggregate(self, node, scope, sel, items, alias_map):
        # group keys (support alias + ordinal)
        group_asts: List[ast.Node] = []
        for g in sel.group_by:
            if isinstance(g, ast.Literal) and g.kind == "int":
                idx = int(g.value) - 1
                if not 0 <= idx < len(items):
                    raise BindError(
                        f"GROUP BY ordinal {int(g.value)} out of range")
                group_asts.append(items[idx].expr)
            elif isinstance(g, ast.ColumnRef) and g.table is None \
                    and g.name in alias_map:
                group_asts.append(alias_map[g.name])
            else:
                group_asts.append(g)
        group_keys = [self.bind_expr(g, scope) for g in group_asts]

        # collect agg calls from items + having + order by
        agg_calls: List[ast.FuncCall] = []

        def collect(e):
            if isinstance(e, ast.FuncCall) and e.name in AGG_FUNCS \
                    and e.window is None:
                agg_calls.append(e)
                return
            if isinstance(e, ast.FuncCall) and e.window is not None:
                # a windowed call is NOT a regular aggregate, but its args
                # and OVER clause may contain ones (share-of-total queries)
                for a in e.args:
                    collect(a)
                for p in e.window.partition_by:
                    collect(p)
                for o in e.window.order_by:
                    collect(o.expr)
                return
            for f in dataclasses_fields_values(e):
                if isinstance(f, ast.Node):
                    collect(f)
                elif isinstance(f, list):
                    for x in f:
                        if isinstance(x, ast.Node):
                            collect(x)
                        elif isinstance(x, tuple):
                            for y in x:
                                if isinstance(y, ast.Node):
                                    collect(y)

        for it in items:
            collect(it.expr)
        if sel.having is not None:
            collect(sel.having)
        for o in sel.order_by:
            collect(o.expr)

        # dedupe by AST equality
        uniq: List[ast.FuncCall] = []
        for a in agg_calls:
            if not any(a == u for u in uniq):
                uniq.append(a)

        # COUNT(DISTINCT x) as the only aggregate: rewrite to
        # Distinct(keys + x) -> count(x) (colexec would use a dedup hash
        # table; Distinct is our sort-based dedup)
        if (len(uniq) == 1 and uniq[0].distinct
                and uniq[0].name == "count"
                and len(uniq[0].args) == 1 and not uniq[0].star):
            a = uniq[0]
            arg = self.bind_expr(a.args[0], scope)
            dedup_exprs = group_keys + [arg]
            dedup_schema = [(f"_g{i}", k.dtype)
                            for i, k in enumerate(group_keys)] + \
                [("_dv", arg.dtype)]
            proj = plan.Project(node, dedup_exprs, dedup_schema)
            node = plan.Distinct(proj, dedup_schema)
            group_keys = [BoundCol(f"_g{i}", k.dtype)
                          for i, k in enumerate(group_keys)]
            bound_aggs = [AggCall("count", BoundCol("_dv", arg.dtype),
                                  False, dt.INT64, out_name="_agg0")]
        else:
            bound_aggs = []
            for i, a in enumerate(uniq):
                if a.distinct:
                    if a.name == "count" and len(uniq) == 1:
                        raise BindError(
                            "count(DISTINCT ...) takes exactly one "
                            "argument")
                    if len(uniq) == 1:
                        raise BindError(
                            f"{a.name}(DISTINCT ...) is not supported yet")
                    raise BindError(
                        f"{a.name}(DISTINCT ...) is not supported yet when "
                        f"mixed with other aggregates")
                if a.star or (not a.args):
                    if a.name != "count":
                        raise BindError(f"{a.name}(*) is not valid")
                    bound_aggs.append(AggCall("count", None, False, dt.INT64,
                                              out_name=f"_agg{i}"))
                    continue
                arg = self.bind_expr(a.args[0], scope)
                fname = "min" if a.name == "any_value" else a.name
                if fname in STDDEV_AGGS | BIT_AGGS and \
                        not arg.dtype.is_numeric:
                    raise BindError(
                        f"{a.name}() requires a numeric argument")
                if fname in BIT_AGGS and not arg.dtype.is_integer:
                    raise BindError(
                        f"{a.name}() requires an integer argument")
                out_t = _agg_result_type(fname, arg.dtype)
                bound_aggs.append(AggCall(fname, arg, a.distinct, out_t,
                                          out_name=f"_agg{i}"))

        key_names = [f"_g{i}" for i in range(len(group_keys))]
        schema = list(zip(key_names, [k.dtype for k in group_keys])) + \
            [(a.out_name, a.dtype) for a in bound_aggs]
        agg_node = plan.Aggregate(node, group_keys, bound_aggs, schema)

        # post-agg scope: group keys by their source AST, aggs by AST
        new_scope = Scope()
        for name, dtype in schema:
            new_scope.add(None, name, dtype)
        agg_sub = {"group_asts": group_asts, "key_names": key_names,
                   "agg_asts": uniq, "aggs": bound_aggs,
                   "scope": new_scope}

        out = agg_node
        if sel.having is not None:
            pred = _coerce_bool(
                self._bind_post_agg(sel.having, new_scope, agg_sub))
            _require_bool(pred, "HAVING")
            out = plan.Filter(out, pred, out.schema)
        return out, new_scope, agg_sub

    def _bind_post_agg(self, e: ast.Node, scope: Scope, agg_sub) -> BoundExpr:
        """Bind an expression above an Aggregate: column refs must match a
        group key AST; agg calls become refs to agg outputs."""
        for g_ast, name in zip(agg_sub["group_asts"], agg_sub["key_names"]):
            if e == g_ast:
                dtype = {c: d for (_, c, d) in agg_sub["scope"].entries}[name]
                return BoundCol(name, dtype)
        if isinstance(e, ast.FuncCall) and e.name in AGG_FUNCS:
            for a_ast, bound in zip(agg_sub["agg_asts"], agg_sub["aggs"]):
                if e == a_ast:
                    return BoundCol(bound.out_name, bound.dtype)
            raise BindError("aggregate not collected (internal)")
        if isinstance(e, ast.ColumnRef):
            raise BindError(
                f"column {e.name} must appear in GROUP BY or an aggregate")
        return self._bind_generic(e, scope,
                                  lambda x: self._bind_post_agg(x, scope, agg_sub))

    # ------------------------------------------------------------ order by
    def _bind_item(self, e, scope, agg_sub, win_map):
        """Bind a select item, substituting window calls with their hidden
        columns (win_map: id(ast node) -> BoundCol)."""
        if isinstance(e, ast.FuncCall) and e.window is not None:
            if win_map:
                return win_map[id(e)]
        import dataclasses as dc

        def has_window(x):
            if isinstance(x, ast.FuncCall) and x.window is not None:
                return True
            if dc.is_dataclass(x) and isinstance(x, ast.Node):
                for f in dc.fields(x):
                    v = getattr(x, f.name)
                    vs = v if isinstance(v, list) else [v]
                    for y in vs:
                        if isinstance(y, ast.Node) and has_window(y):
                            return True
            return False
        if has_window(e):
            raise BindError(
                "window functions may only appear as top-level select "
                "items for now")
        if agg_sub:
            return self._bind_post_agg(e, scope, agg_sub)
        return self.bind_expr(e, scope)

    def _bind_windows(self, node, scope, items, agg_sub):
        """Collect fn(...) OVER (...) calls from select items into a
        plan.Window node; returns (node, scope, {id(ast): BoundCol})."""
        calls = [it.expr for it in items
                 if isinstance(it.expr, ast.FuncCall)
                 and it.expr.window is not None]
        if not calls:
            return node, scope, {}
        entries = []
        win_map = {}
        bind = (lambda x: self._bind_post_agg(x, scope, agg_sub)) \
            if agg_sub else (lambda x: self.bind_expr(x, scope))
        schema = list(node.schema)
        for i, fc in enumerate(calls):
            fn = fc.name
            if fn not in BASIC_AGGS and fn not in WINDOW_ONLY_FUNCS:
                raise BindError(f"{fn}() is not a window function")
            if fc.distinct:
                raise BindError(
                    f"{fn}(DISTINCT ...) OVER (...) is not supported yet")
            if fc.star and fn != "count":
                raise BindError(f"{fn}(*) is not valid")
            if fn in _RANK_FUNCS and (fc.args or fc.star):
                raise BindError(f"{fn}() takes no arguments")
            arg = None
            extra = {"frame": fc.window.frame}
            if fn in BASIC_AGGS and not fc.star:
                if not fc.args:
                    raise BindError(f"{fn}() needs an argument")
                arg = bind(fc.args[0])
                if arg.dtype.is_varlen and fn != "count":
                    raise BindError(
                        f"{fn}() over strings in windows is not "
                        f"supported yet")
            elif fn == "ntile":
                if len(fc.args) != 1 or not isinstance(
                        fc.args[0], ast.Literal):
                    raise BindError("ntile(N) needs one integer literal")
                extra["n"] = int(fc.args[0].value)
                if extra["n"] < 1:
                    raise BindError("ntile(N): N must be >= 1")
            elif fn in ("lag", "lead"):
                if not 1 <= len(fc.args) <= 3:
                    raise BindError(
                        f"{fn}(expr [, offset [, default]]) takes 1-3 "
                        f"arguments")
                arg = bind(fc.args[0])
                extra["offset"] = 1
                if len(fc.args) >= 2:
                    if not isinstance(fc.args[1], ast.Literal):
                        raise BindError(
                            f"{fn}() offset must be an integer literal")
                    extra["offset"] = int(fc.args[1].value)
                    if extra["offset"] < 0:
                        raise BindError(f"{fn}() offset must be >= 0")
                if len(fc.args) == 3:
                    dflt = bind(fc.args[2])
                    if not isinstance(dflt, BoundLiteral):
                        raise BindError(
                            f"{fn}() default must be a literal")
                    if dflt.value is None:
                        pass          # NULL default == no default
                    elif arg.dtype.is_varlen:
                        raise BindError(
                            f"{fn}() over strings supports only NULL "
                            f"default")
                    else:
                        extra["default"] = dflt
            elif fn in ("first_value", "last_value"):
                if len(fc.args) != 1:
                    raise BindError(f"{fn}(expr) takes one argument")
                arg = bind(fc.args[0])
            elif fn == "nth_value":
                if len(fc.args) != 2 or not isinstance(
                        fc.args[1], ast.Literal):
                    raise BindError(
                        "nth_value(expr, N) needs an integer literal N")
                arg = bind(fc.args[0])
                extra["n"] = int(fc.args[1].value)
                if extra["n"] < 1:
                    raise BindError("nth_value(expr, N): N must be >= 1")
            if extra["frame"] is not None and \
                    fn in _RANK_FUNCS | {"ntile", "lag", "lead"}:
                raise BindError(
                    f"{fn}() does not accept a frame clause")
            part = [bind(p) for p in fc.window.partition_by]
            okeys = [bind(o.expr) for o in fc.window.order_by]
            odescs = [o.descending for o in fc.window.order_by]
            if fn in BASIC_AGGS:
                out_t = _agg_result_type(fn, arg.dtype) if arg is not None \
                    else dt.INT64
            elif fn in _VALUE_FUNCS:
                out_t = arg.dtype
            else:
                out_t = dt.INT64
            out_name = f"_w{i}"
            entries.append((fn, arg, part, okeys, odescs, out_name,
                            extra))
            win_map[id(fc)] = BoundCol(out_name, out_t)
            schema.append((out_name, out_t))
        wnode = plan.Window(node, entries, schema)
        new_scope = Scope()
        new_scope.entries = list(scope.entries)
        for name, d in schema[len(node.schema):]:
            new_scope.add(None, name, d)
        return wnode, new_scope, win_map

    def _bind_order_key(self, e, node, names, exprs, scope, agg_sub,
                        alias_map):
        if isinstance(e, ast.Literal) and e.kind == "int":
            idx = int(e.value) - 1
            if not 0 <= idx < len(names):
                raise BindError(f"ORDER BY ordinal {idx + 1} out of range")
            return BoundCol(names[idx], exprs[idx].dtype)
        if isinstance(e, ast.ColumnRef) and e.table is None and e.name in names:
            i = names.index(e.name)
            return BoundCol(names[i], exprs[i].dtype)
        bound = self._bind_post_agg(e, scope, agg_sub) if agg_sub \
            else self.bind_expr(e, scope)
        # match an existing projected expression
        for i, pe in enumerate(exprs):
            if pe == bound:
                return BoundCol(names[i], pe.dtype)
        # hidden sort column: widen the projection
        if not isinstance(node, plan.Project):
            raise BindError(
                "ORDER BY expression must appear in the select list when "
                "using DISTINCT")
        hidden = f"_sort{len(node.exprs)}"
        node.exprs.append(bound)
        node.schema.append((hidden, bound.dtype))
        names.append(hidden)
        exprs.append(bound)
        return BoundCol(hidden, bound.dtype)

    # ------------------------------------------------------------- exprs
    def bind_expr(self, e: ast.Node, scope: Scope) -> BoundExpr:
        return self._bind_generic(e, scope,
                                  lambda x: self.bind_expr(x, scope))

    def _bind_generic(self, e: ast.Node, scope: Scope, rec) -> BoundExpr:
        if isinstance(e, ast.Literal):
            return _bind_literal(e)
        if isinstance(e, ast.DateLiteral):
            return BoundLiteral(e.days, dt.DATE)
        if isinstance(e, ast.ColumnRef):
            qname, dtype = scope.resolve(e.name, e.table)
            return BoundCol(qname, dtype)
        if isinstance(e, ast.BinaryOp):
            return self._bind_binary(e, rec)
        if isinstance(e, ast.UnaryOp):
            a = rec(e.operand)
            if e.op == "not":
                a = _coerce_bool(a)
                _require_bool(a, "NOT")
                return BoundFunc("not", [a], dt.BOOL)
            return BoundFunc("neg", [a], a.dtype)
        if isinstance(e, ast.FuncCall):
            return self._bind_func(e, rec)
        if isinstance(e, ast.SysVar):
            # @@name folds to the SESSION's current value at bind time
            # (reference: frontend/variables.go resolution)
            from matrixone_tpu_torch.frontend.session import current_session
            s = current_session()
            val = (s.variables.get(e.name) if s is not None else None)
            if val is None:
                return BoundLiteral(None, dt.INT64)
            if isinstance(val, bool):
                return BoundLiteral(int(val), dt.INT64)
            if isinstance(val, int):
                return BoundLiteral(val, dt.INT64)
            if isinstance(val, float):
                return BoundLiteral(val, dt.FLOAT64)
            return BoundLiteral(str(val), dt.VARCHAR)
        if isinstance(e, ast.Cast):
            a = rec(e.expr)
            return BoundCast(a, type_from_name(e.type_name, e.type_args))
        if isinstance(e, ast.Case):
            whens = [(rec(c), rec(v)) for c, v in e.whens]
            else_ = rec(e.else_) if e.else_ is not None else None
            # result type promotes across EVERY branch, ELSE included:
            # `case when p then w else d end` over (int, double) is
            # double — typing it by the first THEN branch alone made
            # downstream arithmetic and derived table schemas truncate
            # the double branch (moqa seed-1 sqlite + mview findings)
            out_t = whens[0][1].dtype
            branches = [v for _, v in whens[1:]]
            if else_ is not None:
                branches.append(else_)
            for v in branches:
                out_t = dt.promote(out_t, v.dtype) if v.dtype.is_numeric \
                    and out_t.is_numeric else out_t
            return BoundCase(whens, else_, out_t)
        if isinstance(e, ast.InList):
            arg = rec(e.expr)
            vals = []
            for item in e.items:
                b = self._bind_generic(item, scope, rec)
                if not isinstance(b, BoundLiteral):
                    raise BindError("IN list items must be literals")
                vals.append(_literal_in_arg_domain(b, arg.dtype))
            return BoundInList(arg, vals, e.negated, dt.BOOL)
        if isinstance(e, ast.Between):
            arg = rec(e.expr)
            lo, hi = rec(e.low), rec(e.high)
            ge = BoundFunc("ge", [arg, lo], dt.BOOL)
            le = BoundFunc("le", [arg, hi], dt.BOOL)
            both = BoundFunc("and", [ge, le], dt.BOOL)
            if e.negated:
                return BoundFunc("not", [both], dt.BOOL)
            return both
        if isinstance(e, ast.IsNull):
            return BoundIsNull(rec(e.expr), e.negated, dt.BOOL)
        raise BindError(f"unsupported expression {type(e).__name__}")

    def _bind_binary(self, e: ast.BinaryOp, rec) -> BoundExpr:
        if e.op in ("date+", "date-"):
            left = rec(e.left)
            iv = e.right
            assert isinstance(iv, ast.IntervalLiteral)
            if isinstance(left, BoundLiteral) and left.dtype.oid == TypeOid.DATE:
                base = datetime.date(1970, 1, 1) + datetime.timedelta(days=left.value)
                sign = 1 if e.op == "date+" else -1
                if iv.unit == "day":
                    nd = base + datetime.timedelta(days=sign * iv.value)
                elif iv.unit == "month":
                    m = base.month - 1 + sign * iv.value
                    nd = base.replace(year=base.year + m // 12,
                                      month=m % 12 + 1)
                elif iv.unit == "year":
                    nd = base.replace(year=base.year + sign * iv.value)
                else:
                    raise BindError(f"unsupported interval unit {iv.unit}")
                return BoundLiteral((nd - datetime.date(1970, 1, 1)).days,
                                    dt.DATE)
            if iv.unit != "day":
                raise BindError("non-literal date +/- month/year not supported yet")
            delta = BoundLiteral(iv.value if e.op == "date+" else -iv.value,
                                 dt.INT32)
            return BoundFunc("date_add_days", [left, delta], dt.DATE)

        left, right = rec(e.left), rec(e.right)
        if e.op == "like":
            if not isinstance(right, BoundLiteral):
                raise BindError("LIKE pattern must be a literal")
            return BoundLike(left, str(right.value), False, dt.BOOL)
        if e.op in ("and", "or"):
            # typeless NULL / 0-1 integer literals coerce in logic
            # contexts (MySQL: NULL AND 0 is 0)
            left, right = _coerce_bool(left), _coerce_bool(right)
            _require_bool(left, e.op.upper())
            _require_bool(right, e.op.upper())
            return BoundFunc(e.op, [left, right], dt.BOOL)
        if e.op in ("=", "!=", "<", "<=", ">", ">="):
            op = {"=": "eq", "!=": "ne", "<": "lt", "<=": "le",
                  ">": "gt", ">=": "ge"}[e.op]
            return BoundFunc(op, [left, right], dt.BOOL)
        if e.op in ("+", "-", "*", "/", "%"):
            op = {"+": "add", "-": "sub", "*": "mul", "/": "div",
                  "%": "mod"}[e.op]
            out = _arith_result(op, left.dtype, right.dtype)
            return BoundFunc(op, [left, right], out)
        raise BindError(f"unsupported operator {e.op}")

    def _bind_func(self, e: ast.FuncCall, rec) -> BoundExpr:
        if e.name in AGG_FUNCS:
            raise BindError(f"aggregate {e.name}() not allowed here")
        # date_add/date_sub take an INTERVAL argument that is not an
        # expression (function_id.go DATE_ADD/DATE_SUB family)
        if e.name in ("date_add", "adddate", "date_sub", "subdate") \
                and len(e.args) == 2 \
                and isinstance(e.args[1], ast.IntervalLiteral):
            iv = e.args[1]
            sign = 1 if e.name in ("date_add", "adddate") else -1
            return _bind_date_add_unit(rec(e.args[0]),
                                       sign * iv.value, iv.unit)
        args = [rec(a) for a in e.args]
        u = _udf_lookup(self.catalog, e.name)
        if u is not None:
            if u.kind == "aggregate":
                raise BindError(
                    f"aggregate UDF {e.name}() is only allowed as a "
                    f"top-level select item")
            return _bind_udf_call(u, args)
        if e.name == "mo_ctl":
            # the session answers `select mo_ctl(...)` as the only item
            # of a FROM-less select before binding; anywhere else it is
            # not ported
            raise NotImplementedError(
                "mo_ctl() elsewhere than as the only item of a select "
                "without FROM is not ported yet (ROADMAP.md, section A)")
        if e.name == "load_file":
            # datalink resolution (reference: load_file over the datalink
            # type): a constant URL reads at bind time through the stage
            # registry + fileservice
            if len(args) != 1 or not (isinstance(args[0], BoundLiteral)
                                      and isinstance(args[0].value, str)):
                raise BindError("load_file() requires a literal URL")
            from matrixone_tpu_torch.storage.external import read_datalink
            return BoundLiteral(read_datalink(self.catalog, args[0].value),
                                dt.TEXT)
        return bind_scalar_function(e.name, args)

    # --------------------------------------------------------- pushdown
    def _pushdown_filters(self, node: plan.PlanNode) -> plan.PlanNode:
        """Move Filter conjuncts directly above a Scan into Scan.filters
        (feeds zonemap pruning in the reader — readutil analogue)."""
        node = self._push_join_predicates(node)
        return self._pushdown_scan_filters(node)

    def _pushdown_scan_filters(self, node):
        for attr in ("child", "left", "right"):
            c = getattr(node, attr, None)
            if c is not None:
                setattr(node, attr, self._pushdown_scan_filters(c))
        if isinstance(node, plan.Filter) and isinstance(node.child, plan.Scan):
            scan = node.child
            scan.filters = scan.filters + _split_bound_and(node.pred)
            return scan
        return node

    def _push_join_predicates(self, node) -> plan.PlanNode:
        """Distribute Filter conjuncts over cross/inner joins: side-local
        conjuncts sink to that side, two-sided equalities become join keys
        (cross -> inner). This is what turns `FROM a, b, c WHERE a.k = b.k
        AND ...` comma joins into hash joins instead of cross products
        (reference: plan/query_builder.go filter pushdown + join condition
        extraction)."""
        if isinstance(node, plan.Filter) and \
                isinstance(node.child, plan.Join) and \
                node.child.kind in ("cross", "inner"):
            j = node.child
            lnames = {n for n, _ in j.left.schema}
            rnames = {n for n, _ in j.right.schema}
            lpush, rpush, keep = [], [], []
            conjs = []
            for c0 in _split_bound_and(node.pred):
                conjs.extend(_split_bound_and(_factor_or(c0)))
            for c in conjs:
                refs = _bound_col_names(c)
                if refs <= lnames:
                    lpush.append(c)
                elif refs <= rnames:
                    rpush.append(c)
                else:
                    eq = _as_equi(c, lnames, rnames)
                    if eq is not None:
                        j.left_keys.append(eq[0])
                        j.right_keys.append(eq[1])
                        j.kind = "inner"
                    else:
                        keep.append(c)
            if lpush:
                j.left = plan.Filter(j.left, and_all(lpush),
                                     j.left.schema)
            if rpush:
                j.right = plan.Filter(j.right, and_all(rpush),
                                      j.right.schema)
            if j.kind == "cross" and j.left_keys:
                j.kind = "inner"
            if keep and j.kind == "cross":
                # no equi keys: evaluate the mixed predicate as the cross
                # join's residual (loopjoin analogue) instead of
                # materializing the full product above it
                res = and_all(keep)
                j.residual = res if j.residual is None else \
                    BoundFunc("and", [j.residual, res], dt.BOOL)
                keep = []
            out = j if not keep else plan.Filter(j, and_all(keep),
                                                 j.schema)
            for attr in ("child", "left", "right"):
                c = getattr(out, attr, None)
                if c is not None:
                    setattr(out, attr, self._push_join_predicates(c))
            return out
        for attr in ("child", "left", "right"):
            c = getattr(node, attr, None)
            if c is not None:
                setattr(node, attr, self._push_join_predicates(c))
        return node


# ------------------------------------------------------------------ helpers

def _bind_udf_call(u, args: List[BoundExpr]) -> BoundExpr:
    """Type-check and coerce a resolved UDF call; the definition is
    snapshot into the bound expression (see BoundUdfCall docstring)."""
    from matrixone_tpu_torch.sql.expr import BoundUdfCall
    if len(args) != len(u.arg_types):
        raise BindError(
            f"{u.name}() takes {len(u.arg_types)} argument(s), "
            f"got {len(args)}")
    coerced = []
    for i, (a, want) in enumerate(zip(args, u.arg_types)):
        if a.dtype == want:
            coerced.append(a)
        elif a.dtype.is_numeric and want.is_numeric:
            coerced.append(BoundCast(a, want))
        else:
            raise BindError(
                f"{u.name}() argument {i + 1}: {a.dtype} is not "
                f"compatible with declared type {want}")
    return BoundUdfCall(
        u.name.lower(), coerced, u.ret_type, u.body,
        list(u.arg_names), list(u.arg_types), u.body_hash,
        u.deterministic, u.vectorized, u.kind == "aggregate")


def dataclasses_fields_values(e):
    import dataclasses as dc
    if not dc.is_dataclass(e):
        return []
    return [getattr(e, f.name) for f in dc.fields(e)]


def _expr_name(e: ast.Node, idx: int) -> str:
    if isinstance(e, ast.ColumnRef):
        return e.name
    if isinstance(e, ast.FuncCall):
        return f"{e.name}(*)" if e.star else f"{e.name}(...)"
    return f"_col{idx}"


def _split_and(e: ast.Node) -> List[ast.Node]:
    if isinstance(e, ast.BinaryOp) and e.op == "and":
        return _split_and(e.left) + _split_and(e.right)
    return [e]


def _split_bound_and(e: BoundExpr) -> List[BoundExpr]:
    if isinstance(e, BoundFunc) and e.op == "and":
        return _split_bound_and(e.args[0]) + _split_bound_and(e.args[1])
    return [e]


def _bound_col_names(e: BoundExpr) -> set:
    out = set()

    def walk(x):
        if isinstance(x, BoundCol):
            out.add(x.name)
        for f in dataclasses_fields_values(x):
            if isinstance(f, BoundExpr):
                walk(f)
            elif isinstance(f, list):
                for y in f:
                    if isinstance(y, BoundExpr):
                        walk(y)
                    elif isinstance(y, tuple):
                        for z in y:
                            if isinstance(z, BoundExpr):
                                walk(z)
    walk(e)
    return out


def _as_equi(c: BoundExpr, lnames: set, rnames: set):
    """eq(one-side expr, other-side expr) -> (left_expr, right_expr)."""
    if not (isinstance(c, BoundFunc) and c.op == "eq" and len(c.args) == 2):
        return None
    a, b = c.args
    ra, rb = _bound_col_names(a), _bound_col_names(b)
    if not ra or not rb:
        return None
    if ra <= lnames and rb <= rnames:
        return a, b
    if ra <= rnames and rb <= lnames:
        return b, a
    return None


def _factor_or(e: BoundExpr) -> BoundExpr:
    """(A and X) or (A and Y) -> A and (X or Y): pull conjuncts common to
    every OR arm out, so shared equi-join predicates (TPC-H Q19's
    p_partkey = l_partkey in each arm) become join keys."""
    if not (isinstance(e, BoundFunc) and e.op == "or"):
        return e
    arms = _split_bound_or(e)
    arm_conjs = [_split_bound_and(a) for a in arms]
    common = [c for c in arm_conjs[0]
              if all(any(c == d for d in conj) for conj in arm_conjs[1:])]
    if not common:
        return e
    rest_arms = []
    for conj in arm_conjs:
        rest = [c for c in conj if not any(c == d for d in common)]
        rest_arms.append(and_all(rest) if rest
                         else BoundLiteral(True, dt.BOOL))
    ored = rest_arms[0]
    for r in rest_arms[1:]:
        ored = BoundFunc("or", [ored, r], dt.BOOL)
    return and_all(common + [ored])


def _split_bound_or(e: BoundExpr) -> List[BoundExpr]:
    if isinstance(e, BoundFunc) and e.op == "or":
        return _split_bound_or(e.args[0]) + _split_bound_or(e.args[1])
    return [e]


def _coerce_bool(e: BoundExpr) -> BoundExpr:
    if isinstance(e, BoundLiteral) and e.dtype.oid != TypeOid.BOOL:
        if e.value is None:
            return BoundLiteral(None, dt.BOOL)
        if isinstance(e.value, int):
            return BoundLiteral(bool(e.value), dt.BOOL)
    if isinstance(e, BoundFunc) and e.op == "match_against":
        # MySQL: MATCH ... AGAINST in a boolean context is truthy when
        # the relevance score is positive
        return BoundFunc("gt", [e, BoundLiteral(0.0, dt.FLOAT64)],
                         dt.BOOL)
    return e


def _require_bool(e: BoundExpr, where: str):
    if e.dtype.oid != TypeOid.BOOL:
        raise BindError(f"{where} requires a boolean expression")


def _bind_literal(e: ast.Literal) -> BoundLiteral:
    out = None
    if e.kind == "int":
        out = BoundLiteral(int(e.value), dt.INT64)
    elif e.kind == "float":
        text = str(e.value)
        if "e" not in text.lower() and "." in text:
            frac = text.split(".", 1)[1]
            if len(frac) <= 8:
                scale = len(frac)
                scaled = int(round(float(text) * 10 ** scale))
                out = BoundLiteral(scaled, dt.decimal64(18, scale))
        if out is None:
            out = BoundLiteral(float(text), dt.FLOAT64)
    elif e.kind == "str":
        out = BoundLiteral(str(e.value), dt.VARCHAR)
    elif e.kind == "bool":
        out = BoundLiteral(bool(e.value), dt.BOOL)
    elif e.kind == "null":
        out = BoundLiteral(None, dt.INT64)  # typeless null; cast on use
    else:
        raise BindError(f"unknown literal kind {e.kind}")
    # serving plan cache: parameter-derived literals keep their index so
    # a cached plan can re-derive the value through this SAME transform
    # (serving/plan_cache.py PlanCache._instantiate); transforms that
    # build NEW literals drop the tag, which verifiably marks the plan
    # non-cacheable rather than ever patching a wrong value
    idx = getattr(e, "_param_idx", None)
    if idx is not None:
        out._param_idx = idx
    return out


def _literal_in_arg_domain(lit: BoundLiteral, arg_t: DType):
    if arg_t.oid == TypeOid.DECIMAL64 and lit.dtype.oid == TypeOid.DECIMAL64:
        return lit.value * 10 ** (arg_t.scale - lit.dtype.scale)
    if arg_t.oid == TypeOid.DECIMAL64 and lit.dtype.is_integer:
        return lit.value * 10 ** arg_t.scale
    return lit.value


def _arith_result(op: str, a: DType, b: DType) -> DType:
    if op == "div":
        return dt.FLOAT64
    if op in ("add", "sub"):
        if TypeOid.DECIMAL64 in (a.oid, b.oid) and not (a.is_float or b.is_float):
            sa = a.scale if a.oid == TypeOid.DECIMAL64 else 0
            sb = b.scale if b.oid == TypeOid.DECIMAL64 else 0
            return dt.decimal64(18, max(sa, sb))
        if a.oid == TypeOid.DATE and b.is_integer:
            return dt.DATE
    if op == "mul":
        if TypeOid.DECIMAL64 in (a.oid, b.oid) and not (a.is_float or b.is_float):
            sa = a.scale if a.oid == TypeOid.DECIMAL64 else 0
            sb = b.scale if b.oid == TypeOid.DECIMAL64 else 0
            return dt.decimal64(18, sa + sb)
    if not (a.is_numeric and b.is_numeric):
        if a.oid == b.oid:
            return a
        raise BindError(f"cannot apply {op} to {a} and {b}")
    return dt.promote(a, b)


def _agg_result_type(func: str, arg: DType) -> DType:
    if func == "count":
        return dt.INT64
    if func == "avg":
        return dt.FLOAT64
    if func == "sum":
        if arg.oid == TypeOid.DECIMAL64:
            return arg
        if arg.is_integer:
            return dt.INT64
        return dt.FLOAT64
    if func in STDDEV_AGGS:
        return dt.FLOAT64
    if func in BIT_AGGS:
        return dt.UINT64
    return arg  # min / max


_SCALAR_FUNCS = {
    "mod": ("mod", lambda ts: _arith_result("mod", ts[0], ts[1])),
    "abs": ("abs", lambda ts: ts[0]),
    "floor": ("floor", lambda ts: dt.FLOAT64),
    "ceil": ("ceil", lambda ts: dt.FLOAT64),
    "ceiling": ("ceil", lambda ts: dt.FLOAT64),
    "sqrt": ("sqrt", lambda ts: dt.FLOAT64),
    "exp": ("exp", lambda ts: dt.FLOAT64),
    "ln": ("ln", lambda ts: dt.FLOAT64),
    "log": ("ln", lambda ts: dt.FLOAT64),
    "sin": ("sin", lambda ts: dt.FLOAT64),
    "cos": ("cos", lambda ts: dt.FLOAT64),
    "power": ("power", lambda ts: dt.FLOAT64),
    "pow": ("power", lambda ts: dt.FLOAT64),
    "round": ("round", lambda ts: ts[0]),
    "coalesce": ("coalesce", lambda ts: ts[0]),
    "year": ("year", lambda ts: dt.INT32),
    "month": ("month", lambda ts: dt.INT32),
    "day": ("day", lambda ts: dt.INT32),
    "upper": ("upper", lambda ts: ts[0]),
    "ucase": ("upper", lambda ts: ts[0]),
    "lower": ("lower", lambda ts: ts[0]),
    "lcase": ("lower", lambda ts: ts[0]),
    "length": ("length", lambda ts: dt.INT64),
    "char_length": ("length", lambda ts: dt.INT64),
    "reverse": ("reverse", lambda ts: ts[0]),
    "trim": ("trim", lambda ts: ts[0]),
    "ltrim": ("ltrim", lambda ts: ts[0]),
    "rtrim": ("rtrim", lambda ts: ts[0]),
    "concat": ("concat", lambda ts: dt.VARCHAR),
    "substring": ("substring", lambda ts: dt.VARCHAR),
    "substr": ("substring", lambda ts: dt.VARCHAR),
    "replace": ("replace", lambda ts: dt.VARCHAR),
    "starts_with": ("starts_with", lambda ts: dt.BOOL),
    "ends_with": ("ends_with", lambda ts: dt.BOOL),
    "match_against": ("match_against", lambda ts: dt.FLOAT64),
    # timewin role (colexec/timewin): tumbling time windows via bucketed
    # GROUP BY — time_bucket(ts_col, width) floors to the window start
    "time_bucket": ("time_bucket", lambda ts: ts[0]),
    # ---- math long tail
    "tan": ("tan", lambda ts: dt.FLOAT64),
    "asin": ("asin", lambda ts: dt.FLOAT64),
    "acos": ("acos", lambda ts: dt.FLOAT64),
    "atan": ("atan", lambda ts: dt.FLOAT64),
    "atan2": ("atan2", lambda ts: dt.FLOAT64),
    "cot": ("cot", lambda ts: dt.FLOAT64),
    "degrees": ("degrees", lambda ts: dt.FLOAT64),
    "radians": ("radians", lambda ts: dt.FLOAT64),
    "log2": ("log2", lambda ts: dt.FLOAT64),
    "log10": ("log10", lambda ts: dt.FLOAT64),
    "sign": ("sign", lambda ts: dt.INT64),
    "truncate": ("truncate", lambda ts: ts[0]),
    "greatest": ("greatest", lambda ts: _common_numeric(ts)),
    "least": ("least", lambda ts: _common_numeric(ts)),
    # ---- string long tail (dictionary-level evaluation, vm/exprs.py)
    "lpad": ("lpad", lambda ts: dt.VARCHAR),
    "rpad": ("rpad", lambda ts: dt.VARCHAR),
    "repeat": ("repeat", lambda ts: dt.VARCHAR),
    "space": ("space", lambda ts: dt.VARCHAR),
    "instr": ("instr", lambda ts: dt.INT64),
    "locate": ("locate", lambda ts: dt.INT64),
    "position": ("locate", lambda ts: dt.INT64),
    "ascii": ("ascii", lambda ts: dt.INT64),
    "bit_length": ("bit_length", lambda ts: dt.INT64),
    "hex": ("hex", lambda ts: dt.VARCHAR),
    "unhex": ("unhex", lambda ts: dt.VARCHAR),
    "md5": ("md5", lambda ts: dt.VARCHAR),
    "sha1": ("sha1", lambda ts: dt.VARCHAR),
    "sha": ("sha1", lambda ts: dt.VARCHAR),
    "sha2": ("sha2", lambda ts: dt.VARCHAR),
    "crc32": ("crc32", lambda ts: dt.INT64),
    "to_base64": ("to_base64", lambda ts: dt.VARCHAR),
    "from_base64": ("from_base64", lambda ts: dt.VARCHAR),
    "substring_index": ("substring_index", lambda ts: dt.VARCHAR),
    "field": ("field", lambda ts: dt.INT64),
    "find_in_set": ("find_in_set", lambda ts: dt.INT64),
    "strcmp": ("strcmp", lambda ts: dt.INT64),
    "soundex": ("soundex", lambda ts: dt.VARCHAR),
    "quote": ("quote", lambda ts: dt.VARCHAR),
    "bin": ("bin", lambda ts: dt.VARCHAR),
    "oct": ("oct", lambda ts: dt.VARCHAR),
    "conv": ("conv", lambda ts: dt.VARCHAR),
    # ---- regexp family (Python re semantics on dictionary entries)
    "regexp_like": ("regexp_like", lambda ts: dt.BOOL),
    "regexp_instr": ("regexp_instr", lambda ts: dt.INT64),
    "regexp_substr": ("regexp_substr", lambda ts: dt.VARCHAR),
    "regexp_replace": ("regexp_replace", lambda ts: dt.VARCHAR),
    # ---- geo family (WKT, planar — pkg/geo role)
    "st_geomfromtext": ("st_geomfromtext", lambda ts: dt.VARCHAR),
    "st_astext": ("st_astext", lambda ts: dt.VARCHAR),
    "st_x": ("st_x", lambda ts: dt.FLOAT64),
    "st_y": ("st_y", lambda ts: dt.FLOAT64),
    "st_distance": ("st_distance", lambda ts: dt.FLOAT64),
    "st_within": ("st_within", lambda ts: dt.BOOL),
    "st_contains": ("st_contains", lambda ts: dt.BOOL),
    "st_area": ("st_area", lambda ts: dt.FLOAT64),
    "st_geohash": ("st_geohash", lambda ts: dt.VARCHAR),
    # ---- JSON family
    "json_extract": ("json_extract", lambda ts: dt.VARCHAR),
    "json_unquote": ("json_unquote", lambda ts: dt.VARCHAR),
    "json_valid": ("json_valid", lambda ts: dt.BOOL),
    "json_length": ("json_length", lambda ts: dt.INT64),
    "json_type": ("json_type", lambda ts: dt.VARCHAR),
    "json_keys": ("json_keys", lambda ts: dt.VARCHAR),
    # ---- date/time long tail
    "weekday": ("weekday", lambda ts: dt.INT32),
    "dayofweek": ("dayofweek", lambda ts: dt.INT32),
    "dayofmonth": ("day", lambda ts: dt.INT32),
    "dayofyear": ("dayofyear", lambda ts: dt.INT32),
    "quarter": ("quarter", lambda ts: dt.INT32),
    "week": ("week", lambda ts: dt.INT32),
    "last_day": ("last_day", lambda ts: dt.DATE),
    "to_days": ("to_days", lambda ts: dt.INT64),
    "from_days": ("from_days", lambda ts: dt.DATE),
    "datediff": ("datediff", lambda ts: dt.INT64),
    "hour": ("hour", lambda ts: dt.INT32),
    "minute": ("minute", lambda ts: dt.INT32),
    "second": ("second", lambda ts: dt.INT32),
    "date": ("date", lambda ts: dt.DATE),
    "unix_timestamp": ("unix_timestamp", lambda ts: dt.INT64),
    "from_unixtime": ("from_unixtime", lambda ts: dt.DATETIME),
    "monthname": ("monthname", lambda ts: dt.VARCHAR),
    "dayname": ("dayname", lambda ts: dt.VARCHAR),
    "l2_distance": ("l2_distance", lambda ts: dt.FLOAT64),
    "l2_distance_sq": ("l2_distance_sq", lambda ts: dt.FLOAT64),
    "cosine_distance": ("cosine_distance", lambda ts: dt.FLOAT64),
    "inner_product": ("inner_product", lambda ts: dt.FLOAT64),
    "cosine_similarity": ("cosine_similarity", lambda ts: dt.FLOAT64),
    # ---- r5 long tail: string family (dictionary-level eval)
    "left": ("left", lambda ts: dt.VARCHAR),
    "right": ("right", lambda ts: dt.VARCHAR),
    "mid": ("substring", lambda ts: dt.VARCHAR),
    "ord": ("ord", lambda ts: dt.INT64),
    "insert": ("insert_str", lambda ts: dt.VARCHAR),
    "elt": ("elt", lambda ts: dt.VARCHAR),
    "concat_ws": ("concat_ws", lambda ts: dt.VARCHAR),
    "split_part": ("split_part", lambda ts: dt.VARCHAR),
    "octet_length": ("octet_length", lambda ts: dt.INT64),
    "inet_aton": ("inet_aton", lambda ts: dt.INT64),
    # ---- r5: numeric -> string presentation (unique-value LUT)
    "inet_ntoa": ("inet_ntoa", lambda ts: dt.VARCHAR),
    "format": ("format_num", lambda ts: dt.VARCHAR),
    "sec_to_time": ("sec_to_time", lambda ts: dt.VARCHAR),
    "date_format": ("date_format", lambda ts: dt.VARCHAR),
    # ---- r5: date/time long tail
    "str_to_date": ("str_to_date", lambda ts: dt.DATE),
    "time_to_sec": ("time_to_sec", lambda ts: dt.INT64),
    "microsecond": ("microsecond", lambda ts: dt.INT32),
    "yearweek": ("yearweek", lambda ts: dt.INT64),
    "makedate": ("makedate", lambda ts: dt.DATE),
    "period_add": ("period_add", lambda ts: dt.INT64),
    "period_diff": ("period_diff", lambda ts: dt.INT64),
    "timestampdiff": ("timestampdiff", lambda ts: dt.INT64),
    "timestampadd": ("timestampadd", lambda ts: dt.DATETIME),
    "datetime": ("to_datetime", lambda ts: dt.DATETIME),
    # ---- r5: misc
    "bit_count": ("bit_count", lambda ts: dt.INT64),
    "uuid": ("uuid", lambda ts: dt.VARCHAR),
    "rand": ("rand", lambda ts: dt.FLOAT64),
    # ---- r6 long tail (serving PR): date/time
    "weekofyear": ("weekofyear", lambda ts: dt.INT32),
    "to_seconds": ("to_seconds", lambda ts: dt.INT64),
    "timediff": ("timediff", lambda ts: dt.VARCHAR),
    "addtime": ("addtime", lambda ts: dt.VARCHAR),
    "subtime": ("subtime", lambda ts: dt.VARCHAR),
    "time_format": ("time_format", lambda ts: dt.VARCHAR),
    "maketime": ("maketime", lambda ts: dt.VARCHAR),
    # ---- r6: string / net / json
    "is_ipv4": ("is_ipv4", lambda ts: dt.BOOL),
    "is_ipv6": ("is_ipv6", lambda ts: dt.BOOL),
    "inet6_aton": ("inet6_aton", lambda ts: dt.VARCHAR),
    "inet6_ntoa": ("inet6_ntoa", lambda ts: dt.VARCHAR),
    "json_quote": ("json_quote", lambda ts: dt.VARCHAR),
    "json_contains": ("json_contains", lambda ts: dt.BOOL),
    "char": ("char_fn", lambda ts: dt.VARCHAR),
    "make_set": ("make_set", lambda ts: dt.VARCHAR),
    "export_set": ("export_set", lambda ts: dt.VARCHAR),
    # ---- LLM family (func_builtin_llm.go role; endpoint-configured)
    "llm_chat": ("llm_chat", lambda ts: dt.VARCHAR),
}


_TIME_UNITS = {"microsecond", "second", "minute", "hour"}
_DATE_UNITS = {"day", "week", "month", "quarter", "year"}


def _bind_date_add_unit(base: BoundExpr, n: int, unit: str) -> BoundExpr:
    unit = unit.lower().rstrip("s")
    if unit not in _TIME_UNITS | _DATE_UNITS:
        raise BindError(f"unsupported interval unit {unit!r}")
    out_t = (dt.DATETIME if unit in _TIME_UNITS
             or base.dtype.oid in (TypeOid.DATETIME, TypeOid.TIMESTAMP)
             else dt.DATE)
    return BoundFunc("date_add_unit",
                     [base, BoundLiteral(int(n), dt.INT64),
                      BoundLiteral(unit, dt.VARCHAR)], out_t)


def _common_numeric(ts: List[DType]) -> DType:
    out = ts[0]
    for t in ts[1:]:
        if out.oid == t.oid and out.oid != TypeOid.DECIMAL64:
            continue
        if out.is_numeric and t.is_numeric:
            if TypeOid.DECIMAL64 in (out.oid, t.oid) \
                    and not (out.is_float or t.is_float):
                so = out.scale if out.oid == TypeOid.DECIMAL64 else 0
                st = t.scale if t.oid == TypeOid.DECIMAL64 else 0
                out = dt.decimal64(18, max(so, st))
            else:
                out = dt.promote(out, t)
    return out


def _session_info(name: str):
    """Info functions resolve against the EXECUTING session (the way the
    reference reads them from the frontend session): frontend/session.py
    publishes the current session in a contextvar during execute()."""
    from matrixone_tpu_torch.frontend.session import current_session
    s = current_session()
    if name == "connection_id":
        return BoundLiteral(int(getattr(s, "conn_id", 0) or 0), dt.INT64)
    if name == "last_insert_id":
        return BoundLiteral(int(getattr(s, "last_insert_id", 0) or 0),
                            dt.INT64)
    if name in ("user", "current_user", "session_user", "system_user"):
        auth = getattr(s, "auth", None)
        u = ("root" if auth is None
             else f"{auth.account}:{auth.user}")
        return BoundLiteral(u + "@localhost", dt.VARCHAR)
    if name == "database":
        return BoundLiteral("mo_catalog", dt.VARCHAR)
    return None


_DATE_ARG_FUNCS = {
    "date", "year", "month", "day", "dayofmonth", "dayofweek",
    "dayofyear", "weekday", "week", "yearweek", "quarter", "last_day",
    "to_days", "datediff", "monthname", "dayname", "hour", "minute",
    "second", "microsecond", "unix_timestamp", "date_format",
    "weekofyear", "to_seconds", "adddate", "subdate",
}


def _coerce_date_literals(name: str, args: List[BoundExpr]) -> None:
    """MySQL accepts date/datetime STRINGS wherever dates go
    ('2024-01-02 10:00:00'); parse literal strings at bind so the
    kernels only ever see typed DATE/DATETIME values."""
    import datetime as _dtm
    if name not in _DATE_ARG_FUNCS:
        return
    for i, a in enumerate(args):
        if not (isinstance(a, BoundLiteral) and isinstance(a.value, str)):
            continue
        s = a.value.strip()
        try:
            if len(s) > 10:
                args[i] = BoundLiteral(dt.epoch_micros_from_iso(s),
                                       dt.DATETIME)
            else:
                args[i] = BoundLiteral(dt.epoch_days_from_iso(s),
                                       dt.DATE)
        except ValueError:
            pass        # not a date string: leave for the kernel/error


def _literal_round_int(a: BoundLiteral) -> int:
    """MySQL-style integer view of a numeric literal: decimals unscale
    first, fractional values round half away from zero."""
    import math
    v = a.value
    if a.dtype.oid == TypeOid.DECIMAL64:
        v = v / 10 ** a.dtype.scale
    x = float(v)
    n = int(math.floor(abs(x) + 0.5))
    return -n if x < 0 else n


def bind_scalar_function(name: str, args: List[BoundExpr]) -> BoundExpr:
    import datetime as _dtm
    import math
    _coerce_date_literals(name, args)
    # sugar rewrites (reference: many of the 554 ids are compositions)
    if name == "pi" and not args:
        return BoundLiteral(math.pi, dt.FLOAT64)
    if name == "version" and not args:
        return BoundLiteral("8.0.30-matrixone-tpu", dt.VARCHAR)
    if name in ("connection_id", "last_insert_id", "user", "current_user",
                "session_user", "system_user", "database", "schema") \
            and not args:
        r = _session_info("database" if name == "schema" else name)
        if r is not None:
            return r
    # statement-time clock literals (MySQL: fixed per statement)
    if name in ("now", "current_timestamp", "sysdate",
                "localtimestamp") and not args:
        return BoundLiteral(dt.epoch_micros(_dtm.datetime.now()),
                            dt.DATETIME)
    if name in ("utc_timestamp",) and not args:
        now = _dtm.datetime.now(_dtm.timezone.utc).replace(tzinfo=None)
        return BoundLiteral(dt.epoch_micros(now), dt.DATETIME)
    if name in ("curdate", "current_date") and not args:
        d = (_dtm.date.today() - _dtm.date(1970, 1, 1)).days
        return BoundLiteral(d, dt.DATE)
    if name in ("utc_date",) and not args:
        d = (_dtm.datetime.now(_dtm.timezone.utc).date()
             - _dtm.date(1970, 1, 1)).days
        return BoundLiteral(d, dt.DATE)
    if name in ("curtime", "current_time") and not args:
        now = _dtm.datetime.now()
        return BoundLiteral(now.strftime("%H:%M:%S"), dt.VARCHAR)
    if name == "log" and len(args) == 2:
        # log(b, x) = ln(x) / ln(b)
        lnx = BoundFunc("ln", [args[1]], dt.FLOAT64)
        lnb = BoundFunc("ln", [args[0]], dt.FLOAT64)
        return BoundFunc("div", [lnx, lnb], dt.FLOAT64)
    if name == "llm_embed":
        # embedding width is session-configured (the endpoint's model
        # decides; the session pins the SQL-visible vector type)
        from matrixone_tpu_torch.frontend.session import current_session
        s = current_session()
        dim = int((s.variables.get("llm_embed_dim", 16)
                   if s is not None else 16))
        if len(args) != 1:
            raise BindError("llm_embed(text) takes one argument")
        return BoundFunc("llm_embed", args, dt.vecf32(dim))
    if name == "hex" and args and args[0].dtype.is_numeric:
        # MySQL: hex(string) dumps bytes, hex(number) rounds to BIGINT
        # and formats — two different functions behind one name
        return BoundFunc("hex_int", args, dt.VARCHAR)
    if name in ("timestampadd", "timestampdiff"):
        if len(args) != 3 or not isinstance(args[0], BoundLiteral):
            raise BindError(f"{name}(unit, a, b) takes a unit keyword "
                            f"and two arguments")
        unit = str(args[0].value).lower().rstrip("s")
        if unit not in _TIME_UNITS | _DATE_UNITS:
            raise BindError(f"unsupported {name} unit {unit!r}")
        if name == "timestampadd" and not (
                isinstance(args[1], BoundLiteral)
                and isinstance(args[1].value, int)):
            raise BindError(
                "timestampadd() count must be an integer literal "
                "(per-row counts are not supported yet)")
    if name in ("adddate", "subdate") and len(args) == 2:
        # MySQL 2-arg form: adddate(d, n) adds n DAYS (the INTERVAL form
        # is rewritten in _bind_func before reaching here).  A literal
        # delta may arrive as a scaled decimal (1.5 -> value 15 at
        # scale 1) or float — unscale and round to whole days (MySQL
        # rounds the day count), never use the scaled integer raw.
        delta = args[1]
        sign = -1 if name == "subdate" else 1
        if isinstance(delta, BoundLiteral):
            if delta.value is None:
                return BoundLiteral(None, dt.INT64)   # MySQL: NULL in -> NULL
            try:
                delta = BoundLiteral(sign * _literal_round_int(delta),
                                     dt.INT64)
            except (TypeError, ValueError):
                raise BindError(f"{name}() day count must be numeric")
        elif not delta.dtype.is_integer:
            raise BindError(
                f"{name}() per-row day counts must be integers")
        elif sign < 0:
            delta = BoundFunc("neg", [delta], delta.dtype)
        return BoundFunc("date_add_days", [args[0], delta], dt.DATE)
    if name == "char":
        # CHAR(65, 66) -> 'AB': each value contributes its big-endian
        # bytes (MySQL); NULLs are skipped. All-literal calls fold.
        if args and all(isinstance(a, BoundLiteral) for a in args):
            bs = b""
            for a in args:
                if a.value is None:
                    continue
                try:
                    n = _literal_round_int(a)
                except (TypeError, ValueError):
                    raise BindError("char() arguments must be numeric")
                if n < 0:
                    # matches the runtime path (vm/exprs char_fn):
                    # negative code points yield NULL
                    return BoundLiteral(None, dt.INT64)
                bs += n.to_bytes(max((n.bit_length() + 7) // 8, 1), "big")
            return BoundLiteral(bs.decode("utf-8", "replace"), dt.VARCHAR)
        if len(args) != 1:
            raise BindError(
                "char() over columns supports a single argument")
    if name == "maketime":
        if len(args) != 3:
            raise BindError("maketime(hour, minute, second)")
        if all(isinstance(a, BoundLiteral) for a in args):
            if any(a.value is None for a in args):
                return BoundLiteral(None, dt.INT64)   # MySQL: NULL in -> NULL
            try:
                h, m, s = (_literal_round_int(a) for a in args)
            except (TypeError, ValueError):
                raise BindError("maketime() arguments must be numeric")
            if not (0 <= m < 60 and 0 <= s < 60):
                # typeless NULL (same convention as _bind_literal: a
                # varchar-typed NULL const has no device representation)
                return BoundLiteral(None, dt.INT64)
            sign = "-" if h < 0 else ""
            return BoundLiteral(f"{sign}{abs(h):02d}:{m:02d}:{s:02d}",
                                dt.VARCHAR)
        if not all(isinstance(a, BoundLiteral) for a in args[1:]):
            raise BindError(
                "maketime() minute/second must be literals for now")
    if name == "if" and len(args) == 3:
        _require_bool(args[0], "if()")
        vt = (args[1].dtype if not (isinstance(args[1], BoundLiteral)
                                    and args[1].value is None)
              else args[2].dtype)
        return BoundCase([(args[0], args[1])], args[2], vt)
    if name == "ifnull" and len(args) == 2:
        name, args = "coalesce", args
    if name == "nullif" and len(args) == 2:
        eqf = BoundFunc("eq", [args[0], args[1]], dt.BOOL)
        return BoundCase([(eqf, BoundLiteral(None, args[0].dtype))],
                         args[0], args[0].dtype)
    if name == "isnull" and len(args) == 1:
        from matrixone_tpu_torch.sql.expr import BoundIsNull
        return BoundIsNull(args[0], False, dt.BOOL)
    if name not in _SCALAR_FUNCS:
        raise BindError(f"unknown function {name}()")
    if name in ("greatest", "least"):
        if len(args) < 2:
            raise BindError(f"{name}() needs at least two arguments")
        if any(not a.dtype.is_numeric for a in args):
            # comparing dictionary codes across columns is meaningless
            raise BindError(
                f"{name}() over non-numeric arguments is not "
                f"supported yet")
    op, result = _SCALAR_FUNCS[name]
    # vector literals arrive as '[1,2,...]' strings (MySQL-client style)
    # — only distance functions take vectors (a regexp character class
    # also starts with '[' and must stay a string)
    if op in ("l2_distance", "l2_distance_sq", "cosine_distance",
              "inner_product", "cosine_similarity"):
        for i, a in enumerate(args):
            if isinstance(a, BoundLiteral) and isinstance(a.value, str) \
                    and a.value.lstrip().startswith("["):
                vec = [float(x)
                       for x in a.value.strip()[1:-1].split(",") if x]
                args[i] = BoundLiteral(vec, dt.vecf32(len(vec)))
        dims = [a.dtype.dim for a in args if a.dtype.is_vector]
        if len(dims) == 2 and dims[0] != dims[1]:
            raise BindError(
                f"{name}() dimension mismatch: {dims[0]} vs {dims[1]}")
    return BoundFunc(op, args, result([a.dtype for a in args]))
