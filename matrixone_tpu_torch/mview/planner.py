"""Maintainability analysis: which view definitions can be maintained
from commit deltas instead of recomputed.

The port of `matrixone_tpu/mview/planner.py`.  The maintainable shapes
are the fused-fragment shapes (vm/fusion.py): one base-table scan ->
pushed or explicit filters -> GROUP BY with SUM / COUNT / AVG / MIN /
MAX over traceable argument expressions, optionally re-projected (pure
renames) and ordered.  Anything else (joins, HAVING, DISTINCT, window
functions, subqueries, LIMIT, nondeterministic functions, aggregates
without GROUP BY) degrades to a full rematerialization, and SHOW
MATERIALIZED VIEWS and EXPLAIN say so.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from matrixone_tpu_torch.container.dtypes import DType
from matrixone_tpu_torch.sql import ast, plan as P
from matrixone_tpu_torch.sql.expr import AggCall, BoundCol, BoundExpr

#: aggregate functions the delta maintainer updates; MIN/MAX merge over
#: inserts and recompute their group on deletes (an extremum cannot be
#: subtracted)
MAINTAINABLE_AGGS = frozenset({"sum", "count", "avg", "min", "max"})


@dataclasses.dataclass
class MaintainSpec:
    """What the maintainer needs, taken from the BOUND plan, so a delta
    is evaluated with the expressions a full recompute uses."""
    source: str                        # the single source table
    scan_columns: List[str]            # raw table columns the scan reads
    scan_schema: List[Tuple[str, DType]]   # qualified names for eval
    filters: List[BoundExpr]           # scan-pushed + explicit WHERE
    group_keys: List[BoundExpr]
    aggs: List[AggCall]
    #: backing-table column order: ("key", i) | ("agg", i) per output
    out_cols: List[tuple]
    out_schema: List[Tuple[str, DType]]

    @property
    def has_minmax(self) -> bool:
        return any(a.func in ("min", "max") for a in self.aggs)


def _reason(msg: str):
    return None, msg


def _ast_nondet(sel) -> Optional[str]:
    """The name of the first nondeterministic function called in the
    statement's AST, checked before binding (the binder folds now() to a
    literal, which would freeze time into the maintained state)."""
    from matrixone_tpu_torch.serving.plan_cache import NONDET_FUNCS

    def walk(node):
        if isinstance(node, ast.FuncCall) and \
                node.name.lower() in NONDET_FUNCS:
            yield node.name.lower()
        if dataclasses.is_dataclass(node) and isinstance(node, ast.Node):
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                for x in (v if isinstance(v, list) else [v]):
                    if isinstance(x, ast.Node):
                        yield from walk(x)
                    elif isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, ast.Node):
                                yield from walk(y)
    for name in walk(sel):
        return name
    return None


def analyze(sel, catalog, binder=None):
    """-> (MaintainSpec | None, reason).  `sel` is the parsed SELECT of
    the definition; a None spec means full-refresh mode, with the reason
    SHOW MATERIALIZED VIEWS gives.  Bind errors propagate."""
    from matrixone_tpu_torch.sql.binder import Binder

    if not isinstance(sel, ast.Select):
        return _reason("UNION definitions are not maintainable")
    if sel.ctes or sel.having is not None or sel.distinct \
            or sel.fill is not None:
        return _reason("CTE/HAVING/DISTINCT/FILL are not maintainable")
    if sel.limit is not None or sel.offset:
        return _reason("LIMIT/OFFSET is not maintainable")
    nd = _ast_nondet(sel)
    if nd is not None:
        return _reason(f"nondeterministic function {nd}()")
    node = (binder or Binder(catalog)).bind_statement(sel)
    return analyze_plan(node)


def analyze_plan(node):
    """Shape-match a BOUND plan (see analyze)."""
    from matrixone_tpu_torch.vm import fusion

    # ORDER BY is ignored for maintenance: the backing table is
    # unordered either way
    while isinstance(node, P.Sort):
        node = node.child
    proj = None
    if isinstance(node, P.Project):
        proj = node
        node = node.child
    if not isinstance(node, P.Aggregate):
        return _reason("not a single group-by aggregate")
    agg = node
    if not agg.group_keys:
        return _reason("scalar aggregates (no GROUP BY) degrade to "
                       "full refresh")
    filters: List[BoundExpr] = []
    node = agg.child
    while isinstance(node, P.Filter):
        filters.append(node.pred)
        node = node.child
    if not isinstance(node, P.Scan):
        return _reason("source is not a single base-table scan")
    scan = node
    if scan.as_of_ts is not None:
        return _reason("AS OF scans are immutable; use full refresh")
    filters = list(scan.filters) + filters

    # every expression evaluated over delta rows must be in the fused
    # fragments' traceable subset
    probe = fusion._ExprInfo()
    for f in filters:
        if not fusion._analyze_expr(f, probe):
            return _reason("filter expression is not maintainable")
    for k in agg.group_keys:
        if not fusion._analyze_expr(k, probe):
            return _reason("group key expression is not maintainable")
    for a in agg.aggs:
        if a.distinct:
            return _reason("DISTINCT aggregates are not maintainable")
        if a.func not in MAINTAINABLE_AGGS:
            return _reason(f"{a.func}() is not maintainable")
        if a.arg is not None:
            if a.func in ("min", "max") and a.arg.dtype.is_varlen:
                return _reason("string MIN/MAX is not maintainable")
            if not fusion._analyze_expr(a.arg, probe):
                return _reason("aggregate argument is not maintainable")

    # the projection above the aggregate must be a pure rename of its
    # outputs that keeps every group key (backing rows are addressed by
    # their key values)
    nkeys = len(agg.group_keys)
    agg_names = [n for n, _ in agg.schema]
    out_cols: List[tuple] = []
    if proj is None:
        out_schema = list(agg.schema)
        out_cols = [("key", i) for i in range(nkeys)] + \
            [("agg", i) for i in range(len(agg.aggs))]
    else:
        out_schema = list(proj.schema)
        seen = set()
        for e in proj.exprs:
            if not isinstance(e, BoundCol) or e.name not in agg_names:
                return _reason("projection above the aggregate is not a "
                               "pure rename")
            idx = agg_names.index(e.name)
            if idx in seen:
                return _reason("projection repeats an aggregate output")
            seen.add(idx)
            out_cols.append(("key", idx) if idx < nkeys
                            else ("agg", idx - nkeys))
        if {i for i in seen if i < nkeys} != set(range(nkeys)):
            return _reason("projection must keep every group key")
    spec = MaintainSpec(
        source=scan.table, scan_columns=list(scan.columns),
        scan_schema=list(scan.schema), filters=filters,
        group_keys=list(agg.group_keys), aggs=list(agg.aggs),
        out_cols=out_cols, out_schema=out_schema)
    return spec, "incremental"
