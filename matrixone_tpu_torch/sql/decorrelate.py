"""Decorrelation: rewrite correlated subqueries into joins, pre-bind.

Reference analogue: the plan builder's subquery flattening
(`pkg/sql/plan/build_dml_util.go` / `query_builder.go` turn EXISTS into
semi joins and correlated scalar aggregates into grouped derived tables).
Here the rewrite is AST -> AST so the ordinary binder/optimizer handles
the result:

  [NOT] EXISTS (SELECT ... WHERE inner_k = outer_k AND p [AND mixed])
      -> ast.SemiJoinSpec on the enclosing Select (bound as a semi/anti
         join; `mixed` non-equi outer-referencing conjuncts become the
         join residual — TPC-H Q21's l2.l_suppkey <> l1.l_suppkey)

  expr CMP (SELECT agg(x) FROM ... WHERE inner_k = outer_k AND p)
      -> derived table (SELECT inner_k, agg(x) FROM ... WHERE p GROUP BY
         inner_k) joined on inner_k = outer_k, CMP against its agg column
         (empty-group rows vanish via the inner join — identical to the
         NULL-compare semantics of the correlated form for non-COUNT
         aggregates; COUNT would need a left join + COALESCE and is
         rejected)

Uncorrelated subqueries are left untouched (the session inlines them by
executing once). Correlation is detected structurally: a column reference
inside the subquery that does not resolve against the subquery's own FROM
but does resolve in the enclosing scope.

The rewrite names its derived columns `__sj{n}_k{i}` and `__dc{n}_...`
with n counted per statement (`statement_names`): the same SQL binds to
the same names on every run, so its fused fragments key alike and a warm
run replays their graphs.  The JAX package draws n from a process-wide
counter instead, and re-traces those fragments on every run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
from typing import Dict, List, Optional, Set, Tuple

from matrixone_tpu_torch.sql import ast

_names = threading.local()


@contextlib.contextmanager
def statement_names():
    """Number the rewrite's derived names from 0 for one statement.  A
    nested statement (an uncorrelated subquery run while its outer one
    is prepared) counts on its own and hands the outer count back."""
    prev = getattr(_names, "counter", None)
    _names.counter = itertools.count()
    try:
        yield
    finally:
        _names.counter = prev


def _next_id() -> int:
    return next(_names.counter)

AGG_NAMES = {"count", "sum", "avg", "min", "max"}


class _Locals:
    """Name environment of one FROM clause: alias -> column set."""

    def __init__(self):
        self.tables: Dict[str, Set[str]] = {}

    @property
    def all_cols(self) -> Set[str]:
        out = set()
        for cols in self.tables.values():
            out |= cols
        return out

    def resolves(self, ref: ast.ColumnRef) -> bool:
        if ref.table is not None:
            return ref.table in self.tables and \
                ref.name in self.tables[ref.table]
        return ref.name in self.all_cols


def _collect_locals(from_, catalog, ctes: Dict[str, ast.Select]) -> _Locals:
    env = _Locals()

    def walk(f):
        if f is None:
            return
        if isinstance(f, ast.TableRef):
            alias = f.alias or f.name
            if f.name in ctes:
                env.tables[alias] = _output_names(ctes[f.name])
                return
            try:
                meta = catalog.get_table(f.name)
            except (KeyError, ValueError):   # unknown table: binder
                env.tables[alias] = set()    # reports it, not us
                return
            env.tables[alias] = {c for c, _ in meta.schema}
        elif isinstance(f, ast.SubqueryRef):
            env.tables[f.alias] = _output_names(f.select)
        elif isinstance(f, ast.Join):
            walk(f.left)
            walk(f.right)
    walk(from_)
    return env


def _output_names(sel: ast.Select) -> Set[str]:
    out = set()
    if isinstance(sel, ast.Union):
        return _output_names(sel.selects[0])
    for i, it in enumerate(sel.items):
        if it.alias:
            out.add(it.alias)
        elif isinstance(it.expr, ast.ColumnRef):
            out.add(it.expr.name)
        else:
            out.add(f"_col{i}")
    return out


def _column_refs(e, out: List[ast.ColumnRef]):
    if isinstance(e, ast.ColumnRef):
        out.append(e)
        return
    if isinstance(e, (ast.Subquery, ast.Exists, ast.SubqueryRef)):
        return   # nested scopes analyzed on their own pass
    if dataclasses.is_dataclass(e) and isinstance(e, ast.Node):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            for x in (v if isinstance(v, (list, tuple)) else (v,)):
                if isinstance(x, ast.Node):
                    _column_refs(x, out)
                elif isinstance(x, (list, tuple)):
                    for y in x:
                        if isinstance(y, ast.Node):
                            _column_refs(y, out)


def _split_and(e):
    if isinstance(e, ast.BinaryOp) and e.op == "and":
        return _split_and(e.left) + _split_and(e.right)
    return [e]


def _and_all(cs):
    if not cs:
        return None
    e = cs[0]
    for c in cs[1:]:
        e = ast.BinaryOp("and", e, c)
    return e


def _classify(e, inner: _Locals, outer: _Locals) -> str:
    """'local' | 'outer' | 'mixed' | 'unknown' for one expression."""
    refs: List[ast.ColumnRef] = []
    _column_refs(e, refs)
    if not refs:
        return "local"
    kinds = set()
    for r in refs:
        if inner.resolves(r):
            kinds.add("local")
        elif outer.resolves(r):
            kinds.add("outer")
        else:
            kinds.add("unknown")
    if kinds == {"local"}:
        return "local"
    if kinds == {"outer"}:
        return "outer"
    if "unknown" in kinds:
        return "unknown"
    return "mixed"


def _has_subquery(e) -> bool:
    if isinstance(e, (ast.Subquery, ast.Exists)):
        return True
    if dataclasses.is_dataclass(e) and isinstance(e, ast.Node):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            for x in (v if isinstance(v, (list, tuple)) else (v,)):
                if isinstance(x, ast.Node) and _has_subquery(x):
                    return True
    return False


def is_correlated(sub: ast.Select, outer: _Locals, catalog, ctes) -> bool:
    inner = _collect_locals(sub.from_, catalog, ctes)
    refs: List[ast.ColumnRef] = []
    for part in [sub.where, sub.having] + [it.expr for it in sub.items]:
        if part is not None:
            _column_refs(part, refs)
    return any(not inner.resolves(r) and outer.resolves(r) for r in refs)


class DecorrelateError(Exception):
    pass


def _split_correlation(sub: ast.Select, outer: _Locals, catalog, ctes):
    """Split sub.where into (inner_only, [(outer_expr, inner_expr)],
    mixed_residual). Raises DecorrelateError when a conjunct can't be
    placed (correlation outside WHERE, unknown names...)."""
    inner = _collect_locals(sub.from_, catalog, ctes)
    inner_keep, pairs, mixed = [], [], []
    for c in _split_and(sub.where) if sub.where is not None else []:
        kind = _classify(c, inner, outer)
        if kind == "local" or _has_subquery(c):
            inner_keep.append(c)
            continue
        if kind == "unknown":
            raise DecorrelateError(f"unresolvable column in {c}")
        if isinstance(c, ast.BinaryOp) and c.op == "=":
            lk = _classify(c.left, inner, outer)
            rk = _classify(c.right, inner, outer)
            if lk == "local" and rk == "outer":
                pairs.append((c.right, c.left))
                continue
            if lk == "outer" and rk == "local":
                pairs.append((c.left, c.right))
                continue
        mixed.append(c)
    # correlation must be confined to WHERE
    for part in [sub.having] + [it.expr for it in sub.items]:
        if part is not None and _classify(part, inner, outer) not in (
                "local",):
            raise DecorrelateError("correlation outside WHERE")
    if not pairs and not mixed:
        raise DecorrelateError("subquery is not correlated")
    return inner_keep, pairs, mixed


def _rewrite_local_refs(e, inner: _Locals, alias: str,
                        res_items: List[ast.SelectItem]):
    """In a mixed conjunct, replace inner-resolving column refs with
    references to projected residual columns of the semi-join build side."""
    if isinstance(e, ast.ColumnRef):
        if inner.resolves(e):
            name = f"{alias}_r{len(res_items)}"
            for it in res_items:      # reuse an existing projection
                if isinstance(it.expr, ast.ColumnRef) and \
                        it.expr.table == e.table and it.expr.name == e.name:
                    name = it.alias
                    break
            else:
                res_items.append(ast.SelectItem(
                    ast.ColumnRef(e.name, e.table), alias=name))
            # unqualified: the {alias}_r* names are globally unique and the
            # binder exposes them table-less in the residual scope
            return ast.ColumnRef(name, None)
        return e
    if dataclasses.is_dataclass(e) and isinstance(e, ast.Node):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, ast.Node):
                setattr(e, f.name,
                        _rewrite_local_refs(v, inner, alias, res_items))
            elif isinstance(v, list):
                setattr(e, f.name, [
                    _rewrite_local_refs(x, inner, alias, res_items)
                    if isinstance(x, ast.Node) else x for x in v])
    return e


def decorrelate_select(sel: ast.Select, catalog,
                       ctes: Optional[Dict[str, ast.Select]] = None) -> None:
    """In-place: rewrite correlated EXISTS / scalar-agg subqueries in
    sel.where into SemiJoinSpecs / grouped derived-table joins. Leaves
    uncorrelated subqueries for the session's inline-once path."""
    if ctes is None:
        ctes = {}
    ctes = {**ctes, **{n: s for n, s in sel.ctes}}
    if sel.where is None:
        return
    if getattr(_names, "counter", None) is None:
        with statement_names():
            decorrelate_select(sel, catalog, ctes)
        return
    outer = _collect_locals(sel.from_, catalog, ctes)
    conjuncts = _split_and(sel.where)
    out: List[ast.Node] = []
    for c in conjuncts:
        rewritten = _try_rewrite(c, sel, outer, catalog, ctes)
        out.extend(rewritten if isinstance(rewritten, list) else [rewritten])
    sel.where = _and_all(out)


def _try_rewrite(c, sel, outer, catalog, ctes):
    # --- [NOT] EXISTS (the parser emits NOT as a wrapping UnaryOp)
    if isinstance(c, ast.UnaryOp) and c.op == "not" and \
            isinstance(c.operand, ast.Exists):
        c = ast.Exists(c.operand.select, negated=not c.operand.negated)
    if isinstance(c, ast.Exists) and is_correlated(c.select, outer,
                                                   catalog, ctes):
        if c.select.limit == 0:
            # EXISTS (... LIMIT 0) is constant: no rows can match
            return ast.Literal(bool(c.negated), "bool")
        try:
            inner_keep, pairs, mixed = _split_correlation(
                c.select, outer, catalog, ctes)
        except DecorrelateError:
            return c
        inner = _collect_locals(c.select.from_, catalog, ctes)
        alias = f"__sj{_next_id()}"
        items = [ast.SelectItem(ie, alias=f"{alias}_k{i}")
                 for i, (_, ie) in enumerate(pairs)]
        res_items: List[ast.SelectItem] = []
        residual = None
        if mixed:
            mixed = [_rewrite_local_refs(m, inner, alias, res_items)
                     for m in mixed]
            residual = _and_all(mixed)
        if not pairs and mixed:
            # no equi keys: fall back to a constant key (degenerate
            # cross semi join with residual only)
            items = [ast.SelectItem(ast.Literal(1, "int"),
                                    alias=f"{alias}_k0")]
            pairs = [(ast.Literal(1, "int"), None)]
        sub = dataclasses.replace(
            c.select, items=items + res_items,
            where=_and_all(inner_keep), limit=None, order_by=[],
            semijoins=list(c.select.semijoins))
        sel.semijoins.append(ast.SemiJoinSpec(
            select=sub, outer_keys=[oe for oe, _ in pairs],
            n_keys=len(pairs), residual=residual, negated=c.negated,
            alias=alias))
        return []                      # conjunct fully consumed
    # --- expr CMP (scalar agg subquery)  (either side)
    if isinstance(c, ast.BinaryOp) and c.op in ("=", "<>", "<", "<=",
                                                ">", ">="):
        for this, other, flip in ((c.left, c.right, False),
                                  (c.right, c.left, True)):
            if not isinstance(this, ast.Subquery):
                continue
            s = this.select
            if isinstance(s, ast.Union) or not isinstance(s, ast.Select):
                continue
            if not is_correlated(s, outer, catalog, ctes):
                continue
            if len(s.items) != 1 or s.group_by:
                return c
            agg_expr = s.items[0].expr
            if _contains_count(agg_expr):
                return c               # COUNT over empty group is 0, not
                                      # NULL: inner join would be wrong
            try:
                inner_keep, pairs, mixed = _split_correlation(
                    s, outer, catalog, ctes)
            except DecorrelateError:
                return c
            if mixed or not pairs:
                return c
            alias = f"__dc{_next_id()}"
            d_items = [ast.SelectItem(ie, alias=f"{alias}_k{i}")
                       for i, (_, ie) in enumerate(pairs)]
            d_items.append(ast.SelectItem(agg_expr, alias=f"{alias}_agg"))
            import copy
            derived = dataclasses.replace(
                s, items=d_items, where=_and_all(inner_keep),
                group_by=[copy.deepcopy(ie) for _, ie in pairs],
                limit=None, order_by=[])
            sel.from_ = ast.Join("inner", sel.from_,
                                 ast.SubqueryRef(derived, alias), on=None)
            new = [ast.BinaryOp("=", oe, ast.ColumnRef(f"{alias}_k{i}",
                                                       alias))
                   for i, (oe, _) in enumerate(pairs)]
            aggcol = ast.ColumnRef(f"{alias}_agg", alias)
            # preserve operand order: the subquery's slot gets the agg
            # column (flip=True: the subquery was the RIGHT operand,
            # c.left stays on the left)
            new.append(ast.BinaryOp(c.op, aggcol, other) if not flip
                       else ast.BinaryOp(c.op, other, aggcol))
            return new
    return c


def _contains_count(e) -> bool:
    if isinstance(e, ast.FuncCall) and e.name == "count":
        return True
    if dataclasses.is_dataclass(e) and isinstance(e, ast.Node):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            for x in (v if isinstance(v, (list, tuple)) else (v,)):
                if isinstance(x, ast.Node) and _contains_count(x):
                    return True
    return False
