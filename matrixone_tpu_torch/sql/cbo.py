"""Cost-based optimizer: cardinality estimation + greedy join reordering.

Reference analogue: `pkg/sql/plan/query_builder.go:2714-2790`
(determineJoinOrder over the equi-join graph using stats.go estimates)
plus the build/probe side decision in `plan/build_constraint_util.go`.
Redesign for this engine's executor:

  * the physical join (`vm/join.py`) STREAMS the probe (left) side and
    MATERIALIZES the build (right) side on device — so the optimizer's
    job here is (a) pick a left-deep order that keeps intermediate
    results small and (b) put the smaller input on the build side;
  * estimation works on the bound plan tree with a per-node column-stats
    environment (Scan seeds it from `sql/stats.py`, Project renames it),
    so join-key NDVs survive through filters/projections;
  * inner-join residual predicates are order-independent (they are just
    filters over match lanes), so the flattener carries them as pending
    predicates and re-attaches each at the first join where its columns
    exist.

The pass is a no-op on trees without inner/cross join regions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from matrixone_tpu_torch.container import dtypes as dt
from matrixone_tpu_torch.sql import plan as P
from matrixone_tpu_torch.sql.expr import (BoundCase, BoundCast, BoundCol,
                                    BoundExpr, BoundFunc, BoundInList,
                                    BoundIsNull, BoundLike, BoundLiteral,
                                    and_all, columns_used)
from matrixone_tpu_torch.sql.stats import StatsProvider, TableStats

DEFAULT_SEL = 1.0 / 3.0
_EPS = 1e-9


# --------------------------------------------------------------- estimation

@dataclasses.dataclass
class Est:
    rows: float
    # qualified column name -> (ndv, lo, hi); lo/hi None when unknown
    cols: Dict[str, tuple]

    def ndv(self, name: str) -> Optional[float]:
        c = self.cols.get(name)
        return None if c is None else min(c[0], max(self.rows, 1.0))


def _lit_num(e: BoundExpr) -> Optional[float]:
    if isinstance(e, BoundLiteral) and isinstance(e.value, (int, float)) \
            and not isinstance(e.value, bool):
        v = float(e.value)
        if e.dtype.oid == dt.TypeOid.DECIMAL64:
            v /= 10 ** e.dtype.scale
        return v
    return None


def _col_range(env: Est, col: BoundCol) -> tuple:
    c = env.cols.get(col.name)
    if c is None:
        return None, None
    lo, hi = c[1], c[2]
    if lo is not None and col.dtype.oid == dt.TypeOid.DECIMAL64:
        lo, hi = lo / 10 ** col.dtype.scale, hi / 10 ** col.dtype.scale
    return lo, hi


def selectivity(pred: BoundExpr, env: Est) -> float:
    """Fraction of rows surviving `pred` given the column environment."""
    if isinstance(pred, BoundFunc):
        op = pred.op
        if op == "and":
            return selectivity(pred.args[0], env) * \
                selectivity(pred.args[1], env)
        if op == "or":
            a = selectivity(pred.args[0], env)
            b = selectivity(pred.args[1], env)
            return min(1.0, a + b - a * b)
        if op == "not":
            return max(0.0, 1.0 - selectivity(pred.args[0], env))
        if op in ("eq", "ne", "lt", "le", "gt", "ge") and len(pred.args) == 2:
            a, b = pred.args
            if isinstance(b, BoundCol) and not isinstance(a, BoundCol):
                a, b = b, a
                op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                      "eq": "eq", "ne": "ne"}[op]
            if isinstance(a, BoundCol):
                lv = _lit_num(b)
                if op == "eq":
                    if isinstance(b, BoundCol):
                        # correlated equality inside one relation
                        n1, n2 = env.ndv(a.name), env.ndv(b.name)
                        d = max(n1 or 0, n2 or 0)
                        return 1.0 / d if d > 1 else DEFAULT_SEL
                    d = env.ndv(a.name)
                    return 1.0 / d if d and d > 0 else DEFAULT_SEL
                if op == "ne":
                    d = env.ndv(a.name)
                    return 1.0 - (1.0 / d) if d and d > 1 else 1.0
                lo, hi = _col_range(env, a)
                if lv is not None and lo is not None and hi > lo:
                    if op in ("lt", "le"):
                        f = (lv - lo) / (hi - lo)
                    else:
                        f = (hi - lv) / (hi - lo)
                    return min(1.0, max(0.0, f))
            return DEFAULT_SEL
    if isinstance(pred, BoundInList):
        d = env.ndv(pred.arg.name) if isinstance(pred.arg, BoundCol) else None
        s = len(pred.values) / d if d and d > 0 else DEFAULT_SEL
        s = min(1.0, s)
        return 1.0 - s if pred.negated else s
    if isinstance(pred, BoundLike):
        return 0.75 if pred.negated else 0.25
    if isinstance(pred, BoundIsNull):
        return 0.9 if pred.negated else 0.1
    return DEFAULT_SEL


def estimate(node: P.PlanNode, sp: StatsProvider) -> Est:
    """Bottom-up (rows, column-stats) estimate for a plan subtree."""
    if isinstance(node, P.Scan):
        ts = sp.table(node.table)
        if ts is None:
            return Est(1000.0, {})
        cols = {}
        for (qn, _), raw in zip(node.schema, node.columns):
            c = ts.cols.get(raw)
            if c is not None:
                cols[qn] = (c.ndv, c.lo, c.hi)
        env = Est(float(max(ts.row_count, 1)), cols)
        rows = env.rows
        for f in node.filters:
            rows *= selectivity(f, env)
        return Est(max(rows, _EPS), cols)
    if isinstance(node, P.Filter):
        ch = estimate(node.child, sp)
        return Est(max(ch.rows * selectivity(node.pred, ch), _EPS), ch.cols)
    if isinstance(node, P.Project):
        ch = estimate(node.child, sp)
        cols = {}
        for (qn, _), e in zip(node.schema, node.exprs):
            if isinstance(e, BoundCol) and e.name in ch.cols:
                cols[qn] = ch.cols[e.name]
        return Est(ch.rows, cols)
    if isinstance(node, P.Aggregate):
        ch = estimate(node.child, sp)
        if not node.group_keys:
            return Est(1.0, {})
        groups = 1.0
        for k in node.group_keys:
            d = ch.ndv(k.name) if isinstance(k, BoundCol) else None
            groups *= d if d else math.sqrt(max(ch.rows, 1.0))
        return Est(min(groups, ch.rows), ch.cols)
    if isinstance(node, P.Distinct):
        ch = estimate(node.child, sp)
        return Est(ch.rows, ch.cols)
    if isinstance(node, (P.Sort, P.Window)):
        ch = estimate(node.child, sp)
        return Est(ch.rows, ch.cols)
    if isinstance(node, P.TopK):
        ch = estimate(node.child, sp)
        return Est(min(float(node.k), ch.rows), ch.cols)
    if isinstance(node, P.Limit):
        ch = estimate(node.child, sp)
        n = float(node.n) if node.n is not None else ch.rows
        return Est(min(n, ch.rows), ch.cols)
    if isinstance(node, P.Join):
        le = estimate(node.left, sp)
        re_ = estimate(node.right, sp)
        cols = {**le.cols, **re_.cols}
        rows = _join_rows(node.kind, le, re_, node.left_keys,
                          node.right_keys)
        if node.residual is not None and node.kind in ("inner", "cross"):
            rows *= selectivity(node.residual, Est(rows, cols))
        if node.kind in ("semi", "anti", "left"):
            cols = dict(cols) if node.kind == "left" else le.cols
        return Est(max(rows, _EPS), cols)
    if isinstance(node, P.Sample):
        ch = estimate(node.child, sp)
        if node.n_rows is not None:
            return Est(min(float(node.n_rows), ch.rows), ch.cols)
        return Est(ch.rows * node.percent / 100.0, ch.cols)
    if isinstance(node, P.Fill):
        ch = estimate(node.child, sp)
        return Est(ch.rows, ch.cols)
    if isinstance(node, P.Union):
        rows = sum(estimate(c, sp).rows for c in node.children)
        return Est(rows, {})
    if isinstance(node, P.Values):
        return Est(float(len(node.rows)), {})
    if isinstance(node, (P.VectorTopK, P.FulltextTopK)):
        return Est(float(node.k), {})
    ch = getattr(node, "child", None)
    if ch is not None:
        return estimate(ch, sp)
    return Est(1000.0, {})


def _join_rows(kind: str, le: Est, re_: Est, lkeys, rkeys) -> float:
    if kind == "cross":
        return le.rows * re_.rows
    if kind in ("semi", "anti"):
        base = _equi_rows(le, re_, lkeys, rkeys)
        frac = min(1.0, base / max(le.rows, _EPS))
        return le.rows * (frac if kind == "semi" else (1.0 - frac * 0.9))
    inner = _equi_rows(le, re_, lkeys, rkeys)
    if kind == "left":
        return max(inner, le.rows)
    if kind == "full":
        return max(inner, le.rows, re_.rows)
    return inner


def _equi_rows(le: Est, re_: Est, lkeys, rkeys) -> float:
    denom = 1.0
    for lk, rk in zip(lkeys or [], rkeys or []):
        dl = le.ndv(lk.name) if isinstance(lk, BoundCol) else None
        dr = re_.ndv(rk.name) if isinstance(rk, BoundCol) else None
        d = max(dl or 0.0, dr or 0.0)
        if d <= 0:
            d = math.sqrt(max(min(le.rows, re_.rows), 1.0))
        denom = max(denom, d)
    if not lkeys:
        return le.rows * re_.rows
    return le.rows * re_.rows / denom


# ---------------------------------------------------------------- reorder

@dataclasses.dataclass
class _Edge:
    a: BoundExpr             # key expr over leaf set A
    b: BoundExpr
    a_leaf: int
    b_leaf: int


def _flatten_region(j: P.Join, leaves: list, edges_raw: list,
                    pending: list) -> None:
    """Collect the maximal inner/cross join region rooted at `j`."""
    for side in (j.left, j.right):
        if isinstance(side, P.Join) and side.kind in ("inner", "cross") :
            _flatten_region(side, leaves, edges_raw, pending)
        else:
            leaves.append(side)
    for lk, rk in zip(j.left_keys or [], j.right_keys or []):
        edges_raw.append((lk, rk))
    if j.residual is not None:
        pending.append(j.residual)


def _leaf_of(expr: BoundExpr, leaf_names: List[set]) -> Optional[int]:
    used = set(columns_used(expr))
    if not used:
        return None
    owners = [i for i, names in enumerate(leaf_names) if used <= names]
    return owners[0] if len(owners) == 1 else None


def reorder_joins(node: P.PlanNode, sp: StatsProvider) -> P.PlanNode:
    """Recursively reorder every maximal inner/cross join region using a
    greedy smallest-intermediate heuristic, and place the smaller side of
    every rebuilt join on the build (right) side."""
    if isinstance(node, P.Join) and node.kind in ("inner", "cross"):
        leaves: list = []
        edges_raw: list = []
        pending: list = []
        _flatten_region(node, leaves, edges_raw, pending)
        leaves = [reorder_joins(l, sp) for l in leaves]
        leaf_names = [{n for n, _ in l.schema} for l in leaves]
        edges: List[_Edge] = []
        for a, b in edges_raw:
            ia, ib = _leaf_of(a, leaf_names), _leaf_of(b, leaf_names)
            if ia is None or ib is None:
                pending.append(BoundFunc("eq", [a, b], dt.BOOL))
            else:
                edges.append(_Edge(a, b, ia, ib))
        return _greedy_build(leaves, edges, pending, sp)
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if c is not None:
            setattr(node, attr, reorder_joins(c, sp))
    if getattr(node, "children", None):
        node.children = [reorder_joins(c, sp) for c in node.children]
    return node


def _greedy_build(leaves, edges, pending, sp) -> P.PlanNode:
    ests = [estimate(l, sp) for l in leaves]
    n = len(leaves)
    remaining = set(range(n))
    # start from the smallest leaf that has at least one edge (a pure
    # cross-product island starts only if nothing is connected)
    connected = {e.a_leaf for e in edges} | {e.b_leaf for e in edges}
    order_pool = sorted(remaining,
                        key=lambda i: (i not in connected, ests[i].rows))
    start = order_pool[0]
    acc = leaves[start]
    acc_est = ests[start]
    acc_set = {start}
    remaining.discard(start)
    pending = list(pending)

    while remaining:
        best = None          # (rows, leaf_idx, keys)
        for i in remaining:
            keys = _keys_between(edges, acc_set, i)
            if not keys:
                continue
            le, re_ = acc_est, ests[i]
            rows = _equi_rows(le, re_, [a for a, _ in keys],
                              [b for _, b in keys])
            if best is None or rows < best[0]:
                best = (rows, i, keys)
        if best is None:
            # disconnected: cross-join the smallest remaining leaf
            i = min(remaining, key=lambda i: ests[i].rows)
            best = (acc_est.rows * ests[i].rows, i, [])
        rows, i, keys = best
        left, right = acc, leaves[i]
        lkeys = [a for a, _ in keys]
        rkeys = [b for _, b in keys]
        left_est, right_est = acc_est, ests[i]
        # build side = smaller input (vm/join materializes the right side)
        if right_est.rows > left_est.rows * 1.2:
            left, right = right, left
            lkeys, rkeys = rkeys, lkeys
            left_est, right_est = right_est, left_est
        kind = "inner" if keys else "cross"
        j = P.Join(kind, left, right, lkeys, rkeys, None,
                   left.schema + right.schema)
        acc_set.add(i)
        remaining.discard(i)
        # attach any pending residuals whose columns are now in scope
        avail = {nm for nm, _ in j.schema}
        still = []
        for pr in pending:
            if set(columns_used(pr)) <= avail:
                j.residual = pr if j.residual is None else \
                    BoundFunc("and", [j.residual, pr], dt.BOOL)
            else:
                still.append(pr)
        pending = still
        acc = j
        acc_est = estimate(j, sp)
    if pending:
        acc = P.Filter(acc, and_all(pending), acc.schema)
    return acc


def _keys_between(edges: List[_Edge], acc_set: set, i: int):
    out = []
    for e in edges:
        if e.a_leaf in acc_set and e.b_leaf == i:
            out.append((e.a, e.b))
        elif e.b_leaf in acc_set and e.a_leaf == i:
            out.append((e.b, e.a))
    return out


def optimize_plan(node: P.PlanNode, catalog) -> P.PlanNode:
    """Entry point for the session: stats-driven join reordering."""
    from matrixone_tpu_torch.sql.stats import provider_for
    return reorder_joins(node, provider_for(catalog))
