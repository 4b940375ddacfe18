"""Index-aware plan rewrites (reference: pkg/sql/plan/apply_indices*.go).

`apply_indices` rewrites

    TopK(k, key = distance(vec_col, const_vec) ASC)
      -> Project(..., distance(...), ...)
        -> Scan(table)                      [no pushed filters]

into the same tree with the Scan replaced by a VectorTopK source that runs
the IVF index (vectorindex/ivf_flat) and yields only ~k candidate rows
(all table columns fetched by row id + the index distance). The Project
then recomputes the exact distance over k rows (free exact re-rank) and
the TopK re-orders them — so the rewrite can only change WHICH k rows are
returned (index recall), never their values or order semantics.
"""

from __future__ import annotations

from typing import Optional

from matrixone_tpu_torch.sql import plan as P
from matrixone_tpu_torch.sql.expr import BoundCol, BoundFunc, BoundLiteral

_DIST_METRIC = {"l2_distance": "l2", "l2_distance_sq": "l2",
                "cosine_distance": "cosine", "inner_product": "ip"}


def apply_indices(node: P.PlanNode, catalog, nprobe: int = 8,
                  overfetch: int = 3, skip_tables=frozenset()) -> P.PlanNode:
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if c is not None:
            setattr(node, attr, apply_indices(c, catalog, nprobe, overfetch,
                                              skip_tables))
    if not isinstance(node, P.TopK):
        return node
    ft = _try_fulltext(node, catalog, skip_tables)
    if ft is not None:
        return ft
    if len(node.keys) != 1 or node.descendings[0]:
        return node
    key = node.keys[0]
    proj = node.child
    if not (isinstance(key, BoundCol) and isinstance(proj, P.Project)):
        return node
    # resolve the sort key to its projected expression
    try:
        kidx = [n for n, _ in proj.schema].index(key.name)
    except ValueError:
        return node
    dist = proj.exprs[kidx]
    if not (isinstance(dist, BoundFunc) and dist.op in _DIST_METRIC
            and len(dist.args) == 2):
        return node
    col_e, vec_e = dist.args
    if not isinstance(col_e, BoundCol):
        col_e, vec_e = vec_e, col_e
    if not (isinstance(col_e, BoundCol) and isinstance(vec_e, BoundLiteral)
            and isinstance(vec_e.value, list)):
        return node
    scan = proj.child
    if not (isinstance(scan, P.Scan) and not scan.filters
            and scan.as_of_ts is None):
        return node
    if scan.table in skip_tables:
        # txn snapshot / workspace reads: exact scan realizes the txn
        # view, the (frontier-built) index cannot — decline the rewrite
        return node
    # find a matching index on (table, column)
    raw_col = col_e.name.split(".")[-1]
    metric = _DIST_METRIC[dist.op]
    for ix in catalog.indexes_on(scan.table):
        if ix.algo in ("ivfflat", "ivfpq", "hnsw") \
                and ix.columns[0] == raw_col \
                and ix.options.get("_metric", "l2") == metric:
            # PQ candidates need a deeper pool: the exact re-rank above
            # (Project recompute + TopK) recovers ADC quantization loss
            factor = overfetch * (3 if ix.algo == "ivfpq" else 1)
            k = (node.k + node.offset) * factor
            proj.child = P.VectorTopK(
                table=scan.table, index_name=ix.name,
                query_vector=list(vec_e.value), k=k, metric=metric,
                columns=scan.columns, schema=scan.schema, nprobe=nprobe)
            return node
    return node


def _try_fulltext(node: P.TopK, catalog, skip_tables) -> "P.PlanNode | None":
    """TopK(desc, key = match_against(col, 'q')) over Project over Scan ->
    FulltextTopK replacing the whole subtree."""
    if len(node.keys) != 1 or not node.descendings[0]:
        return None
    key = node.keys[0]
    proj = node.child
    if not (isinstance(key, BoundCol) and isinstance(proj, P.Project)):
        return None
    try:
        kidx = [n for n, _ in proj.schema].index(key.name)
    except ValueError:
        return None
    mexpr = proj.exprs[kidx]
    if not (isinstance(mexpr, BoundFunc) and mexpr.op == "match_against"
            and len(mexpr.args) >= 2):
        return None
    col_exprs, q_e = mexpr.args[:-1], mexpr.args[-1]
    if not (all(isinstance(c, BoundCol) for c in col_exprs)
            and isinstance(q_e, BoundLiteral)
            and isinstance(q_e.value, str)):
        return None
    scan = proj.child
    if not (isinstance(scan, P.Scan) and not scan.filters
            and scan.as_of_ts is None
            and scan.table not in skip_tables):
        return None
    raw_cols_wanted = [c.name.split(".")[-1] for c in col_exprs]
    for ix in catalog.indexes_on(scan.table):
        if ix.algo != "fulltext" or ix.columns != raw_cols_wanted:
            continue
        # every projected output must be a plain column or the match expr
        out_exprs = []
        for e in proj.exprs:
            if e == mexpr:
                out_exprs.append(("score",))
            elif isinstance(e, BoundCol):
                out_exprs.append(("col", e.name.split(".")[-1]))
            else:
                return None
        return P.FulltextTopK(
            table=scan.table, index_name=ix.name, query=q_e.value,
            k=node.k, offset=node.offset, columns=scan.columns,
            out_exprs=out_exprs, schema=proj.schema)
    return None
