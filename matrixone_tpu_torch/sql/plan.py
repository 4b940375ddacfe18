"""Logical plan nodes (reference: proto/plan.proto + pkg/sql/plan — redesigned).

A plan is a tree of dataclass nodes, each with an output `schema`
(list of (name, DType)). The planner applies a small pass list —
filter pushdown into Scan (feeds zonemap pruning), ORDER BY+LIMIT -> TopK
fusion, vector-index rewrite — the reference's pass list lives in
`plan/query_builder.go:2714-2790`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from matrixone_tpu_torch.container.dtypes import DType
from matrixone_tpu_torch.sql.expr import AggCall, BoundExpr

Schema = List[Tuple[str, DType]]


class PlanNode:
    schema: Schema


@dataclasses.dataclass
class Scan(PlanNode):
    table: str
    columns: List[str]
    schema: Schema
    # conjunctive filters pushed into the scan (zonemap pruning + early mask)
    filters: List[BoundExpr] = dataclasses.field(default_factory=list)
    # time-travel read (AS OF SNAPSHOT/TIMESTAMP): overrides the txn snapshot
    as_of_ts: Optional[int] = None
    # distributed execution: (shard_idx, n_shards) — this scan reads only
    # every n-th chunk (reference: RemoteRun ships scopes whose readers
    # cover disjoint block ranges, compile/scope.go:423)
    shard: Optional[Tuple[int, int]] = None
    # hash exchange: (column, shard_idx, n_shards) — this scan keeps only
    # rows whose splitmix64(column) % n_shards == shard_idx (the all-to-all
    # repartition of colexec/shuffle expressed as a read-side route; when
    # the table is hash-partitioned on `column` with n_parts == n_shards
    # the engine skips non-matching segments structurally and no row moves)
    hash_shard: Optional[Tuple[str, int, int]] = None


@dataclasses.dataclass
class Filter(PlanNode):
    child: PlanNode
    pred: BoundExpr
    schema: Schema


@dataclasses.dataclass
class Project(PlanNode):
    child: PlanNode
    exprs: List[BoundExpr]
    schema: Schema


@dataclasses.dataclass
class Aggregate(PlanNode):
    child: PlanNode
    group_keys: List[BoundExpr]
    aggs: List[AggCall]
    schema: Schema          # group key cols then agg cols


@dataclasses.dataclass
class Sort(PlanNode):
    child: PlanNode
    keys: List[BoundExpr]
    descendings: List[bool]
    schema: Schema


@dataclasses.dataclass
class TopK(PlanNode):
    child: PlanNode
    keys: List[BoundExpr]
    descendings: List[bool]
    k: int
    offset: int
    schema: Schema


@dataclasses.dataclass
class Limit(PlanNode):
    child: PlanNode
    n: Optional[int]
    offset: int
    schema: Schema


@dataclasses.dataclass
class Join(PlanNode):
    kind: str    # inner | left | full | semi | anti | cross (right->left)
    left: PlanNode
    right: PlanNode
    left_keys: List[BoundExpr]
    right_keys: List[BoundExpr]
    residual: Optional[BoundExpr]
    schema: Schema


@dataclasses.dataclass
class Window(PlanNode):
    """Window functions (reference: colexec/window): each entry computes
    one fn over (partition, order) into a new hidden column."""
    child: PlanNode
    # (func, arg BoundExpr|None, part_keys, ord_keys, ord_descs, out_name)
    entries: List[tuple]
    schema: Schema


@dataclasses.dataclass
class Distinct(PlanNode):
    child: PlanNode
    schema: Schema


@dataclasses.dataclass
class Union(PlanNode):
    children: List[PlanNode]
    schema: Schema


@dataclasses.dataclass
class Values(PlanNode):
    rows: List[list]
    schema: Schema


@dataclasses.dataclass
class Materialized(PlanNode):
    """Host arrays injected into a plan (never serialized): the
    coordinator substitutes merged fragment results for the subtree the
    peers executed, then runs the remaining upper plan locally."""
    arrays: dict                 # col -> np.ndarray | list[str|None]
    validity: dict               # col -> np.ndarray[bool]
    schema: Schema
    # varlen columns may arrive pre-encoded: arrays[col] holds int32
    # codes into dicts[col] (skips two per-row Python passes)
    dicts: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Sample(PlanNode):
    """Random sample of the child (reference: colexec/sample): either a
    fixed number of rows (single-pass random-key top-N reservoir) or a
    percentage (per-row Bernoulli mask)."""
    child: PlanNode
    n_rows: Optional[int]
    percent: Optional[float]
    schema: Schema
    seed: int = 42


@dataclasses.dataclass
class Fill(PlanNode):
    """Null-fill over ordered grouped output (reference: colexec/fill):
    materializes the child, orders by the first group key, and fills NULL
    values in the non-key columns by mode prev | linear | value."""
    child: PlanNode
    mode: str
    const: Optional[float]
    order_col: str           # first group-key output column
    key_cols: List[str]      # group-key outputs (never filled)
    schema: Schema


@dataclasses.dataclass
class UdfAggregate(PlanNode):
    """Whole-relation aggregate UDFs: materialize each call's argument
    columns (masked + valid rows only) and run the body ONCE per call —
    one output row (matrixone_tpu/udf; reference: pkg/udf aggregate
    registration)."""
    child: PlanNode
    calls: List[BoundExpr]        # BoundUdfCall per output column
    schema: Schema


@dataclasses.dataclass
class VectorTopK(PlanNode):
    """Index-accelerated `ORDER BY distance(col, const) LIMIT k` — the
    reference's applyIndices rewrite (plan/apply_indices_ivfflat.go)."""
    table: str
    index_name: str
    query_vector: list
    k: int
    metric: str
    columns: List[str]
    schema: Schema
    nprobe: int = 8


@dataclasses.dataclass
class FulltextTopK(PlanNode):
    """Index-accelerated `ORDER BY match(col) against('q') DESC LIMIT k` —
    replaces the whole Project+TopK subtree (the score is produced by the
    index search, not re-evaluated per row). Reference:
    plan/apply_indices_fulltext.go + table_function/fulltext."""
    table: str
    index_name: str
    query: str
    k: int
    offset: int
    columns: List[str]                  # table columns needed
    out_exprs: List[object]             # per output: ('col', raw) | ('score',)
    schema: Schema


def _udf_call_notes(node: PlanNode) -> str:
    """` UdfCall f [jit|row|remote]` markers for every UDF call inside
    this node's expressions (EXPLAIN surface for the udf subsystem)."""
    from matrixone_tpu_torch.sql.expr import BoundUdfCall, walk
    roots: List[BoundExpr] = []
    if isinstance(node, Project):
        roots = list(node.exprs)
    elif isinstance(node, Filter):
        roots = [node.pred]
    elif isinstance(node, UdfAggregate):
        roots = list(node.calls)
    elif isinstance(node, Scan):
        roots = list(node.filters)
    calls = [e for r in roots for e in walk(r)
             if isinstance(e, BoundUdfCall)]
    if not calls:
        return ""
    from matrixone_tpu_torch.udf.executor import expected_tier
    seen = []
    for c in calls:
        tier = ("aggregate" if c.is_aggregate else expected_tier(c))
        note = f"UdfCall {c.name} [{tier}]"
        if note not in seen:
            seen.append(note)
    return " " + " ".join(seen)


def explain(node: PlanNode, indent: int = 0, annotate=None) -> str:
    """Render a plan tree.  `annotate(node) -> str` appends per-node
    decorations (the session uses it to mark fusion fragment ids)."""
    pad = "  " * indent
    name = type(node).__name__
    extra = ""
    if isinstance(node, Scan):
        extra = f" table={node.table} cols={node.columns}" + (
            f" filters={len(node.filters)}" if node.filters else "")
    elif isinstance(node, Aggregate):
        extra = f" keys={len(node.group_keys)} aggs={[a.func for a in node.aggs]}"
    elif isinstance(node, (Sort, TopK)):
        extra = f" desc={node.descendings}" + (
            f" k={node.k}" if isinstance(node, TopK) else "")
    elif isinstance(node, Join):
        extra = f" kind={node.kind}"
    elif isinstance(node, VectorTopK):
        extra = f" index={node.index_name} k={node.k} metric={node.metric}"
    elif isinstance(node, FulltextTopK):
        extra = f" index={node.index_name} k={node.k} query={node.query!r}"
    extra += _udf_call_notes(node)
    if annotate is not None:
        extra += annotate(node)
    lines = [f"{pad}{name}{extra}  -> {[n for n, _ in node.schema]}"]
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if c is not None:
            lines.append(explain(c, indent + 1, annotate))
    for c in getattr(node, "children", []) or []:
        lines.append(explain(c, indent + 1, annotate))
    return "\n".join(lines)
