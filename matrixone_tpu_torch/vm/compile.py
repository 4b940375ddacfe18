"""Plan -> operator tree (reference: pkg/sql/compile/compile.go:670
compileScope, collapsed: one process, one pipeline per plan).

The port of `matrixone_tpu/vm/compile.py`.  After the tree is built,
the whole-plan fusion pass (vm/fusion.py) replaces maximal fusable
operator chains with fused fragments, each step of which is one CUDA
graph on the card, replayed once per batch.  It is on by default, as in
the JAX package; `MO_PLAN_FUSION=0` (or `SET plan_fusion = 0`) keeps
the per-operator path.  Every AggOp gets `use_pallas=True`, which is
what the reference resolves on its TPU (`HK.enabled()`), so float32
grouped sums take the segment-sum kernel exactly where the reference's
do.

`VectorTopK` compiles to `vm/vector_scan.VectorTopKOp` (the IVF-Flat,
IVF-PQ or HNSW search as a source) and `FulltextTopK` to
`vm/fulltext_scan.FulltextTopKOp` (BM25 on the index's device).
`UdfAggregate` compiles to `vm/operators.UdfAggregateOp` (the aggregate
UDF tier, udf/executor.py) and `Materialized` (a merged cross-shard
result, parallel/dist_query.py) to `vm/operators.MaterializedOp`.
"""

from __future__ import annotations

from matrixone_tpu_torch.sql import plan as P
from matrixone_tpu_torch.vm import operators as ops
from matrixone_tpu_torch.vm.join import JoinOp
from matrixone_tpu_torch.vm.process import ExecContext
from matrixone_tpu_torch.vm.window import WindowOp


def compile_plan(node: P.PlanNode, ctx) -> ops.Operator:
    if not isinstance(ctx, ExecContext):
        ctx = ExecContext(catalog=ctx)
    op = _compile_node(node, ctx)
    from matrixone_tpu_torch.vm import fusion
    if fusion.enabled(ctx):
        op = fusion.fuse_operator_tree(op, ctx)
    return op


def iter_ops(root: ops.Operator):
    """Every operator reachable through the standard tree attributes
    (fragments expose their source as `child`, so this walks through
    them)."""
    stack = [root]
    while stack:
        op = stack.pop()
        yield op
        for attr in ("child", "left", "right"):
            c = getattr(op, attr, None)
            if isinstance(c, ops.Operator):
                stack.append(c)
        for c in getattr(op, "children", None) or []:
            if isinstance(c, ops.Operator):
                stack.append(c)


def retarget_tree(root: ops.Operator, ctx: ExecContext) -> None:
    """Prepare a cached compiled operator tree for a fresh execution:
    point every operator at the new ExecContext (snapshot ts, session
    variables, device) and clear what an execution leaves behind that
    the next one would read.  What a tree bakes at construction (the
    fusion switches, the join build budget, the device, the encoding
    policy) is the session's `_tree_vars_sig`, not reset here.

    The audit, operator by operator:
      * ScanOp: the runtime filters its joins appended (a reused tree
        would AND the previous parameters' build-key ranges into this
        execution's); the read-ahead thread and the device references
        are per execution already (`_batches` closes the thread).
      * JoinOp: a fused fragment's build-state handoff left by an
        execution that ended in its degrade ladder before consuming it;
        the build side and the Grace spill are per execution already.
      * AggOp: the group-table capacity grown by the last execution,
        its dictionary tracker and a spill an aborted execution left.
      * UnionOp: its union-wide dictionaries (also reset at execute).
      * fused fragments: the graphs an interrupted execution still owns
        (released back to the fragment cache), the EXPLAIN ANALYZE stats
        and a fallback rewire of the original chain.  Their LIMIT
        counters, top-k and aggregate carries and `_ReplaySource` are
        made per execution.
      * window operators keep no state between executions."""
    from matrixone_tpu_torch.vm import fusion
    tree = list(iter_ops(root))
    for op in list(tree):
        if isinstance(op, fusion.FusedFragmentOp):
            tree.extend(op.original_ops())
    for op in tree:
        if hasattr(op, "ctx"):
            op.ctx = ctx
        if isinstance(op, ops.ScanOp):
            op.runtime_filters = []
        elif isinstance(op, JoinOp):
            op._prepared_build = None
        elif isinstance(op, ops.AggOp):
            op.max_groups = op.initial_max_groups
            op.__dict__.pop("_agg_tracker", None)
            if op._spill is not None:
                op._spill.cleanup()
                op._spill = None
        elif isinstance(op, ops.UnionOp):
            op._union_dicts = {}
            op._union_lut = {}
        if isinstance(op, fusion.FusedFragmentOp):
            op.reset_execution()


def _compile_node(node: P.PlanNode, ctx: ExecContext) -> ops.Operator:
    if isinstance(node, P.Scan):
        rel = ctx.catalog.get_table(node.table)
        return ops.ScanOp(node, rel, ctx)
    if isinstance(node, P.Values):
        return ops.ValuesOp(node, ctx)
    if isinstance(node, P.Filter):
        return ops.FilterOp(node, _compile_node(node.child, ctx))
    if isinstance(node, P.Project):
        return ops.ProjectOp(node, _compile_node(node.child, ctx))
    if isinstance(node, P.Aggregate):
        return ops.AggOp(node, _compile_node(node.child, ctx), ctx=ctx,
                         use_pallas=True)
    if isinstance(node, P.Sort):
        return ops.SortOp(node, _compile_node(node.child, ctx))
    if isinstance(node, P.TopK):
        return ops.TopKOp(node, _compile_node(node.child, ctx))
    if isinstance(node, P.Limit):
        return ops.LimitOp(node, _compile_node(node.child, ctx))
    if isinstance(node, P.Window):
        return WindowOp(node, _compile_node(node.child, ctx))
    if isinstance(node, P.Distinct):
        return ops.DistinctOp(node, _compile_node(node.child, ctx))
    if isinstance(node, P.Sample):
        return ops.SampleOp(node, _compile_node(node.child, ctx))
    if isinstance(node, P.Fill):
        return ops.FillOp(node, _compile_node(node.child, ctx))
    if isinstance(node, P.Union):
        return ops.UnionOp(node, [_compile_node(c, ctx)
                                  for c in node.children])
    if isinstance(node, P.FulltextTopK):
        from matrixone_tpu_torch.vm.fulltext_scan import FulltextTopKOp
        return FulltextTopKOp(node, ctx)
    if isinstance(node, P.VectorTopK):
        from matrixone_tpu_torch.vm.vector_scan import VectorTopKOp
        return VectorTopKOp(node, ctx)
    if isinstance(node, P.Join):
        return JoinOp(node, _compile_node(node.left, ctx),
                      _compile_node(node.right, ctx), ctx=ctx)
    if isinstance(node, P.UdfAggregate):
        return ops.UdfAggregateOp(node, _compile_node(node.child, ctx),
                                  ctx.device)
    if isinstance(node, P.Materialized):
        return ops.MaterializedOp(node, ctx)
    raise NotImplementedError(
        f"compile: unknown plan node {type(node).__name__}")
