"""Plan -> operator tree (reference: pkg/sql/compile/compile.go:670
compileScope, collapsed: one process, one pipeline per plan).

The port of the per-operator path of `matrixone_tpu/vm/compile.py` (the
JAX package's `MO_PLAN_FUSION=0`): no fusion pass.  Every AggOp gets
`use_pallas=True`, which is what the reference resolves on its TPU
(`HK.enabled()`), so float32 grouped sums take the segment-sum kernel
exactly where the reference's do.
"""

from __future__ import annotations

from matrixone_tpu_torch.sql import plan as P
from matrixone_tpu_torch.vm import operators as ops
from matrixone_tpu_torch.vm.join import JoinOp
from matrixone_tpu_torch.vm.process import ExecContext


def compile_plan(node: P.PlanNode, ctx) -> ops.Operator:
    if not isinstance(ctx, ExecContext):
        ctx = ExecContext(catalog=ctx)
    return _compile_node(node, ctx)


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
        return ops.AggOp(node, _compile_node(node.child, ctx), ctx,
                         use_pallas=True)
    if isinstance(node, P.Sort):
        return ops.SortOp(node, _compile_node(node.child, ctx))
    if isinstance(node, P.TopK):
        return ops.TopKOp(node, _compile_node(node.child, ctx))
    if isinstance(node, P.Limit):
        return ops.LimitOp(node, _compile_node(node.child, ctx))
    if isinstance(node, P.Join):
        return JoinOp(node, _compile_node(node.left, ctx),
                      _compile_node(node.right, ctx), ctx=ctx)
    raise NotImplementedError(
        f"compile: {type(node).__name__} is not ported yet (ROADMAP.md, "
        f"section A)")
