"""Bound (typed) expressions — the planner/executor IR.

Reference analogue: the protobuf `plan.Expr` tree (`proto/plan.proto`) +
function overload resolution (`pkg/sql/plan/function`). Here an expression
is a small Python tree with a resolved DType; the vm layer compiles it to
jnp kernel calls (ops.scalar) over DeviceBatch columns — an expression tree
evaluates as ONE fused XLA computation, where the reference interprets it
per-operator (`colexec/evalExpression.go`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from matrixone_tpu_torch.container.dtypes import BOOL, DType


class BoundExpr:
    dtype: DType


@dataclasses.dataclass
class BoundCol(BoundExpr):
    name: str          # column name in the child's schema
    dtype: DType


@dataclasses.dataclass
class BoundLiteral(BoundExpr):
    value: object
    dtype: DType


@dataclasses.dataclass
class BoundFunc(BoundExpr):
    op: str            # kernel name: add/sub/mul/div/mod/eq/lt/.../and/or/not
    args: List[BoundExpr]
    dtype: DType


@dataclasses.dataclass
class BoundUdfCall(BoundExpr):
    """A resolved user-defined function call. The definition is SNAPSHOT
    at bind time (body + hash ride the expression), so a cached plan
    executes the body it was bound against — DROP/REPLACE invalidates
    through ddl_gen, never by mutating in-flight plans."""
    name: str
    args: List[BoundExpr]
    dtype: DType                  # declared RETURNS type
    body: str
    arg_names: List[str]
    arg_types: List[DType]        # declared argument types
    body_hash: str
    deterministic: bool = True
    vectorized: bool = True
    is_aggregate: bool = False


@dataclasses.dataclass
class BoundCast(BoundExpr):
    arg: BoundExpr
    dtype: DType


@dataclasses.dataclass
class BoundCase(BoundExpr):
    whens: List[Tuple[BoundExpr, BoundExpr]]
    else_: Optional[BoundExpr]
    dtype: DType


@dataclasses.dataclass
class BoundInList(BoundExpr):
    arg: BoundExpr
    values: List[object]     # python literals
    negated: bool
    dtype: DType


@dataclasses.dataclass
class BoundIsNull(BoundExpr):
    arg: BoundExpr
    negated: bool
    dtype: DType


@dataclasses.dataclass
class BoundLike(BoundExpr):
    arg: BoundExpr           # varchar column (dict codes on device)
    pattern: str
    negated: bool
    dtype: DType


@dataclasses.dataclass
class AggCall:
    func: str                # sum | count | avg | min | max
    arg: Optional[BoundExpr]  # None for count(*)
    distinct: bool
    dtype: DType             # result type
    out_name: str = ""


def walk(e: BoundExpr):
    yield e
    for child in getattr(e, "args", []) or []:
        yield from walk(child)
    if isinstance(e, BoundCast):
        yield from walk(e.arg)
    if isinstance(e, (BoundInList, BoundIsNull, BoundLike)):
        yield from walk(e.arg)
    if isinstance(e, BoundCase):
        for c, v in e.whens:
            yield from walk(c)
            yield from walk(v)
        if e.else_ is not None:
            yield from walk(e.else_)


def columns_used(e: BoundExpr) -> List[str]:
    return [n.name for n in walk(e) if isinstance(n, BoundCol)]


def and_all(cs: List[BoundExpr]) -> BoundExpr:
    """Fold conjuncts into one left-deep AND tree (canonical helper for
    binder pushdown / CBO residual re-attachment)."""
    e = cs[0]
    for c in cs[1:]:
        e = BoundFunc("and", [e, c], BOOL)
    return e
