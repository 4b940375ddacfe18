"""JSON serialization of bound expressions and plan fragments.

The port of `matrixone_tpu/sql/serde.py` (reference analogue:
`compile/remoterun.go:86 encodeScope`), written to give the same JSON
for the same bound plan.  The device-shard executor
(`parallel/dist_query.py`) clones a fragment once per shard through it
(`plan_to_json`, then `plan_from_json` per shard), and it is the wire
format a host-peer executor would ship.
"""

from __future__ import annotations

from typing import List

from matrixone_tpu_torch.container.dtypes import DType, TypeOid
from matrixone_tpu_torch.sql.expr import (AggCall, BoundCase, BoundCast, BoundCol,
                                    BoundExpr, BoundFunc, BoundInList,
                                    BoundIsNull, BoundLike, BoundLiteral,
                                    BoundUdfCall)


def dtype_to_json(d: DType) -> list:
    return [d.oid.value, d.width, d.scale, d.dim]


def dtype_from_json(v: list) -> DType:
    return DType(TypeOid(v[0]), width=v[1], scale=v[2], dim=v[3])


def expr_to_json(e: BoundExpr) -> dict:
    if isinstance(e, BoundCol):
        return {"t": "col", "name": e.name, "dtype": dtype_to_json(e.dtype)}
    if isinstance(e, BoundLiteral):
        return {"t": "lit", "value": e.value, "dtype": dtype_to_json(e.dtype)}
    if isinstance(e, BoundFunc):
        return {"t": "func", "op": e.op,
                "args": [expr_to_json(a) for a in e.args],
                "dtype": dtype_to_json(e.dtype)}
    if isinstance(e, BoundCast):
        return {"t": "cast", "arg": expr_to_json(e.arg),
                "dtype": dtype_to_json(e.dtype)}
    if isinstance(e, BoundCase):
        return {"t": "case",
                "whens": [[expr_to_json(c), expr_to_json(v)]
                          for c, v in e.whens],
                "else": expr_to_json(e.else_) if e.else_ is not None else None,
                "dtype": dtype_to_json(e.dtype)}
    if isinstance(e, BoundInList):
        return {"t": "in", "arg": expr_to_json(e.arg), "values": e.values,
                "negated": e.negated, "dtype": dtype_to_json(e.dtype)}
    if isinstance(e, BoundIsNull):
        return {"t": "isnull", "arg": expr_to_json(e.arg),
                "negated": e.negated, "dtype": dtype_to_json(e.dtype)}
    if isinstance(e, BoundLike):
        return {"t": "like", "arg": expr_to_json(e.arg),
                "pattern": e.pattern, "negated": e.negated,
                "dtype": dtype_to_json(e.dtype)}
    if isinstance(e, BoundUdfCall):
        # the DEFINITION ships with the call (body + hash): the peer
        # evaluates exactly the body this plan was bound against, no
        # catalog round-trip (pkg/udf pythonservice request shape)
        return {"t": "udf", "name": e.name,
                "args": [expr_to_json(a) for a in e.args],
                "dtype": dtype_to_json(e.dtype), "body": e.body,
                "arg_names": list(e.arg_names),
                "arg_types": [dtype_to_json(t) for t in e.arg_types],
                "body_hash": e.body_hash,
                "deterministic": e.deterministic,
                "vectorized": e.vectorized,
                "is_aggregate": e.is_aggregate}
    raise TypeError(f"cannot serialize {type(e).__name__}")


def expr_from_json(d: dict) -> BoundExpr:
    t = d["t"]
    dt_ = dtype_from_json(d["dtype"])
    if t == "col":
        return BoundCol(d["name"], dt_)
    if t == "lit":
        return BoundLiteral(d["value"], dt_)
    if t == "func":
        return BoundFunc(d["op"], [expr_from_json(a) for a in d["args"]], dt_)
    if t == "cast":
        return BoundCast(expr_from_json(d["arg"]), dt_)
    if t == "case":
        return BoundCase([(expr_from_json(c), expr_from_json(v))
                          for c, v in d["whens"]],
                         expr_from_json(d["else"]) if d["else"] else None,
                         dt_)
    if t == "in":
        return BoundInList(expr_from_json(d["arg"]), d["values"],
                           d["negated"], dt_)
    if t == "isnull":
        return BoundIsNull(expr_from_json(d["arg"]), d["negated"], dt_)
    if t == "like":
        return BoundLike(expr_from_json(d["arg"]), d["pattern"],
                         d["negated"], dt_)
    if t == "udf":
        return BoundUdfCall(
            d["name"], [expr_from_json(a) for a in d["args"]], dt_,
            d["body"], list(d["arg_names"]),
            [dtype_from_json(x) for x in d["arg_types"]],
            d["body_hash"], d.get("deterministic", True),
            d.get("vectorized", True), d.get("is_aggregate", False))
    raise TypeError(f"cannot deserialize expr kind {t}")


def agg_to_json(a: AggCall) -> dict:
    return {"func": a.func,
            "arg": expr_to_json(a.arg) if a.arg is not None else None,
            "distinct": a.distinct, "dtype": dtype_to_json(a.dtype),
            "out_name": a.out_name}


def agg_from_json(d: dict) -> AggCall:
    return AggCall(d["func"],
                   expr_from_json(d["arg"]) if d["arg"] else None,
                   d["distinct"], dtype_from_json(d["dtype"]),
                   d["out_name"])


# --------------------------------------------------------------- plans
# Operator-subtree shipping (reference: compile/remoterun.go:86
# encodeScope + proto/pipeline.proto:529 — protobuf scopes to peer CNs;
# here: JSON plan fragments to peer CN fragment servers).

def schema_cols_to_json(schema) -> list:
    return [[n, dtype_to_json(d)] for n, d in schema]


def schema_cols_from_json(rows) -> list:
    return [(n, dtype_from_json(d)) for n, d in rows]


def plan_to_json(node) -> dict:
    from matrixone_tpu_torch.sql import plan as P
    s = {"schema": schema_cols_to_json(node.schema)}
    if isinstance(node, P.Scan):
        return {**s, "t": "scan", "table": node.table,
                "columns": list(node.columns),
                "filters": [expr_to_json(f) for f in node.filters],
                "as_of_ts": node.as_of_ts, "shard": node.shard,
                "hash_shard": list(node.hash_shard)
                if node.hash_shard else None}
    if isinstance(node, P.Filter):
        return {**s, "t": "filter", "child": plan_to_json(node.child),
                "pred": expr_to_json(node.pred)}
    if isinstance(node, P.Project):
        return {**s, "t": "project", "child": plan_to_json(node.child),
                "exprs": [expr_to_json(e) for e in node.exprs]}
    if isinstance(node, P.Aggregate):
        return {**s, "t": "aggregate", "child": plan_to_json(node.child),
                "group_keys": [expr_to_json(k) for k in node.group_keys],
                "aggs": [agg_to_json(a) for a in node.aggs]}
    if isinstance(node, P.Sort):
        return {**s, "t": "sort", "child": plan_to_json(node.child),
                "keys": [expr_to_json(k) for k in node.keys],
                "descendings": list(node.descendings)}
    if isinstance(node, P.TopK):
        return {**s, "t": "topk", "child": plan_to_json(node.child),
                "keys": [expr_to_json(k) for k in node.keys],
                "descendings": list(node.descendings),
                "k": node.k, "offset": node.offset}
    if isinstance(node, P.Limit):
        return {**s, "t": "limit", "child": plan_to_json(node.child),
                "n": node.n, "offset": node.offset}
    if isinstance(node, P.Join):
        return {**s, "t": "join", "kind": node.kind,
                "left": plan_to_json(node.left),
                "right": plan_to_json(node.right),
                "left_keys": [expr_to_json(k) for k in node.left_keys],
                "right_keys": [expr_to_json(k) for k in node.right_keys],
                "residual": (expr_to_json(node.residual)
                             if node.residual is not None else None)}
    if isinstance(node, P.Distinct):
        return {**s, "t": "distinct", "child": plan_to_json(node.child)}
    if isinstance(node, P.Values):
        return {**s, "t": "values", "rows": node.rows}
    raise TypeError(f"cannot serialize plan node {type(node).__name__}")


def plan_from_json(d: dict):
    from matrixone_tpu_torch.sql import plan as P
    t = d["t"]
    schema = schema_cols_from_json(d["schema"])
    if t == "scan":
        return P.Scan(d["table"], list(d["columns"]), schema,
                      filters=[expr_from_json(f) for f in d["filters"]],
                      as_of_ts=d.get("as_of_ts"),
                      shard=tuple(d["shard"]) if d.get("shard") else None,
                      hash_shard=(d["hash_shard"][0],
                                  int(d["hash_shard"][1]),
                                  int(d["hash_shard"][2]))
                      if d.get("hash_shard") else None)
    if t == "filter":
        return P.Filter(plan_from_json(d["child"]),
                        expr_from_json(d["pred"]), schema)
    if t == "project":
        return P.Project(plan_from_json(d["child"]),
                         [expr_from_json(e) for e in d["exprs"]], schema)
    if t == "aggregate":
        return P.Aggregate(plan_from_json(d["child"]),
                           [expr_from_json(k) for k in d["group_keys"]],
                           [agg_from_json(a) for a in d["aggs"]], schema)
    if t == "sort":
        return P.Sort(plan_from_json(d["child"]),
                      [expr_from_json(k) for k in d["keys"]],
                      list(d["descendings"]), schema)
    if t == "topk":
        return P.TopK(plan_from_json(d["child"]),
                      [expr_from_json(k) for k in d["keys"]],
                      list(d["descendings"]), d["k"], d["offset"], schema)
    if t == "limit":
        return P.Limit(plan_from_json(d["child"]), d["n"], d["offset"],
                       schema)
    if t == "join":
        return P.Join(d["kind"], plan_from_json(d["left"]),
                      plan_from_json(d["right"]),
                      [expr_from_json(k) for k in d["left_keys"]],
                      [expr_from_json(k) for k in d["right_keys"]],
                      (expr_from_json(d["residual"])
                       if d.get("residual") else None), schema)
    if t == "distinct":
        return P.Distinct(plan_from_json(d["child"]), schema)
    if t == "values":
        return P.Values(d["rows"], schema)
    raise TypeError(f"cannot deserialize plan kind {t}")
