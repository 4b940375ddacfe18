"""Table partitioning: spec, row assignment, and partition pruning.

The port's copy of `matrixone_tpu/storage/partition.py` (numpy only).
Reference analogue: `pkg/partitionservice` (DDL + per-partition storage
management) and `pkg/partitionprune` (filter -> partition set at plan
time). Redesign: partitions are a property of SEGMENTS — the commit
pipeline splits every insert batch so one segment holds exactly one
partition's rows, so pruning is a structural per-segment skip in
`iter_chunks` (riding the same path as zonemap pruning, and composing
with the CBO's runtime join filters), and TRUNCATE PARTITION is a
plain tombstone commit over the partition's segments (MVCC/time-travel
preserved).

Partition keys are int-backed columns (ints, DATE as epoch days,
DECIMAL64 as scaled int64). RANGE bounds are half-open [lo, hi) in raw
units with an optional MAXVALUE tail; NULL keys land in partition 0
(MySQL's convention). HASH uses the engine-wide splitmix64 so the
assignment matches the device-side hash kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import numpy as np

from matrixone_tpu_torch import native
from matrixone_tpu_torch.sql.expr import (BoundCol, BoundFunc, BoundInList,
                                    BoundLiteral)


@dataclasses.dataclass
class PartitionSpec:
    kind: str                      # 'range' | 'hash'
    column: str
    names: List[str]               # partition names, index = part_id
    # range only: upper bounds (exclusive, raw units); None = MAXVALUE
    bounds: List[Optional[int]] = dataclasses.field(default_factory=list)

    @property
    def n_parts(self) -> int:
        return len(self.names)

    def to_json(self) -> dict:
        return {"kind": self.kind, "column": self.column,
                "names": self.names, "bounds": self.bounds}

    @staticmethod
    def from_json(d: Optional[dict]) -> "Optional[PartitionSpec]":
        if d is None:
            return None
        return PartitionSpec(d["kind"], d["column"], list(d["names"]),
                             [b for b in d.get("bounds", [])])


class PartitionError(ValueError):
    pass


def build_spec(raw: dict, schema) -> PartitionSpec:
    """Validate a parsed PARTITION BY clause against the table schema and
    convert bounds to raw storage units (DATE strings -> epoch days,
    DECIMAL -> scaled ints)."""
    import datetime
    from matrixone_tpu_torch.container.dtypes import TypeOid
    col = raw["column"]
    sd = dict(schema)
    if col not in sd:
        raise PartitionError(f"unknown partition column {col!r}")
    d = sd[col]
    int_like = d.is_integer or d.oid in (TypeOid.DATE, TypeOid.DECIMAL64)
    if not int_like or d.is_varlen:
        raise PartitionError(
            f"partition column {col!r} must be an int-backed type "
            f"(int/date/decimal), got {d}")

    def to_raw(b):
        if isinstance(b, str):
            if d.oid != TypeOid.DATE:
                raise PartitionError(
                    f"string bound {b!r} on non-DATE partition column")
            day = datetime.date.fromisoformat(b)
            return (day - datetime.date(1970, 1, 1)).days
        if d.oid == TypeOid.DECIMAL64:
            return round(b * 10 ** d.scale)
        return int(b)

    if raw["kind"] == "hash":
        n = int(raw["n"])
        return PartitionSpec("hash", col, [f"p{i}" for i in range(n)])
    names, bounds = [], []
    for pname, b in raw["parts"]:
        names.append(pname)
        bounds.append(None if b is None else to_raw(b))
    if len(set(names)) != len(names):
        raise PartitionError("duplicate partition names")
    for a, b in zip(bounds, bounds[1:]):
        if a is None or (b is not None and b <= a):
            raise PartitionError(
                "RANGE partition bounds must be strictly increasing "
                "(MAXVALUE last)")
    return PartitionSpec("range", col, names, bounds)


def assign_partitions(spec: PartitionSpec, keys: np.ndarray,
                      validity: np.ndarray) -> np.ndarray:
    """part_id per row. NULL -> 0; RANGE overflow raises (MySQL errors
    when no MAXVALUE partition catches the row)."""
    keys = np.asarray(keys, np.int64)
    if spec.kind == "hash":
        pid = (native.hash64(keys)
               % np.uint64(spec.n_parts)).astype(np.int64)
    else:
        ends = np.array([np.iinfo(np.int64).max if b is None else b
                         for b in spec.bounds], np.int64)
        pid = np.searchsorted(ends, keys, side="right")
        over = validity & (pid >= spec.n_parts)
        if over.any():
            v = int(keys[over][0])
            raise PartitionError(
                f"value {v} is out of range for RANGE partitions of "
                f"column {spec.column!r} (no MAXVALUE partition)")
        pid = np.minimum(pid, spec.n_parts - 1)
    pid = np.where(validity, pid, 0)
    return pid.astype(np.int64)


def split_by_partition(spec: PartitionSpec, arrays: Dict[str, np.ndarray],
                       validity: Dict[str, np.ndarray]):
    """Yield (part_id, arrays, validity) with rows routed to partitions,
    preserving input order within each partition."""
    key = arrays[spec.column]
    val = validity[spec.column]
    pid = assign_partitions(spec, key, val)
    for p in np.unique(pid):
        sel = pid == p
        if not sel.any():
            continue
        yield int(p), {c: a[sel] for c, a in arrays.items()}, \
            {c: v[sel] for c, v in validity.items()}


def prune(spec: PartitionSpec, filters, qmap: Dict[str, str]
          ) -> Optional[Set[int]]:
    """Partition ids that can contain rows satisfying the conjunctive
    `filters` (plan/runtime BoundExprs over qualified names). Returns
    None when nothing prunes. Conservative: unknown predicate shapes
    keep all partitions."""
    allowed: Optional[Set[int]] = None
    for f in filters or []:
        s = _prune_one(spec, f, qmap)
        if s is None:
            continue
        allowed = s if allowed is None else (allowed & s)
    return allowed


def _raw_col(name: str, qmap: Dict[str, str]) -> str:
    return qmap.get(name, name.split(".")[-1])


def _lit_raw(lit: BoundLiteral, col_dtype):
    """Literal in the partition key's raw domain.  Fractional floats are
    returned as-is (NOT truncated): int(10.5)->10 would let `col < 10.5`
    prune the partition holding col=10 — interval tests below run fine in
    the float domain."""
    v = lit.value
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    from matrixone_tpu_torch.container.dtypes import TypeOid
    if col_dtype is not None and col_dtype.oid == TypeOid.DECIMAL64:
        ls = lit.dtype.scale if lit.dtype.oid == TypeOid.DECIMAL64 else 0
        if lit.dtype.oid == TypeOid.DECIMAL64 or lit.dtype.is_integer:
            return int(v * 10 ** (col_dtype.scale - ls))
        return None
    if lit.dtype.oid == TypeOid.DECIMAL64 and (lit.dtype.scale or 0) > 0:
        # decimal literal against an INTEGER partition column: descale the
        # stored scaled-int (18.5 arrives as 185 @ scale 1); a raw int(v)
        # here compared 185 against the partition bounds
        fv = v / (10 ** lit.dtype.scale)
        return int(fv) if float(fv).is_integer() else fv
    if isinstance(v, float) and not v.is_integer():
        return v
    return int(v)


def _prune_one(spec: PartitionSpec, f, qmap, col_dtype=None
               ) -> Optional[Set[int]]:
    nparts = spec.n_parts
    if isinstance(f, BoundInList) and not f.negated \
            and isinstance(f.arg, BoundCol) \
            and _raw_col(f.arg.name, qmap) == spec.column:
        out: Set[int] = set()
        for v in f.values:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return None
            if isinstance(v, float) and not v.is_integer():
                continue                   # no integer key equals 10.5
            out |= _point(spec, int(v))
        return out
    if not (isinstance(f, BoundFunc)
            and f.op in ("eq", "lt", "le", "gt", "ge")
            and len(f.args) == 2):
        return None
    a, b = f.args
    op = f.op
    if isinstance(b, BoundCol) and isinstance(a, BoundLiteral):
        a, b = b, a
        op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}[op]
    if not (isinstance(a, BoundCol) and isinstance(b, BoundLiteral)):
        return None
    if _raw_col(a.name, qmap) != spec.column:
        return None
    lv = _lit_raw(b, a.dtype)
    if lv is None:
        return None
    if spec.kind == "hash":
        if op == "eq" and isinstance(lv, int):
            return _point(spec, lv)
        return None                        # fractional eq: no int matches;
    #                                        conservative keep-all is safe
    # range: map the predicate interval onto partition intervals; all
    # comparisons are valid with lv int OR fractional float (partition
    # members are the ints in [lo, hi), so "some x > lv" ⟺ hi-1 > lv)
    ends = [np.iinfo(np.int64).max if e is None else e for e in spec.bounds]
    starts = [np.iinfo(np.int64).min] + ends[:-1]
    out = set()
    for i in range(nparts):
        lo, hi = starts[i], ends[i]       # partition covers [lo, hi)
        if op == "eq":
            ok = lo <= lv < hi
        elif op == "lt":
            ok = lo < lv                   # some x in [lo,hi) with x < lv
        elif op == "le":
            ok = lo <= lv
        elif op == "gt":
            ok = hi - 1 > lv               # some x in [lo,hi) with x > lv
        else:                              # ge
            ok = hi - 1 >= lv
        if ok:
            out.add(i)
    return out


def _point(spec: PartitionSpec, v: int) -> Set[int]:
    pid = assign_partitions(spec, np.array([v], np.int64),
                            np.array([True]))
    return {int(pid[0])}
