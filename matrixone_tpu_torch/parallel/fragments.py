"""Where a plan splits for distributed execution: the planning half.

The port of the planning half of `matrixone_tpu/parallel/fragments.py`
(reference analogue: the compiler's Magic: Remote decision,
`compile/types.go:162`): `plan_split` finds the fragment below the
uppers (Project, TopK, Sort, Limit, Filter, Distinct) that can run once
per shard — a partial aggregate, a local top-k, or an inner join of two
big scans — and the scan whose rows partition it; `_collect_arrays`
brings a fragment's output rows to the host; `_rebuild_uppers` puts the
uppers back over the merged result.  The device-shard executor
(`parallel/dist_query.py`) runs the fragment once per slot of the mesh.

The peer half of the reference's module (its fragment server, the peer
pool, the shuffle store and Arrow IPC transport) is a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from matrixone_tpu_torch.container.batch import from_device
from matrixone_tpu_torch.ops import filter as F
from matrixone_tpu_torch.sql import plan as P
from matrixone_tpu_torch.sql.parser import BASIC_AGGS, STDDEV_AGGS
from matrixone_tpu_torch.sql.serde import plan_to_json

# the second-moment family distributes too: its sum/sumsq/count fields
# merge by addition, as the classic five's do
_ALLOWED_AGGS = BASIC_AGGS | STDDEV_AGGS


def _to_host(ex, schema):
    db = F.compact(ex.batch, ex.mask, ex.padded_len)
    return from_device(db, ex.dicts, schema=dict(schema))


def _collect_arrays(op, schema):
    """The fragment's output rows as HOST arrays (strings decoded through
    each batch's dictionary).  -> (arrays, valid, n_total); empty dicts
    when there are no rows.  Every batch leaves the device before the
    next is pulled, so a batch that is a graph's output is read before
    the graph replays."""
    parts: List[dict] = []
    vparts: List[dict] = []
    n_total = 0
    for ex in op.execute():
        host = _to_host(ex, schema)
        n = len(host)
        if n == 0:
            continue
        n_total += n
        arrays, valid = {}, {}
        for name, dtype in schema:
            vec = host.columns[name]
            if dtype.is_varlen:
                arrays[name] = vec.to_pylist()
            else:
                arrays[name] = np.asarray(vec.data)
            valid[name] = np.asarray(vec.valid_mask())
        parts.append(arrays)
        vparts.append(valid)
    if not parts:
        return {}, {}, 0
    arrays, valid = {}, {}
    for name, dtype in schema:
        if dtype.is_varlen:
            merged: List[Optional[str]] = []
            for p in parts:
                merged.extend(p[name])
            arrays[name] = merged
        else:
            arrays[name] = np.concatenate([p[name] for p in parts])
        valid[name] = np.concatenate([v[name] for v in vparts])
    return arrays, valid, n_total


_UPPER = (P.Project, P.TopK, P.Sort, P.Limit, P.Filter, P.Distinct)


@dataclasses.dataclass
class _Split:
    kind: str                    # "agg" | "topk" | "join"
    uppers: List[P.PlanNode]     # nodes above the split, root first
    split: P.PlanNode            # the Aggregate / TopK / Join at the split
    scan_path: List[str]         # attr path from fragment child to scan
    scan_table: str
    # shuffle join only: the build (right) side's own sharded scan
    right_path: Optional[List[str]] = None
    right_table: Optional[str] = None


def _find_scan_path(node) -> Optional[Tuple[List[str], str]]:
    """Path of child attrs from `node` down to a scan that is on the
    probe (left) side of every join on the way: the side whose row
    partition partitions the join output."""
    path: List[str] = []
    cur = node
    while True:
        if isinstance(cur, P.Scan):
            return path, cur.table
        if isinstance(cur, (P.Filter, P.Project)):
            path.append("child")
            cur = cur.child
            continue
        if isinstance(cur, P.Join):
            if cur.kind == "full":
                return None      # build-side unmatched rows are not
            path.append("left")  # partitioned by the probe's shard
            cur = cur.left
            continue
        return None


def _has_full_join(node) -> bool:
    if isinstance(node, P.Join):
        if node.kind == "full":
            return True
        return _has_full_join(node.left) or _has_full_join(node.right)
    c = getattr(node, "child", None)
    if c is not None:
        return _has_full_join(c)
    return False


def _serializable(*nodes) -> bool:
    try:
        for n in nodes:
            plan_to_json(n)
    except TypeError:
        return False
    return True


def plan_split(node, catalog, min_rows: int = 0) -> Optional[_Split]:
    """Whether and where to distribute `node`.  None -> run local."""
    uppers: List[P.PlanNode] = []
    cur = node
    topk_at: Optional[int] = None
    while isinstance(cur, _UPPER):
        if isinstance(cur, P.TopK) and topk_at is None:
            topk_at = len(uppers)
        uppers.append(cur)
        cur = cur.child
    if isinstance(cur, P.Aggregate):
        aggs = cur.aggs
        if any(a.distinct for a in aggs):
            return None
        if any(a.func not in _ALLOWED_AGGS for a in aggs):
            return None
        if any(a.arg is not None and (a.arg.dtype.is_varlen
                                      or a.arg.dtype.is_vector)
               for a in aggs):
            return None
        if _has_full_join(cur.child):
            return None
        found = _find_scan_path(cur.child)
        if found is None:
            return None
        path, table = found
        if not _table_big_enough(catalog, table, min_rows):
            return None
        if not _serializable(cur.child):
            return None
        return _Split("agg", uppers, cur, path, table)
    if topk_at is not None:
        tk = uppers[topk_at]
        if any(k.dtype.is_varlen for k in tk.keys):
            return None
        if _has_full_join(tk.child):
            return None
        found = _find_scan_path(tk.child)
        if found is None:
            return None
        path, table = found
        if not _table_big_enough(catalog, table, min_rows):
            return None
        if not _serializable(tk):
            return None
        return _Split("topk", uppers[:topk_at], tk, path, table)
    # shuffle join (reference: plan/shuffle.go + colexec/shuffle): both
    # sides big, so both are hash-repartitioned by the join key and each
    # bucket joins locally
    if isinstance(cur, P.Join) and cur.kind == "inner" \
            and cur.left_keys and not cur.residual:
        from matrixone_tpu_torch.sql.expr import BoundCol
        if not all(isinstance(k, BoundCol)
                   for k in cur.left_keys + cur.right_keys):
            return None
        lf = _scan_only_path(cur.left)
        rf = _scan_only_path(cur.right)
        if lf is None or rf is None:
            return None
        (lpath, ltab), (rpath, rtab) = lf, rf
        if not (_table_big_enough(catalog, ltab, min_rows)
                and _table_big_enough(catalog, rtab, min_rows)):
            return None
        if not _serializable(cur.left, cur.right):
            return None
        return _Split("join", uppers, cur, lpath, ltab,
                      right_path=rpath, right_table=rtab)
    return None


def _scan_only_path(node) -> Optional[Tuple[List[str], str]]:
    """Scan path through Filter/Project ONLY (no joins below): each
    shuffle side must be a single sharded table scan subtree."""
    path: List[str] = []
    cur = node
    while True:
        if isinstance(cur, P.Scan):
            return path, cur.table
        if isinstance(cur, (P.Filter, P.Project)):
            path.append("child")
            cur = cur.child
            continue
        return None


def _table_big_enough(catalog, table: str, min_rows: int) -> bool:
    try:
        t = catalog.get_table(table)
        return t.n_rows >= min_rows
    except Exception:          # noqa: BLE001  (e.g. an external table)
        return False


def _rebuild_uppers(uppers: List[P.PlanNode], leaf: P.PlanNode):
    node = leaf
    for up in reversed(uppers):
        node = dataclasses.replace(up, child=node)
    return node
