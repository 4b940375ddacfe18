"""Physical operators: host-driven loops over device batches.

The port of the per-operator path of `matrixone_tpu/vm/operators.py`
(reference analogue: `pkg/sql/colexec` + the `vm.Operator` pull loop):
Scan (pushed filters, zonemap pruning and the runtime filters joins
inject), Values, Filter, Project, the streaming grouped and scalar
aggregate, Sort, TopK and Limit.  Operators yield ExecBatch (device
tensors + mask): filters produce masks, not compacted rows; group-by is
the sort/segment kernel (ops/agg) with a streaming partial merge into a
bounded device-resident group table.

Not ported yet (ROADMAP.md, section A): the dense small-key aggregate
(the TPC-H Q1 shape; it raises rather than run the general path, whose
float sums would differ from the reference's f64 dense sums), the
aggregate's host spill past `max_device_groups`, UNION, DISTINCT,
SAMPLE, FILL, aggregate UDFs, and the scan's shard routing and
read-ahead thread.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from matrixone_tpu_torch.container import device as dev
from matrixone_tpu_torch.container import dtypes as dt
from matrixone_tpu_torch.container.device import (DeviceBatch, DeviceColumn,
                                                  bucket_length)
from matrixone_tpu_torch.container.dtypes import DType, TypeOid
from matrixone_tpu_torch.ops import agg as A, encodings as ENC
from matrixone_tpu_torch.ops import filter as F, sort as msort
from matrixone_tpu_torch.sql import plan as P
from matrixone_tpu_torch.sql.expr import AggCall, BoundExpr, BoundLiteral
from matrixone_tpu_torch.sql.parser import BIT_AGGS, STDDEV_AGGS
from matrixone_tpu_torch.vm.exprs import (EvalError, ExecBatch, _dict_of,
                                          eval_expr, lut_gather)


class Operator:
    def execute(self) -> Iterator[ExecBatch]:
        raise NotImplementedError

    schema: List


# ------------------------------------------------------------------- scan

def chunk_to_execbatch(arrays, validity, table_dicts, n, columns, schema,
                       device) -> ExecBatch:
    """Host chunk -> padded device ExecBatch, renaming raw table columns to
    the plan's qualified names and tagging varlen columns."""
    qnames = [nm for nm, _ in schema]
    arr2, val2, dicts2, dtypes = {}, {}, {}, {}
    for qn, col, dtype in zip(qnames, columns, [d for _, d in schema]):
        arr2[qn] = arrays[col]
        val2[qn] = validity[col]
        dtypes[qn] = dt.INT32 if dtype.is_varlen else dtype
        if col in table_dicts:
            dicts2[qn] = table_dicts[col]
            # narrow dict codes to the smallest signed width the
            # dictionary fits (lossless — hash/compare/gather are
            # width-invariant); from_numpy preserves the narrow dtype
            arr2[qn] = ENC.narrow_codes(arr2[qn], len(table_dicts[col]))
    db = dev.from_numpy(arr2, dtypes, val2, n_rows=n, device=device)
    for qn, (_, dtype) in zip(qnames, schema):
        if dtype.is_varlen:
            c = db.columns[qn]
            db.columns[qn] = DeviceColumn(c.data, c.validity, dtype)
    return ExecBatch(batch=db, dicts=dicts2, mask=db.row_mask())


class ScanOp(Operator):
    """Table scan with filter pushdown + zonemap chunk pruning
    (reference: colexec/table_scan + readutil block pruning).  Each chunk
    is uploaded to the context's device."""

    def __init__(self, node: P.Scan, relation, ctx,
                 batch_rows: int = 1 << 20):
        if node.shard is not None or node.hash_shard is not None:
            raise NotImplementedError(
                "sharded scans are not ported yet (ROADMAP.md, section A)")
        self.node = node
        self.rel = relation
        self.batch_rows = batch_rows
        self.schema = node.schema
        self.ctx = ctx
        # filters injected at run time by upstream joins (build-side key
        # ranges — reference: vm/message/runtimeFilterMsg.go); they ride
        # the same zonemap-pruning + early-mask path as planned filters
        self.runtime_filters: List[BoundExpr] = []

    def execute(self) -> Iterator[ExecBatch]:
        read_args = self.ctx.table_read_args(self.node.table)
        if self.node.as_of_ts is not None:
            # time travel: a historical read, independent of the txn view
            read_args = {"snapshot_ts": self.node.as_of_ts}
        filters = self.node.filters + self.runtime_filters
        batch_rows = int((self.ctx.variables or {}).get("batch_rows",
                                                        self.batch_rows))
        qnames = [n for n, _ in self.node.schema]
        device = self.ctx.device
        for arrays, validity, dicts, n in self.rel.iter_chunks(
                self.node.columns, batch_rows, filters=filters,
                qualified_names=qnames, **read_args):
            ex = chunk_to_execbatch(arrays, validity, dicts, n,
                                    self.node.columns, self.node.schema,
                                    device)
            # evaluate pushed filters as an early mask (zonemap pruning
            # already dropped fully-excluded chunks host-side)
            for f in filters:
                pred = eval_expr(f, ex)
                ex.mask = ex.mask & F.predicate_mask(pred, ex.batch)
            yield ex


class ValuesOp(Operator):
    def __init__(self, node: P.Values, ctx):
        self.node = node
        self.schema = node.schema
        self.ctx = ctx

    def execute(self) -> Iterator[ExecBatch]:
        arrays, dtypes = {}, {}
        for i, (name, dtype) in enumerate(self.node.schema):
            vals = [row[i] for row in self.node.rows]
            arrays[name] = np.asarray(vals, dtype=dtype.np_dtype)
            dtypes[name] = dtype
        db = dev.from_numpy(arrays, dtypes, n_rows=len(self.node.rows),
                            device=self.ctx.device)
        yield ExecBatch(batch=db, dicts={}, mask=db.row_mask())


# ----------------------------------------------------------------- filter

class FilterOp(Operator):
    def __init__(self, node: P.Filter, child: Operator):
        self.node = node
        self.child = child
        self.schema = node.schema

    def execute(self) -> Iterator[ExecBatch]:
        for ex in self.child.execute():
            pred = eval_expr(self.node.pred, ex)
            ex.mask = ex.mask & F.predicate_mask(pred, ex.batch)
            yield ex


class ProjectOp(Operator):
    def __init__(self, node: P.Project, child: Operator):
        self.node = node
        self.child = child
        self.schema = node.schema

    def execute(self) -> Iterator[ExecBatch]:
        for ex in self.child.execute():
            cols: Dict[str, DeviceColumn] = {}
            dicts: Dict[str, List[str]] = {}
            for (name, dtype), e in zip(self.node.schema, self.node.exprs):
                col = eval_expr(e, ex)
                cols[name] = col
                src_dict = _expr_dict(e, ex)
                if src_dict is not None:
                    dicts[name] = src_dict
            db = DeviceBatch(columns=cols, n_rows=ex.batch.n_rows)
            yield ExecBatch(batch=db, dicts=dicts, mask=ex.mask)


def _expr_dict(e: BoundExpr, ex: ExecBatch):
    if isinstance(e, BoundLiteral) and e.dtype.is_varlen:
        return [str(e.value)]
    return _dict_of(e, ex)


# -------------------------------------------------------------- aggregate

class AggOp(Operator):
    """Streaming group-by: per-batch partial agg folded into a device-
    resident group table (colexec/group + mergegroup, re-expressed).

    The group table grows adaptively (quantized x4, as the reference
    grows its hash table) up to `max_device_groups`.  `use_pallas` is
    the reference's per-call-site routing of float32 grouped sums to the
    segment-sum kernel (vm/compile passes what the reference resolves on
    its TPU: on)."""

    def __init__(self, node: P.Aggregate, child: Operator, ctx,
                 max_groups: int = 4096,
                 max_device_groups: int = 1 << 21,
                 use_pallas: bool = False):
        self.node = node
        self.child = child
        self.ctx = ctx
        self.schema = node.schema
        self.max_groups = max_groups
        self.max_device_groups = max(max_groups, max_device_groups)
        self.use_pallas = use_pallas

    def _grow(self, needed: int) -> None:
        nxt = self.max_groups
        while nxt < needed:
            nxt *= 4
        nxt = min(nxt, self.max_device_groups)
        if nxt < needed:
            raise NotImplementedError(
                f"group count {needed} exceeds the device budget "
                f"({self.max_device_groups}); the aggregate's host spill "
                f"is not ported yet (ROADMAP.md, section A)")
        self.max_groups = nxt

    def execute(self) -> Iterator[ExecBatch]:
        if not self.node.group_keys:
            yield from self._scalar_agg()
            return
        yield from self._grouped_agg()

    # ---- scalar (no GROUP BY)
    def _scalar_agg(self):
        states = [None] * len(self.node.aggs)
        tracker = _AggDictTracker(self.node.aggs)
        for ex in self.child.execute():
            tracker.observe(ex)
            for i, a in enumerate(self.node.aggs):
                states[i] = _scalar_step_host(a, ex, states[i])
        yield self._scalar_result(states, tracker, self.ctx.device)

    def _scalar_result(self, states, tracker, device) -> ExecBatch:
        cols = {}
        out_dicts: Dict[str, list] = {}
        for (name, dtype), a, st in zip(
                self.node.schema[len(self.node.group_keys):],
                self.node.aggs, states):
            col = _scalar_final(a, st, dtype, device)
            d = tracker.dicts.get(a.out_name)
            if d is not None and dtype.is_varlen:
                col = _rank_to_code(col, d, dtype)
                out_dicts[name] = d
            cols[name] = col
        db = DeviceBatch(columns=cols,
                         n_rows=torch.tensor(1, dtype=torch.int32,
                                             device=device))
        return ExecBatch(batch=db, dicts=out_dicts,
                         mask=torch.ones((1,), dtype=torch.bool,
                                         device=device))

    # ---- grouped
    def _grouped_agg(self):
        nkeys = len(self.node.group_keys)
        key_dicts: List[Optional[List[str]]] = [None] * nkeys
        self._agg_tracker = _AggDictTracker(self.node.aggs)
        state = None   # dict: keys:[tensors], kvalid:[tensors], partials per agg
        dense_checked = False
        for ex in self.child.execute():
            self._agg_tracker.observe(ex)
            keys = [eval_expr(k, ex) for k in self.node.group_keys]
            for i, (k_ast, k) in enumerate(zip(self.node.group_keys, keys)):
                d = _expr_dict(k_ast, ex)
                if d is not None:
                    key_dicts[i] = d
            kdata = [_broadcast_full(k, ex.padded_len).data for k in keys]
            kvalid = [_broadcast_full(k, ex.padded_len).validity
                      for k in keys]
            values = [None if (a.func == "count" and a.arg is None)
                      else _agg_value(a, ex) for a in self.node.aggs]
            if not dense_checked:
                dense_checked = True
                self._refuse_dense(ex)
            part = self._partial_vals(kdata, kvalid, ex.mask, values)
            state = part if state is None else self._merge(state, part)
        if state is None:
            state = self._empty_state(self.ctx.device)
        yield self._finalize(state, key_dicts)

    def _refuse_dense(self, ex) -> None:
        """The reference takes its dense small-key path (vm/operators.py
        `_dense_init`) when every key is dictionary-coded or BOOL with a
        small key space and every aggregate is additive; its float sums
        are f64 there.  That path is not ported yet, and running the
        general one instead would not give the reference's numbers."""
        dense_funcs = {"count", "sum", "avg"} | STDDEV_AGGS
        for a in self.node.aggs:
            if a.distinct or a.func not in dense_funcs:
                return
        sizes = []
        for k in self.node.group_keys:
            d = _expr_dict(k, ex)
            if d is not None:
                sizes.append(max(len(d), 1))
            elif k.dtype.oid == TypeOid.BOOL:
                sizes.append(2)
            else:
                return
        g = 1
        for s in sizes:
            g *= s + 1
        n_fields = 1
        for a in self.node.aggs:
            n_fields += (1 if a.func == "count"
                         else 2 if a.func in ("sum", "avg") else 3)
        if g > 256 or g * n_fields > 4096:
            return
        raise NotImplementedError(
            "GROUP BY over small dictionary-coded or BOOL keys takes the "
            "reference's dense accumulator, which is not ported yet "
            "(ROADMAP.md, section A: the TPC-H Q1 slice)")

    def _partial_vals(self, kdata, kvalid, mask, values):
        while True:
            mg = self.max_groups
            gi = A.group_ids(kdata, kvalid, mask, mg)
            ng = int(gi.num_groups)
            if ng <= mg:
                break
            self._grow(ng)
        rep_k, rep_v = A.gather_keys(kdata, kvalid, gi.rep_rows)
        present = torch.arange(mg, dtype=torch.int32,
                               device=mask.device) < gi.num_groups
        partials = []
        for a, v in zip(self.node.aggs, values):
            partials.append(_grouped_step(a, gi, v, mask, mg,
                                          use_pallas=self.use_pallas))
        return {"keys": rep_k, "kvalid": rep_v, "present": present,
                "partials": partials, "n": gi.num_groups}

    def _merge(self, s1, s2):
        """Merge two partial group tables by concatenating their rows and
        re-grouping (mergegroup)."""
        keys = [torch.cat([a, b]) for a, b in zip(s1["keys"], s2["keys"])]
        kvalid = [torch.cat([a, b])
                  for a, b in zip(s1["kvalid"], s2["kvalid"])]
        mask = torch.cat([s1["present"], s2["present"]])
        while True:
            mg = self.max_groups
            gi = A.group_ids(keys, kvalid, mask, mg)
            ng = int(gi.num_groups)
            if ng <= mg:
                break
            self._grow(ng)
        rep_k, rep_v = A.gather_keys(keys, kvalid, gi.rep_rows)
        present = torch.arange(mg, dtype=torch.int32,
                               device=mask.device) < gi.num_groups
        partials = []
        for a, p1, p2 in zip(self.node.aggs, s1["partials"], s2["partials"]):
            partials.append(_grouped_merge(a, p1, p2, gi, mask, mg))
        return {"keys": rep_k, "kvalid": rep_v, "present": present,
                "partials": partials, "n": gi.num_groups}

    def _empty_state(self, device):
        mg = self.max_groups
        keys, kvalid = [], []
        for k in self.node.group_keys:
            keys.append(torch.zeros((mg,), dtype=(
                torch.int32 if k.dtype.is_varlen else k.dtype.torch_dtype),
                device=device))
            kvalid.append(torch.zeros((mg,), dtype=torch.bool,
                                      device=device))
        partials = [_grouped_empty(a, mg, device) for a in self.node.aggs]
        return {"keys": keys, "kvalid": kvalid,
                "present": torch.zeros((mg,), dtype=torch.bool,
                                       device=device),
                "partials": partials,
                "n": torch.tensor(0, dtype=torch.int32, device=device)}

    def _finalize(self, state, key_dicts) -> ExecBatch:
        nkeys = len(self.node.group_keys)
        cols: Dict[str, DeviceColumn] = {}
        dicts: Dict[str, List[str]] = {}
        for i, ((name, dtype), k) in enumerate(zip(self.node.schema[:nkeys],
                                                   self.node.group_keys)):
            cols[name] = DeviceColumn(state["keys"][i], state["kvalid"][i],
                                      k.dtype)
            if key_dicts[i] is not None:
                dicts[name] = key_dicts[i]
        for (name, dtype), a, part in zip(self.node.schema[nkeys:],
                                          self.node.aggs, state["partials"]):
            col = _grouped_final(a, part, dtype)
            d = self._agg_tracker.dicts.get(a.out_name)
            if d is not None and dtype.is_varlen:
                col = _rank_to_code(col, d, dtype)
                dicts[name] = d
            cols[name] = col
        db = DeviceBatch(columns=cols, n_rows=state["n"])
        return ExecBatch(batch=db, dicts=dicts, mask=state["present"])


def _broadcast_full(col: DeviceColumn, n: int) -> DeviceColumn:
    if col.data.shape[0] == n:
        return col
    return DeviceColumn(col.data.expand((n,) + tuple(col.data.shape[1:])),
                        col.validity.expand(n), col.dtype)


# agg kernels: per-batch partial, merge, finalize -------------------------

def _agg_value(a: AggCall, ex: ExecBatch):
    if a.func in ("min", "max") and a.arg.dtype.is_varlen:
        # aggregate over collation ranks so min/max follow string order,
        # not dictionary insertion order; finalize maps rank -> string
        if _expr_dict(a.arg, ex) is None:
            raise EvalError(
                f"{a.func}() over computed strings without a dictionary "
                f"is not supported yet")
        return _broadcast_full(_sort_key_col(a.arg, ex), ex.padded_len)
    col = eval_expr(a.arg, ex)
    return _broadcast_full(col, ex.padded_len)


def _rank_to_code(col: DeviceColumn, d: list, dtype) -> DeviceColumn:
    """Invert collation rank back to a dictionary code (string min/max
    finalize; shared by the scalar and grouped paths)."""
    order = np.argsort(np.asarray(d, dtype=object)).astype(np.int32)
    return DeviceColumn(lut_gather(order, col.data), col.validity, dtype)


class _AggDictTracker:
    """Captures the dictionary behind each string min/max argument and
    REJECTS mid-stream growth: collation ranks are only comparable across
    batches when the dictionary is frozen."""

    def __init__(self, aggs):
        self.watch = [a for a in aggs
                      if a.func in ("min", "max") and a.arg is not None
                      and a.arg.dtype.is_varlen]
        self.dicts: Dict[str, list] = {}
        self._sizes: Dict[str, int] = {}

    def observe(self, ex: ExecBatch):
        for a in self.watch:
            d = _expr_dict(a.arg, ex)
            if d is None:
                continue
            prev = self.dicts.get(a.out_name)
            if prev is None:
                self.dicts[a.out_name] = d
                self._sizes[a.out_name] = len(d)
            elif prev is not d or len(d) != self._sizes[a.out_name]:
                raise EvalError(
                    f"{a.func}() over strings from a growing dictionary "
                    f"(union / multi-source) is not supported yet")


_BIT_IDENT = {"bit_and": -1, "bit_or": 0, "bit_xor": 0}
_BIT_UFUNC = {"bit_and": np.bitwise_and, "bit_or": np.bitwise_or,
              "bit_xor": np.bitwise_xor}


def _host_bit_reduce(func: str, data, gids, mask, mg: int):
    """Grouped bitwise reduce on the host: no segment and/or/xor exists
    on the device, and the identity values make ufunc.at both exact and
    merge-transparent."""
    d = data.cpu().numpy().astype(np.int64)
    g = gids.cpu().numpy()
    m = mask.cpu().numpy()
    out = np.full(mg, _BIT_IDENT[func], np.int64)
    _BIT_UFUNC[func].at(out, g[m], d[m])
    return torch.from_numpy(out).to(data.device)


def _grouped_step(a: AggCall, gi, col: Optional[DeviceColumn],
                  row_mask, mg: int, use_pallas: bool = False):
    """Per-batch partial for one aggregate over PRE-EVALUATED values
    (col = _agg_value(...); None for count(*))."""
    if a.func == "count" and a.arg is None:
        return {"count": A.seg_count(gi.gids, row_mask, mg)}
    m = row_mask & col.validity
    if a.func == "count":
        return {"count": A.seg_count(gi.gids, m, mg)}
    if a.func == "sum":
        return {"sum": A.seg_sum(col.data, gi.gids, m, mg,
                                 use_pallas=use_pallas),
                "count": A.seg_count(gi.gids, m, mg)}
    if a.func == "avg":
        return {"sum": A.seg_sum(col.data.to(torch.float64)
                                 if col.dtype.is_float else col.data,
                                 gi.gids, m, mg),
                "count": A.seg_count(gi.gids, m, mg)}
    if a.func == "min":
        return {"min": A.seg_min(col.data, gi.gids, m, mg),
                "count": A.seg_count(gi.gids, m, mg)}
    if a.func == "max":
        return {"max": A.seg_max(col.data, gi.gids, m, mg),
                "count": A.seg_count(gi.gids, m, mg)}
    if a.func in STDDEV_AGGS:
        x = _float_of(col)
        return {"sum": A.seg_sum(x, gi.gids, m, mg),
                "sumsq": A.seg_sum(x * x, gi.gids, m, mg),
                "count": A.seg_count(gi.gids, m, mg)}
    if a.func in BIT_AGGS:
        return {"bits": _host_bit_reduce(a.func, col.data, gi.gids, m,
                                         mg),
                "count": A.seg_count(gi.gids, m, mg)}
    raise EvalError(f"unsupported aggregate {a.func}")


def _float_of(col: DeviceColumn):
    x = col.data.to(torch.float64)
    if col.dtype.oid == TypeOid.DECIMAL64:
        x = x / (10.0 ** col.dtype.scale)
    return x


def _grouped_merge(a: AggCall, p1, p2, gi, mask, mg: int):
    out = {}
    for field in p1:
        vals = torch.cat([p1[field], p2[field]])
        if field in ("sum", "count", "sumsq"):
            out[field] = A.seg_sum(vals, gi.gids, mask, mg)
        elif field == "min":
            out[field] = A.seg_min(vals, gi.gids, mask, mg)
        elif field == "max":
            out[field] = A.seg_max(vals, gi.gids, mask, mg)
        elif field == "bits":
            out[field] = _host_bit_reduce(a.func, vals, gi.gids, mask, mg)
    return out


def _grouped_empty(a: AggCall, mg: int, device):
    def zeros(t):
        return torch.zeros((mg,), dtype=t, device=device)
    z64 = zeros(torch.int64)
    if a.func == "count":
        return {"count": z64}
    vt = a.arg.dtype.torch_dtype
    if a.func == "sum":
        return {"sum": zeros(vt if a.arg.dtype.is_float else torch.int64),
                "count": z64}
    if a.func == "avg":
        return {"sum": zeros(torch.float64 if a.arg.dtype.is_float
                             else torch.int64), "count": z64}
    if a.func in ("min", "max"):
        return {a.func: zeros(vt), "count": z64}
    if a.func in STDDEV_AGGS:
        zf = zeros(torch.float64)
        return {"sum": zf, "sumsq": zf, "count": z64}
    if a.func in BIT_AGGS:
        return {"bits": torch.full((mg,), _BIT_IDENT[a.func],
                                   dtype=torch.int64, device=device),
                "count": z64}
    raise EvalError(a.func)


def _grouped_final(a: AggCall, part, dtype: DType) -> DeviceColumn:
    valid = part["count"] > 0
    if a.func == "count":
        return DeviceColumn(part["count"], torch.ones_like(valid), dt.INT64)
    if a.func == "sum":
        s = part["sum"]
        if dtype.oid == TypeOid.DECIMAL64:
            s = s.to(torch.int64)
        return DeviceColumn(s.to(dtype.torch_dtype), valid, dtype)
    if a.func == "avg":
        s = part["sum"].to(torch.float64)
        if a.arg.dtype.oid == TypeOid.DECIMAL64:
            s = s / (10.0 ** a.arg.dtype.scale)
        c = torch.clamp(part["count"], min=1).to(torch.float64)
        return DeviceColumn(s / c, valid, dt.FLOAT64)
    if a.func in ("min", "max"):
        return DeviceColumn(part[a.func], valid, dtype)
    if a.func in STDDEV_AGGS:
        c = part["count"].to(torch.float64)
        mean = part["sum"] / torch.clamp(c, min=1.0)
        var_pop = torch.clamp(
            part["sumsq"] / torch.clamp(c, min=1.0) - mean * mean, min=0.0)
        if a.func in ("stddev_samp", "var_samp"):
            var = var_pop * c / torch.clamp(c - 1.0, min=1.0)
            ok = part["count"] > 1
        else:
            var = var_pop
            ok = part["count"] > 0
        out = var if a.func in ("variance", "var_pop", "var_samp") \
            else torch.sqrt(var)
        return DeviceColumn(out, ok, dt.FLOAT64)
    if a.func in BIT_AGGS:
        # MySQL: the neutral value, never NULL
        return DeviceColumn(part["bits"].to(torch.uint64),
                            torch.ones_like(valid), dt.UINT64)
    raise EvalError(a.func)


def _scalar_step_host(a: AggCall, ex: ExecBatch, state):
    """Per-batch scalar partial including the host-side families
    (bitwise aggregates reduce via numpy ufuncs)."""
    if a.func in BIT_AGGS:
        col = _agg_value(a, ex)
        m = ex.mask & col.validity
        d = col.data.cpu().numpy().astype(np.int64)
        mm = m.cpu().numpy()
        v = _BIT_UFUNC[a.func].reduce(d[mm]) if mm.any() \
            else _BIT_IDENT[a.func]
        c = A.scalar_count(m)
        if state is None:
            return (torch.tensor(int(v), dtype=torch.int64,
                                 device=ex.device), c)
        merged = _BIT_UFUNC[a.func](np.int64(state[0].item()), np.int64(v))
        return (torch.tensor(int(merged), dtype=torch.int64,
                             device=ex.device), state[1] + c)
    return _scalar_step(a, ex, state)


def _scalar_step(a: AggCall, ex: ExecBatch, state):
    if a.func == "count" and a.arg is None:
        v = A.scalar_count(ex.mask)
        return v if state is None else state + v
    col = _agg_value(a, ex)
    m = ex.mask & col.validity
    if a.func == "count":
        v = A.scalar_count(m)
        return v if state is None else state + v
    if a.func in ("sum", "avg"):
        s = A.scalar_sum(col.data.to(torch.float64)
                         if (a.func == "avg" and col.dtype.is_float)
                         else col.data, m)
        c = A.scalar_count(m)
        if state is None:
            return (s, c)
        return (state[0] + s, state[1] + c)
    if a.func == "min":
        v = A.scalar_min(col.data, m)
        c = A.scalar_count(m)
        return (v, c) if state is None else (torch.minimum(state[0], v),
                                             state[1] + c)
    if a.func == "max":
        v = A.scalar_max(col.data, m)
        c = A.scalar_count(m)
        return (v, c) if state is None else (torch.maximum(state[0], v),
                                             state[1] + c)
    if a.func in STDDEV_AGGS:
        x = _float_of(col)
        s = A.scalar_sum(x, m)
        s2 = A.scalar_sum(x * x, m)
        c = A.scalar_count(m)
        if state is None:
            return (s, s2, c)
        return (state[0] + s, state[1] + s2, state[2] + c)
    raise EvalError(a.func)


def _scalar_final(a: AggCall, state, dtype: DType, device) -> DeviceColumn:
    one = torch.ones((1,), dtype=torch.bool, device=device)
    if a.func == "count":
        v = (torch.zeros((), dtype=torch.int64, device=device)
             if state is None else state)
        return DeviceColumn(v[None].to(torch.int64), one, dt.INT64)
    if a.func in BIT_AGGS:
        v = (torch.tensor(_BIT_IDENT[a.func], dtype=torch.int64,
                          device=device) if state is None else state[0])
        return DeviceColumn(v[None].to(torch.uint64), one, dt.UINT64)
    if a.func in STDDEV_AGGS:
        if state is None:
            return DeviceColumn.const_null(dt.FLOAT64, device)
        s, s2, c = state
        cf = torch.clamp(c.to(torch.float64), min=1.0)
        mean = s / cf
        var_pop = torch.clamp(s2 / cf - mean * mean, min=0.0)
        if a.func in ("stddev_samp", "var_samp"):
            var = var_pop * cf / torch.clamp(cf - 1.0, min=1.0)
            ok = c > 1
        else:
            var = var_pop
            ok = c > 0
        out = var if a.func in ("variance", "var_pop", "var_samp") \
            else torch.sqrt(var)
        return DeviceColumn(out[None], ok[None], dt.FLOAT64)
    if state is None:
        return DeviceColumn.const_null(dtype, device)
    if a.func == "sum":
        s, c = state
        return DeviceColumn(s[None].to(dtype.torch_dtype), (c > 0)[None],
                            dtype)
    if a.func == "avg":
        s, c = state
        sf = s.to(torch.float64)
        if a.arg.dtype.oid == TypeOid.DECIMAL64:
            sf = sf / (10.0 ** a.arg.dtype.scale)
        return DeviceColumn((sf / torch.clamp(c, min=1))[None],
                            (c > 0)[None], dt.FLOAT64)
    v, c = state
    return DeviceColumn(v[None], (c > 0)[None], dtype)


# ------------------------------------------------------------- sort / topk

def _sort_key_col(expr: BoundExpr, ex: ExecBatch) -> DeviceColumn:
    """Evaluate an ORDER BY key; dictionary-coded strings are translated
    code -> collation rank so the sort follows string order, not insertion
    order of the dictionary."""
    col = _broadcast_full(eval_expr(expr, ex), ex.padded_len)
    d = _expr_dict(expr, ex)
    if d is not None and col.dtype.is_varlen:
        ranks = np.empty(len(d), dtype=np.int32)
        ranks[np.argsort(np.asarray(d, dtype=object))] = np.arange(len(d))
        return DeviceColumn(lut_gather(ranks, col.data), col.validity,
                            dt.INT32)
    return col


def _concat_batches(batches: List[ExecBatch], schema) -> ExecBatch:
    if len(batches) == 1:
        return batches[0]
    names = [n for n, _ in schema]
    cols = {}
    for n in names:
        datas, valids = [], []
        for ex in batches:
            c = _broadcast_full(ex.batch.columns[n], ex.padded_len)
            datas.append(c.data)
            valids.append(c.validity)
        first = batches[0].batch.columns[n]
        cols[n] = DeviceColumn(torch.cat(datas), torch.cat(valids),
                               first.dtype)
    mask = torch.cat([ex.mask for ex in batches])
    n_rows = torch.stack([ex.batch.n_rows for ex in batches]).sum()
    dicts = {}
    for ex in batches:
        dicts.update(ex.dicts)
    db = DeviceBatch(columns=cols, n_rows=n_rows.to(torch.int32))
    return ExecBatch(batch=db, dicts=dicts, mask=mask)


class SortOp(Operator):
    def __init__(self, node: P.Sort, child: Operator):
        self.node = node
        self.child = child
        self.schema = node.schema

    def execute(self) -> Iterator[ExecBatch]:
        batches = list(self.child.execute())
        if not batches:
            return
        ex = _concat_batches(batches, self.schema)
        cols = [_sort_key_col(k, ex) for k in self.node.keys]
        order = msort.sort_indices([c.data for c in cols],
                                   [c.validity for c in cols],
                                   self.node.descendings, ex.mask)
        n_out = ex.mask.to(torch.int32).sum()
        out = F.gather(ex.batch, order, n_out)
        yield ExecBatch(batch=out, dicts=ex.dicts, mask=out.row_mask())


class TopKOp(Operator):
    def __init__(self, node: P.TopK, child: Operator):
        self.node = node
        self.child = child
        self.schema = node.schema

    def execute(self) -> Iterator[ExecBatch]:
        batches = list(self.child.execute())
        if not batches:
            return
        ex = _concat_batches(batches, self.schema)
        want = self.node.k + self.node.offset
        if len(self.node.keys) == 1:
            key = _sort_key_col(self.node.keys[0], ex)
            k = min(want, ex.padded_len)
            idx, count = msort.top_k_indices(key.data, key.validity,
                                             self.node.descendings[0],
                                             ex.mask, k)
            out = F.gather(ex.batch, idx, torch.clamp(count, max=k))
            ex2 = ExecBatch(batch=out, dicts=ex.dicts, mask=out.row_mask())
            # top_k gives the right SET; restore exact ORDER via sort of k rows
            key2 = _sort_key_col(self.node.keys[0], ex2)
            order = msort.sort_indices([key2.data], [key2.validity],
                                       [self.node.descendings[0]], ex2.mask)
            out2 = F.gather(ex2.batch, order, out.n_rows)
        else:
            cols = [_sort_key_col(kx, ex) for kx in self.node.keys]
            order = msort.sort_indices([c.data for c in cols],
                                       [c.validity for c in cols],
                                       self.node.descendings, ex.mask)
            n_out = torch.clamp(ex.mask.to(torch.int32).sum(), max=want)
            out2 = F.gather(ex.batch, order[:max(bucket_length(want), 1)],
                            n_out)
        if self.node.offset:
            out2 = _apply_offset(out2, self.node.offset, self.node.k)
        yield ExecBatch(batch=out2, dicts=ex.dicts, mask=out2.row_mask())


def _apply_offset(db: DeviceBatch, offset: int, k: Optional[int]) -> DeviceBatch:
    n = db.padded_len
    device = db.n_rows.device
    idx = torch.clamp(torch.arange(n, device=device) + offset, 0, n - 1)
    remaining = torch.clamp(db.n_rows - offset, min=0)
    if k is not None:
        remaining = torch.clamp(remaining, max=k)
    return F.gather(db, idx, remaining)


class LimitOp(Operator):
    def __init__(self, node: P.Limit, child: Operator):
        self.node = node
        self.child = child
        self.schema = node.schema

    def execute(self) -> Iterator[ExecBatch]:
        seen = 0
        off = self.node.offset
        n = self.node.n
        for ex in self.child.execute():
            rank = torch.cumsum(ex.mask.to(torch.int64), 0) + seen
            keep = ex.mask
            if off:
                keep = keep & (rank > off)
            if n is not None:
                keep = keep & (rank <= off + n)
            seen += int(ex.mask.to(torch.int64).sum())
            ex.mask = keep
            yield ex
            if n is not None and seen >= off + n:
                return
