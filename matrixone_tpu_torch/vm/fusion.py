"""Whole-plan fusion: fused plan fragments, each step one CUDA graph.

The port of `matrixone_tpu/vm/fusion.py`.  A fusion planner walks the
compiled operator tree and greedily groups maximal chains of operators
a step function can run without the host (scan filters -> Filter ->
Project -> Limit, with an optional dense grouped, scalar or streaming
top-k terminal) into FusedFragmentOp nodes.  Where the JAX package
compiles each fragment's step once per key into one `jax.jit` program,
the port captures it once per key as a CUDA graph (vm/graphs.py) and
replays the graph once per batch; on the CPU the same step function
runs eagerly, which is the fused path there.

Key properties, as in the reference:

  * parameter literals in data positions are LIFTED to step inputs
    (vm/exprs.lifted_literal_scope), so two runs that differ only in
    literal values share one graph;
  * dictionary-dependent expressions (LIKE, IN / comparisons over
    dict-coded strings) bake their lookup tables when the step is first
    run and key the step on the dictionary CONTENT, so a changed
    dictionary captures a new graph instead of serving a stale LUT;
  * operators a step cannot run without the host (string-transforming
    projections, UDF calls, sampling, framed windows, FULL OUTER and
    cross joins) are fusion barriers: the chain splits around them;
  * batches below MO_FUSION_MIN_ROWS, an empty source and a group-key
    dictionary growing mid-stream fall back to the ORIGINAL operator
    chain, so `MO_PLAN_FUSION=0/1` give the same rows;
  * steps live in a process-global FragmentCompileCache (LRU,
    MO_FUSION_CACHE entries and an eighth of the card's memory), whose
    entries hold the graphs,
    their memory pools and the constants they baked.

The reference's trace-failure rung has no counterpart on the card: the
barriers are decided by the same static analysis, so a capture or a
replay that raises is a fault, and it propagates.

The fused grouped terminal takes the NULL-slotted lane layout with a
count lane per aggregate argument for every batch.  The reference picks
between that layout and a compact one per batch, from all-valid flags it
reads back with one host sync; both layouts give the same numbers, so
the port's step needs no sync.

`MO_PLAN_FUSION=0` (or `SET plan_fusion = 0`) disables the pass; the
per-operator path is unchanged.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from matrixone_tpu_torch.container.device import (DeviceBatch, DeviceColumn,
                                                  bucket_length, to_device)
from matrixone_tpu_torch.container.dtypes import TypeOid
from matrixone_tpu_torch.ops import agg as A, filter as F, sort as msort
from matrixone_tpu_torch.ops import encodings as ENC
from matrixone_tpu_torch.ops import kernels as HK
from matrixone_tpu_torch.sql.expr import (BoundCase, BoundCast, BoundCol,
                                          BoundExpr, BoundFunc, BoundInList,
                                          BoundIsNull, BoundLike,
                                          BoundLiteral, BoundUdfCall)
from matrixone_tpu_torch.sql.parser import STDDEV_AGGS
from matrixone_tpu_torch.utils import keys as keyaudit
from matrixone_tpu_torch.utils import metrics as M, motrace, qa
from matrixone_tpu_torch.vm import exprs as EX
from matrixone_tpu_torch.vm import graphs as G
from matrixone_tpu_torch.vm import operators as O
from matrixone_tpu_torch.vm.exprs import ExecBatch, eval_expr


def enabled(ctx=None) -> bool:
    """Fusion gate: MO_PLAN_FUSION env (default on) + session
    `SET plan_fusion = 0`."""
    if os.environ.get("MO_PLAN_FUSION", "1") == "0":
        return False
    variables = getattr(ctx, "variables", None)
    if variables:
        v = variables.get("plan_fusion")
        if v is not None and str(v) in ("0", "off", "false"):
            return False
    return True


def min_fused_rows() -> int:
    """Batches below this padded length run the original operator chain
    eagerly: capturing a fragment for a 1k-row batch costs more than it
    saves."""
    try:
        return int(os.environ.get("MO_FUSION_MIN_ROWS", "65536"))
    except ValueError:
        return 65536


def join_fusion_enabled() -> bool:
    """MO_FUSION_JOIN=0 keeps joins as fusion barriers."""
    return os.environ.get("MO_FUSION_JOIN", "1") != "0"


def window_fusion_enabled() -> bool:
    """MO_FUSION_WINDOW=0 keeps window functions as fusion barriers."""
    return os.environ.get("MO_FUSION_WINDOW", "1") != "0"


def topk_fusion_enabled() -> bool:
    """MO_FUSION_TOPK=0 keeps ORDER BY .. LIMIT tails on TopKOp."""
    return os.environ.get("MO_FUSION_TOPK", "1") != "0"


# =====================================================================
# expression analysis: what a step can run, which literals are lifted
# =====================================================================

#: ops whose eval consumes every argument through eval_expr and whose
#: literal args can therefore be lifted to step inputs
_LIFT_FUNCS = set(EX._SIMPLE) | set(EX._CMP) | {"not", "neg"}

#: ops a step can run that read some literal args on the host: their
#: literals stay BAKED (values enter the cache key)
_PURE_FUNCS = (set(EX._DATE_FUNCS)
               | {"year", "month", "day", "date_add_days",
                  "date_add_unit", "timestampadd", "timestampdiff",
                  "makedate", "period_add", "period_diff", "to_datetime",
                  "bit_count", "round", "truncate", "time_bucket",
                  "l2_distance", "l2_distance_sq", "cosine_distance",
                  "inner_product", "cosine_similarity"})


class _ExprInfo:
    """Analysis product for a set of expressions: which literals become
    step inputs (lift), which stay baked constants (their VALUES join
    the cache key), and which sub-expressions bake a dictionary LUT
    (their dict CONTENT joins the key, resolved against the dict
    environment of the stage they evaluate under)."""

    def __init__(self):
        self.lift: List[BoundLiteral] = []
        self.baked: List[BoundLiteral] = []
        self.dictdep: List[Tuple[int, BoundExpr]] = []   # (env idx, expr)
        self.env_idx = 0


def _liftable(lit: BoundLiteral) -> bool:
    return (lit.value is not None and not lit.dtype.is_varlen
            and not getattr(lit.dtype, "is_vector", False))


def _eval_arg(a: BoundExpr, info: _ExprInfo) -> bool:
    """An argument consumed via eval_expr: literals here may be lifted."""
    if isinstance(a, BoundLiteral):
        if _liftable(a):
            info.lift.append(a)
        else:
            info.baked.append(a)
        return True
    return _analyze_expr(a, info)


def _analyze_expr(e: BoundExpr, info: _ExprInfo) -> bool:
    """True when `e` evaluates inside a step with no host sync.  Side
    effect: populates info.lift / info.baked / info.dictdep."""
    if isinstance(e, BoundCol):
        return True
    if isinstance(e, BoundLiteral):
        info.baked.append(e)
        return True
    if isinstance(e, BoundCast):
        if e.dtype.is_varlen or e.arg.dtype.is_varlen:
            return False
        return _eval_arg(e.arg, info)
    if isinstance(e, BoundIsNull):
        return _eval_arg(e.arg, info)
    if isinstance(e, BoundInList):
        if isinstance(e.arg, BoundLiteral):
            info.baked.append(e.arg)
            return True
        if e.arg.dtype.is_varlen:
            info.dictdep.append((info.env_idx, e.arg))
        return _analyze_expr(e.arg, info)
    if isinstance(e, BoundLike):
        info.dictdep.append((info.env_idx, e.arg))
        return _analyze_expr(e.arg, info)
    if isinstance(e, BoundCase):
        ok = True
        for c, _ in e.whens:
            ok = ok and _analyze_expr(c, info)
        branches = [v for _, v in e.whens] + (
            [e.else_] if e.else_ is not None else [])
        for v in branches:
            if v is None:
                continue
            if e.dtype.is_varlen:
                # string CASE: branches must be literals (eval builds a
                # deterministic dictionary from their values)
                if not isinstance(v, BoundLiteral):
                    return False
                info.baked.append(v)
            else:
                ok = ok and _eval_arg(v, info)
        return ok
    if isinstance(e, BoundUdfCall):
        return False
    if isinstance(e, BoundFunc):
        op = e.op
        if op in EX._CMP:
            if any(a.dtype.is_varlen for a in e.args):
                # string comparison: the dict side bakes a LUT, literal
                # sides are consumed on the host (values keyed)
                ok = True
                for a in e.args:
                    if isinstance(a, BoundLiteral):
                        info.baked.append(a)
                    else:
                        if a.dtype.is_varlen:
                            info.dictdep.append((info.env_idx, a))
                        ok = ok and _analyze_expr(a, info)
                return ok
            return all(_eval_arg(a, info) for a in e.args)
        if op in _LIFT_FUNCS:
            if any(a.dtype.is_varlen
                   or getattr(a.dtype, "is_vector", False)
                   for a in e.args):
                return False
            return all(_eval_arg(a, info) for a in e.args)
        if op in _PURE_FUNCS:
            # literal args may be read on the host by the eval (round
            # digits, interval units): bake them all
            ok = True
            for a in e.args:
                if isinstance(a, BoundLiteral):
                    info.baked.append(a)
                elif a.dtype.is_varlen:
                    return False
                else:
                    ok = ok and _analyze_expr(a, info)
            return ok
        return False
    return False


def _dedup_sig(e: BoundExpr):
    """Identity-exact expression signature for lane deduplication:
    sum(q) and avg(q) evaluate their argument once and share lanes,
    but two lifted literals never alias (their ids differ)."""
    if isinstance(e, BoundLiteral):
        return ("l", id(e))
    if isinstance(e, BoundCol):
        return ("c", e.name)
    if isinstance(e, BoundCast):
        return ("cast", _tsig(e.dtype), _dedup_sig(e.arg))
    if isinstance(e, BoundIsNull):
        return ("isnull", e.negated, _dedup_sig(e.arg))
    if isinstance(e, BoundFunc):
        return ("f", e.op, tuple(_dedup_sig(a) for a in e.args))
    return ("id", id(e))


def _norm_val(v):
    """Hashable form of a baked literal / IN-list value."""
    if isinstance(v, (list, tuple)):
        return tuple(_norm_val(x) for x in v)
    if isinstance(v, (int, float, str, bool, type(None), np.integer,
                      np.floating, np.bool_)):
        return v
    return repr(v)


def _tsig(d) -> tuple:
    return (int(d.oid), d.width, d.scale, getattr(d, "dim", 0) or 0)


def _baked_consts(exprs, lift_ids: frozenset) -> tuple:
    """Every constant a step BAKES from these expressions (IN-list
    values, LIKE patterns, non-lifted literal values, dtypes): the key
    auditor's independent re-walk of what _expr_sig keyed.  Lifted
    literals contribute only their dtype."""
    out: list = []

    def walk(e):
        if e is None or not isinstance(e, BoundExpr):
            return
        if isinstance(e, BoundLiteral):
            out.append(("lit", _tsig(e.dtype),
                        "P" if id(e) in lift_ids
                        else _norm_val(e.value)))
            return
        if isinstance(e, BoundInList):
            out.append(("in", tuple(_norm_val(v) for v in e.values),
                        e.negated))
            walk(e.arg)
            return
        if isinstance(e, BoundLike):
            out.append(("like", e.pattern, e.negated))
            walk(e.arg)
            return
        if isinstance(e, BoundCase):
            for c, v in e.whens:
                walk(c)
                walk(v)
            walk(e.else_)
            return
        for a in getattr(e, "args", None) or ():
            walk(a)
        arg = getattr(e, "arg", None)
        if isinstance(arg, BoundExpr):
            walk(arg)

    for e in exprs:
        walk(e)
    return tuple(out)


def _expr_sig(e: BoundExpr, lift_ids: frozenset) -> tuple:
    """Structural signature of an expression: shape + dtypes + baked
    structural constants; lifted literals appear as parameter slots."""
    if isinstance(e, BoundCol):
        return ("c", e.name, _tsig(e.dtype))
    if isinstance(e, BoundLiteral):
        return ("l", _tsig(e.dtype), "P" if id(e) in lift_ids else "B")
    if isinstance(e, BoundCast):
        return ("cast", _tsig(e.dtype), _expr_sig(e.arg, lift_ids))
    if isinstance(e, BoundIsNull):
        return ("isnull", e.negated, _expr_sig(e.arg, lift_ids))
    if isinstance(e, BoundInList):
        return ("in", _tsig(e.dtype),
                tuple(_norm_val(v) for v in e.values), e.negated,
                _expr_sig(e.arg, lift_ids))
    if isinstance(e, BoundLike):
        return ("like", e.pattern, e.negated,
                _expr_sig(e.arg, lift_ids))
    if isinstance(e, BoundCase):
        return ("case", _tsig(e.dtype),
                tuple((_expr_sig(c, lift_ids), _expr_sig(v, lift_ids))
                      for c, v in e.whens),
                _expr_sig(e.else_, lift_ids)
                if e.else_ is not None else None)
    if isinstance(e, BoundFunc):
        return ("f", e.op, _tsig(e.dtype),
                tuple(_expr_sig(a, lift_ids) for a in e.args))
    return ("?", type(e).__name__)


# =====================================================================
# static dictionary resolution (host-side, mirrors vm/exprs._dict_of
# for the expression subset a step runs)
# =====================================================================

def _static_dict(e: BoundExpr, env: Dict[str, list]) -> Optional[list]:
    if isinstance(e, BoundCol):
        return env.get(e.name)
    if isinstance(e, BoundCase) and e.dtype.is_varlen:
        return EX.case_string_dict(e)
    if isinstance(e, BoundLiteral) and e.dtype.is_varlen:
        return [str(e.value)]
    if isinstance(e, BoundFunc) and e.op == "monthname":
        return list(EX._MONTH_NAMES)
    if isinstance(e, BoundFunc) and e.op == "dayname":
        return list(EX._DAY_NAMES)
    return None


def _project_dict_ok(e: BoundExpr) -> bool:
    """Varlen project outputs must have a statically derivable output
    dictionary (passthrough column / string CASE / literal / month-day
    names): everything else is a fusion barrier anyway."""
    if not e.dtype.is_varlen:
        return True
    return (isinstance(e, (BoundCol, BoundLiteral))
            or isinstance(e, BoundCase)
            or (isinstance(e, BoundFunc)
                and e.op in ("monthname", "dayname")))


# ---- dictionary content keys (the LUT-staleness guard) ---------------

_DICT_KEY_LOCK = threading.Lock()
_DICT_KEYS: "OrderedDict[int, tuple]" = OrderedDict()  # id -> (ref, len, key)


def _dict_key(d: Optional[list]):
    """Content key of a dictionary, memoized by (identity, length): warm
    scans hand out the same list objects, so the O(distinct) hash runs
    once per dictionary, not once per batch.  The memo keeps a strong
    reference so a recycled id can never alias a different list."""
    if d is None:
        return None
    with _DICT_KEY_LOCK:
        ent = _DICT_KEYS.get(id(d))
        if ent is not None and ent[0] is d and ent[1] == len(d):
            _DICT_KEYS.move_to_end(id(d))
            return ent[2]
        key = (len(d), hash(tuple(str(s) for s in d)))
        _DICT_KEYS[id(d)] = (d, len(d), key)
        while len(_DICT_KEYS) > 256:
            _DICT_KEYS.popitem(last=False)
        return key


# =====================================================================
# fragment cache
# =====================================================================

class FragmentCompileCache:
    """LRU of fragment key -> the fragment's step functions and, on the
    card, their captured graphs.  The key is content-addressed (plan
    shape, input dtypes/shapes, baked literal values, dictionary
    content, dense key sizes, the device), so any DDL that changes an
    input re-keys instead of replaying a stale graph.  An evicted entry
    frees its graphs and their memory pools with it.  Entries are bounded
    by count (MO_FUSION_CACHE) and by the bytes their graphs hold on the
    card, pools and static buffers (an eighth of the card,
    `note_capture`)."""

    def __init__(self, max_entries: Optional[int] = None):
        from matrixone_tpu_torch.utils.lru import LruCache, env_entries
        if max_entries is None:
            max_entries = env_entries("MO_FUSION_CACHE", 256)
        self._lru = LruCache(max_entries)

    @staticmethod
    def max_held_bytes(device) -> int:
        """The bound on the bytes the cached graphs hold: an eighth of
        the card's memory, the rest left to the data."""
        return torch.cuda.get_device_properties(device).total_memory // 8

    @staticmethod
    def _held_bytes(entries) -> int:
        return sum(g.held_bytes for e in entries
                   for g in G.entry_graphs(e))

    def note_capture(self, device) -> None:
        """After a capture: drop the spare graphs no execution owns, then
        evict the least recently used entries, until the bytes the cached
        graphs hold fit the bound.  The newest entry and those whose
        graphs an execution still runs stay (evicting them frees nothing
        before the execution ends, and its next batch would capture
        again); an evicted graph's pool goes back to the allocator."""
        bound = self.max_held_bytes(device)
        entries = self._lru.snapshot()
        # first the spares concurrent executions left, which no
        # execution now needs, then whole entries
        M.fusion_graphs.inc(G.drop_free_spares(
            entries, lambda: self._held_bytes(entries) > bound),
            event="evict")
        for e in self._lru.evict_oldest_while(
                lambda es: self._held_bytes(es) > bound,
                pinned=lambda e: any(g.active
                                     for g in G.entry_graphs(e))):
            M.fusion_graphs.inc(len(G.entry_graphs(e)), event="evict")

    @property
    def max_entries(self) -> int:
        return self._lru.max_entries

    def entry(self, key: tuple) -> dict:
        e = self._lru.lookup(key)
        if e is not None:
            M.fusion_compile.inc(outcome="hit")
            return e
        e = self._lru.insert(key, {"fn": {}, "graphs": {}, "spares": {},
                                   "trace_s": 0.0})
        M.fusion_compile.inc(outcome="miss")
        return e

    def clear(self) -> None:
        self._lru.clear()

    def stats(self) -> dict:
        entries = self._lru.snapshot()
        graphs = [g for e in entries for g in G.entry_graphs(e)]
        return {"entries": len(entries),
                "graphs": len(graphs),
                "graph_replays": sum(g.replays for g in graphs),
                "held_bytes": self._held_bytes(entries),
                "evicted_graphs": int(M.fusion_graphs.get(event="evict")),
                "max_entries": self.max_entries,
                "hits": int(M.fusion_compile.get(outcome="hit")),
                "misses": int(M.fusion_compile.get(outcome="miss")),
                "trace_seconds": round(M.fusion_trace_seconds.get(), 4),
                "captures": int(M.fusion_graphs.get(event="capture")),
                "spare_graphs": int(M.fusion_graphs.get(event="spare")),
                "replays": int(M.fusion_graphs.get(event="replay")),
                "dispatches": int(M.fusion_dispatch.get(kind="step")),
                "eager_dispatches": int(
                    M.fusion_dispatch.get(kind="eager")),
                "enabled": enabled()}


#: process-global cache (all sessions share fragment steps)
CACHE = FragmentCompileCache()


def stats() -> dict:
    return {
        "compile_cache": CACHE.stats(),
        "executions": {m: int(M.fusion_exec.get(mode=m))
                       for m in ("fused", "eager", "fallback",
                                 "degraded")},
    }


# =====================================================================
# fusion planner
# =====================================================================

@dataclasses.dataclass
class _Stage:
    kind: str                 # filter | project | limit
    op: object                # original operator (fallback chain)
    node: object
    pred: Optional[BoundExpr] = None
    exprs: tuple = ()
    schema: tuple = ()
    offset: int = 0
    n: Optional[int] = None


def _agg_static_ok(node) -> bool:
    aggs = node.aggs
    if not aggs or any(a.distinct for a in aggs):
        return False
    probe = _ExprInfo()
    if node.group_keys:
        allowed = {"count", "sum", "avg"} | STDDEV_AGGS
        if any(a.func not in allowed for a in aggs):
            return False
        for k in node.group_keys:
            if not (k.dtype.is_varlen or k.dtype.oid == TypeOid.BOOL):
                return False
            if not _analyze_expr(k, probe):
                return False
        for a in aggs:
            # a host-LUT argument (string funcs, UDF calls) would run
            # "fine" while its dictionary stayed out of the cache key:
            # untraceable args bar the fused terminal
            if a.arg is not None and not _analyze_expr(a.arg, probe):
                return False
    else:
        allowed = {"count", "sum", "avg", "min", "max"} | STDDEV_AGGS
        for a in aggs:
            if a.func not in allowed:
                return False
            if a.arg is not None:
                if a.func in ("min", "max") and a.arg.dtype.is_varlen:
                    return False
                if not _analyze_expr(a.arg, probe):
                    return False
    return True


def _stage_ok(op) -> bool:
    """Can this operator join a fused chain?"""
    if isinstance(op, O.FilterOp):
        return _analyze_expr(op.node.pred, _ExprInfo())
    if isinstance(op, O.ProjectOp):
        trial = _ExprInfo()
        return all(_analyze_expr(e, trial) and _project_dict_ok(e)
                   for e in op.node.exprs)
    return isinstance(op, O.LimitOp)


def _collect_chain(top):
    """Walk DOWN from `top` over fusable stage operators; returns
    (stages in execution/bottom-up order, source operator)."""
    run: List[object] = []
    cur = top
    while _stage_ok(cur):
        run.append(cur)
        cur = cur.child
    stages: List[_Stage] = []
    for op in reversed(run):          # execution order (bottom first)
        if isinstance(op, O.FilterOp):
            stages.append(_Stage("filter", op, op.node,
                                 pred=op.node.pred))
        elif isinstance(op, O.ProjectOp):
            stages.append(_Stage("project", op, op.node,
                                 exprs=tuple(op.node.exprs),
                                 schema=tuple(op.node.schema)))
        else:
            stages.append(_Stage("limit", op, op.node,
                                 offset=op.node.offset or 0,
                                 n=op.node.n))
    return stages, cur


def _small_output(source) -> bool:
    """Sources whose output is a handful of rows (post-aggregate
    projections, HAVING filters): a fragment there costs a capture and
    saves nothing."""
    from matrixone_tpu_torch.vm.window import WindowOp
    return isinstance(source, (O.AggOp, O.ValuesOp, WindowOp))


def fragment_map(root) -> Dict[int, int]:
    """id(plan node) -> fragment id over a compiled operator tree
    (EXPLAIN renders fusion boundaries from this)."""
    from matrixone_tpu_torch.vm.compile import iter_ops
    out: Dict[int, int] = {}
    for op in iter_ops(root):
        if isinstance(op, FusedFragmentOp):
            for nid in op.covered_nodes:
                out[nid] = op.fragment_id
    return out


def fragment_roles(root) -> Dict[int, str]:
    """id(plan node) -> role label for nodes with a special place in a
    fragment (join build/probe, window prelude, top-k terminal)."""
    from matrixone_tpu_torch.vm.compile import iter_ops
    out: Dict[int, str] = {}
    for op in iter_ops(root):
        if isinstance(op, FusedFragmentOp):
            out.update(op.node_roles)
    return out


def _topk_static_ok(op) -> bool:
    """Can this TopKOp become a fused streaming terminal?  Keys and
    output columns must be scalar non-varlen (a dictionary-coded column
    carried across batches would pin the carry to one dictionary), and
    the carry must stay bounded."""
    node = op.node
    want = node.k + node.offset
    if want <= 0 or bucket_length(max(want, 1)) > 8192:
        return False
    probe = _ExprInfo()
    for k in node.keys:
        if k.dtype.is_varlen or getattr(k.dtype, "is_vector", False):
            return False
        if not _analyze_expr(k, probe):
            return False
    for _nm, t in op.schema:
        if t.is_varlen or getattr(t, "is_vector", False):
            return False
    return True


def fuse_operator_tree(root, ctx):
    """Replace maximal fusable chains in a compiled operator tree with
    FusedFragmentOp nodes.  Barrier operators stay and their children
    are fused recursively."""
    counter = itertools.count(1)
    return _fuse(root, ctx, counter)


def _join_fusable(op) -> bool:
    from matrixone_tpu_torch.vm.fusion_join import join_fusable
    return join_fusable(op)


def _window_fusable(op) -> bool:
    from matrixone_tpu_torch.vm.fusion_window import window_fusable
    return window_fusable(op)


def _try_fragment(top, ctx, counter, agg_op=None, sort_op=None):
    """Build a fragment whose chain ends at `top` (inclusive for stage
    operators; agg_op/sort_op ride as the terminal).  Join and window
    sources become PRELUDES of the step instead of barriers; returns
    None when no fragment is worth building here."""
    from matrixone_tpu_torch.vm import fusion_join as FJ
    from matrixone_tpu_torch.vm import fusion_window as FW
    stages, source = _collect_chain(top)
    if _join_fusable(source):
        return FJ.FusedJoinProbeOp(
            source, stages, agg_op,
            _fuse(source.left, ctx, counter),
            _fuse(source.right, ctx, counter),
            ctx, next(counter), sort_op=sort_op)
    if _window_fusable(source):
        return FW.FusedWindowOp(
            source, stages, agg_op,
            _fuse(source.child, ctx, counter),
            ctx, next(counter), sort_op=sort_op)
    if agg_op is None and (not stages or _small_output(source)):
        # not worth a fragment here (no fusable stage, or a source whose
        # output is already tiny): barrier; fuse below it.  This also
        # covers every sort_op-only case with no stages
        return None
    src = _fuse(source, ctx, counter)
    return FusedFragmentOp(src, stages, agg_op, ctx, next(counter),
                           sort_op=sort_op)


def _fuse(op, ctx, counter):
    if isinstance(op, FusedFragmentOp):
        return op
    got = None
    if isinstance(op, O.AggOp) and _agg_static_ok(op.node):
        got = _try_fragment(op.child, ctx, counter, agg_op=op)
    elif isinstance(op, O.TopKOp) and topk_fusion_enabled() \
            and _topk_static_ok(op):
        got = _try_fragment(op.child, ctx, counter, sort_op=op)
    elif isinstance(op, (O.FilterOp, O.ProjectOp, O.LimitOp)):
        got = _try_fragment(op, ctx, counter)
    elif _join_fusable(op) or _window_fusable(op):
        # a bare join probe / window with nothing fusable above it still
        # collapses its own per-operator launches into one step
        got = _try_fragment(op, ctx, counter)
    if got is not None:
        return got
    for attr in ("child", "left", "right"):
        c = getattr(op, attr, None)
        if isinstance(c, O.Operator):
            setattr(op, attr, _fuse(c, ctx, counter))
    kids = getattr(op, "children", None)
    if isinstance(kids, list):
        op.children = [_fuse(c, ctx, counter) for c in kids]
    return op


# =====================================================================
# replay source (fallback path)
# =====================================================================

class _ReplaySource(O.Operator):
    """Re-enters already-pulled source batches (plus the rest of the
    iterator) into the ORIGINAL operator chain when a fragment degrades.
    Applies the scan filters the fused path had deferred, with exactly
    the per-batch evaluation ScanOp itself would have done."""

    def __init__(self, batches, schema, filters):
        self._source = batches
        self.schema = schema
        self._filters = filters

    def execute(self):
        for ex in self._source:
            for f in self._filters:
                ex.mask = ex.mask & F.predicate_mask(
                    eval_expr(f, ex), ex.batch)
            yield ex


def _clone_tree(x):
    """A copy of every tensor in a nested tuple (a graph's outputs are
    overwritten by its next replay)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone_tree(v) for v in x)
    return x


# =====================================================================
# the fused fragment operator
# =====================================================================

class FusedFragmentOp(O.Operator):
    """One step function per (plan shape, dtype signature, padded
    batch bucket) covering a chain of operators: one CUDA graph on the
    card, replayed once per batch.

    `child` points at the source operator so tree walkers (runtime
    filter resolution, ctx retargeting) traverse through fragments
    unchanged."""

    #: prelude subclasses (join probe, window) build the chain's input
    #: batch in the step: the child scan stays its own operator there
    _allow_scan_defer = True

    def __init__(self, source, stages: List[_Stage], agg_op, ctx,
                 fragment_id: int, sort_op=None):
        self.child = source
        self.stages = stages
        self._agg_op = agg_op                  # original AggOp or None
        self._sort_op = sort_op                # original TopKOp or None
        self.ctx = ctx
        self.fragment_id = fragment_id
        self._limit_stages = [st for st in stages if st.kind == "limit"]
        if agg_op is not None:
            self.schema = agg_op.schema
            self.node = agg_op.node
            self._terminal = ("agg_grouped" if agg_op.node.group_keys
                              else "agg_scalar")
        elif sort_op is not None:
            self.schema = sort_op.schema
            self.node = sort_op.node
            self._terminal = "topk"
        elif stages:
            top = stages[-1]
            self.schema = top.op.schema
            self.node = top.node
            self._terminal = "stream"
        else:
            self.schema = self._source_schema()
            self.node = self._source_node()
            self._terminal = "stream"
        # original chain links for the fallback path
        chain_ops = [st.op for st in stages] + (
            [agg_op] if agg_op is not None else
            [sort_op] if sort_op is not None else [])
        self._orig_top = chain_ops[-1] if chain_ops else None
        self._orig_bottom = chain_ops[0] if chain_ops else None
        # scan absorption: defer the source scan's filter-mask eval into
        # the step when every pushed filter can run there
        scan_info = _ExprInfo()
        self._scan_defer = (
            self._allow_scan_defer
            and isinstance(source, O.ScanOp)
            and all(_analyze_expr(f, scan_info)
                    for f in source.node.filters))
        # full analysis in EXECUTION order (env indexes line up with the
        # dict environments the runtime key resolves against)
        info = _ExprInfo()
        if self._scan_defer:
            info.env_idx = 0
            for f in source.node.filters:
                _analyze_expr(f, info)
        self._analyze_prelude(info)
        env_i = 0
        for st in stages:
            info.env_idx = env_i
            if st.kind == "filter":
                _analyze_expr(st.pred, info)
            elif st.kind == "project":
                for e in st.exprs:
                    _analyze_expr(e, info)
                env_i += 1
        if agg_op is not None:
            info.env_idx = env_i
            for k in agg_op.node.group_keys:
                _analyze_expr(k, info)
            for a in agg_op.node.aggs:
                if a.arg is not None:
                    _analyze_expr(a.arg, info)
        if sort_op is not None:
            info.env_idx = env_i
            for k in sort_op.node.keys:
                _analyze_expr(k, info)
            self._topk_w = bucket_length(
                max(sort_op.node.k + sort_op.node.offset, 1))
        self._lift_lits = list(info.lift)
        self._baked_lits = list(info.baked)
        self._dictdeps = list(info.dictdep)
        lift_ids = frozenset(id(x) for x in self._lift_lits)
        self._plan_sig = self._build_plan_sig(lift_ids)
        # EXPLAIN surface
        self.covered_nodes = {id(st.node) for st in stages}
        self.node_roles: Dict[int, str] = {}
        if agg_op is not None:
            self.covered_nodes.add(id(agg_op.node))
        if sort_op is not None:
            self.covered_nodes.add(id(sort_op.node))
            self.node_roles[id(sort_op.node)] = "topk-terminal"
        if self._scan_defer:
            self.covered_nodes.add(id(source.node))
        self._graphs_used: list = []
        #: the execution that owns this fragment's graphs (vm/graphs.py)
        self._owner = None
        #: EXPLAIN ANALYZE surface for the last execution: mode, step
        #: calls, milliseconds of first runs and captures, whether the
        #: fragment cache held the key
        self.last_stats = self._new_stats()

    # -------------------------------------------- subclass seam points
    def _source_schema(self):
        """Schema of the batches entering the stage chain (a prelude
        subclass produces these in its step instead of pulling them
        from `child`)."""
        return self.child.schema

    def _source_node(self):
        return getattr(self.child, "node", None)

    def _analyze_prelude(self, info: _ExprInfo) -> None:
        """Hook for prelude expressions (join keys/residual, window
        entries) to contribute lifted/baked literals and dict deps at
        env index 0."""

    def describe(self) -> str:
        """Compact chain label: the fused operator names, bottom-up
        (ScanOp>FilterOp>ProjectOp>AggOp)."""
        parts = []
        if self._scan_defer:
            parts.append("ScanOp")
        parts.extend(self._prelude_labels())
        parts.extend(type(st.op).__name__ for st in self.stages)
        if self._agg_op is not None:
            parts.append("AggOp")
        if self._sort_op is not None:
            parts.append("TopKOp")
        return ">".join(parts) or "PassOp"

    def _prelude_labels(self) -> List[str]:
        return []

    def _shard_ctx(self):
        """The exchange shape the source scan is routed under: (mode,
        column, mesh size, mesh axis) or None.  Shard routing is a row
        mask at chunk production (vm/operators._hash_route), so the step
        is the same for every shard index: the shape alone keys the
        cache, and one captured graph serves every shard of the mesh on
        a device (the device is in the runtime key)."""
        sc = getattr(self.child, "node", None)
        hs = getattr(sc, "hash_shard", None)
        if hs is not None:
            return ("hash", hs[0], int(hs[2]), "shard")
        rr = getattr(sc, "shard", None)
        if rr is not None:
            return ("rr", None, int(rr[1]), "shard")
        return None

    # ----------------------------------------------------------- sig
    def _build_plan_sig(self, lift_ids) -> tuple:
        parts: List[tuple] = [("term", self._terminal)]
        sctx = self._shard_ctx()
        if sctx is not None:
            parts.append(("shard",) + sctx)
        parts.extend(self._prelude_sig(lift_ids))
        if self._scan_defer:
            parts.append(("scanf",
                          tuple(_expr_sig(f, lift_ids)
                                for f in self.child.node.filters)))
        for st in self.stages:
            if st.kind == "filter":
                parts.append(("filter", _expr_sig(st.pred, lift_ids)))
            elif st.kind == "project":
                parts.append(("project",
                              tuple((nm, _tsig(d),
                                     _expr_sig(e, lift_ids))
                                    for (nm, d), e in zip(st.schema,
                                                          st.exprs))))
            else:
                parts.append(("limit", st.offset, st.n))
        if self._agg_op is not None:
            node = self._agg_op.node
            parts.append(("agg",
                          tuple(_expr_sig(k, lift_ids)
                                for k in node.group_keys),
                          tuple((a.func, _tsig(a.dtype),
                                 _expr_sig(a.arg, lift_ids)
                                 if a.arg is not None else None)
                                for a in node.aggs)))
        if self._sort_op is not None:
            node = self._sort_op.node
            parts.append(("topk", node.k, node.offset,
                          tuple(_expr_sig(k, lift_ids)
                                for k in node.keys),
                          tuple(bool(d) for d in node.descendings)))
        return tuple(parts)

    def _prelude_sig(self, lift_ids) -> List[tuple]:
        return []

    # ------------------------------------------------- step dispatch
    def _run(self, entry, slot, fn, args, carry_index=None, stable=(),
             stat="dispatches"):
        """One step: a graph of the entry on the card, owned by this
        execution (vm/graphs.py), the eager step on the CPU.  -> (outputs,
        whether they came from a graph).  A first run on the CPU and a
        capture on the card are `fusion.compile` spans, every other call
        a `fusion.dispatch` span.  Under MO_FUSION_PROFILE=1 the step's
        seconds are taken to its end on the device (a sync per step on
        the batch's device, after the capture has ended: a diagnostic,
        not the fused path's cost)."""
        t0 = time.perf_counter()
        graph = G.claim(entry, slot, fn, args, carry_index, stable,
                        owner=self._owner)
        if graph is not None and graph not in self._graphs_used:
            self._graphs_used.append(graph)     # released at the end
        captured = graph is not None and graph.graph is None
        first = captured or (graph is None
                             and slot not in entry.setdefault("ran", set()))
        profile = os.environ.get("MO_FUSION_PROFILE") == "1"
        with motrace.span("fusion.compile" if first
                          else "fusion.dispatch", slot=slot,
                          profiled=profile):
            if graph is None:
                out = fn(*args)
                entry["ran"].add(slot)
            else:
                out = graph(args)
                if profile:
                    torch.cuda.synchronize(graph.device)
        if graph is None and first:
            self.last_stats["trace_ms"] += (time.perf_counter() - t0) * 1e3
        if captured:
            entry["trace_s"] += graph.capture_s
            M.fusion_trace_seconds.inc(graph.capture_s)
            CACHE.note_capture(graph.device)
            self.last_stats["trace_ms"] += graph.capture_s * 1000.0
        if self.last_stats["cache"] == "-":
            self.last_stats["cache"] = "miss" if first else "hit"
        self.last_stats[stat] += 1
        if profile:
            M.fusion_step_seconds.inc(time.perf_counter() - t0,
                                      kind="device")
        M.fusion_dispatch.inc(kind="step")
        return out, graph is not None

    def _release_graphs(self) -> None:
        for g in self._graphs_used:
            g.release()
        self._graphs_used = []

    def _new_stats(self) -> dict:
        return {"mode": "none", "dispatches": 0, "trace_ms": 0.0,
                "cache": "-"}

    def _begin_execution(self) -> None:
        """A fresh owner token for this execution's graphs, fresh
        EXPLAIN ANALYZE stats."""
        self._owner = object()
        self.last_stats = self._new_stats()

    def original_ops(self) -> list:
        """The operators the fragment replaced, which its degrade ladders
        still run (vm/compile.retarget_tree resets them too)."""
        out = [st.op for st in self.stages]
        out += [op for op in (self._agg_op, self._sort_op) if op is not None]
        return out

    def partial_state(self):
        """The shard executor's partial (parallel/dist_query.py): the
        fragment runs as in `execute`, and its carry comes back as
        `AggOp.partial_state`'s ("dense", ...) tuple, or for a scalar
        terminal as `AggOp.partial_scalar_state`'s (states, tracker),
        instead of being finalized; a degrade or fallback hands back the
        original AggOp's partial.  On the card the carry is copied out
        of the captured graph's buffers, which the next replay of the
        same key (the next shard's) overwrites."""
        if self._agg_op is None:
            raise TypeError("partial state of a fragment without an "
                            "aggregate terminal")
        self._partial = [None]
        try:
            for _ex in self.execute():
                raise AssertionError("a partial run yields no batch")
            return self._partial[0]
        finally:
            self._partial = None

    #: one body serves both terminals; the name matches AggOp's
    partial_scalar_state = partial_state

    def _partial_wanted(self) -> bool:
        return getattr(self, "_partial", None) is not None

    def _keep_partial(self, carry, sizes, key_dicts) -> None:
        """Partial mode's end of a fused run: the carry in
        `AggOp.partial_state`'s layout, copied out of the graph's buffers
        (`_carry_out`) before the execution releases the graph, which the
        next shard of the statement replays."""
        carry = self._carry_out(carry)
        tracker = O._AggDictTracker(self._agg_op.node.aggs)
        self._partial[0] = (
            ("dense", self._grouped_partials(carry, sizes), key_dicts,
             tracker) if self._terminal == "agg_grouped"
            else (list(carry), tracker))

    def reset_execution(self) -> None:
        """Before a cached tree runs again (vm/compile.retarget_tree):
        release the graphs an interrupted execution still owns, undo a
        fallback rewire of the original chain, reset the stats."""
        self._release_graphs()
        if self._orig_bottom is not None:
            self._orig_bottom.child = self.child
        self.last_stats = self._new_stats()

    def _init_grouped_carry(self, sizes, device):
        """Full NULL-slotted accumulator, one field array per aggregate
        partial plus the shared rows lane: the layout AggOp._dense_init
        allocates."""
        g = 1
        for s in sizes:
            g *= s + 1
        fields = []
        for a in self._agg_op.node.aggs:
            for cls, _field in O.AggOp._dense_fields(a):
                fields.append(torch.zeros(
                    (g,), dtype=(torch.int64 if cls == "int"
                                 else torch.float64), device=device))
        return tuple(fields), torch.zeros((g,), dtype=torch.int64,
                                          device=device)

    # -------------------------------------------------- chain helpers
    def resolve_column(self, name: str) -> Optional[str]:
        """Map an OUTPUT column name back through project renames to the
        source column that feeds it (runtime-filter pushdown support).
        A limit stage makes pre-filtering unsafe (it changes which rows
        reach the limit), exactly like the unfused walker stopping at
        LimitOp."""
        if self._limit_stages or self._agg_op is not None \
                or self._sort_op is not None:
            return None
        for st in reversed(self.stages):
            if st.kind != "project":
                continue
            hit = None
            for (nm, _), e in zip(st.schema, st.exprs):
                if nm == name:
                    hit = e
                    break
            if hit is None or not isinstance(hit, BoundCol):
                return None
            name = hit.name
        return name

    def _dict_envs(self, dicts0) -> List[Dict[str, list]]:
        """Dictionary environment at every stage boundary (envs[0] is
        the source batch's dicts; each project advances it)."""
        env = dict(dicts0)
        envs = [env]
        for st in self.stages:
            if st.kind != "project":
                continue
            env2: Dict[str, list] = {}
            for (nm, d), e in zip(st.schema, st.exprs):
                if d.is_varlen:
                    got = _static_dict(e, env)
                    if got is not None:
                        env2[nm] = got
            env = env2
            envs.append(env)
        return envs

    def _sizes(self, env_final) -> Optional[Tuple[int, ...]]:
        """Dense key-space sizes for the fused grouped aggregate, or
        None when a key has no bounded code space this batch (the
        general hash path takes over via the degrade fallback)."""
        node = self._agg_op.node
        sizes = []
        for k in node.group_keys:
            d = _static_dict(k, env_final)
            if d is not None:
                sizes.append(max(len(d), 1))
            elif k.dtype.oid == TypeOid.BOOL:
                sizes.append(2)
            else:
                return None
        g = 1
        for s in sizes:
            g *= s + 1
        n_fields = 1
        for a in node.aggs:
            n_fields += len(O.AggOp._dense_fields(a))
        try:
            gmax = int(os.environ.get("MO_DENSE_GROUPS_MAX", "256"))
        except ValueError:
            gmax = 256
        if g > gmax or g * n_fields > 4096:
            return None
        return tuple(sizes)

    def _lane_flags(self):
        """(keys all valid, per-aggregate argument all valid) the step
        assumes for every batch: the NULL-slotted layout, a count lane
        per argument (see the module docstring)."""
        return False, tuple(a.arg is None for a in self._agg_op.node.aggs)

    # --------------------------------------------------------- execute
    def execute(self):
        self._begin_execution()
        if self._orig_bottom is not None:
            # undo a stale fallback rewire from a previous execution
            self._orig_bottom.child = self.child
        scan_defer = self._scan_defer
        filters: List[BoundExpr] = []
        rt_filters: List[BoundExpr] = []
        rt_info = _ExprInfo()
        if scan_defer:
            rt_filters = list(self.child.runtime_filters)
            if rt_filters and not all(_analyze_expr(f, rt_info)
                                      for f in rt_filters):
                # runtime filters are ge/le numeric compares by
                # construction; if ever not, run the chain eagerly
                M.fusion_exec.inc(mode="fallback")
                self.last_stats["mode"] = "fallback"
                yield from self._fallback(None, self.child.execute(), [])
                return
            filters = list(self.child.node.filters) + rt_filters
            src_iter = self.child._batches(apply_mask=False)
        else:
            src_iter = self.child.execute()
        first = next(src_iter, None)
        if first is None:
            M.fusion_exec.inc(mode="fallback")
            self.last_stats["mode"] = "fallback"
            yield from self._fallback(None, src_iter, filters)
            return
        if first.padded_len < min_fused_rows():
            M.fusion_exec.inc(mode="eager")
            self.last_stats["mode"] = "eager"
            yield from self._fallback(first, src_iter, filters)
            return
        try:
            yield from self._execute_fused(first, src_iter, filters,
                                           rt_filters, rt_info)
        finally:
            self._release_graphs()

    def _fallback(self, first, rest, deferred_filters):
        """Run the ORIGINAL operator chain over the (partially pulled)
        source stream: the pre-fusion path."""
        batches = itertools.chain([first] if first is not None else [],
                                  rest)
        replay = _ReplaySource(batches, self.child.schema,
                               deferred_filters)
        if self._orig_bottom is None:
            yield from replay.execute()
            return
        self._orig_bottom.child = replay
        try:
            if self._partial_wanted():
                agg = self._agg_op
                self._partial[0] = (agg.partial_state()
                                    if agg.node.group_keys
                                    else agg.partial_scalar_state())
                return
            yield from self._orig_top.execute()
        finally:
            self._orig_bottom.child = self.child

    # ----------------------------------------------- fused execution
    def _runtime_key(self, ex, envs, rt_sig, rt_baked, sizes):
        cols = ex.batch.columns
        # colsig carries the ARRAY dtype too (not just the SQL oid):
        # narrow dict codes make int8/int16/int32 all legal carriers for
        # one oid, and a widened dictionary must capture anew
        colsig = tuple((nm, int(c.dtype.oid), str(c.data.dtype),
                        tuple(c.data.shape))
                       for nm, c in cols.items())
        baked = tuple(_norm_val(lit.value)
                      for lit in self._baked_lits) + rt_baked
        dicts = tuple(_dict_key(_static_dict(e, envs[i]))
                      for i, e in self._dictdeps)
        return (self._plan_sig, rt_sig, colsig,
                int(ex.mask.shape[0]), baked, dicts, sizes,
                ENC.signature(ex.device), HK.signature(), str(ex.device))

    def _audit_deps(self, envs, rt_lift, scan_filters, sizes_flags,
                    device):
        """Capture-relevant content RECOMPUTED FROM SOURCE STATE for
        the armed key auditor (utils/keys.py), independent of
        _runtime_key's own hashing (full dictionary content instead of
        _dict_key's memo, a fresh constant walk instead of _expr_sig)."""
        lift_ids = frozenset(id(x) for x in self._lift_lits) | \
            frozenset(id(x) for x in rt_lift)
        return {
            "dict_content": tuple(
                tuple(str(s) for s in d) if d is not None else None
                for d in (_static_dict(e, envs[i])
                          for i, e in self._dictdeps)),
            "baked_values": tuple(_norm_val(lit.value)
                                  for lit in self._baked_lits),
            "baked_plan_constants": _baked_consts(
                self._audit_exprs() + list(scan_filters), lift_ids),
            "lift_arity": len(self._lift_lits) + len(rt_lift),
            "sizes_flags": sizes_flags,
            "chain_shape": self.describe(),
            "shard_ctx": self._shard_ctx(),
            # step-time dtype policy: bf16 lanes are applied inside the
            # step, invisible in the input dtypes
            "encoding_policy": (ENC.signature(device), HK.signature()),
        }

    def _audit_exprs(self) -> list:
        """Every expression whose BAKED constants the step may embed
        (subclasses extend with their prelude expressions)."""
        out: list = []
        for st in self.stages:
            if st.kind == "filter":
                out.append(st.pred)
            elif st.kind == "project":
                out.extend(st.exprs)
        if self._agg_op is not None:
            node = self._agg_op.node
            out.extend(node.group_keys)
            out.extend(a.arg for a in node.aggs if a.arg is not None)
        if self._sort_op is not None:
            out.extend(self._sort_op.node.keys)
        return out

    def _lifted_values(self, rt_lift) -> tuple:
        """The lifted literals' values as [1] CPU tensors of their SQL
        dtype (on the card, written into the graph's input buffers)."""
        return tuple(torch.tensor([lit.value],
                                  dtype=lit.dtype.torch_dtype)
                     for lit in self._lift_lits + rt_lift)

    def _step_args(self, ex, rt_lift, seens, carry):
        cols = ex.batch.columns
        datas = tuple(c.data for c in cols.values())
        valids = tuple(c.validity for c in cols.values())
        n_rows = ex.batch.n_rows.to(torch.int32)
        return (datas, valids, n_rows, ex.mask,
                self._lifted_values(rt_lift), seens, carry)

    def _zero_seens(self, device) -> tuple:
        return tuple(torch.zeros((), dtype=torch.int64, device=device)
                     for _ in self._limit_stages)

    def _slot(self, carry) -> str:
        if self._terminal == "agg_scalar":
            return "step0" if carry is None else "stepN"
        return "step"

    def _carry_index(self, carry, index: int):
        return (index if self._terminal != "stream" and carry is not None
                else None)

    def _execute_fused(self, first, src_iter, filters, rt_filters,
                       rt_info):
        M.fusion_exec.inc(mode="fused")
        self.last_stats["mode"] = "fused"
        node = self._agg_op.node if self._agg_op is not None else None
        grouped = self._terminal == "agg_grouped"
        nkeys = len(node.group_keys) if grouped else 0
        key_dicts: List[Optional[list]] = [None] * nkeys
        rt_lift = list(rt_info.lift)
        rt_lift_ids = frozenset(id(x) for x in rt_lift)
        rt_sig = tuple(_expr_sig(f, rt_lift_ids) for f in rt_filters)
        rt_baked = tuple(_norm_val(lit.value) for lit in rt_info.baked)
        scan_filters = filters if self._scan_defer else []
        device = first.device
        carry = None
        if self._terminal == "topk":
            carry = self._init_topk_carry(device)
        seens: tuple = self._zero_seens(device)
        trace_sizes: object = ()          # () = not yet pinned
        batches = itertools.chain([first], src_iter)
        for ex in batches:
            envs = self._dict_envs(ex.dicts)
            sizes = None
            flags = None
            if grouped:
                for i, k in enumerate(node.group_keys):
                    d = _static_dict(k, envs[-1])
                    if d is not None:
                        key_dicts[i] = d
                sizes = self._sizes(envs[-1])
                if trace_sizes == ():
                    trace_sizes = sizes
                if sizes is None or sizes != trace_sizes:
                    # key space not dense / changed mid-stream: degrade
                    # to the general path, folding fused partials in
                    M.fusion_exec.inc(mode="degraded")
                    self.last_stats["mode"] = "degraded"
                    yield from self._degrade_grouped(
                        self._carry_out(carry), trace_sizes, key_dicts,
                        ex, batches, scan_filters)
                    return
                flags = self._lane_flags()
                if carry is None:
                    carry = self._init_grouped_carry(sizes, device)
            M.fusion_batches.inc()
            key = self._runtime_key(ex, envs, rt_sig, rt_baked,
                                    (sizes, flags))
            entry = CACHE.entry(key)
            if keyaudit.armed():
                keyaudit.audit("vm/fusion.py:fragment", key,
                               self._audit_deps(envs, rt_lift,
                                                scan_filters,
                                                (sizes, flags), device))
            slot = self._slot(carry)
            args = self._step_args(ex, rt_lift, seens, carry)
            fn = entry["fn"].get(slot)
            if fn is None:
                trig = tuple((nm, c.dtype)
                             for nm, c in ex.batch.columns.items())
                fn = self._make_step(trig, sizes, flags, envs,
                                     scan_filters, rt_lift)
                entry["fn"][slot] = fn
            out, graphed = self._run(entry, slot, fn, args,
                                     self._carry_index(carry, 6))
            payload, seens = out
            if self._terminal == "stream":
                if graphed:
                    payload = _clone_tree(payload)
                yield self._stream_batch(ex, payload, envs)
            else:
                carry = payload
            if self._limits_satisfied(seens):
                if hasattr(src_iter, "close"):
                    src_iter.close()
                break
        if self._terminal == "stream":
            return
        if self._partial_wanted():
            self._keep_partial(carry, trace_sizes, key_dicts)
            return
        carry = self._carry_out(carry)
        if self._terminal == "topk":
            yield self._finalize_topk(carry)
            return
        yield self._finalize_agg(carry, trace_sizes, key_dicts)

    def _carry_out(self, carry):
        """The carry, copied out of the graph's buffers on the card: the
        next execution of the same key writes them again."""
        if carry is None or not self._graphs_used:
            return carry
        return _clone_tree(carry)

    def _limits_satisfied(self, seens) -> bool:
        for st, s in zip(self._limit_stages, seens):
            if st.n is not None and int(s) >= st.offset + st.n:
                return True
        return False

    def _out_schema(self, ex):
        """(names, dtypes) of the fragment's stream output."""
        for st in reversed(self.stages):
            if st.kind == "project":
                return ([n for n, _ in st.schema],
                        [d for _, d in st.schema])
        return (list(ex.batch.columns.keys()),
                [c.dtype for c in ex.batch.columns.values()])

    def _stream_batch(self, ex, payload, envs) -> ExecBatch:
        out_datas, out_valids, out_mask = payload
        names, dtypes = self._out_schema(ex)
        cols = {nm: DeviceColumn(d, v, t)
                for nm, t, d, v in zip(names, dtypes, out_datas,
                                       out_valids)}
        env_final = envs[-1]
        dicts = {nm: env_final[nm] for nm, t in zip(names, dtypes)
                 if t.is_varlen and env_final.get(nm) is not None}
        db = DeviceBatch(columns=cols, n_rows=ex.batch.n_rows)
        return ExecBatch(batch=db, dicts=dicts, mask=out_mask)

    # ------------------------------------------------------ the step
    def _make_step(self, trig_schema, sizes, flags, envs, scan_filters,
                   rt_lift):
        """Build the fragment's step function: captured as a graph on
        the card, called eagerly on the CPU."""
        chain = self._make_chain_fn(sizes, flags, envs)
        lift_lits = self._lift_lits + rt_lift
        env0 = envs[0]

        def _fragment_step(datas, valids, n_rows, mask, lifted, seens,
                           carry):
            binding = {id(lit): v
                       for lit, v in zip(lift_lits, lifted)}
            with EX.lifted_literal_scope(binding):
                cols = {nm: DeviceColumn(d, v, t)
                        for (nm, t), d, v in zip(trig_schema, datas,
                                                 valids)}
                ex = ExecBatch(batch=DeviceBatch(columns=cols,
                                                 n_rows=n_rows),
                               dicts=env0, mask=mask)
                for f in scan_filters:
                    ex.mask = ex.mask & F.predicate_mask(
                        eval_expr(f, ex), ex.batch)
                return chain(ex, seens, carry)

        return _fragment_step

    def _make_chain_fn(self, sizes, flags, envs):
        """The stage + terminal body shared by every fragment flavor:
        consumes the chain's input ExecBatch (plain columns for scan
        chains, the probe/window prelude's output in vm/fusion_join.py
        / vm/fusion_window.py) and returns (payload, out_seens).  Must
        be called inside the lifted-literal scope."""
        node = self._agg_op.node if self._agg_op is not None else None
        sort_node = (self._sort_op.node if self._sort_op is not None
                     else None)
        terminal = self._terminal
        stages = self.stages
        out_schema = list(self.schema)
        topk_w = getattr(self, "_topk_w", None)
        all_envs = envs
        if terminal == "agg_grouped":
            keys_allvalid, agg_flags = flags
            with_null = not keys_allvalid
        else:
            with_null = None
            agg_flags = None

        def chain(ex, seens, carry):
            out_seens: list = []
            li = 0
            env_i = 0
            for st in stages:
                if st.kind == "filter":
                    ex.mask = ex.mask & F.predicate_mask(
                        eval_expr(st.pred, ex), ex.batch)
                elif st.kind == "project":
                    env_i += 1
                    pcols = {}
                    for (nm, _d), e in zip(st.schema, st.exprs):
                        pcols[nm] = eval_expr(e, ex)
                    ex = ExecBatch(
                        batch=DeviceBatch(columns=pcols,
                                          n_rows=ex.batch.n_rows),
                        dicts=all_envs[env_i], mask=ex.mask)
                else:          # limit
                    seen = seens[li]
                    rank = torch.cumsum(ex.mask.to(torch.int64), 0) + seen
                    keep = ex.mask
                    if st.offset:
                        keep = keep & (rank > st.offset)
                    if st.n is not None:
                        keep = keep & (rank <= st.offset + st.n)
                    out_seens.append(seen + ex.mask.to(torch.int64).sum())
                    ex = ExecBatch(ex.batch, ex.dicts, keep)
                    li += 1
            if terminal == "stream":
                ocols = list(ex.batch.columns.values())
                payload = (tuple(c.data for c in ocols),
                           tuple(c.validity for c in ocols),
                           ex.mask)
                return payload, tuple(out_seens)
            if terminal == "agg_scalar":
                sts = (carry if carry is not None
                       else [None] * len(node.aggs))
                new = tuple(O._scalar_step(a, ex, s)
                            for a, s in zip(node.aggs, sts))
                return new, tuple(out_seens)
            if terminal == "topk":
                return (self._topk_merge(ex, carry, out_schema,
                                         sort_node, topk_w),
                        tuple(out_seens))
            return (self._grouped_merge(ex, carry, node, sizes,
                                        with_null, agg_flags),
                    tuple(out_seens))

        return chain

    def _topk_merge(self, ex, carry, out_schema, sort_node, topk_w):
        """Streaming ORDER BY .. LIMIT k: merge this batch's rows into
        the running top-W carry under the exact total order (sort keys,
        then global row index: the tiebreak the host path realizes by
        stable-sorting the concatenated stream)."""
        cdat, cval, cgid, cmask, clive, coff = carry
        n = ex.padded_len
        gidx = coff + torch.arange(n, dtype=torch.int64, device=ex.device)
        mdat, mval, mcols = [], [], {}
        for (nm, t), cd, cv in zip(out_schema, cdat, cval):
            col = O._broadcast_full(ex.batch.columns[nm], n)
            mdat.append(torch.cat([cd, col.data.to(cd.dtype)]))
            mval.append(torch.cat([cv, col.validity]))
            mcols[nm] = DeviceColumn(mdat[-1], mval[-1], t)
        mmask = torch.cat([cmask, ex.mask])
        mgid = torch.cat([cgid, gidx])
        mex = ExecBatch(
            batch=DeviceBatch(columns=mcols,
                              n_rows=mmask.to(torch.int32).sum()),
            dicts=ex.dicts, mask=mmask)
        kcols = [O._sort_key_col(k, mex) for k in sort_node.keys]
        if len(kcols) == 1:
            # the host path's top-k selection: on ties it prefers the
            # lower merged index == lower global row index (carry lanes
            # precede batch lanes and are older)
            take, _cnt = msort.top_k_indices(
                kcols[0].data, kcols[0].validity,
                sort_node.descendings[0], mmask, topk_w)
        else:
            order = msort.sort_indices(
                [c.data for c in kcols] + [mgid],
                [c.validity for c in kcols] + [None],
                list(sort_node.descendings) + [False], mmask)
            take = order[:topk_w]
        return (tuple(d[take] for d in mdat),
                tuple(v[take] for v in mval),
                mgid[take], mmask[take],
                clive + ex.mask.to(torch.int64).sum(),
                coff + n)

    def _grouped_merge(self, ex, carry, node, sizes, with_null,
                       agg_flags):
        """The fused port of AggOp._dense_step: deduplicated lanes over
        the key space, scattered into the full-space carry."""
        n = ex.padded_len
        kdata, kvalid = [], []
        for k in node.group_keys:
            kc = O._broadcast_full(eval_expr(k, ex), n)
            kdata.append(kc.data)
            kvalid.append(kc.validity)
        val_cache: dict = {}

        def _val(arg):
            sig = _dedup_sig(arg)
            got = val_cache.get(sig)
            if got is None:
                got = O._broadcast_full(eval_expr(arg, ex), n)
                val_cache[sig] = got
            return got

        int_vals, int_masks = [], []
        float_vals, float_masks = [], []
        lane_of: dict = {}
        fieldmap: list = []      # one entry per carry field
        for a, aflag in zip(node.aggs, agg_flags):
            v = None if a.arg is None else _val(a.arg)
            allv = v is None or aflag
            mkey = ("rows" if allv else ("m", _dedup_sig(a.arg)))
            mval = None if allv else v.validity
            x = None
            for cls, field in O.AggOp._dense_fields(a):
                if field == "count" and mkey == "rows":
                    fieldmap.append("rows")
                    continue
                if cls == "float" and field != "count" \
                        and a.func in STDDEV_AGGS and x is None:
                    x = O._float_of(v)
                val = (None if field == "count"
                       else x * x if field == "sumsq"
                       else x if x is not None else v.data)
                lk = (cls, field == "sumsq",
                      None if field == "count"
                      else _dedup_sig(a.arg), mkey)
                lane = lane_of.get(lk)
                if lane is None:
                    if cls == "int":
                        lane = ("int", len(int_vals))
                        int_vals.append(val)
                        int_masks.append(mval)
                    else:
                        lane = ("float", len(float_vals))
                        # narrow-encodings policy: FLOAT32 agg inputs
                        # round to bf16 here (inside the step); the
                        # accumulation stays f64
                        float_vals.append(ENC.narrow_lane(val))
                        float_masks.append(mval)
                    lane_of[lk] = lane
                fieldmap.append(lane)
        ints, floats, rows = A.dense_lane_partials(
            tuple(kdata), tuple(kvalid), ex.mask,
            tuple(int_vals), tuple(int_masks),
            tuple(float_vals), tuple(float_masks),
            sizes=sizes, with_null=with_null)
        pos = _compact_positions(sizes, with_null, ex.device)
        fields, crows = carry
        new_fields = []
        for f_arr, ref in zip(fields, fieldmap):
            add = (rows if ref == "rows"
                   else ints[ref[1]] if ref[0] == "int"
                   else floats[ref[1]])
            new_fields.append(f_arr.index_add(0, pos, add.to(f_arr.dtype)))
        new_rows = crows.index_add(0, pos, rows)
        return tuple(new_fields), new_rows

    # ------------------------------------------------- topk terminal
    def _init_topk_carry(self, device):
        """Empty top-W carry: per output column (data, validity), plus
        global row index, live-lane mask, live-row count and the padded
        offset the next batch's global indexes start at."""
        w = self._topk_w
        datas, valids = [], []
        for _nm, t in self.schema:
            datas.append(torch.zeros((w,), dtype=t.torch_dtype,
                                     device=device))
            valids.append(torch.zeros((w,), dtype=torch.bool,
                                      device=device))
        return (tuple(datas), tuple(valids),
                torch.zeros((w,), dtype=torch.int64, device=device),
                torch.zeros((w,), dtype=torch.bool, device=device),
                torch.zeros((), dtype=torch.int64, device=device),
                torch.zeros((), dtype=torch.int64, device=device))

    def _finalize_topk(self, carry) -> ExecBatch:
        """Order the carried top-W rows exactly (sort keys, then global
        row index: the stable-sort order of the host path) and apply
        the node's offset/k window."""
        datas, valids, gidx, cmask, live, _off = carry
        node = self._sort_op.node
        w = self._topk_w
        device = cmask.device
        cols = {nm: DeviceColumn(d, v, t)
                for (nm, t), d, v in zip(self.schema, datas, valids)}
        cex = ExecBatch(batch=DeviceBatch(
            columns=cols, n_rows=cmask.to(torch.int32).sum()),
            dicts={}, mask=cmask)
        kcols = [O._sort_key_col(k, cex) for k in node.keys]
        order = msort.sort_indices(
            [c.data for c in kcols] + [gidx],
            [c.validity for c in kcols] + [None],
            list(node.descendings) + [False], cmask)
        idx = order[torch.clamp(torch.arange(w, dtype=torch.int64,
                                             device=device)
                                + node.offset, 0, w - 1)]
        n_out = torch.clamp(torch.clamp(live, max=node.offset + node.k)
                            - node.offset, 0, node.k).to(torch.int32)
        keep = torch.arange(w, dtype=torch.int32, device=device) < n_out
        out_cols = {nm: DeviceColumn(d[idx], v[idx] & keep, t)
                    for (nm, t), d, v in zip(self.schema, datas,
                                             valids)}
        db = DeviceBatch(columns=out_cols, n_rows=n_out)
        return ExecBatch(batch=db, dicts={}, mask=keep)

    # -------------------------------------------------- agg finalize
    def _grouped_partials(self, carry, sizes):
        """Full-space carry fields -> per-aggregate partial dicts in
        the exact layout AggOp's dense accumulator uses."""
        fields, rows = carry
        node = self._agg_op.node
        partials = []
        idx = 0
        for a in node.aggs:
            part = {}
            for _cls, field in O.AggOp._dense_fields(a):
                part[field] = fields[idx]
                idx += 1
            partials.append(part)
        return {"sizes": tuple(sizes), "partials": partials,
                "rows": rows}

    def _finalize_agg(self, carry, sizes, key_dicts) -> ExecBatch:
        agg = self._agg_op
        agg._agg_tracker = O._AggDictTracker(agg.node.aggs)
        if self._terminal == "agg_scalar":
            return agg._scalar_result(list(carry), agg._agg_tracker,
                                      self.ctx.device)
        if qa.armed():
            # the padding canary: a poisoned pad row that reached a float
            # accumulator lane shows up as NaN in the carry
            qa.audit_carry(carry[0], f"fragment {self.fragment_id} "
                                     f"({self.describe()})")
        dense = self._grouped_partials(carry, sizes)
        state = agg._dense_to_state(dense)
        return agg._finalize(state, key_dicts)

    def _degrade_grouped(self, carry, sizes, key_dicts, ex, rest,
                         scan_filters):
        """A group-key dictionary grew mid-stream (or the key space was
        never dense): convert the fused partials into a general
        group-table state and continue on the ORIGINAL operator chain,
        seeded."""
        agg = self._agg_op
        agg._agg_tracker = O._AggDictTracker(agg.node.aggs)
        seed = None
        if carry is not None:
            dense = self._grouped_partials(carry, sizes)
            seed = agg._dense_to_state(dense)
        batches = itertools.chain([ex], rest)
        replay = _ReplaySource(batches, self.child.schema, scan_filters)
        rewire = self._orig_bottom if self.stages else agg
        rewire.child = replay
        try:
            if self._partial_wanted():
                self._partial[0] = agg.partial_state(seed=seed,
                                                     seed_dicts=key_dicts)
                return
            yield from agg._grouped_agg(seed=seed, seed_dicts=key_dicts)
        finally:
            rewire.child = self.child


def _compact_positions(sizes, with_null: bool, device):
    """Full-space slot of each effective-space slot (the scatter target
    for compact-variant partials; identity when with_null)."""
    strides_c, g_eff = A.dense_slot_strides(sizes, null_slots=with_null)
    strides_f, _g_full = A.dense_slot_strides(sizes)
    pos = np.zeros(g_eff, np.int64)
    for slot in range(g_eff):
        full, rem = 0, slot
        for stc, stf in zip(strides_c, strides_f):
            digit = rem // stc
            rem = rem % stc
            full += digit * stf
        pos[slot] = full
    return to_device(pos, device)
