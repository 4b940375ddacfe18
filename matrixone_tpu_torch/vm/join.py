"""Joins as sort + sorted-search probes — no pointer-chasing hash tables.

The port of the per-operator join of `matrixone_tpu/vm/join.py`
(reference analogue: `colexec/hashbuild` + `colexec/join`):

  build:  hash build-side keys -> stable argsort in unsigned order ->
          the sorted hash array                               (one sort)
  probe:  hash probe keys -> sorted search (the hand-written kernel
          behind ops/kernels.sorted_lookup) -> expand up to
          `max_matches` consecutive duplicates -> verify real key
          equality (hashes only route; equality decides) -> gather

Duplicate fan-out beyond max_matches is detected on the host and the
probe re-runs with a doubled budget.  Inner, left, semi and anti joins;
build-side min/max runtime filters pushed into the probe scans.
Dictionary-coded (varchar) join keys translate the PROBE side's codes
into the BUILD side's code space through a host O(distinct) LUT before
hashing.

Not ported yet (ROADMAP.md, section A): full outer and cross joins, the
Grace spill of a build side past `DEFAULT_BUILD_BUDGET` live rows (both
raise), and the fused join fragments.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from matrixone_tpu_torch.container import dtypes as dt
from matrixone_tpu_torch.container.device import (DeviceBatch, DeviceColumn,
                                                  bucket_length)
from matrixone_tpu_torch.ops import filter as F, hash as H
from matrixone_tpu_torch.ops import kernels as HK
from matrixone_tpu_torch.sql import plan as P
from matrixone_tpu_torch.sql.expr import BoundCol, BoundFunc, BoundLiteral
from matrixone_tpu_torch.vm import operators as O
from matrixone_tpu_torch.vm.exprs import EvalError, ExecBatch, eval_expr
from matrixone_tpu_torch.vm.operators import (Operator, _broadcast_full,
                                              _concat_batches, _expr_dict)

#: UINT64_MAX: the hash a build row with a NULL key takes, so it sorts last
_NULL_HASH = -1


def _probe_scans(op, name: str):
    """Resolve a probe-key column down to the scans that produce it,
    walking only through operators where a pre-filter is always safe
    (Filter: conjunctive; Project: plain column renames)."""
    if isinstance(op, O.FilterOp):
        return _probe_scans(op.child, name)
    if isinstance(op, O.ProjectOp):
        for (n, _), e in zip(op.node.schema, op.node.exprs):
            if n == name:
                if isinstance(e, BoundCol):
                    return _probe_scans(op.child, e.name)
                return []
        return []
    if isinstance(op, O.ScanOp):
        if any(n == name for n, _ in op.node.schema):
            return [(op, name)]
    return []


def _maybe_compact(out: ExecBatch) -> ExecBatch:
    """Join outputs carry np*mm lanes but typically few live rows; without
    compaction a chain of joins grows lanes multiplicatively.  Compact
    whenever the live fraction drops below 1/4, padding to the bucket."""
    lanes = int(out.mask.shape[0])
    if lanes <= 2048:
        return out
    live = int(out.mask.to(torch.int32).sum())
    cap = bucket_length(max(live, 1))
    if cap * 4 > lanes:
        return out
    db = F.compact(out.batch, out.mask, cap)
    return ExecBatch(batch=db, dicts=out.dicts,
                     mask=torch.arange(cap, dtype=torch.int32,
                                       device=out.device) < db.n_rows)


# =====================================================================
# device kernels of the join, module-level as in the reference
# =====================================================================

def build_key_columns(node, build: ExecBatch):
    """Evaluate the build side's join keys.  Varchar keys stay in their
    own (build) code space widened to int64 — the probe side translates
    into it — and their dictionaries are returned for that translation."""
    bkeys, bdicts = [], []
    for k in node.right_keys:
        c = _broadcast_full(eval_expr(k, build), build.padded_len)
        d = None
        if k.dtype.is_varlen:
            d = _expr_dict(k, build)
            c = DeviceColumn(c.data.to(torch.int64), c.validity, c.dtype)
        bkeys.append(c)
        bdicts.append(d)
    return bkeys, bdicts


def probe_key_columns(node, ex: ExecBatch, bkey_dicts):
    """Evaluate the probe side's join keys, translating varchar codes
    into the build side's code space: a probe string present in the
    build dictionary takes the build code, an absent one takes a
    non-colliding id past it."""
    pkeys = []
    for k, bd in zip(node.left_keys, bkey_dicts):
        c = _broadcast_full(eval_expr(k, ex), ex.padded_len)
        if k.dtype.is_varlen:
            d = _expr_dict(k, ex)
            if d is not None and bd is not None:
                if len(d) == 0:
                    # all-NULL probe column: no row can match
                    data = torch.zeros(c.data.shape, dtype=torch.int64,
                                       device=c.data.device)
                else:
                    code_of = {str(s): i for i, s in enumerate(bd)}
                    lut = np.asarray(
                        [code_of.get(str(s), len(bd) + i)
                         for i, s in enumerate(d)], np.int64)
                    idx = torch.clamp(c.data.to(torch.int64), 0,
                                      max(len(d) - 1, 0))
                    data = torch.from_numpy(lut).to(c.data.device)[idx]
            else:
                # no dictionary to translate through: the two sides'
                # code spaces are incomparable — refuse
                raise EvalError(
                    "unsupported string comparison: varchar join key "
                    f"{k!r} has no resolvable dictionary")
            c = DeviceColumn(data, c.validity, c.dtype)
        pkeys.append(c)
    return pkeys


def hash_valid_keys(kcols, mask):
    """(row hash, all-keys-valid mask) for one side's key columns; rows
    with any NULL key never match (SQL equi-join semantics)."""
    h = H.hash_columns([k.data for k in kcols],
                       [k.validity for k in kcols])
    valid = mask
    for k in kcols:
        valid = valid & k.validity
    return h, valid


def build_sorted_hash(bkeys, mask):
    """Build finalize: hash + stable argsort of the build keys in
    unsigned order -> (the sorted hash array the probe searches, the row
    order, the valid-key mask)."""
    bhash, bvalid = hash_valid_keys(bkeys, mask)
    bhash = torch.where(bvalid, bhash, _NULL_HASH)
    order = torch.argsort(H.unsigned_order(bhash), stable=True)
    return bhash[order], order, bvalid


def runtime_filter_specs(node):
    """Static eligibility for the build-side min/max runtime filters:
    [(key index, probe BoundCol)] for the int-like BoundCol probe keys
    whose width/scale agree with the build key."""
    specs = []
    for i, (lk, rk) in enumerate(zip(node.left_keys, node.right_keys)):
        if not isinstance(lk, BoundCol):
            continue
        dtype = lk.dtype
        int_like = dtype.is_integer or dtype.oid in (
            dt.TypeOid.DATE, dt.TypeOid.DECIMAL64)
        if not int_like or dtype.is_varlen:
            continue
        # scales/widths must agree for a raw-unit range to be valid
        if rk.dtype != dtype and not (rk.dtype.is_integer
                                      and dtype.is_integer):
            continue
        if getattr(rk.dtype, "is_vector", False):
            continue
        specs.append((i, lk))
    return specs


def runtime_filter_ranges(specs, bkeys, bvalid):
    """(lo[], hi[], any_valid) build-key ranges for the eligible probe
    keys, in raw units."""
    los, his = [], []
    for i, _lk in specs:
        data = bkeys[i].data
        big = torch.iinfo(data.dtype).max
        los.append(torch.where(bvalid, data, big).min().to(torch.int64))
        his.append(torch.where(bvalid, data, -big - 1).max()
                   .to(torch.int64))
    device = bvalid.device
    lo = (torch.stack(los) if los
          else torch.zeros((0,), dtype=torch.int64, device=device))
    hi = (torch.stack(his) if his
          else torch.zeros((0,), dtype=torch.int64, device=device))
    return lo, hi, bvalid.any()


def expand_probe(node, ex: ExecBatch, build: ExecBatch, sorted_hash,
                 border, phash, pvalid, pkeys, bkeys, mm: int):
    """One probe batch against a finalized build side: sorted search ->
    expand `mm` duplicate lanes -> verify true key equality -> gather
    both sides -> residual -> left-join NULL-extension.  Returns
    (out ExecBatch [np*mm lanes], overflow bool tensor)."""
    np_ = ex.padded_len
    nb = sorted_hash.shape[0]
    device = ex.device
    # entry point into the sorted hash run: the hand-kernel seam
    start = HK.sorted_lookup(sorted_hash, phash).to(torch.int64)   # [np]
    lane = torch.arange(mm, device=device)
    pos = start[:, None] + lane[None, :]                  # [np, mm]
    pos_c = torch.clamp(pos, 0, nb - 1)
    cand_hash = sorted_hash[pos_c]
    hash_ok = (cand_hash == phash[:, None]) & (pos < nb) & pvalid[:, None]
    cand_rows = border[pos_c]                             # build row ids
    # verify true key equality (hash only routes)
    key_ok = hash_ok
    for pk, bk in zip(pkeys, bkeys):
        pv = pk.data[:, None]
        bv = bk.data[cand_rows]
        if pk.data.dtype != bv.dtype:
            ct = torch.promote_types(pk.data.dtype, bv.dtype)
            pv, bv = pv.to(ct), bv.to(ct)
        key_ok = key_ok & (pv == bv)
    # overflow: a (mm+1)-th duplicate would also match
    extra = torch.clamp(start + mm, 0, nb - 1)
    overflow = ((sorted_hash[extra] == phash) & (start + mm < nb)
                & pvalid).any()

    match = key_ok.reshape(-1)                            # [np*mm]
    probe_idx = torch.arange(np_, device=device).repeat_interleave(mm)
    build_idx = cand_rows.reshape(-1)

    cols = {}
    for name, _ in node.left.schema:
        c = _broadcast_full(ex.batch.columns[name], np_)
        cols[name] = DeviceColumn(c.data[probe_idx],
                                  c.validity[probe_idx], c.dtype)
    for name, _ in node.right.schema:
        c = _broadcast_full(build.batch.columns[name], build.padded_len)
        validity = c.validity[build_idx] & match
        cols[name] = DeviceColumn(c.data[build_idx], validity, c.dtype)
    db = DeviceBatch(columns=cols, n_rows=match.to(torch.int32).sum())
    out = ExecBatch(batch=db, dicts={**build.dicts, **ex.dicts},
                    mask=match)
    # residual ON predicate filters match lanes BEFORE left-join
    # null-extension: a left row whose matches all fail the residual
    # still emits one null-extended row (MySQL semantics)
    if node.residual is not None:
        pred = eval_expr(node.residual, out)
        out.mask = out.mask & F.predicate_mask(pred, db)
    if node.kind == "left":
        matched_any = out.mask.reshape(np_, mm).any(dim=1)
        lane0 = (lane == 0).repeat(np_)
        null_emit = lane0 & ~matched_any.repeat_interleave(mm) & \
            ex.mask.repeat_interleave(mm)
        # null-extended lanes: right-side columns must read as NULL
        for name, _ in node.right.schema:
            c = out.batch.columns[name]
            out.batch.columns[name] = DeviceColumn(
                c.data, c.validity & ~null_emit, c.dtype)
        out.mask = out.mask | null_emit
    out.batch.n_rows = out.mask.to(torch.int32).sum()
    return out, overflow


def collapse_semi_anti(node, ex: ExecBatch, out_mask, mm: int):
    """Collapse match lanes back onto the probe rows: emit each left
    row once iff it has (semi) / lacks (anti) a surviving match."""
    np_ = ex.padded_len
    matched_any = out_mask.reshape(np_, mm).any(dim=1)
    keep = (ex.mask & matched_any if node.kind == "semi"
            else ex.mask & ~matched_any)
    db = DeviceBatch(
        columns={n: _broadcast_full(ex.batch.columns[n], np_)
                 for n, _ in node.left.schema},
        n_rows=keep.to(torch.int32).sum())
    return ExecBatch(batch=db, dicts=dict(ex.dicts), mask=keep)


def stream_build_side(build_iter, budget: int):
    """Pull the build side counting live rows against `budget` ->
    (batches, overflowed).  The padded lane count bounds live rows from
    above, so a build fitting the budget never syncs; past the bound the
    per-batch mask sums are stacked on the device and drained in one
    reduction only when the un-synced upper bound could cross."""
    batches: List[ExecBatch] = []
    pending = []
    padded_pending = 0
    live = 0
    overflowed = False
    for ex in build_iter:
        batches.append(ex)
        pending.append(ex.mask.to(torch.int64).sum())
        padded_pending += int(ex.padded_len)
        if live + padded_pending <= budget:
            continue
        live += int(torch.stack(pending).sum())
        pending = []
        padded_pending = 0
        if live > budget:
            overflowed = True
            break
    return batches, overflowed


class JoinOp(Operator):
    #: build rows beyond which the reference Grace-spills both sides
    DEFAULT_BUILD_BUDGET = 1 << 22

    def __init__(self, node: P.Join, left: Operator, right: Operator,
                 max_matches: int = 4, ctx=None):
        self.node = node
        self.left = left
        self.right = right
        self.schema = node.schema
        self.max_matches = max_matches
        self.ctx = ctx
        self.build_budget = self.DEFAULT_BUILD_BUDGET
        if ctx is not None and ctx.variables:
            self.build_budget = int(ctx.variables.get(
                "join_build_budget", self.build_budget))

    def execute(self) -> Iterator[ExecBatch]:
        if self.node.kind not in ("inner", "left", "semi", "anti") \
                or not self.node.right_keys:
            raise NotImplementedError(
                f"{self.node.kind} joins without equi-keys or of kind full "
                f"or cross are not ported yet (ROADMAP.md, section A)")
        # stream the build side counting live rows; past the budget the
        # reference switches to its Grace spill
        build_batches, overflowed = stream_build_side(self.right.execute(),
                                                      self.build_budget)
        if overflowed:
            raise NotImplementedError(
                f"join build side past {self.build_budget} live rows: the "
                f"Grace spill is not ported yet (ROADMAP.md, section A)")
        if not build_batches and self.node.kind in ("inner", "semi"):
            return
        build = (_concat_batches(build_batches, self.node.right.schema)
                 if build_batches else None)
        if build is None:
            if self.node.kind == "anti":
                # NOT EXISTS against nothing: every left row passes
                yield from self.left.execute()
                return
            # LEFT JOIN with empty right side: all left rows null-extended
            for ex in self.left.execute():
                yield self._null_extend_all(ex)
            return
        # build side: hash + sort keys
        bkeys, bkey_dicts = build_key_columns(self.node, build)
        sorted_hash, order, bvalid = build_sorted_hash(bkeys, build.mask)
        if self.node.kind in ("inner", "semi"):
            self._push_runtime_filters(bkeys, bvalid)
        for ex in self.left.execute():
            yield from self._probe(ex, build, sorted_hash, order, bkeys,
                                   bkey_dicts)

    def _push_runtime_filters(self, bkeys, bvalid) -> None:
        """Build-side key min/max pushed into probe-side scans before the
        probe starts (reference: runtimeFilterMsg sent hashbuild -> scan).
        Inner/semi only — removing non-matching probe rows early cannot
        change the result."""
        specs = runtime_filter_specs(self.node)
        if not specs:
            return
        lo, hi, any_valid = runtime_filter_ranges(specs, bkeys, bvalid)
        if not bool(any_valid):
            return
        for (_i, lk), lo_v, hi_v in zip(specs, lo.tolist(), hi.tolist()):
            dtype = lk.dtype
            if dtype.is_integer:
                info = np.iinfo(dtype.np_dtype)
                lo_v = max(lo_v, int(info.min))
                hi_v = min(hi_v, int(info.max))
            for scan, name in _probe_scans(self.left, lk.name):
                col = BoundCol(name, dtype)
                scan.runtime_filters.append(
                    BoundFunc("ge", [col, BoundLiteral(lo_v, dtype)],
                              dt.BOOL))
                scan.runtime_filters.append(
                    BoundFunc("le", [col, BoundLiteral(hi_v, dtype)],
                              dt.BOOL))

    def _probe(self, ex: ExecBatch, build, sorted_hash, border, bkeys,
               bkey_dicts):
        pkeys = probe_key_columns(self.node, ex, bkey_dicts)
        phash, pvalid = hash_valid_keys(pkeys, ex.mask)
        mm = self.max_matches
        while True:
            out, overflow = expand_probe(
                self.node, ex, build, sorted_hash, border, phash,
                pvalid, pkeys, bkeys, mm)
            if not bool(overflow):
                break
            mm *= 2
        if self.node.kind in ("semi", "anti"):
            yield collapse_semi_anti(self.node, ex, out.mask, mm)
            return
        yield _maybe_compact(out)

    def _null_extend_all(self, ex: ExecBatch) -> ExecBatch:
        np_ = ex.padded_len
        cols = {}
        for name, _ in self.node.left.schema:
            cols[name] = _broadcast_full(ex.batch.columns[name], np_)
        for name, dtype in self.node.right.schema:
            cols[name] = _null_column(dtype, np_, ex.device)
        db = DeviceBatch(columns=cols, n_rows=ex.batch.n_rows)
        return ExecBatch(batch=db, dicts=dict(ex.dicts), mask=ex.mask)


def _null_column(dtype, n: int, device) -> DeviceColumn:
    """An all-NULL column of `dtype` and n rows (left-join
    null-extension)."""
    t = torch.int32 if dtype.is_varlen else dtype.torch_dtype
    shape = (n, dtype.dim) if dtype.is_vector else (n,)
    return DeviceColumn(torch.zeros(shape, dtype=t, device=device),
                        torch.zeros((n,), dtype=torch.bool, device=device),
                        dtype)
