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
probe re-runs with a doubled budget.  Inner, left, full outer, semi and
anti joins; build-side min/max runtime filters pushed into the probe
scans.  FULL OUTER marks the build rows each probe batch matched and
ends with the unmatched ones, probe side null-extended.

A join whose ON has no equi-key probes with empty keys: every row
hashes alike, each probe row meets the whole build side, and the
residual decides (the JAX package raises a TypeError on such a LEFT
JOIN; ROADMAP.md, section C).  A cross join is a repeat/tile product of
each probe batch with the build side, then the residual (reference:
loopjoin).  Without keys both sides are compacted to their live rows
first (the reference pairs padded lanes).

Dictionary-coded (varchar) join keys translate the PROBE side's codes
into the BUILD side's code space through a host O(distinct) LUT before
hashing.

The pure kernels below (`build_key_columns`, `build_sorted_hash`,
`runtime_filter_ranges`, `expand_probe`, `collapse_semi_anti`) are
shared by `JoinOp` and the fused build and probe steps of
vm/fusion_join.py, which run them inside CUDA graphs: none of them
syncs the host.

A build side past `join_build_budget` live rows (`DEFAULT_BUILD_BUDGET`
by default) Grace-spills (reference: colexec/spillutil/join_spill.go):
both sides are hash-partitioned by the join key into numpy `.npz`
chunks in a temporary directory, and each partition joins in memory
with the same code.  Rows with equal keys always share a partition, so
every keyed join kind partitions exactly.  A row's partition is the
unsigned remainder of the reference's 64-bit key hash, so an unordered
spilled join gives the reference's rows in the reference's order.  The
spill is host work between device batches; it never runs inside a
captured graph (a fused join hands an over-budget build to this
operator).
"""

from __future__ import annotations

import hashlib
import itertools
import os
import shutil
import tempfile
import time
from typing import Iterator, List

import numpy as np
import torch

from matrixone_tpu_torch.container import dtypes as dt
from matrixone_tpu_torch.container.device import (DeviceBatch, DeviceColumn,
                                                  bucket_length, from_numpy,
                                                  to_device)
from matrixone_tpu_torch.ops import filter as F, hash as H
from matrixone_tpu_torch.ops import kernels as HK
from matrixone_tpu_torch.sql import plan as P
from matrixone_tpu_torch.sql.expr import BoundCol, BoundFunc, BoundLiteral
from matrixone_tpu_torch.utils import metrics as M, motrace
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
    from matrixone_tpu_torch.vm.fusion import FusedFragmentOp
    if isinstance(op, O.FilterOp):
        return _probe_scans(op.child, name)
    if isinstance(op, FusedFragmentOp):
        # walk the fragment's fused project renames down to its source;
        # the fragment reads runtime_filters off the scan at execute
        # time and folds them into its step's predicate
        src_name = op.resolve_column(name)
        if src_name is None:
            return []
        return _probe_scans(op.child, src_name)
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
    if int(out.mask.shape[0]) <= 2048:
        return out
    return _compact_live(out, min_shrink=4)


def _compact_live(ex: ExecBatch, min_shrink: int = 1) -> ExecBatch:
    """The live rows of `ex` gathered to the front of their bucket, when
    that shrinks the lanes at least `min_shrink` times (one host sync).
    A join without keys pairs every probe lane with every build lane, so
    both sides go in compacted: a filtered scan keeps its padded lanes."""
    lanes = int(ex.mask.shape[0])
    cap = bucket_length(max(int(ex.mask.to(torch.int32).sum()), 1))
    if cap * min_shrink > lanes:
        return ex
    db = F.compact(ex.batch, ex.mask, cap)
    return ExecBatch(batch=db, dicts=ex.dicts,
                     mask=torch.arange(cap, dtype=torch.int32,
                                       device=ex.device) < db.n_rows)


# =====================================================================
# device kernels of the join, module-level as in the reference
# =====================================================================

def _str_hash_i64(s) -> int:
    """Stable 64-bit value hash of a dictionary entry (spill routing:
    equal strings must land in equal partitions on BOTH sides, whose
    dictionary codes are each their own)."""
    d = hashlib.blake2b(str(s).encode("utf-8"), digest_size=8).digest()
    return int(np.frombuffer(d, dtype="<u8")[0].astype(np.int64))


def unsigned_mod(h: torch.Tensor, p: int) -> torch.Tensor:
    """The remainder of the uint64 bit patterns in h by p, a power of
    two (torch's `%` of a negative int64 is another number)."""
    assert p > 0 and p & (p - 1) == 0, p
    return h & (p - 1)


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
                    data = to_device(lut, c.data.device)[idx]
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
    with any NULL key never match (SQL equi-join semantics).  With no
    keys (an ON without an equi-key) every row hashes to 0, so each
    probe row meets every build row and the residual decides."""
    if not kcols:
        return torch.zeros(mask.shape, dtype=torch.int64,
                           device=mask.device), mask
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


def _each_repeated(x: torch.Tensor, mm: int) -> torch.Tensor:
    """x[i] repeated mm times in a row, for each i (repeat_interleave by
    a constant, written as a view so it never syncs the host)."""
    return x[:, None].expand(x.shape[0], mm).reshape(-1)


def expand_probe(node, ex: ExecBatch, build: ExecBatch, sorted_hash,
                 border, phash, pvalid, pkeys, bkeys, mm: int,
                 build_matched=None):
    """One probe batch against a finalized build side: sorted search ->
    expand `mm` duplicate lanes -> verify true key equality -> gather
    both sides -> residual -> left/full NULL-extension.  Returns
    (out ExecBatch [np*mm lanes], overflow bool tensor, build_matched':
    for a full join, the build rows matched so far)."""
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
    probe_idx = _each_repeated(torch.arange(np_, device=device), mm)
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
    if node.kind == "full":
        # record which build rows matched (post-residual, pre-null-
        # extension) — monotonic across overflow re-runs
        hits = torch.zeros(build_matched.shape, dtype=torch.int32,
                           device=device).index_add_(
            0, build_idx, out.mask.to(torch.int32))
        build_matched = build_matched | (hits > 0)
    if node.kind in ("left", "full"):
        matched_any = out.mask.reshape(np_, mm).any(dim=1)
        lane0 = (lane == 0).repeat(np_)
        null_emit = lane0 & ~_each_repeated(matched_any, mm) & \
            _each_repeated(ex.mask, mm)
        # null-extended lanes: right-side columns must read as NULL
        for name, _ in node.right.schema:
            c = out.batch.columns[name]
            out.batch.columns[name] = DeviceColumn(
                c.data, c.validity & ~null_emit, c.dtype)
        out.mask = out.mask | null_emit
    out.batch.n_rows = out.mask.to(torch.int32).sum()
    return out, overflow, build_matched


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
    reduction only when the un-synced upper bound could cross.  Each
    drain is a `join.build.livesync` span."""
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
        with motrace.span("join.build.livesync", pending=len(pending)):
            live += int(torch.stack(pending).sum())
        pending = []
        padded_pending = 0
        if live > budget:
            overflowed = True
            break
    return batches, overflowed


def _spill_time(stage: str, t0: float) -> float:
    """Count the seconds since t0 against a spill stage -> now."""
    now = time.perf_counter()
    M.spill_seconds.inc(now - t0, kind="join", stage=stage)
    return now


class _JoinSpill:
    """Host-disk partitions of one join's two sides (Grace).  Each stored
    chunk keeps its source batch's dictionaries, so replayed ExecBatches
    are exactly as expressive as the originals."""

    def __init__(self, n_partitions: int):
        self.P = n_partitions
        self.dir = tempfile.mkdtemp(prefix="mo_join_spill_")
        self._chunks: dict = {}          # (side, p) -> [(path, dicts, n)]
        self._seq = 0
        #: where replayed chunks go: the device of the first spilled batch
        self.device = None

    def add(self, side: str, p: int, arrays: dict, validity: dict,
            dicts: dict, n: int) -> None:
        path = os.path.join(self.dir, f"{side}_{p}_{self._seq}.npz")
        self._seq += 1
        payload = {}
        for c, a in arrays.items():
            payload[f"d_{c}"] = a
            payload[f"v_{c}"] = validity[c]
        np.savez(path, **payload)
        M.spill_bytes.inc(os.path.getsize(path), kind="join")
        self._chunks.setdefault((side, p), []).append(
            (path, dict(dicts), n))

    def chunks(self, side: str, p: int) -> list:
        return self._chunks.get((side, p), [])

    def cleanup(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


class _ReplayOp(Operator):
    """Spilled host chunks as an operator (the drain half of Grace)."""

    def __init__(self, chunks: list, schema, device):
        self.chunks = chunks
        self.schema = schema
        self.device = device

    def execute(self) -> Iterator[ExecBatch]:
        for path, dicts, n in self.chunks:
            if n == 0:
                continue
            t0 = time.perf_counter()
            with np.load(path) as z:
                arrays, validity, dtypes = {}, {}, {}
                for name, dtype in self.schema:
                    arrays[name] = z[f"d_{name}"]
                    validity[name] = z[f"v_{name}"]
                    dtypes[name] = dt.INT32 if dtype.is_varlen else dtype
            db = from_numpy(arrays, dtypes, validity, n_rows=n,
                            device=self.device)
            for name, dtype in self.schema:
                if dtype.is_varlen:
                    c = db.columns[name]
                    db.columns[name] = DeviceColumn(c.data, c.validity,
                                                    dtype)
            _spill_time("replay", t0)
            yield ExecBatch(batch=db, dicts=dicts, mask=db.row_mask())


class JoinOp(Operator):
    #: build rows beyond which the join Grace-spills both sides
    DEFAULT_BUILD_BUDGET = 1 << 22
    #: partitions of a Grace spill, as in the reference
    SPILL_PARTITIONS = 16

    def __init__(self, node: P.Join, left: Operator, right: Operator,
                 max_matches: int = 4, ctx=None):
        self.node = node
        self.left = left
        self.right = right
        self.schema = node.schema
        self.max_matches = max_matches
        self.ctx = ctx
        #: (build ExecBatch, sorted_hash, order, bvalid, bkeys,
        #: bkey_dicts) handed over by a fused join fragment degrading to
        #: this op: its build step already ran the finalize and pushed
        #: the runtime filters.  Consumed (and cleared) by the next
        #: execute() iff the build batch is the very same object.
        self._prepared_build = None
        self.build_budget = self.DEFAULT_BUILD_BUDGET
        if ctx is not None and ctx.variables:
            self.build_budget = int(ctx.variables.get(
                "join_build_budget", self.build_budget))

    def execute(self) -> Iterator[ExecBatch]:
        # stream the build side counting live rows; past the budget,
        # switch to the Grace path (cross joins have no key to partition
        # by — they stay in memory whatever the size)
        build_iter = self.right.execute()
        overflowed = False
        if self.node.kind != "cross" and self.node.right_keys:
            build_batches, overflowed = stream_build_side(
                build_iter, self.build_budget)
        else:
            build_batches = list(build_iter)
        if overflowed:
            yield from self._grace(build_batches, build_iter)
            return
        if not build_batches and self.node.kind in ("inner", "semi"):
            return
        build = (_concat_batches(build_batches, self.node.right.schema)
                 if build_batches else None)
        keyless = not self.node.right_keys
        if build is not None and keyless:
            build = _compact_live(build)
        if self.node.kind == "cross":
            yield from self._cross(build)
            return
        if build is None:
            if self.node.kind == "anti":
                # NOT EXISTS against nothing: every left row passes
                yield from self.left.execute()
                return
            # LEFT/FULL JOIN with empty right side: all left rows
            # null-extended
            for ex in self.left.execute():
                yield self._null_extend_all(ex)
            return
        # build side: hash + sort keys
        prep, self._prepared_build = self._prepared_build, None
        if prep is not None and prep[0] is build:
            # fused-fragment degrade handoff: the build finalize already
            # ran as one step and the runtime filters are already on the
            # probe scans: do neither again
            _, sorted_hash, order, bvalid, bkeys, bkey_dicts = prep
        else:
            bkeys, bkey_dicts = build_key_columns(self.node, build)
            sorted_hash, order, bvalid = build_sorted_hash(bkeys,
                                                           build.mask)
            if self.node.kind in ("inner", "semi"):
                self._push_runtime_filters(bkeys, bvalid)
        build_matched = None
        probe_dicts = {}
        if self.node.kind == "full":
            build_matched = torch.zeros(build.padded_len, dtype=torch.bool,
                                        device=build.device)
        for ex in self.left.execute():
            if keyless:
                ex = _compact_live(ex)
            probe_dicts.update(ex.dicts)
            out, build_matched = self._probe(
                ex, build, sorted_hash, order, bkeys, bkey_dicts,
                build_matched)
            yield out
        if self.node.kind == "full":
            yield self._unmatched_build(build, build_matched, probe_dicts)

    # ------------------------------------------------------------- grace
    def _grace(self, prefix: List[ExecBatch], rest) -> Iterator[ExecBatch]:
        """Build side over budget: hash-partition BOTH sides to host disk
        by the join key, then run each partition through the normal
        in-memory join (reference: spillutil/join_spill.go)."""
        M.join_spills.inc()
        spill = _JoinSpill(self.SPILL_PARTITIONS)
        try:
            for ex in itertools.chain(prefix, rest):
                self._partition_side(spill, ex, "build",
                                     self.node.right_keys,
                                     self.node.right.schema)
            for ex in self.left.execute():
                self._partition_side(spill, ex, "probe",
                                     self.node.left_keys,
                                     self.node.left.schema)
            M.spill_partitions.inc(spill.P, kind="join")
            for p in range(spill.P):
                sub = JoinOp(
                    self.node,
                    _ReplayOp(spill.chunks("probe", p),
                              self.node.left.schema, spill.device),
                    _ReplayOp(spill.chunks("build", p),
                              self.node.right.schema, spill.device),
                    max_matches=self.max_matches)
                # a partition joins in memory; key skew concentrating a
                # partition past the budget would recurse on identical
                # hashes forever, so partitions never re-spill
                sub.build_budget = 1 << 62
                yield from sub.execute()
        finally:
            spill.cleanup()

    def _partition_side(self, spill: _JoinSpill, ex: ExecBatch, side: str,
                        keys, schema) -> None:
        """Route each live row to partition hash(key) mod P (the hash
        read as unsigned, as the reference reads it).  NULL-key rows
        ride their hash too: they never match, but left/anti/full joins
        still emit them from within their partition.  Varchar keys route
        by a stable VALUE hash of the string (each side partitions
        independently, so codes cannot agree across sides)."""
        t0 = time.perf_counter()
        if spill.device is None:
            spill.device = ex.device
        kcols = []
        for k in keys:
            c = _broadcast_full(eval_expr(k, ex), ex.padded_len)
            if k.dtype.is_varlen:
                d = _expr_dict(k, ex)
                if d:
                    lut = np.asarray([_str_hash_i64(s) for s in d],
                                     np.int64)
                    idx = torch.clamp(c.data.to(torch.int64), 0,
                                      max(len(d) - 1, 0))
                    c = DeviceColumn(to_device(lut, ex.device)[idx],
                                     c.validity, c.dtype)
                else:
                    # None (unresolvable: the in-memory join inside the
                    # partition raises) or empty (all-NULL: routing is
                    # irrelevant, NULL keys never match)
                    c = DeviceColumn(torch.zeros(c.data.shape,
                                                 dtype=torch.int64,
                                                 device=ex.device),
                                     c.validity, c.dtype)
            kcols.append(c)
        h = H.hash_columns([k.data for k in kcols],
                           [k.validity for k in kcols])
        part_np = unsigned_mod(h, spill.P).cpu().numpy()
        live = np.nonzero(ex.mask.cpu().numpy())[0]
        # live rows grouped by partition, in row order inside each
        order = live[np.argsort(part_np[live], kind="stable")]
        ends = np.cumsum(np.bincount(part_np[order], minlength=spill.P))
        host_cols, host_val = {}, {}
        for name, _dtype in schema:
            c = _broadcast_full(ex.batch.columns[name], ex.padded_len)
            host_cols[name] = c.data.cpu().numpy()[order]
            host_val[name] = c.validity.cpu().numpy()[order]
        t0 = _spill_time("partition", t0)
        start = 0
        for p in range(spill.P):
            end = int(ends[p])
            if end > start:
                spill.add(side, p,
                          {n: a[start:end] for n, a in host_cols.items()},
                          {n: v[start:end] for n, v in host_val.items()},
                          ex.dicts, end - start)
            start = end
        _spill_time("write", t0)

    def _unmatched_build(self, build: ExecBatch, build_matched,
                         probe_dicts) -> ExecBatch:
        """FULL OUTER: the build rows no probe row matched, probe-side
        columns null-extended (the probe loop already null-extended the
        unmatched probe rows)."""
        unmatched = build.mask & ~build_matched
        nb = build.padded_len
        cols = {name: _null_column(dtype, nb, build.device)
                for name, dtype in self.node.left.schema}
        for name, _ in self.node.right.schema:
            cols[name] = _broadcast_full(build.batch.columns[name], nb)
        db = DeviceBatch(columns=cols,
                         n_rows=unmatched.to(torch.int32).sum())
        # probe-side varchar columns are all-NULL here but expressions
        # above the join still resolve them through their dictionary
        dicts = {**probe_dicts, **build.dicts}
        for name, dtype in self.node.left.schema:
            if dtype.is_varlen:
                dicts.setdefault(name, [""])
        return ExecBatch(batch=db, dicts=dicts, mask=unmatched)

    def _push_runtime_filters(self, bkeys, bvalid) -> None:
        """Build-side key min/max pushed into probe-side scans before the
        probe starts (reference: runtimeFilterMsg sent hashbuild -> scan).
        Inner/semi only — removing non-matching probe rows early cannot
        change the result."""
        specs = runtime_filter_specs(self.node)
        if not specs:
            return
        lo, hi, any_valid = runtime_filter_ranges(specs, bkeys, bvalid)
        self.apply_runtime_filters(specs, lo.tolist(), hi.tolist(),
                                   bool(any_valid))

    def apply_runtime_filters(self, specs, lo_list, hi_list,
                              any_valid: bool) -> None:
        """Inject ge/le runtime filters for build-key ranges computed on
        the device (shared with the fused build step, which returns the
        ranges as outputs)."""
        if not any_valid:
            return
        for (_i, lk), lo_v, hi_v in zip(specs, lo_list, hi_list):
            lo_v, hi_v = int(lo_v), int(hi_v)
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
               bkey_dicts, build_matched=None):
        """One probe batch -> (its output batch, build_matched')."""
        pkeys = probe_key_columns(self.node, ex, bkey_dicts)
        phash, pvalid = hash_valid_keys(pkeys, ex.mask)
        # without keys every live build row matches: start at the whole
        # build side instead of doubling up to it
        mm = (self.max_matches if self.node.right_keys
              else build.padded_len)
        while True:
            out, overflow, bm = expand_probe(
                self.node, ex, build, sorted_hash, border, phash,
                pvalid, pkeys, bkeys, mm, build_matched)
            if not bool(overflow):
                break
            mm *= 2
        if self.node.kind in ("semi", "anti"):
            return collapse_semi_anti(self.node, ex, out.mask, mm), bm
        return _maybe_compact(out), bm

    def _cross(self, build):
        if build is None:
            return
        for ex in self.left.execute():
            yield _maybe_compact(_cross_product(self.node, _compact_live(ex),
                                                build))

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


def _cross_product(node, ex: ExecBatch, build: ExecBatch) -> ExecBatch:
    """Every live probe row of `ex` against every live build row:
    np * nb lanes, probe-major, then the residual."""
    np_, nb = ex.padded_len, build.padded_len
    device = ex.device
    probe_idx = torch.arange(np_, device=device).repeat_interleave(nb)
    build_idx = torch.arange(nb, device=device).repeat(np_)
    emit = ex.mask.repeat_interleave(nb) & build.mask.repeat(np_)
    cols = {}
    for name, _ in node.left.schema:
        c = _broadcast_full(ex.batch.columns[name], np_)
        cols[name] = DeviceColumn(c.data[probe_idx], c.validity[probe_idx],
                                  c.dtype)
    for name, _ in node.right.schema:
        c = _broadcast_full(build.batch.columns[name], nb)
        cols[name] = DeviceColumn(c.data[build_idx], c.validity[build_idx],
                                  c.dtype)
    db = DeviceBatch(columns=cols, n_rows=emit.to(torch.int32).sum())
    out = ExecBatch(batch=db, dicts={**build.dicts, **ex.dicts}, mask=emit)
    if node.residual is not None:
        pred = eval_expr(node.residual, out)
        out.mask = out.mask & F.predicate_mask(pred, db)
    return out
