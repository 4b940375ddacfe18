"""Distributed query execution over the slot mesh (`parallel/mesh.py`).

The port of `matrixone_tpu/parallel/dist_query.py` (reference analogue:
`compile/scope.go:504 ParallelRun`, `colexec/shuffle` + `dispatch` +
`merge*`).  One process drives every slot, as the reference's one
controller drives every device:

  reference                      here
  ---------------------------    -----------------------------------
  rows sharded over mesh axis    one tensor per slot (`shard_rows`)
  psum / pmax in shard_map       `mesh.psum` / `pmax`, slot order
  all_gather of [b, k]           `mesh.all_gather`, slot order
  all_to_all repartition         `mesh.all_to_all`, source order

The primitives `sharded_group_aggregate`, `sharded_topk`, `hash_shuffle`
and `distributed_q1` are the reference's, on per-slot tensors.

The SQL shard executor: `fragments.plan_split` decides the fragment as
for remote CNs; each shard's clone of it (through `sql/serde.py`) is
compiled against a shard-routed scan (`shard=(s, n)` for chunk round
robin, `hash_shard=(col, s, n)` for a hash exchange) and run on its
slot's device, through the fused fragments: a captured graph is keyed by
the exchange's shape and the device, never by the shard index, so on one
card one graph serves every shard.  A replay overwrites that graph's
outputs, so a shard's partial leaves the graph as a copy
(`FusedFragmentOp.partial_state`) before the next shard runs.
The partials merge once (`merge_exec`): a dense psum, or a single
re-group of every shard's representative rows.  Broadcast join builds
are materialized once and shared by every shard's plan.

Degrade, never a wrong answer, and never a hidden card: `try_shard`
returns None (the caller runs one device) only for the planning
refusals — fewer slots than shards, fewer than 2 shards, an input under
`dist_min_rows`, operators that do not shard (`plan_split`) — and for a
`ShardDegrade` a shard raises (divergent dictionaries, a group table
past the device budget).  The session refuses an open transaction
before it calls.  Every other error surfaces: out of memory, a failed
launch, a kernel that does not build, a bug here.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from matrixone_tpu_torch.ops import agg as A, distance as D, hash as H
from matrixone_tpu_torch.ops.topk import topk_smallest
from matrixone_tpu_torch.parallel import mesh as MS
from matrixone_tpu_torch.parallel.merge_exec import (  # noqa: F401
    SITE_MERGE, _MERGE_CALLS, ShardDegrade, _dense_merge,
    _general_merge, _merge_key_dicts, _merge_trackers, _scalar_combine)
from matrixone_tpu_torch.sql import plan as PL
from matrixone_tpu_torch.utils import metrics as M, motrace


# ---------------------------------------------------------------- group by

def sharded_group_aggregate(mesh: MS.Mesh, keys, values, row_mask,
                            max_groups: int):
    """Distributed `SELECT key, sum(v), count(*) GROUP BY key` over
    per-slot tensors: a dense-bucket segment aggregate per slot, then
    psum (sums, counts) and pmax (keys) onto slot 0.  Exact when keys
    are dense codes in [0, max_groups).  -> (group_keys, sums, counts,
    present), each [max_groups]."""
    sums, counts, ktbl = [], [], []
    for k, v, m in zip(keys, values, row_mask):
        bucket = k.clamp(0, max_groups - 1).to(torch.int32)
        sums.append(A.seg_sum(v, bucket, m, max_groups))
        counts.append(A.seg_count(bucket, m, max_groups))
        ktbl.append(A.seg_max(k, bucket, m, max_groups))
    dst = mesh.slots[0]
    counts = MS.psum(counts, dst)
    return (MS.pmax(ktbl, dst), MS.psum(sums, dst), counts, counts > 0)


# ----------------------------------------------------------------- top-k

def sharded_topk(mesh: MS.Mesh, vectors, queries: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of row-sharded vectors (one [n/S, d] tensor per slot)
    for replicated queries: each slot's L2 distances and local top-k,
    then one all_gather of [b, k] per slot and a global top-k."""
    n_per = int(vectors[0].shape[0])
    dst = mesh.slots[0]
    top_s, top_i = [], []
    for s, (v_sh, d) in enumerate(zip(vectors, mesh.slots)):
        dist = D.l2_distance_sq(v_sh, queries.to(d))        # [n_sh, b]
        ls, li = topk_smallest(dist.T, k)                   # [b, k]
        top_s.append(ls)
        top_i.append(li + s * n_per)                        # global rows
    all_s = MS.all_gather(top_s, dst, dim=1)
    all_i = MS.all_gather(top_i, dst, dim=1)
    best_s, pos = topk_smallest(all_s, k)
    return best_s, all_i.gather(1, pos)


# ---------------------------------------------------------------- shuffle

class ShuffleOverflow(RuntimeError):
    """cap_per_dest was too small for the key skew; re-run with the
    reported capacity."""

    def __init__(self, needed: int):
        super().__init__(
            f"hash_shuffle bucket overflow: a destination needs capacity "
            f"{needed}; re-run with cap_per_dest >= {needed}")
        self.needed = needed


def hash_shuffle(mesh: MS.Mesh, keys, values,
                 cap_per_dest: Optional[int] = None):
    """all_to_all hash repartition: row (k, v) moves to slot
    hash(k) % S (the reference's `colexec/shuffle` hash mode).  Each
    source slot packs a [S, cap] bucket table (default cap: its row
    count, lossless), and slot p receives the S tables' row p in source
    order.  An undersized `cap_per_dest` raises ShuffleOverflow with the
    capacity needed: rows are never dropped.  -> (keys', values') per
    slot, key -1 marking padding."""
    n_dev = mesh.size
    buckets_k, buckets_v, needs = [], [], []
    for k_sh, v_sh in zip(keys, values):
        n = int(k_sh.shape[0])
        cap = n if cap_per_dest is None else cap_per_dest
        dest = H.unsigned_mod(H.hash_column(k_sh), n_dev)
        order = torch.argsort(dest, stable=True)
        k_srt, v_srt, d_srt = k_sh[order], v_sh[order], dest[order]
        idx = torch.arange(n, device=k_sh.device)
        start = torch.cat([torch.ones(1, dtype=torch.bool,
                                      device=k_sh.device),
                           d_srt[1:] != d_srt[:-1]])
        seg_start = torch.where(start, idx, torch.zeros_like(idx))
        rank = idx - torch.cummax(seg_start, 0).values
        needs.append(rank.max() + 1 if n else
                     torch.zeros((), dtype=torch.int64,
                                 device=k_sh.device))
        slot_k = torch.full((n_dev, cap), -1, dtype=k_sh.dtype,
                            device=k_sh.device)
        slot_v = torch.zeros((n_dev, cap), dtype=v_sh.dtype,
                             device=v_sh.device)
        ok = rank < cap
        slot_k[d_srt[ok], rank[ok]] = k_srt[ok]
        slot_v[d_srt[ok], rank[ok]] = v_srt[ok]
        buckets_k.append(list(slot_k))
        buckets_v.append(list(slot_v))
    if cap_per_dest is not None:
        needed = int(MS.pmax(needs, mesh.slots[0]))
        if needed > cap_per_dest:
            raise ShuffleOverflow(needed)
    return MS.all_to_all(mesh, buckets_k), MS.all_to_all(mesh, buckets_v)


# ----------------------------------------------------------- full Q1 step

def distributed_q1(mesh: MS.Mesh, cols: dict, n_flags: int = 4,
                   n_status: int = 2):
    """TPC-H Q1 over per-slot columns: each slot's masked segment sums
    into the dense (returnflag x linestatus) table, psum-merged onto
    slot 0.  cols: per-slot lists {flag, status (int codes), qty, price,
    disc, tax (int64 scaled), mask}.  -> sum_qty, sum_base, sum_disc,
    sum_charge, count, present, keyed by flag * n_status + status."""
    g = n_flags * n_status
    fields = [[] for _ in range(5)]
    for s in range(mesh.size):
        gid = (cols["flag"][s] * n_status + cols["status"][s]).to(
            torch.int32)
        m = cols["mask"][s]
        price = cols["price"][s]
        disc_price = price * (100 - cols["disc"][s])     # scale 4
        charge = disc_price * (100 + cols["tax"][s])     # scale 6
        for f, v in zip(fields, (cols["qty"][s], price, disc_price,
                                 charge)):
            f.append(A.seg_sum(v, gid, m, g))
        fields[4].append(A.seg_count(gid, m, g))
    out = [MS.psum(f, mesh.slots[0]) for f in fields]
    return tuple(out) + (out[4] > 0,)


# =====================================================================
# the SQL shard executor
# =====================================================================

def _shuffle_min_build() -> int:
    return int(os.environ.get("MO_SHUFFLE_BUILD_ROWS", "65536") or 65536)


@dataclasses.dataclass
class _JoinX:
    """One spine join's exchange decision."""
    prefix: tuple                  # attr path from the fragment root
    node: object                   # the ORIGINAL join node (read-only)
    mode: str                      # broadcast | shuffle | local
    lcol: Optional[str] = None     # probe-scan raw hash column (shuffle)
    rpath: Optional[tuple] = None  # path inside node.right to its scan
    rcol: Optional[str] = None     # build-scan raw hash column (shuffle)


@dataclasses.dataclass
class _XPlan:
    joins: List[_JoinX]
    probe_mode: str                # "rr" (chunk round-robin) | "hash"
    probe_col: Optional[str]
    modes_by_id: dict              # id(original node) -> mode (EXPLAIN)


def _node_at(root, path):
    cur = root
    for attr in path:
        cur = getattr(cur, attr)
    return cur


def _spine_joins(root, scan_path):
    """[(prefix, join_node)] for every join on the probe spine, top
    first, and the probe scan node itself."""
    out = []
    cur = root
    for i, step in enumerate(scan_path):
        if step == "left":
            out.append((tuple(scan_path[:i]), cur))
        cur = getattr(cur, step)
    return out, cur


def _filter_only_scan(node):
    """(path, scan) walking Filter nodes ONLY: the join key's name maps
    1:1 onto the scan schema (a Project rename would break it)."""
    path = []
    cur = node
    while True:
        if isinstance(cur, PL.Scan):
            return tuple(path), cur
        if isinstance(cur, PL.Filter):
            path.append("child")
            cur = cur.child
            continue
        return None


def _qcol_to_raw(scan, qname: str) -> Optional[str]:
    """Qualified column name -> the scan's raw storage column, when the
    column is int-backed (the hash routing domain)."""
    for (qn, d), raw in zip(scan.schema, scan.columns):
        if qn == qname:
            if d.is_varlen or not np.issubdtype(np.dtype(d.np_dtype),
                                                np.integer):
                return None
            return raw
    return None


def _partition_spec(catalog, table: str):
    try:
        return catalog.get_table(table).meta.partition
    except Exception:           # noqa: BLE001 — a table without meta
        return None


def _co_partitioned(catalog, table: str, col: str, n_shards: int) -> bool:
    spec = _partition_spec(catalog, table)
    return (spec is not None and spec.kind == "hash"
            and spec.column == col and spec.n_parts == n_shards)


def _partition_sig(catalog, table: str):
    spec = _partition_spec(catalog, table)
    return None if spec is None else tuple(sorted(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in spec.to_json().items()))


def _shuffle_choice(j, catalog, n_shards: int):
    """Shuffle or broadcast for the bottom spine join (the CBO's build-
    side cardinality and the runtime filter's key ranges).  ->
    (mode, probe_raw_col, right_path, right_raw_col), or None for
    broadcast."""
    from matrixone_tpu_torch.sql import cbo
    from matrixone_tpu_torch.sql.expr import BoundCol
    from matrixone_tpu_torch.sql.stats import provider_for
    if j.kind != "inner" or not j.left_keys or j.residual is not None:
        return None
    lk, rk = j.left_keys[0], j.right_keys[0]
    if not (isinstance(lk, BoundCol) and isinstance(rk, BoundCol)):
        return None
    lwalk = _filter_only_scan(j.left)
    rwalk = _filter_only_scan(j.right)
    if lwalk is None or rwalk is None:
        return None
    (_lpath, lscan), (rpath, rscan) = lwalk, rwalk
    lraw = _qcol_to_raw(lscan, lk.name)
    rraw = _qcol_to_raw(rscan, rk.name)
    if lraw is None or rraw is None:
        return None
    sp = provider_for(catalog)
    est_r = cbo.estimate(j.right, sp)
    if est_r.rows < _shuffle_min_build():
        return None            # small build: replicate it, keep rr scans
    # a build whose key range is much narrower than the probe's already
    # prunes most probe rows shard-locally through the runtime filter:
    # broadcast keeps that pruning movement-free
    est_l = cbo.estimate(j.left, sp)
    br = est_r.cols.get(rk.name)
    pr = est_l.cols.get(lk.name)
    if br and pr and None not in (br[1], br[2], pr[1], pr[2]):
        bw, pw = br[2] - br[1], pr[2] - pr[1]
        if pw > 0 and bw < pw / 4:
            return None
    mode = "local" if (_co_partitioned(catalog, lscan.table, lraw,
                                       n_shards)
                       and _co_partitioned(catalog, rscan.table, rraw,
                                           n_shards)) else "shuffle"
    return mode, lraw, rpath, rraw


def _plan_exchanges(split, catalog, n_shards: int) -> _XPlan:
    """Classify every exchange of the fragment: each spine join gets
    broadcast/shuffle/local, the probe scan rr or hash routing."""
    modes: dict = {}
    if split.kind == "join":
        j = split.split
        ch = _shuffle_choice(j, catalog, n_shards)
        if ch is None:
            jx = _JoinX((), j, "broadcast")
            probe_mode, probe_col = "rr", None
        else:
            mode, lraw, rpath, rraw = ch
            jx = _JoinX((), j, mode, lcol=lraw, rpath=rpath, rcol=rraw)
            probe_mode, probe_col = "hash", lraw
        modes[id(j)] = jx.mode
        lscan = _node_at(j.left, split.scan_path)
        modes[id(lscan)] = "local" if jx.mode in ("broadcast", "local") \
            else "shuffle"
        return _XPlan([jx], probe_mode, probe_col, modes)
    root = split.split.child
    joins, scan = _spine_joins(root, split.scan_path)
    xj: List[_JoinX] = []
    probe_mode, probe_col = "rr", None
    for i, (prefix, j) in enumerate(joins):
        mode, lraw, rpath, rraw = "broadcast", None, None, None
        if i == len(joins) - 1:
            ch = _shuffle_choice(j, catalog, n_shards)
            if ch is not None:
                mode, lraw, rpath, rraw = ch
                probe_mode, probe_col = "hash", lraw
        xj.append(_JoinX(prefix, j, mode, lcol=lraw, rpath=rpath,
                         rcol=rraw))
        modes[id(j)] = mode
    if probe_mode == "rr":
        modes[id(scan)] = "local"
    else:
        modes[id(scan)] = "local" if xj[-1].mode == "local" else "shuffle"
    return _XPlan(xj, probe_mode, probe_col, modes)


# ------------------------------------------------------- materialization

def _empty_materialized(schema) -> PL.Materialized:
    arrays = {nm: ([] if d.is_varlen else np.zeros(0, d.np_dtype))
              for nm, d in schema}
    valid = {nm: np.zeros(0, np.bool_) for nm, _ in schema}
    return PL.Materialized(arrays, valid, schema)


def _materialize(op, schema) -> PL.Materialized:
    """A broadcast build's rows on the host.  A varlen column stays
    dictionary codes when every batch carries the same dictionary (a
    scan's table dictionary: no string is decoded, and every shard's
    `MaterializedOp` uploads the codes as they are); else its strings
    are decoded, as the reference's `_collect_arrays` decodes all."""
    from matrixone_tpu_torch.ops import filter as F
    parts = []
    for ex in op.execute():
        db = F.compact(ex.batch, ex.mask, ex.padded_len)
        n = int(db.n_rows)
        if n == 0:
            continue
        arrays, valid = {}, {}
        for name, _dtype in schema:
            col = db.columns[name]
            data, v = col.data.cpu().numpy(), col.validity.cpu().numpy()
            if col.is_const:
                data = np.broadcast_to(data, (n,) + data.shape[1:])
                v = np.broadcast_to(v, (n,))
            arrays[name], valid[name] = data[:n], v[:n]
        parts.append((arrays, valid, ex.dicts))
    if not parts:
        return _empty_materialized(schema)
    arrays, valid, dicts = {}, {}, {}
    for name, dtype in schema:
        valid[name] = np.concatenate([p[1][name] for p in parts])
        if not dtype.is_varlen:
            arrays[name] = np.concatenate([p[0][name] for p in parts])
            continue
        ds = [p[2].get(name) for p in parts]
        if ds[0] is not None and all(d is ds[0] or d == ds[0]
                                     for d in ds[1:]):
            arrays[name] = np.concatenate(
                [p[0][name] for p in parts]).astype(np.int32)
            dicts[name] = list(ds[0])
        else:
            arrays[name] = [d[c] if ok else None for p, d in zip(parts, ds)
                            for c, ok in zip(p[0][name], p[1][name])]
    return PL.Materialized(arrays, valid, schema, dicts=dicts)


def _mat_nbytes(mat: PL.Materialized) -> int:
    total = 0
    for nm, _d in mat.schema:
        a = mat.arrays[nm]
        if isinstance(a, np.ndarray):
            total += a.nbytes
        else:
            total += len(a) + sum(len(s) for s in a if s is not None)
        d = mat.dicts.get(nm)
        if d is not None:
            total += sum(len(s) for s in d)
        v = mat.validity.get(nm)
        if isinstance(v, np.ndarray):
            total += v.nbytes
    return total


def _concat_materialized(parts, vparts, n_total, schema) -> PL.Materialized:
    if not n_total:
        return _empty_materialized(schema)
    arrays, valid = {}, {}
    for nm, d in schema:
        if d.is_varlen:
            merged: list = []
            for p in parts:
                merged.extend(p[nm])
            arrays[nm] = merged
        else:
            arrays[nm] = np.concatenate([p[nm] for p in parts])
        valid[nm] = np.concatenate([v[nm] for v in vparts])
    return PL.Materialized(arrays, valid, schema)


def _ex_to_materialized(ex, schema) -> PL.Materialized:
    """The finalized merge's ExecBatch -> a host Materialized (varlen
    columns carried as codes with their dictionary)."""
    pres = ex.mask.cpu().numpy().astype(bool)
    arrays, valid, dicts = {}, {}, {}
    for name, dtype in schema:
        col = ex.batch.columns[name]
        data = col.data.cpu().numpy()
        vm = col.validity.cpu().numpy()
        if data.shape[0] != len(pres):          # a constant column
            data = np.broadcast_to(data, (len(pres),) + data.shape[1:])
        if vm.shape[0] != len(pres):
            vm = np.broadcast_to(vm, (len(pres),))
        data, vm = data[pres], vm[pres]
        if dtype.is_varlen:
            d = ex.dicts.get(name)
            if d is None and not pres.any():
                d = []                          # no row to decode
            if d is None:
                raise ShardDegrade(
                    f"varlen column {name!r} finalized without a "
                    f"dictionary")
            arrays[name] = np.clip(data.astype(np.int64), 0,
                                   max(len(d) - 1, 0)).astype(np.int32)
            dicts[name] = list(d)
        else:
            arrays[name] = data
        valid[name] = vm
    return PL.Materialized(arrays, valid, schema, dicts=dicts)


# ------------------------------------------------------------- execution

def _to(x, device):
    """Every tensor of a partial moved to `device` (no copy where it is
    there already)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def _broadcast_builds(xp: _XPlan, ctx, n_shards: int) -> dict:
    """Materialize every broadcast join's build side ONCE; the shared
    Materialized node goes into every shard's plan (its bytes counted
    once per non-owning shard)."""
    from matrixone_tpu_torch.vm.compile import compile_plan
    out = {}
    for jx in xp.joins:
        if jx.mode != "broadcast":
            continue
        with motrace.span("shard.broadcast"):
            op = compile_plan(jx.node.right, ctx)
            mat = _materialize(op, jx.node.right.schema)
        M.exchange_broadcast_bytes.inc(_mat_nbytes(mat) * (n_shards - 1))
        out[jx.prefix] = mat
    return out


def _apply_exchanges(root, xp: _XPlan, bc: dict, s: int, n_shards: int,
                     scan_path):
    for jx in xp.joins:
        j = _node_at(root, jx.prefix)
        if jx.mode == "broadcast":
            j.right = bc[jx.prefix]
        else:
            rscan = _node_at(j.right, jx.rpath)
            rscan.hash_shard = (jx.rcol, s, n_shards)
    sc = _node_at(root, scan_path)
    if xp.probe_mode == "hash":
        sc.hash_shard = (xp.probe_col, s, n_shards)
    else:
        sc.shard = (s, n_shards)


def _exec_agg(split, xp, catalog, ctx, mesh: MS.Mesh):
    from matrixone_tpu_torch.sql.serde import plan_from_json, plan_to_json
    from matrixone_tpu_torch.vm.compile import compile_plan
    from matrixone_tpu_torch.vm.operators import AggOp
    agg = split.split
    n_shards = mesh.size
    child_json = plan_to_json(agg.child)
    bc = _broadcast_builds(xp, ctx, n_shards)
    psig = _partition_sig(catalog, split.scan_table)
    grouped = bool(agg.group_keys)
    parts = []
    for s, slot in enumerate(mesh.slots):
        plan_s = plan_from_json(child_json)
        _apply_exchanges(plan_s, xp, bc, s, n_shards, split.scan_path)
        with motrace.span("shard.partial", shard=s):
            # the Aggregate itself is compiled, so a dense or scalar
            # terminal fuses into the shard's graph like the local one's
            op = compile_plan(PL.Aggregate(plan_s, agg.group_keys,
                                           agg.aggs, agg.schema),
                              dataclasses.replace(ctx, device=slot))
            if grouped:
                parts.append(op.partial_state())
            else:
                parts.append(op.partial_scalar_state())
    dst = ctx.device
    merger = AggOp(PL.Aggregate(agg.child, agg.group_keys, agg.aggs,
                                agg.schema), None, ctx)
    if not grouped:
        tracker = _merge_trackers([p[1] for p in parts], agg.aggs)
        merged = [None] * len(agg.aggs)
        with motrace.span("shard.merge", kind="scalar"):
            for states, _tr in parts:
                for j, a in enumerate(agg.aggs):
                    if states[j] is None:
                        continue
                    st = _to(states[j], dst)
                    merged[j] = st if merged[j] is None else \
                        _scalar_combine(a, merged[j], st)
            ex = merger._scalar_result(merged, tracker, dst)
        M.exchange_partial_merge.inc(1, kind="scalar")
        return _ex_to_materialized(ex, agg.schema)
    key_dicts = _merge_key_dicts([p[2] for p in parts],
                                 len(agg.group_keys))
    tracker = _merge_trackers([p[3] for p in parts], agg.aggs)
    denses = [p[1] for p in parts if p[0] == "dense"]
    states = [p[1] for p in parts if p[0] == "general"]
    if denses and not states \
            and len({d["sizes"] for d in denses}) == 1 and len(denses) > 1:
        with motrace.span("shard.merge", kind="dense"):
            state = _dense_merge(merger, denses, psig, dst)
        mkind = "dense"
    else:
        states = states + [merger._dense_to_state(d) for d in denses]
        if not states:
            state = merger._empty_state(dst)
            mkind = "empty"
        elif len(states) == 1:
            state = states[0]
            mkind = "single"
        else:
            with motrace.span("shard.merge", kind="general"):
                state = _general_merge(states, agg.aggs, psig, dst)
            mkind = "general"
    M.exchange_partial_merge.inc(1, kind=mkind)
    merger._agg_tracker = tracker
    ex = merger._finalize(state, key_dicts)
    return _ex_to_materialized(ex, agg.schema)


def _collect_shards(ctx, mesh: MS.Mesh, node, place):
    """Run `node`'s clone on every slot (`place(clone, s)` routes it) and
    bring each shard's rows to the host before the next shard runs."""
    from matrixone_tpu_torch.parallel import fragments as FR
    from matrixone_tpu_torch.sql.serde import plan_from_json, plan_to_json
    from matrixone_tpu_torch.vm.compile import compile_plan
    node_json = plan_to_json(node)
    parts, vparts, n_total = [], [], 0
    for s, slot in enumerate(mesh.slots):
        loc = place(plan_from_json(node_json), s)
        with motrace.span("shard.partial", shard=s):
            op = compile_plan(loc, dataclasses.replace(ctx, device=slot))
            arrays, valid, n = FR._collect_arrays(op, node.schema)
        if n:
            parts.append(arrays)
            vparts.append(valid)
            n_total += n
    return parts, vparts, n_total


def _exec_topk(split, xp, catalog, ctx, mesh: MS.Mesh):
    tk = split.split
    n_shards = mesh.size
    bc = _broadcast_builds(xp, ctx, n_shards)

    def place(loc, s):
        loc = dataclasses.replace(loc, k=tk.k + tk.offset, offset=0)
        _apply_exchanges(loc.child, xp, bc, s, n_shards, split.scan_path)
        return loc

    parts, vparts, n_total = _collect_shards(ctx, mesh, tk, place)
    mat = _concat_materialized(parts, vparts, n_total, tk.schema)
    M.exchange_partial_merge.inc(1, kind="topk")
    # the ORIGINAL TopK re-runs over the union: every global top-k row
    # is inside its shard's local top-(k + offset)
    return dataclasses.replace(tk, child=mat)


def _exec_join(split, xp, catalog, ctx, mesh: MS.Mesh):
    j = split.split
    jx = xp.joins[0]
    n_shards = mesh.size
    bc = _broadcast_builds(xp, ctx, n_shards)

    def place(loc, s):
        lscan = _node_at(loc.left, split.scan_path)
        if jx.mode == "broadcast":
            loc.right = bc[jx.prefix]
            lscan.shard = (s, n_shards)
        else:
            lscan.hash_shard = (jx.lcol, s, n_shards)
            rscan = _node_at(loc.right, jx.rpath)
            rscan.hash_shard = (jx.rcol, s, n_shards)
        return loc

    parts, vparts, n_total = _collect_shards(ctx, mesh, j, place)
    M.exchange_partial_merge.inc(1, kind="join")
    return _concat_materialized(parts, vparts, n_total, j.schema)


# -------------------------------------------------------------- entrypoint

def _mesh_for(ctx, n_shards: int) -> Optional[MS.Mesh]:
    if n_shards < 2:
        return None
    slots = MS.devices(ctx.device)
    if len(slots) < n_shards:
        return None
    return MS.Mesh(tuple(slots[:n_shards]))


def try_shard(node, catalog, ctx, n_shards: int,
              min_rows: int = 100_000):
    """Run `node`'s distributable fragment across n_shards slots and
    return the rewritten plan (the uppers over a Materialized merge
    result), or None to run on one device: the mesh has fewer slots,
    fewer than 2 shards, the input is small, an operator does not shard,
    or a shard raised ShardDegrade.  Every other error surfaces."""
    from matrixone_tpu_torch.parallel import fragments as FR
    mesh = _mesh_for(ctx, n_shards)
    if mesh is None:
        return None
    split = FR.plan_split(node, catalog, min_rows=min_rows)
    if split is None:
        return None
    xp = _plan_exchanges(split, catalog, n_shards)
    run = {"agg": _exec_agg, "topk": _exec_topk,
           "join": _exec_join}[split.kind]
    try:
        with motrace.span("shard.exec", kind=split.kind, shards=n_shards):
            leaf = run(split, xp, catalog, ctx, mesh)
    except ShardDegrade as e:
        print(f"[shard] degrading to single-device execution: {e}",
              file=sys.stderr)
        return None
    return FR._rebuild_uppers(split.uppers, leaf)


def explain_exchanges(node, catalog, ctx, n_shards: int,
                      min_rows: int = 100_000) -> dict:
    """id(plan node) -> exchange mode for the EXPLAIN annotation; empty
    when the plan would not shard."""
    from matrixone_tpu_torch.parallel import fragments as FR
    if _mesh_for(ctx, n_shards) is None:
        return {}
    split = FR.plan_split(node, catalog, min_rows=min_rows)
    if split is None:
        return {}
    return _plan_exchanges(split, catalog, n_shards).modes_by_id
