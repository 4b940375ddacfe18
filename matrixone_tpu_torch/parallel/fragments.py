"""Plan fragments: where a plan splits, and its execution on host peers.

The port of `matrixone_tpu/parallel/fragments.py` (reference analogue:
`compile/remoterun.go:86 encodeScope` + `proto/pipeline.proto:529`,
operator subtrees shipped to peer CNs over morpc).

Planning (`plan_split`, the compiler's Magic: Remote decision,
`compile/types.go:162`): the fragment below the uppers (Project, TopK,
Sort, Limit, Filter, Distinct) that runs once per shard (a partial
aggregate, a local top-k, or an inner join of two big scans) and the
scan whose rows partition it.  Two executors run it: the device-shard
executor (`parallel/dist_query.py`) on the slots of the mesh, and the
host-peer executor below on fragment servers (`cluster/cn.py`).

Host peers: every peer holds the whole table (an engine it shares, or a
CN replica fed by the TN's logtail), so a fragment ships as a JSON plan
(`sql/serde`) with ONE scan marked `shard=(i, n)`: peer i reads every
n-th chunk of that scan's chunk sequence, and every other scan (a join's
build side) is read from the peer's own copy, a broadcast with nothing
on the wire.  The peer compiles the fragment against its device, so its
scans upload there and its joins and f32 grouped sums launch the port's
kernels.  Three fragment kinds, all exact:

  * partial_agg: the peer runs the Aggregate to its partial state
    (`AggOp.partial_state`, the device-shard executor's) and ships it;
    the coordinator merges the states once (`merge_exec`) and finalizes,
    as the device-shard executor does;
  * collect: the peer runs a local top-(k + offset) and ships its rows;
    the ORIGINAL TopK re-runs over their union at the coordinator;
  * shuffle join: both sides hash-repartitioned by the join key across
    the peers, peer to peer (`shuffle_put`), each bucket joined on its
    peer, the buckets' rows concatenated at the coordinator.

Rows, partial states and shuffle buckets travel as `cluster/wire.py`
blobs, the WAL's column format.  The bucket hash is the port's own
(`_stable_row_hash`): deterministic across processes, integers widened
to int64 first, so an int key and a bigint key meet.

Degrade, never a wrong answer, and never a hidden card: `try_distribute`
returns None (the session runs the statement locally) for a transport
fault (`TransportError`, `DeadlineExceeded`, `BreakerOpen`: a peer that
is gone or stuck), a planning refusal (an open transaction, a plan that
`plan_split` refuses, an input under `dist_min_rows`) and a layout
disagreement (peers that report different table signatures, a layout
that changed under a fragment, divergent group-key dictionaries, a
replica that cannot reach the snapshot).  A peer's response carries
`err_name` of its exception; a fragment that failed on the peer's
device (a failed launch, out of memory) or any other executor error
raises `FragmentError` at the client.

Merge safety: the coordinator holds a txn lease for the duration
(`txn_opened`), so no merge starts and rewrites row ids under the
peers' pinned snapshot; the signature checks catch one in flight.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import sys
import threading
import time
import uuid
from concurrent import futures
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from matrixone_tpu_torch.container.batch import from_device
from matrixone_tpu_torch.ops import filter as F
from matrixone_tpu_torch.sql import plan as P
from matrixone_tpu_torch.sql.parser import BASIC_AGGS, STDDEV_AGGS
from matrixone_tpu_torch.sql.serde import plan_to_json
from matrixone_tpu_torch.utils import metrics as M

# the second-moment family distributes too: its sum/sumsq/count fields
# merge by addition, as the classic five's do
_ALLOWED_AGGS = BASIC_AGGS | STDDEV_AGGS
_dist_ids = itertools.count(1 << 40)


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




# =====================================================================
# errors
# =====================================================================

class FragmentError(RuntimeError):
    """A fragment failed inside a peer's executor (a failed launch, out
    of memory on its device, a bug): it surfaces at the client."""


class FragmentDegrade(RuntimeError):
    """A failure the statement survives by running locally (never a
    wrong answer): the sharded table's layout changed under a fragment
    or peers disagree on it, a replica cannot serve the snapshot, a
    shuffle's buckets never all arrived."""


def degrade_errors() -> tuple:
    """The exceptions that degrade a distributed statement to a local
    run, on both sides of the fabric: a peer answers `degrade: True`
    for them, and `try_distribute` catches them.  They are the fabric's
    own failures (`RpcError`: transport, deadline, open breaker), a
    FragmentDegrade, a shard merge's ShardDegrade and a broken replica.
    Every other exception is a fragment's executor error (a failed
    launch, out of memory on the device) and surfaces at the client."""
    from matrixone_tpu_torch.cluster.cn import ReplicaBrokenError
    from matrixone_tpu_torch.cluster.rpc import RpcError
    from matrixone_tpu_torch.parallel.merge_exec import ShardDegrade
    return (RpcError, FragmentDegrade, ShardDegrade, ReplicaBrokenError)


# =====================================================================
# peer side: execute one fragment against the local copy
# =====================================================================

#: session knobs that steer how a fragment compiles, forwarded so a
#: distributed run behaves as the local one does
_FORWARD_VARS = ("plan_fusion", "join_build_budget")


def _wait_snapshot(catalog, header: dict) -> None:
    consumer = getattr(catalog, "consumer", None)
    snap = header.get("snapshot_ts")
    if consumer is not None and snap is not None:
        try:
            consumer.wait_ts(snap)     # the replica must reach it
        except TimeoutError as e:
            raise FragmentDegrade(f"the replica did not reach snapshot "
                                  f"{snap}: {e}") from e


def _exec_ctx(catalog, header: dict, device):
    from matrixone_tpu_torch.vm.process import ExecContext
    return ExecContext(catalog=catalog,
                       frozen_ts=header.get("snapshot_ts"),
                       variables={"batch_rows":
                                  int(header.get("batch_rows", 1 << 16)),
                                  **header.get("session_vars", {})},
                       device=device)


def table_signature(catalog, table: str, snap: Optional[int]) -> str:
    """Fingerprint of the chunk-sequence-determining layout visible at
    `snap`: every peer must report the same one, or the shard strides do
    not partition the table (a merge resync in flight)."""
    import json
    t = catalog.get_table(table)
    segs = [(s.seg_id, s.base_gid, s.n_rows) for s in t.segments
            if snap is None or s.commit_ts <= snap]
    return hashlib.sha1(json.dumps(segs).encode()).hexdigest()


def _signed(catalog, header: dict, run):
    """Run a fragment between two signature reads of its sharded table:
    the layout must not change under the scan."""
    table = header.get("shard_table")
    snap = header.get("snapshot_ts")
    sig = table_signature(catalog, table, snap) if table else None
    resp, parts = run()
    if sig is not None:
        if table_signature(catalog, table, snap) != sig:
            raise FragmentDegrade("table layout changed during fragment "
                                  "execution (merge resync)")
        resp["table_sig"] = sig
    return resp, parts


def execute_fragment(catalog, header: dict, device
                     ) -> Tuple[dict, list]:
    """Run a fragment header against `catalog` (a CN's RemoteCatalog or
    an Engine) on `device`.  -> (response header, blob parts)."""
    from matrixone_tpu_torch.sql.serde import plan_from_json
    from matrixone_tpu_torch.vm.compile import compile_plan
    _wait_snapshot(catalog, header)
    ctx = _exec_ctx(catalog, header, device)
    plan = plan_from_json(header["plan"])
    kind = header["kind"]
    if kind not in ("collect", "partial_agg"):
        raise ValueError(f"unknown fragment kind {kind!r}")

    def run():
        op = compile_plan(plan, ctx)
        if kind == "collect":
            return _run_collect(op, plan.schema)
        if plan.group_keys:
            return _run_partial_grouped(op, plan)
        return _run_partial_scalar(op, plan)
    return _signed(catalog, header, run)


def _host_column(col, n: int) -> Tuple[np.ndarray, np.ndarray]:
    data, v = col.data.cpu().numpy(), col.validity.cpu().numpy()
    if col.is_const:
        return (np.broadcast_to(data, (n,) + data.shape[1:]),
                np.broadcast_to(v, (n,)))
    return data[:n], v[:n]


def _collect_encoded(op, schema) -> Tuple[dict, dict, int]:
    """The fragment's rows on the host in wire form: numeric columns as
    arrays, varchar columns as DictEncoded (the batch's dictionary codes,
    re-encoded batch-locally; no string is decoded where a dictionary
    exists).  -> (arrays, validity, n_rows)."""
    from matrixone_tpu_torch.cluster import wire
    from matrixone_tpu_torch.storage.wal import to_dict_encoded
    parts, n_total = [], 0
    for ex in op.execute():
        db = F.compact(ex.batch, ex.mask, ex.padded_len)
        n = int(db.n_rows)
        if n == 0:
            continue
        n_total += n
        arrays, valid = {}, {}
        host = None
        for name, dtype in schema:
            data, v = _host_column(db.columns[name], n)
            valid[name] = np.ascontiguousarray(v, dtype=np.bool_)
            if not dtype.is_varlen:
                arrays[name] = np.ascontiguousarray(data)
                continue
            d = ex.dicts.get(name)
            if d is not None:
                arrays[name] = to_dict_encoded(d, data, valid[name])
            else:                        # computed strings: decode once
                if host is None:
                    host = from_device(db, ex.dicts, schema=dict(schema))
                arrays[name] = wire.encode_strings(
                    host.columns[name].to_pylist())
        parts.append((arrays, valid))
    return (*_concat_wire(parts, schema), n_total)


def _concat_wire(parts, schema) -> Tuple[dict, dict]:
    """Concatenate wire-form parts [(arrays, validity)] of one schema
    (DictEncoded columns merged into one dictionary)."""
    from matrixone_tpu_torch.cluster import wire
    from matrixone_tpu_torch.storage.wal import DictEncoded
    arrays, valid = {}, {}
    for name, dtype in schema:
        cols = [a[name] for a, _v in parts]
        valid[name] = (np.concatenate([v[name] for _a, v in parts])
                       if parts else np.zeros(0, np.bool_))
        if dtype.is_varlen:
            codes, cats = wire.merge_encoded(cols)
            arrays[name] = DictEncoded(codes, cats)
        elif cols:
            arrays[name] = np.concatenate(cols)
        else:
            arrays[name] = np.zeros(0, dtype.np_dtype)
    return arrays, valid


def _wire_materialized(blobs, schema) -> P.Materialized:
    """Wire blobs of one schema -> one Materialized node: varchar columns
    as codes into one union dictionary (MaterializedOp uploads them as
    they are)."""
    from matrixone_tpu_torch.cluster import wire
    parts = []
    for b in blobs:
        a, v = wire.unpack(b)
        if v:
            parts.append((a, v))
    arrays, valid = _concat_wire(parts, schema)
    out, dicts = {}, {}
    for name, dtype in schema:
        if dtype.is_varlen:
            col = arrays[name]
            out[name] = np.asarray(col.codes, np.int32)
            dicts[name] = list(col.cats) or [""]
        else:
            out[name] = arrays[name]
    return P.Materialized(out, valid, schema, dicts=dicts)


def _run_collect(op, schema) -> Tuple[dict, list]:
    from matrixone_tpu_torch.cluster import wire
    arrays, valid, n = _collect_encoded(op, schema)
    if n == 0:
        return {"ok": True, "n": 0}, []
    return {"ok": True, "n": n}, wire.pack_parts(arrays, valid)


def _np(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy())


def _run_partial_grouped(op, agg: P.Aggregate) -> Tuple[dict, list]:
    """The aggregate's partial state (`AggOp.partial_state`, fused or
    not) on the wire.  A dense state ships whole, with its (small) key
    dictionaries in the header; a general state ships its present rows,
    varchar keys as DictEncoded over the peer's dictionary."""
    from matrixone_tpu_torch.cluster import wire
    from matrixone_tpu_torch.storage.wal import to_dict_encoded
    kind, payload, key_dicts, _tracker = op.partial_state()
    arrays = {}
    if kind == "empty":
        return {"ok": True, "state": "empty"}, []
    if kind == "dense":
        arrays["_rows"] = _np(payload["rows"])
        for j, part in enumerate(payload["partials"]):
            for f, t in part.items():
                arrays[f"_a{j}_{f}"] = _np(t)
        return ({"ok": True, "state": "dense",
                 "sizes": [int(x) for x in payload["sizes"]],
                 "key_dicts": [None if d is None else list(d)
                               for d in key_dicts]},
                wire.pack_parts(arrays, {}))
    present = payload["present"].nonzero().flatten()
    for i, (k, kd) in enumerate(zip(agg.group_keys, key_dicts)):
        codes = _np(payload["keys"][i][present])
        kv = _np(payload["kvalid"][i][present])
        arrays[f"_kv{i}"] = kv
        if k.dtype.is_varlen:
            arrays[f"_k{i}"] = to_dict_encoded(kd or [], codes, kv)
        else:
            arrays[f"_k{i}"] = codes
    for j, part in enumerate(payload["partials"]):
        for f, t in part.items():
            arrays[f"_a{j}_{f}"] = _np(t[present])
    return ({"ok": True, "state": "general", "n": int(len(present))},
            wire.pack_parts(arrays, {}))


def _run_partial_scalar(op, agg: P.Aggregate) -> Tuple[dict, list]:
    """Per-aggregate scalar partials: None, a count, or a tuple of
    0-d tensors (`shapes`: None, -1 or the tuple's length)."""
    from matrixone_tpu_torch.cluster import wire
    states, _tracker = op.partial_scalar_state()
    arrays, shapes = {}, []
    for j, st in enumerate(states):
        if st is None:
            shapes.append(None)
            continue
        parts = [st] if isinstance(st, torch.Tensor) else list(st)
        shapes.append(-1 if isinstance(st, torch.Tensor) else len(parts))
        for i, t in enumerate(parts):
            arrays[f"_s{j}_{i}"] = _np(t).reshape(1)
    return ({"ok": True, "state": "scalar", "shapes": shapes},
            wire.pack_parts(arrays, {}))


# =====================================================================
# coordinator side: split, ship, merge
# =====================================================================

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


# =====================================================================
# host peers: the coordinator
# =====================================================================

def shard_of_peer(addrs, table: str) -> Dict[int, int]:
    """Stable shard ownership (reference: pkg/shardservice
    types.go:67): each table's shards map to peers by a deterministic
    hash permutation, so the same peer scans the same shard of a table
    across statements and coordinators (its blocks stay warm in one
    CN's cache).  -> {peer index: shard index}."""
    n = len(addrs)
    perm = sorted(range(n), key=lambda i: hashlib.sha1(
        f"{addrs[i]}|{table}".encode()).digest())
    return {perm[s]: s for s in range(n)}


def _set_shard(plan_json: dict, path: List[str], i: int, n: int) -> dict:
    import copy
    out = copy.deepcopy(plan_json)
    cur = out
    for attr in path:
        cur = cur[attr]
    cur["shard"] = [i, n]
    return out


_pool_guard = threading.Lock()


def pool_for(catalog) -> "FragmentPeers":
    """The catalog's shared FragmentPeers pool over its `dist_peers`
    (made again, the old one closed, when the peer list changes)."""
    addrs = list(catalog.dist_peers)
    with _pool_guard:
        pool = getattr(catalog, "_frag_pool", None)
        if pool is None or pool.addrs != addrs:
            if pool is not None:
                pool.close()
            pool = FragmentPeers(addrs)
            catalog._frag_pool = pool
    return pool


class FragmentPeers:
    """Pooled RpcClients over the peers' fragment endpoints, LANES warm
    sockets each (a shuffle's two sides overlap on a peer).  The timeout
    is generous, since a cold peer builds its kernels and captures its
    graphs on its first statement; `MO_FRAG_TIMEOUT` overrides it (the
    chaos drills shrink it so a dead peer trips its breaker in
    seconds)."""

    LANES = 2

    def __init__(self, addrs, timeout: Optional[float] = None):
        from matrixone_tpu_torch.cluster.rpc import RpcClient, _env_float
        if timeout is None:
            timeout = _env_float("MO_FRAG_TIMEOUT", 180.0)
        self.timeout = timeout
        self.addrs = list(addrs)
        self.clients = [RpcClient(a, timeout=timeout, pool_size=self.LANES)
                        for a in self.addrs]

    def close(self) -> None:
        for c in self.clients:
            c.close()

    def run(self, headers: List[dict]) -> List[Tuple[dict, bytes]]:
        """One fragment per header, header i on peer i % n, all at once.
        A transport fault raises the fabric's error; a peer's answer
        flagged `degrade` FragmentDegrade; any other failure
        FragmentError."""
        from matrixone_tpu_torch.cluster.rpc import deadline_scope
        n = len(self.addrs)

        def one(i):
            c = self.clients[i % n]
            # fragments are read-only: transport retries are safe, and a
            # peer whose breaker is open fails the batch at once
            with deadline_scope(self.timeout):
                resp, blob = c.call({"op": "run_fragment", **headers[i]},
                                    retryable=True)
            if not resp.get("ok"):
                where = f"fragment on {self.addrs[i % n]}"
                if resp.get("degrade"):
                    raise FragmentDegrade(f"{where}: {resp.get('err')}")
                raise FragmentError(f"{where}: {resp.get('err')}")
            M.fragment_wire_bytes.inc(len(blob), kind="result")
            return resp, blob
        with futures.ThreadPoolExecutor(
                max_workers=max(2, len(headers))) as pool:
            return list(pool.map(one, range(len(headers))))


def try_distribute(node, catalog, ctx, peers: FragmentPeers,
                   min_rows: int = 0, batch_rows: int = 1 << 16):
    """If the plan qualifies, run its lower fragment on `peers` and
    return the rebuilt plan (the uppers over a Materialized merge
    result); None -> the caller runs the plan locally: a planning
    refusal, a transport fault or a layout disagreement.  Every other
    error (a fragment that failed inside a peer's executor) raises."""
    from matrixone_tpu_torch.utils import motrace
    if ctx.txn is not None:
        return None       # peers cannot see an open txn's workspace
    split = plan_split(node, catalog, min_rows)
    if split is None:
        return None
    did = next(_dist_ids)
    opened = False
    try:
        # lease first, snapshot second: with the lease held no merge can
        # start, and the signature checks catch one already in flight
        catalog.txn_opened(did)
        opened = True
        consumer = getattr(catalog, "consumer", None)
        if consumer is not None:
            # a CN coordinator: its committed_ts may hold local-only
            # commits that never ride the logtail; the replicated
            # frontier is the consumer's applied position
            snap = consumer.applied_ts or None
        else:
            snap = max(ctx.snapshot_ts or 0,
                       getattr(catalog, "committed_ts", 0)) or None
        sess_vars = {k: v for k, v in (ctx.variables or {}).items()
                     if k in _FORWARD_VARS}
        run = {"agg": _dist_aggregate, "join": _dist_shuffle_join,
               "topk": _dist_topk}[split.kind]
        with motrace.span("peer.exec", kind=split.kind,
                          peers=len(peers.addrs)):
            mat = run(split, catalog, snap, peers, batch_rows, sess_vars,
                      ctx)
    except degrade_errors() as e:
        print(f"[dist] running locally: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return None
    finally:
        if opened:
            try:
                catalog.txn_closed(did)
            except degrade_errors():
                pass            # the lease expires on its own
    return _rebuild_uppers(split.uppers, mat)


def _check_sigs(results) -> None:
    sigs = {r[0].get("table_sig") for r in results}
    if len(sigs) > 1:
        raise FragmentDegrade(
            f"peers disagree on the sharded table's layout ({sigs}): a "
            f"merge resync is in flight")


def _common(split, snap, batch_rows, sess_vars) -> dict:
    return {"snapshot_ts": snap, "batch_rows": batch_rows,
            "session_vars": sess_vars or {},
            "shard_table": split.scan_table}


def _dist_aggregate(split: _Split, catalog, snap, peers: FragmentPeers,
                    batch_rows: int, sess_vars, ctx) -> P.Materialized:
    from matrixone_tpu_torch.parallel.dist_query import _partition_sig
    agg: P.Aggregate = split.split
    n = len(peers.addrs)
    agg_json = plan_to_json(agg)
    owners = shard_of_peer(peers.addrs, split.scan_table)
    headers = [{"kind": "partial_agg",
                "plan": _set_shard(agg_json, ["child"] + split.scan_path,
                                   owners[i], n),
                **_common(split, snap, batch_rows, sess_vars)}
               for i in range(n)]
    results = peers.run(headers)
    _check_sigs(results)
    psig = _partition_sig(catalog, split.scan_table)
    if agg.group_keys:
        parts = [_decode_grouped(r, b, agg, ctx.device) for r, b in results]
        return _merge_grouped(agg, parts, psig, ctx)
    return _merge_scalar(agg, [_decode_scalar(r, b, ctx.device)
                               for r, b in results], ctx)


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def _fields_of(arrays: dict, j: int, device) -> dict:
    pre = f"_a{j}_"
    return {k[len(pre):]: _t(v, device) for k, v in arrays.items()
            if k.startswith(pre)}


def _decode_grouped(resp: dict, blob, agg: P.Aggregate, device):
    """A peer's grouped partial -> `AggOp.partial_state`'s (kind,
    payload, key_dicts) on `device`; a general state's varchar keys are
    codes into the part's own dictionary (its DictEncoded categories)."""
    from matrixone_tpu_torch.cluster import wire
    nkeys = len(agg.group_keys)
    state = resp.get("state")
    if state == "empty":
        return "empty", None, [None] * nkeys
    arrays, _v = wire.unpack(blob)
    partials = [_fields_of(arrays, j, device) for j in range(len(agg.aggs))]
    if state == "dense":
        return ("dense", {"sizes": tuple(resp["sizes"]),
                          "rows": _t(arrays["_rows"], device),
                          "partials": partials},
                [None if d is None else list(d)
                 for d in resp["key_dicts"]])
    keys, kvalid, kdicts = [], [], []
    for i in range(nkeys):
        k = arrays[f"_k{i}"]
        if hasattr(k, "cats"):
            keys.append(_t(np.asarray(k.codes, np.int32), device))
            kdicts.append(list(k.cats))
        else:
            keys.append(_t(k, device))
            kdicts.append(None)
        kvalid.append(_t(arrays[f"_kv{i}"], device))
    n = int(resp["n"])
    return ("general",
            {"keys": keys, "kvalid": kvalid,
             "present": torch.ones((n,), dtype=torch.bool, device=device),
             "partials": partials,
             "n": torch.tensor(n, dtype=torch.int32, device=device)},
            kdicts)


def _remap_keys(states, agg: P.Aggregate, device) -> list:
    """Varchar group keys of every state re-coded into one union
    dictionary per key (in place).  -> the key dictionaries."""
    out: List[Optional[list]] = []
    for i, k in enumerate(agg.group_keys):
        if not k.dtype.is_varlen:
            out.append(None)
            continue
        union: List[str] = []
        lut: Dict[str, int] = {}
        for st, kd in states:
            if kd[i] is None:
                continue
            remap = np.empty(max(len(kd[i]), 1), np.int32)
            remap[0] = 0
            for c, s in enumerate(kd[i]):
                u = lut.get(s)
                if u is None:
                    u = lut[s] = len(union)
                    union.append(s)
                remap[c] = u
            codes = st["keys"][i].to(torch.int64).clamp(0, len(remap) - 1)
            st["keys"][i] = _t(remap, device)[codes]
        out.append(union or None)
    return out


def _merge_grouped(agg: P.Aggregate, parts, psig, ctx) -> P.Materialized:
    """mergegroup at the coordinator, as the device-shard executor
    merges: same-shape dense accumulators with one add, anything else
    re-grouped once over every peer's representative rows; then the
    local AggOp's finalize."""
    from matrixone_tpu_torch.parallel.dist_query import _ex_to_materialized
    from matrixone_tpu_torch.parallel.merge_exec import (_dense_merge,
                                                         _general_merge)
    from matrixone_tpu_torch.vm.operators import AggOp, _AggDictTracker
    dst = ctx.device
    merger = AggOp(P.Aggregate(agg.child, agg.group_keys, agg.aggs,
                               agg.schema), None, ctx)
    merger._agg_tracker = _AggDictTracker(agg.aggs)
    denses = [p for p in parts if p[0] == "dense"]
    # a peer whose shard held no group ships a general state of 0 rows
    gens = [p for p in parts if p[0] == "general"
            and p[1]["present"].shape[0]]
    if len(denses) > 1 and not gens \
            and len({d[1]["sizes"] for d in denses}) == 1 \
            and all(d[2] == denses[0][2] for d in denses):
        state = _dense_merge(merger, [d[1] for d in denses], psig, dst)
        key_dicts = denses[0][2]
    else:
        states = ([(merger._dense_to_state(d[1]), d[2]) for d in denses]
                  + [(g[1], g[2]) for g in gens])
        key_dicts = _remap_keys(states, agg, dst)
        if not states:
            state = merger._empty_state(dst)
        elif len(states) == 1:
            state = states[0][0]
        else:
            state = _general_merge([s for s, _kd in states], agg.aggs,
                                   psig, dst)
    ex = merger._finalize(state, key_dicts)
    return _ex_to_materialized(ex, agg.schema)


def _decode_scalar(resp: dict, blob, device) -> list:
    from matrixone_tpu_torch.cluster import wire
    arrays, _v = wire.unpack(blob)
    out = []
    for j, shape in enumerate(resp["shapes"]):
        if shape is None:
            out.append(None)
            continue
        ts = [_t(arrays[f"_s{j}_{i}"], device).reshape(())
              for i in range(1 if shape == -1 else shape)]
        out.append(ts[0] if shape == -1 else tuple(ts))
    return out


def _merge_scalar(agg: P.Aggregate, parts, ctx) -> P.Materialized:
    from matrixone_tpu_torch.parallel.dist_query import _ex_to_materialized
    from matrixone_tpu_torch.parallel.merge_exec import _scalar_combine
    from matrixone_tpu_torch.vm.operators import AggOp, _AggDictTracker
    merged = [None] * len(agg.aggs)
    for states in parts:
        for j, a in enumerate(agg.aggs):
            st = states[j]
            if st is not None:
                merged[j] = st if merged[j] is None else \
                    _scalar_combine(a, merged[j], st)
    merger = AggOp(P.Aggregate(agg.child, agg.group_keys, agg.aggs,
                               agg.schema), None, ctx)
    ex = merger._scalar_result(merged, _AggDictTracker(agg.aggs),
                               ctx.device)
    return _ex_to_materialized(ex, agg.schema)


def _dist_topk(split: _Split, catalog, snap, peers: FragmentPeers,
               batch_rows: int, sess_vars, ctx) -> P.PlanNode:
    """Each peer's top-(k + offset) over its shard, concatenated; the
    ORIGINAL TopK re-runs over the union (exact: every global top-k row
    is in its shard's local top-(k + offset))."""
    tk: P.TopK = split.split
    local = dataclasses.replace(tk, k=tk.k + tk.offset, offset=0)
    n = len(peers.addrs)
    tk_json = plan_to_json(local)
    owners = shard_of_peer(peers.addrs, split.scan_table)
    headers = [{"kind": "collect",
                "plan": _set_shard(tk_json, ["child"] + split.scan_path,
                                   owners[i], n),
                **_common(split, snap, batch_rows, sess_vars)}
               for i in range(n)]
    results = peers.run(headers)
    _check_sigs(results)
    mat = _wire_materialized([b for r, b in results if r.get("n", 0)],
                             tk.schema)
    return dataclasses.replace(tk, child=mat)


# =====================================================================
# shuffle join (reference: plan/shuffle.go determineShuffleMethod +
# colexec/shuffle + dispatch): both sides hash-repartitioned by the join
# key across the peers, each peer joins its buckets, the coordinator
# concatenates.  Exact for inner equi-joins: equal keys land in the same
# bucket on both sides.
# =====================================================================

_MIX = np.uint64(0x9E3779B1)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    z = x + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _string_hash(s: str) -> int:
    return int.from_bytes(hashlib.blake2b(s.encode(),
                                          digest_size=8).digest(), "little")


def _stable_row_hash(cols: List[object]) -> np.ndarray:
    """Deterministic cross-process row hash of the join key columns:
    splitmix64 of integers widened to int64 (so an int key and a bigint
    key hash alike) and of floats widened to float64 (-0.0 as 0.0); a
    varchar column (DictEncoded) hashes each of its strings once
    (BLAKE2b, 8 bytes).  Columns combine with an odd multiplier.  The
    JAX package's hash is pandas' siphash, which the card machine
    lacks: the buckets differ from the reference's, the joined rows do
    not."""
    out = None
    with np.errstate(over="ignore"):
        for c in cols:
            if hasattr(c, "cats"):
                ch = np.array([_string_hash(s) for s in c.cats],
                              dtype=np.uint64)
                codes = np.asarray(c.codes, np.int64)
                h = (ch[np.clip(codes, 0, len(ch) - 1)] if len(ch)
                     else np.zeros(len(codes), np.uint64))
            else:
                a = np.asarray(c)
                if a.dtype.kind in ("i", "u", "b"):
                    a = a.astype(np.int64).view(np.uint64)
                elif a.dtype.kind == "f":
                    a = (a.astype(np.float64) + 0.0).view(np.uint64)
                else:
                    raise TypeError(f"cannot hash a {a.dtype} join key")
                h = _splitmix64(a)
            out = h if out is None else (out * _MIX) ^ h
    return out


class ShuffleStore:
    """A peer's mailbox of in-flight shuffle buckets, keyed by
    (shuffle_id, side, to): it takes pushes from every peer (its own
    bucket too) and hands the join phase a complete set.  The
    destination rides in the key so fragment servers that share an
    engine (tests, one-process rigs) keep each recipient's buckets
    apart."""

    #: buckets orphaned by a failed phase 1 (the coordinator also sends
    #: shuffle_drop, which a dead coordinator cannot) go on later traffic
    TTL_S = 600.0

    def __init__(self):
        self._cond = threading.Condition()
        self._buckets: Dict[tuple, Dict[int, bytes]] = {}
        self._born: Dict[tuple, float] = {}

    def put(self, shuffle_id, side: str, frm: int, to: int, blob) -> None:
        now = time.monotonic()
        with self._cond:
            self._prune_locked(now)
            self._buckets.setdefault((shuffle_id, side, to), {})[frm] = blob
            self._born.setdefault((shuffle_id, side, to), now)
            self._cond.notify_all()

    def _prune_locked(self, now: float) -> None:
        for k in [k for k, t0 in self._born.items()
                  if now - t0 > self.TTL_S]:
            self._buckets.pop(k, None)
            self._born.pop(k, None)

    def wait_all(self, shuffle_id, side: str, to: int, expect: int,
                 timeout: float = 120.0) -> Dict[int, bytes]:
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                got = self._buckets.get((shuffle_id, side, to), {})
                if len(got) >= expect:
                    return dict(got)
                left = deadline - time.monotonic()
                if left <= 0:
                    raise FragmentDegrade(
                        f"shuffle {shuffle_id}/{side}->{to}: "
                        f"{len(got)}/{expect} buckets after timeout")
                self._cond.wait(left)

    def drop(self, shuffle_id, to: int) -> None:
        with self._cond:
            for k in [k for k in self._buckets
                      if k[0] == shuffle_id and k[2] == to]:
                del self._buckets[k]
                self._born.pop(k, None)

    def drop_sid(self, shuffle_id) -> None:
        """Every bucket of a failed shuffle, all destinations."""
        with self._cond:
            for k in [k for k in self._buckets if k[0] == shuffle_id]:
                del self._buckets[k]
                self._born.pop(k, None)


def shuffle_store_for(catalog) -> ShuffleStore:
    with _pool_guard:
        st = getattr(catalog, "_shuffle_store", None)
        if st is None:
            st = catalog._shuffle_store = ShuffleStore()
    return st


def _take(arrays: dict, valid: dict, rows: np.ndarray, schema
          ) -> Tuple[dict, dict]:
    """Rows `rows` of wire-form columns (varchar re-encoded to the
    categories those rows use)."""
    from matrixone_tpu_torch.storage.wal import to_dict_encoded
    ba, bv = {}, {}
    for nm, d in schema:
        bv[nm] = valid[nm][rows]
        a = arrays[nm]
        ba[nm] = (to_dict_encoded(a.cats, np.asarray(a.codes)[rows],
                                  bv[nm]) if d.is_varlen else a[rows])
    return ba, bv


def run_shuffle_scan(catalog, header: dict, device) -> Tuple[dict, list]:
    """Phase 1 on a peer: run the sharded scan subtree, hash its rows
    into n buckets by the join key, push each bucket to its owner peer
    (CN to CN, not through the coordinator), keep its own."""
    from matrixone_tpu_torch.cluster import wire
    from matrixone_tpu_torch.cluster.rpc import RpcClient
    from matrixone_tpu_torch.sql.serde import plan_from_json
    from matrixone_tpu_torch.vm.compile import compile_plan
    _wait_snapshot(catalog, header)
    # the mailbox of the BASE catalog: the fragment server's shuffle_put
    # handler puts into the same one
    store = shuffle_store_for(catalog)
    ctx = _exec_ctx(catalog, header, device)
    plan = plan_from_json(header["plan"])
    schema = plan.schema
    key_names = header["key_names"]
    n = int(header["n_buckets"])
    me = int(header["my_index"])
    sid = str(header["shuffle_id"])
    side = header["side"]

    def run():
        op = compile_plan(plan, ctx)
        arrays, valid, n_rows = _collect_encoded(op, schema)
        buckets = ((_stable_row_hash([arrays[k] for k in key_names])
                    % np.uint64(n)).astype(np.int64) if n_rows
                   else np.zeros(0, np.int64))
        order = np.argsort(buckets, kind="stable")
        bounds = np.searchsorted(buckets[order], np.arange(n + 1))
        pushed = sent_bytes = 0
        for j in range(n):
            rows = order[bounds[j]:bounds[j + 1]]
            ba, bv = _take(arrays, valid, rows, schema)
            parts = wire.pack_parts(ba, bv)
            if j == me:
                store.put(sid, side, me, me,
                          b"".join(bytes(p) for p in parts))
                continue
            c = RpcClient(tuple(header["peer_addrs"][j]), timeout=60.0)
            try:
                # idempotent: a retried put overwrites the same bucket
                # key with the same bytes
                r, _ = c.call({"op": "shuffle_put", "shuffle_id": sid,
                               "side": side, "from": me, "to": j},
                              parts, retryable=True)
                if not r.get("ok"):
                    raise FragmentDegrade(f"shuffle_put to peer {j}: "
                                          f"{r.get('err')}")
            finally:
                c.close()
            pushed += len(rows)
            sent_bytes += sum(memoryview(p).nbytes for p in parts)
        M.fragment_pushed_rows.inc(pushed)
        M.fragment_wire_bytes.inc(sent_bytes, kind="shuffle")
        return {"ok": True, "n": n_rows, "pushed": pushed,
                "pushed_bytes": sent_bytes}, []
    return _signed(catalog, header, run)


def run_shuffle_join(catalog, header: dict, device) -> Tuple[dict, list]:
    """Phase 2 on a peer: its buckets of both sides, joined on its
    device; the joined rows go back."""
    from matrixone_tpu_torch.sql.serde import (expr_from_json,
                                               schema_cols_from_json)
    from matrixone_tpu_torch.vm.compile import compile_plan
    store = shuffle_store_for(catalog)
    sid = str(header["shuffle_id"])
    expect = int(header["n_buckets"])
    me = int(header["my_index"])
    lschema = schema_cols_from_json(header["left_schema"])
    rschema = schema_cols_from_json(header["right_schema"])
    try:
        lparts = store.wait_all(sid, "L", me, expect)
        rparts = store.wait_all(sid, "R", me, expect)
        left = _wire_materialized([lparts[k] for k in sorted(lparts)],
                                  lschema)
        right = _wire_materialized([rparts[k] for k in sorted(rparts)],
                                   rschema)
    finally:
        store.drop(sid, me)
    join = P.Join(kind="inner", left=left, right=right,
                  left_keys=[expr_from_json(k)
                             for k in header["left_keys"]],
                  right_keys=[expr_from_json(k)
                              for k in header["right_keys"]],
                  residual=None,
                  schema=schema_cols_from_json(header["out_schema"]))
    op = compile_plan(join, _exec_ctx(catalog, header, device))
    return _run_collect(op, join.schema)


def _shuffle_cleanup(peers: FragmentPeers, sid) -> None:
    """Best effort after a failed shuffle: peers drop the buckets they
    got, rather than hold them until the TTL."""
    from matrixone_tpu_torch.cluster.rpc import RpcClient, parse_addr
    for a in peers.addrs:
        try:
            c = RpcClient(parse_addr(a), timeout=5.0)
            try:
                c.call({"op": "shuffle_drop", "shuffle_id": sid})
            finally:
                c.close()
        except Exception:      # noqa: BLE001 — cleanup is best effort
            pass


def _dist_shuffle_join(split: _Split, catalog, snap,
                       peers: FragmentPeers, batch_rows: int, sess_vars,
                       ctx) -> P.Materialized:
    from matrixone_tpu_torch.cluster.rpc import parse_addr
    from matrixone_tpu_torch.sql.serde import (expr_to_json,
                                               schema_cols_to_json)
    join: P.Join = split.split
    n = len(peers.addrs)
    # unique across coordinators: several may shuffle through the same
    # peers at once
    sid = uuid.uuid4().hex
    common = {"snapshot_ts": snap, "batch_rows": batch_rows,
              "session_vars": sess_vars or {}, "shuffle_id": sid,
              "n_buckets": n,
              "peer_addrs": [list(parse_addr(a)) for a in peers.addrs]}
    ljson = plan_to_json(join.left)
    rjson = plan_to_json(join.right)
    lowners = shard_of_peer(peers.addrs, split.scan_table)
    rowners = shard_of_peer(peers.addrs, split.right_table)
    # phase 1: both sides scatter at once (2n fragments in one run)
    headers = [{**common, "kind": "shuffle_scan",
                "plan": _set_shard(ljson, split.scan_path, lowners[i], n),
                "side": "L", "my_index": i,
                "key_names": [k.name for k in join.left_keys],
                "shard_table": split.scan_table} for i in range(n)]
    headers += [{**common, "kind": "shuffle_scan",
                 "plan": _set_shard(rjson, split.right_path, rowners[i], n),
                 "side": "R", "my_index": i,
                 "key_names": [k.name for k in join.right_keys],
                 "shard_table": split.right_table} for i in range(n)]
    try:
        results = peers.run(headers)
        _check_sigs(results[:n])
        _check_sigs(results[n:])
        # phase 2: every peer joins its buckets
        jres = peers.run([{
            **common, "kind": "shuffle_join", "my_index": i,
            "left_schema": schema_cols_to_json(join.left.schema),
            "right_schema": schema_cols_to_json(join.right.schema),
            "out_schema": schema_cols_to_json(join.schema),
            "left_keys": [expr_to_json(k) for k in join.left_keys],
            "right_keys": [expr_to_json(k) for k in join.right_keys]}
            for i in range(n)])
    except BaseException:
        # peer-side mailbox cleanup after any failure, then re-raised
        _shuffle_cleanup(peers, sid)
        raise
    return _wire_materialized([b for r, b in jres if r.get("n", 0)],
                              join.schema)
