"""TN service: the storage and commit owner, and the logtail push server.

The port of `matrixone_tpu/cluster/tn.py` (reference analogue:
`pkg/tnservice` + `tae/rpc/handle.go:537,547`, CN commits over RPC, and
`tae/logtail/service/server.go:192`, the push server fanning commit
deltas out to subscribed CNs).  One fabric serves every lane: the
frame of `cluster/frame.py`, the request dedup and deadlines of
`cluster/rpc.py`.

The TN's WAL stream IS the logtail (`LogtailHub`: one serialization,
two consumers, durability and replication).  Ops: `ping`, `commit`,
`ddl`, `alloc_auto` / `observe_auto` (the auto-increment service),
`create_snapshot`, `restore_table`, `merge_table` (deferred while any
CN holds a txn lease), `checkpoint`, and the lease ops `txn_begin`,
`txn_end`, `txn_renew`; `subscribe` turns the connection into a one-way
logtail push.  The TN runs the materialized-view maintenance of its
engine, on `device` (CUDA unless the caller names the CPU).

Not ported yet (ROADMAP.md, section A, step 5): the quorum WAL over log
replicas and the HAKeeper registration of the JAX package's `main()`,
and the DDL records of publications, sources and dynamic tables, which
the port's engine does not hold (`_handle_ddl` raises, naming step 5).
"""

from __future__ import annotations

import itertools
import queue
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from matrixone_tpu_torch import resolve_device
from matrixone_tpu_torch.cluster import wire
from matrixone_tpu_torch.cluster.frame import recv_msg, send_msg
from matrixone_tpu_torch.cluster.rpc import (RequestDedup, deadline_scope,
                                             err_name, unpack_blobs)
from matrixone_tpu_torch.storage.engine import (ConflictError,
                                                ConstraintError,
                                                DuplicateKeyError, Engine,
                                                TableMeta, schema_from_json)
from matrixone_tpu_torch.storage.fileservice import FileService, LocalFS
from matrixone_tpu_torch.storage.wal import DictEncoded
from matrixone_tpu_torch.utils import motrace
from matrixone_tpu_torch.utils.lifecycle import ServiceThreads


class LogtailHub:
    """A tee over the engine's WAL: every append is durable (the inner
    WAL) and reaches the subscriber queues.

    The hub keeps the records since the last truncation in memory,
    seeded once from the durable log at start: a subscribe never reads
    the WAL again.  Fan-out runs on a dispatcher thread, so an append
    holds the hub lock only for the durable write and an enqueue; a slow
    subscriber never stalls a commit.

    The subscribe handoff: every record gets an LSN; the dispatcher
    publishes `_processed_lsn` and snapshots the subscriber list under
    the lock before it fans a record out, and `subscribe` reads
    `_processed_lsn`, slices the backlog up to it and registers its queue
    in one hold of the lock, so each record is delivered exactly once."""

    def __init__(self, wal):
        self.wal = wal
        self.last_ts = 0
        self._subs: List[queue.Queue] = []
        self._lock = threading.Lock()
        self._backlog: List[tuple] = []      # (lsn, header, blob)
        self._next_lsn = 1
        for h, b in wal.replay():            # the one read of the log
            self._backlog.append((self._next_lsn, h, bytes(b)))
            self.last_ts = max(self.last_ts, h.get("ts", 0))
            self._next_lsn += 1
        self._processed_lsn = self._next_lsn - 1
        self._dispatchq: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True, name="pt-tn-logtail")
        self._thread.start()

    # ---- the WAL interface the engine appends through
    def append(self, header: dict, blob=b"") -> None:
        if isinstance(blob, list):
            blob = b"".join(bytes(p) for p in blob)
        with self._lock:
            self.wal.append(header, blob)
            self.last_ts = max(self.last_ts, header.get("ts", 0))
            lsn = self._next_lsn
            self._next_lsn += 1
            self._backlog.append((lsn, header, blob))
            # enqueued under the lock: dispatch order is WAL order (the
            # applier's commit-group buffering relies on it)
            self._dispatchq.put((lsn, header, blob))

    def truncate(self) -> None:
        with self._lock:
            self.wal.truncate()
            # live subscribers still get what is queued; only future
            # subscribers start from the checkpoint (a resync)
            self._backlog = []

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                lsn, h, b = self._dispatchq.get(timeout=0.25)
            except queue.Empty:
                continue
            with self._lock:
                subs = list(self._subs)
                self._processed_lsn = lsn
            for q in subs:
                q.put((h, b))

    # ---- the logtail side
    def subscribe(self, from_ts: int) -> Tuple[list, queue.Queue]:
        """The records after from_ts, in WAL order, and a live queue.  A
        backlog cut mid-commit-group ends with inserts and deletes whose
        commit record arrives on the queue; the consumer's WalApplier
        buffers them until it does."""
        with self._lock:
            p = self._processed_lsn
            backlog = [(h, b) for lsn, h, b in self._backlog
                       if lsn <= p
                       and not (h.get("ts", 0) and h["ts"] <= from_ts)]
            q: queue.Queue = queue.Queue()
            self._subs.append(q)
            return backlog, q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            self._subs = [s for s in self._subs if s is not q]

    def safe_frontier(self, q: queue.Queue, committed_ts: int):
        """`committed_ts` only if every appended record was dispatched
        and this subscriber's queue is drained, else None (read
        committed_ts BEFORE calling: a committed ts implies its record
        already holds an LSN).  A frontier ahead of delivery would let a
        subscriber advance past records still in flight."""
        with self._lock:
            if self._processed_lsn == self._next_lsn - 1 and q.empty():
                return committed_ts
            return None


#: DDL records the port's engine cannot apply yet
_STEP5_DDL = ("create_publication", "drop_publication", "mark_source",
              "create_dynamic")


class TNService:
    """One TN: an Engine, the commit RPC, the logtail push and the DDL
    apply, served on 127.0.0.1:`port` (0: any free port)."""

    def __init__(self, fs: Optional[FileService] = None,
                 data_dir: Optional[str] = None, port: int = 0, wal=None,
                 device=None):
        self.device = resolve_device(device)
        if fs is None:
            fs = LocalFS(data_dir)
        self.engine = Engine.open(fs, wal=wal)
        # view maintenance (mview/maintain.py) runs on the TN's device
        self.engine.default_device = self.device
        self.hub = LogtailHub(self.engine.wal)
        self.engine.wal = self.hub
        # the cluster-wide active-txn registry: a CN leases a token per
        # open txn, merges defer while a live token exists, and leases
        # expire, so a CN killed mid-txn cannot block merges for ever
        self._remote_txns: Dict[str, float] = {}     # token -> deadline
        self._txn_lock = threading.Lock()
        self._txn_ids = itertools.count(1)
        # idempotency: a retried CN call (same rid, any connection)
        # replays the recorded response instead of running again
        self._rids = RequestDedup()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(64)
        self._stopping = threading.Event()
        self._svc = ServiceThreads("pt-tn")

    # ------------------------------------------------------------- serve
    def start(self) -> "TNService":
        self._svc.spawn_accept(self._serve)
        return self

    def _serve(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            self._svc.spawn_handler(self._handle, conn)

    def stop(self) -> List[str]:
        """Stop serving and join every thread of the service (the
        accept loop, each connection's handler, the logtail pushes, the
        hub's dispatcher).  -> the threads still alive (none)."""
        self._stopping.set()
        self.hub.stop()
        left = self._svc.shutdown(self._sock)
        self.engine.close()
        return left

    # ------------------------------------------------- remote txn leases
    def live_remote_txns(self) -> int:
        now = time.monotonic()
        with self._txn_lock:
            for tok in [t for t, dl in self._remote_txns.items()
                        if dl < now]:
                del self._remote_txns[tok]
            return len(self._remote_txns)

    # ----------------------------------------------------------- handlers
    def _handle(self, conn: socket.socket) -> None:
        try:
            while True:
                header, blob = recv_msg(conn)
                op = header.get("op")
                if op == "subscribe":
                    self._serve_logtail(conn, header.get("from_ts", 0))
                    return
                rid = header.get("rid")
                if rid:
                    # a retry of a call already executed (or still
                    # executing on another connection) replays its
                    # recorded response
                    dl_ms = header.get("deadline_ms") or 30_000
                    kind, ent = self._rids.claim(
                        rid, timeout=max(0.05, dl_ms / 1000.0))
                    if kind == "done":
                        send_msg(conn, dict(ent[0], dedup=True), ent[1])
                        continue
                # the caller's trace context and time budget ride the
                # same header; the TN's spans ship back on the response
                rs = motrace.remote_session(header, proc="tn",
                                            name=f"tn.{op}")
                try:
                    with deadline_scope(
                            ms=header.get("deadline_ms") or 30_000):
                        with rs:
                            resp, rblob = self._dispatch(op, header, blob)
                except Exception as e:        # noqa: BLE001 — answered
                    resp, rblob = {"ok": False, "err": str(e),
                                   "etype": err_name(e)}, b""
                rs.attach(resp)
                if rid:
                    # recorded before the send: a disconnect between the
                    # apply and the client's read is the window a retry
                    # closes
                    self._rids.complete(rid, resp, rblob)
                send_msg(conn, resp, rblob)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, op: str, header: dict, blob):
        eng = self.engine
        if op == "ping":
            return {"ok": True, "committed_ts": eng.committed_ts,
                    "ckpt_ts": eng._ckpt_ts}, b""
        if op == "commit":
            return self._handle_commit(header, blob), b""
        if op == "ddl":
            return self._handle_ddl(header["record"]), b""
        if op == "alloc_auto":
            t = eng.get_table(header["table"])
            vals = t.allocate_auto(int(header["n"]))
            return {"ok": True, "vals": np.asarray(vals).tolist()}, b""
        if op == "observe_auto":
            t = eng.get_table(header["table"])
            t.observe_auto(np.asarray(header["vals"], np.int64))
            return {"ok": True}, b""
        if op == "create_snapshot":
            ts = eng.create_snapshot(header["name"])
            return {"ok": True, "ts": ts,
                    "applied_ts": self.hub.last_ts}, b""
        if op == "restore_table":
            n = eng.restore_table(header["table"], int(header["ts"]))
            return {"ok": True, "affected": n,
                    "applied_ts": self.hub.last_ts}, b""
        if op == "txn_begin":
            lease = float(header.get("lease", 30.0))
            tok = f"rtxn-{next(self._txn_ids)}"
            with self._txn_lock:
                self._remote_txns[tok] = time.monotonic() + lease
            return {"ok": True, "token": tok}, b""
        if op == "txn_end":
            with self._txn_lock:
                self._remote_txns.pop(header["token"], None)
            return {"ok": True}, b""
        if op == "txn_renew":
            # an upsert: a restarted TN lost its registry, and the txns
            # still open on CNs win their merge protection back here
            lease = float(header.get("lease", 30.0))
            now = time.monotonic()
            with self._txn_lock:
                for tok in header.get("tokens", []):
                    self._remote_txns[tok] = now + lease
            return {"ok": True}, b""
        if op == "merge_table":
            # an open snapshot txn on any CN would see pre-merge row ids
            # the merge destroys: defer (-2, Engine.merge_table's code)
            if self.live_remote_txns() > 0:
                return {"ok": True, "kept": -2,
                        "applied_ts": self.hub.last_ts}, b""
            kept = eng.merge_table(header["name"],
                                   min_segments=header.get("min_segments",
                                                           2))
            return {"ok": True, "kept": kept,
                    "applied_ts": self.hub.last_ts}, b""
        if op == "checkpoint":
            eng.checkpoint()
            return {"ok": True}, b""
        return {"ok": False, "err": f"bad op {op}"}, b""

    def _handle_commit(self, header: dict, blob) -> dict:
        """tae/rpc/handle.go:547 HandleCommit: the shipped workspace
        rebuilt, its varchar columns (batch-local DictEncoded) re-coded
        into the TN's dictionaries under the commit lock, then the
        commit pipeline.  The commit itself runs outside that hold:
        table codes are append-only and stay valid, and the post-commit
        view maintenance must run with the commit lock free."""
        eng = self.engine
        with eng._commit_lock:
            inserts: Dict[str, list] = {}
            for tname, b in zip(header.get("tables", []),
                                unpack_blobs(blob)):
                t = eng.get_table(tname)
                arrays, validity = wire.unpack(b)
                arrays = {c: (t.encode_dict_encoded(c, a)
                              if isinstance(a, DictEncoded)
                              else np.array(a))
                          for c, a in arrays.items()}
                validity = {c: np.array(v) for c, v in validity.items()}
                inserts.setdefault(tname, []).append((arrays, validity))
            deletes = {t: np.asarray(g, np.int64)
                       for t, g in header.get("deletes", {}).items()}
        try:
            affected = eng.commit_txn(header.get("snapshot_ts"), inserts,
                                      deletes)
        except (ConflictError, DuplicateKeyError, ConstraintError) as e:
            return {"ok": False, "err": str(e), "etype": err_name(e)}
        return {"ok": True, "affected": affected, "ts": eng.committed_ts}

    def _handle_ddl(self, rec: dict) -> dict:
        """A catalog mutation forwarded from a CN, applied through the
        engine's own methods with log=True: the WAL record streams to
        every subscriber, the requesting CN too, which applies it as a
        restart replay would."""
        from matrixone_tpu_torch.storage.partition import PartitionSpec
        eng = self.engine
        op = rec["op"]
        if op == "create_table":
            eng.create_table(
                TableMeta(rec["name"], schema_from_json(rec["schema"]),
                          rec.get("pk") or [],
                          auto_increment=rec.get("auto"),
                          not_null=rec.get("not_null", []),
                          partition=PartitionSpec.from_json(
                              rec.get("partition"))),
                if_not_exists=rec.get("if_not_exists", False))
        elif op == "drop_table":
            eng.drop_table(rec["name"],
                           if_exists=rec.get("if_exists", False))
        elif op == "create_external":
            eng.create_external(
                TableMeta(rec["name"], schema_from_json(rec["schema"]),
                          []),
                rec["location"], rec["fmt"],
                if_not_exists=rec.get("if_not_exists", False),
                snapshot=rec.get("snapshot"))
        elif op == "create_stage":
            eng.create_stage(rec["name"], rec["url"])
        elif op == "drop_stage":
            eng.drop_stage(rec["name"])
        elif op == "drop_snapshot":
            eng.drop_snapshot(rec["name"])
        elif op == "alter_partition_drop":
            eng.alter_partition_drop(rec["table"], rec["part"])
        elif op in _STEP5_DDL:
            raise NotImplementedError(
                f"DDL {op!r} through the TN is not ported yet: the "
                f"port's engine holds no publications, sources or "
                f"dynamic tables (ROADMAP.md, section A, step 5)")
        else:
            return {"ok": False, "err": f"bad ddl {op}"}
        return {"ok": True, "applied_ts": self.hub.last_ts}

    def _serve_logtail(self, conn: socket.socket, from_ts: int) -> None:
        """The backlog, then the live push; the connection is one-way
        from here.  A subscriber whose from_ts predates the last
        checkpoint lost its records to the truncation: it rebuilds from
        the manifest first (`__resync__`) and streams from the
        checkpoint's ts.  The loop closes the race against a checkpoint
        between reading `_ckpt_ts` and registering the queue."""
        while True:
            ck = self.engine._ckpt_ts
            backlog, q = self.hub.subscribe(max(from_ts, ck))
            if self.engine._ckpt_ts == ck:
                break
            self.hub.unsubscribe(q)
        try:
            if ck > from_ts:
                send_msg(conn, {"op": "__resync__", "ts": ck})
            for h, b in backlog:
                send_msg(conn, h, b)
            cu_ts = self.engine.committed_ts
            send_msg(conn, {"op": "__caught_up__",
                            "ts": self.hub.safe_frontier(q, cu_ts) or 0})
            while not self._stopping.is_set():
                try:
                    h, b = q.get(timeout=0.25)
                except queue.Empty:
                    # the frontier heartbeat: an idle CN's applied_ts
                    # keeps up with the TN, so read gates stay reachable
                    # without fresh commits; only a delivery-safe
                    # frontier is sent
                    safe = self.hub.safe_frontier(
                        q, self.engine.committed_ts)
                    if safe:
                        send_msg(conn, {"op": "__frontier__", "ts": safe})
                    continue
                send_msg(conn, h, b)
        except (ConnectionError, OSError):
            pass
        finally:
            self.hub.unsubscribe(q)
            try:
                conn.close()
            except OSError:
                pass
