"""CN: a compute node over a logtail-replayed replica, and the fragment
server that runs its peers' plan fragments.

The port of `matrixone_tpu/cluster/cn.py` (reference analogue:
`pkg/vm/engine/disttae`: per-table partition state replayed from the
TN's logtail push (`disttae/logtail_consumer.go:296`), snapshot reads
served from it, the txn workspace shipped to the TN at commit, and
read-your-writes gated on the logtail catching up
(`logtail_consumer.go:389 waitCanServeTableSnapshot`)).

The replica is a whole `Engine` built by `Engine.open_checkpoint`
(manifest and objects from the shared storage, a null WAL) and advanced
record by record by `WalApplier`, the code a TN restart replays with,
so a replica cannot diverge from what a recovery would rebuild.
`RemoteCatalog` gives an unmodified `frontend.Session` the engine's
surface: reads hit the replica, mutations go to the TN.  A replica never
maintains a materialized view (its backing rows arrive through the
logtail, maintained by the TN) and resolves UDFs from the replicated
`system_udf` rows.  Commits ship the port's wire format (the WAL's
insert payload, `cluster/wire.py`), varchar as batch-local
dictionary codes: CN and TN dictionaries grow independently, so codes
are re-coded at the TN, never trusted across the wire.

`FragmentServer` (the ops `ping`, `stats`, `run_fragment`,
`shuffle_put`, `shuffle_drop`) runs shipped fragments on its `device`
(CUDA unless the caller names the CPU); `frags_run` counts them.
`CNService` is a replica with a fragment server; its MySQL server waits
for step 5 (ROADMAP.md, section A).
"""

from __future__ import annotations

import json
import socket
import sys
import threading
from typing import Dict, Optional

import numpy as np

from matrixone_tpu_torch import resolve_device
from matrixone_tpu_torch.cluster import wire
from matrixone_tpu_torch.cluster.frame import recv_msg, send_msg
from matrixone_tpu_torch.cluster.rpc import (ERR_TYPES, RpcClient,
                                             backoff_delay, deadline_scope,
                                             err_name, new_rid, pack_blobs,
                                             parse_addr)
from matrixone_tpu_torch.storage.engine import (Engine, WalApplier,
                                                schema_to_json)
from matrixone_tpu_torch.storage.fileservice import FileService, LocalFS
from matrixone_tpu_torch.storage.wal import to_dict_encoded
from matrixone_tpu_torch.utils.fault import INJECTOR
from matrixone_tpu_torch.utils.lifecycle import ServiceThreads


class ReplicaBrokenError(RuntimeError):
    """The logtail circuit breaker tripped: the replica is quarantined
    (its state may be stale) and refuses reads and commit gates rather
    than answer from frozen data."""


class LogtailConsumer:
    """Subscribes to the TN's logtail and applies its records to the
    replica.  Resubscribes from `applied_ts` when the stream drops (a TN
    restart), with jittered backoff; `wait_ts` is the read-your-writes
    gate.

    Circuit breaker: apply errors without progress first trigger ONE
    full resync (the partial state dropped, the replica rebuilt from the
    manifest); if the failure persists the consumer marks the replica
    `broken` and stops, and every read or gate raises
    ReplicaBrokenError.  `stop()` joins the consumer's thread."""

    MAX_STRIKES = 3

    def __init__(self, replica: Engine, addr):
        self.replica = replica
        self.addr = parse_addr(addr)
        self.applied_ts = replica._ckpt_ts
        self.last_error: Optional[str] = None
        self.strikes = 0
        self.broken = False
        self._healed_once = False
        self._cv = threading.Condition()
        self._caught_up = threading.Event()
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, timeout: float = 60.0) -> "LogtailConsumer":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pt-cn-logtail")
        self._thread.start()
        if not self._caught_up.wait(timeout):
            self.stop()
            raise TimeoutError("logtail subscription never caught up")
        return self

    def stop(self) -> None:
        self._stop.set()
        s = self._sock
        if s is not None:
            try:
                s.shutdown(socket.SHUT_RDWR)   # wakes the blocked recv
            except OSError:
                pass
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=5)

    # ------------------------------------------------------------ loop
    def _run(self) -> None:
        attempt = 0
        while not self._stop.is_set():
            try:
                self._consume_once()
                attempt = 0
            except (OSError, ConnectionError):
                # the TN is down or restarting: resubscribe from what we
                # have, with jitter (every CN loses the stream at once)
                attempt += 1
                self._stop.wait(backoff_delay(attempt))
            except Exception as e:            # noqa: BLE001 — the breaker
                self.last_error = repr(e)
                self.strikes += 1
                print(f"[cn-logtail] apply error (strike "
                      f"{self.strikes}/{self.MAX_STRIKES}): {e!r}",
                      file=sys.stderr, flush=True)
                if self.strikes >= self.MAX_STRIKES:
                    if not self._healed_once:
                        # self-heal: a poisoned partial state is dropped
                        # and the replica rebuilt from the manifest
                        self._healed_once = True
                        self.strikes = 0
                        try:
                            self._resync_full()
                            with self._cv:
                                self.applied_ts = max(
                                    self.applied_ts, self.replica._ckpt_ts)
                        except Exception as e2:   # noqa: BLE001
                            self.last_error = repr(e2)
                            self.broken = True
                            print(f"[cn-logtail] BREAKER OPEN (resync "
                                  f"failed): {e2!r}", file=sys.stderr,
                                  flush=True)
                            break
                    else:
                        # a deterministic poison: quarantine instead of
                        # spinning while reads serve frozen data
                        self.broken = True
                        print(f"[cn-logtail] BREAKER OPEN: {e!r}",
                              file=sys.stderr, flush=True)
                        break
                attempt += 1
                self._stop.wait(backoff_delay(attempt))
        if self.broken:
            with self._cv:         # wake any wait_ts blocked on us
                self._cv.notify_all()

    def _consume_once(self) -> None:
        if INJECTOR.trigger("logtail.subscribe") == "drop":
            raise ConnectionError(
                "fault injected: logtail subscription dropped")
        sock = socket.create_connection(self.addr, timeout=30.0)
        # a poll tick, not a deadline: it bounds how often _stop is
        # re-checked while the stream is idle
        sock.settimeout(1.0)
        self._sock = sock
        try:
            send_msg(sock, {"op": "subscribe", "from_ts": self.applied_ts})
            applier = WalApplier(self.replica, skip_ts=self.applied_ts)
            while not self._stop.is_set():
                try:
                    h, b = recv_msg(sock)
                except socket.timeout:
                    continue
                self._apply(applier, h, b)
        finally:
            self._sock = None
            try:
                sock.close()
            except OSError:
                pass

    def _apply(self, applier: WalApplier, h: dict, b) -> None:
        op = h.get("op")
        if op == "__caught_up__":
            # the TN frontier at subscribe time: every commit <= it was
            # in the backlog just applied
            self._advance(h.get("ts", 0), commit=True)
            self._caught_up.set()
            return
        if op == "__frontier__":
            self._advance(h.get("ts", 0), commit=True)
            return
        if op == "__resync__":
            # our applied_ts predates the TN's checkpoint: the records
            # in the gap were truncated; rebuild from the manifest
            self._resync_full()
            self._advance(h.get("ts", 0), commit=True)
            return
        if op == "merge_table":
            self._resync_table(h["name"])
            self._advance(h.get("ts", 0), commit=True)
            return
        with self.replica._commit_lock:
            ts = applier.apply(h, b)
        if ts is not None:
            self._advance(ts, commit=True)
        elif op not in ("insert", "delete") and h.get("ts"):
            self._advance(h["ts"], commit=False)

    def _advance(self, ts: int, commit: bool) -> None:
        rep = self.replica
        self.strikes = 0            # progress: the stream is healthy
        self._healed_once = False
        with self._cv:
            if commit and ts > rep.committed_ts:
                rep.committed_ts = ts
            rep.hlc.update(ts)
            self.applied_ts = max(self.applied_ts, ts)
            self._cv.notify_all()
        from matrixone_tpu_torch.utils.sync import notify_waiters
        notify_waiters()

    def _resync_table(self, name: str) -> None:
        """A TN merge rewrote the table's row ids: rebuild it from the
        fresh manifest (written before the merge record was logged)."""
        rep = self.replica
        manifest = json.loads(rep.fs.read("meta/manifest.json").decode())
        with rep._commit_lock:
            tm = manifest["tables"].get(name)
            if tm is not None:
                rep._load_manifest_table(name, tm, replace=True)
            else:
                rep.tables.pop(name, None)
            rep.ddl_gen += 1
            for ix in rep.indexes_on(name):
                ix.dirty = True

    def _resync_full(self) -> None:
        """Rebuild the whole replica from the latest manifest."""
        rep = self.replica
        with rep._commit_lock:
            rep.tables = {}
            rep.snapshots = {}
            rep.stages = {}
            rep._load_checkpoint()
            rep.ddl_gen += 1
            for ix in rep.indexes.values():
                ix.dirty = True
            rep.committed_ts = max(rep.committed_ts, rep._ckpt_ts)

    # ------------------------------------------------------------ gate
    def wait_ts(self, ts: int, timeout: float = 30.0) -> None:
        with self._cv:
            if not self._cv.wait_for(
                    lambda: self.broken or self.applied_ts >= ts, timeout):
                raise TimeoutError(
                    f"logtail did not reach ts {ts} within {timeout}s "
                    f"(applied {self.applied_ts})")
            if self.broken and self.applied_ts < ts:
                raise ReplicaBrokenError(
                    f"logtail breaker open (last error: "
                    f"{self.last_error})")


class _TableProxy:
    """A replica table whose write path goes to the TN: auto-increment
    values are allocated there (pkg/incrservice; a per-CN counter would
    collide) and autocommit inserts ship to its commit pipeline."""

    def __init__(self, rc: "RemoteCatalog", t):
        object.__setattr__(self, "_rc", rc)
        object.__setattr__(self, "_t", t)

    def __getattr__(self, k):
        return getattr(object.__getattribute__(self, "_t"), k)

    def __setattr__(self, k, v):
        setattr(object.__getattribute__(self, "_t"), k, v)

    def allocate_auto(self, n: int) -> np.ndarray:
        resp = self._rc._call({"op": "alloc_auto",
                               "table": self._t.meta.name, "n": int(n)})
        return np.asarray(resp["vals"], np.int64)

    def observe_auto(self, values) -> None:
        vals = np.asarray(values).tolist()
        if vals:
            self._rc._call({"op": "observe_auto",
                            "table": self._t.meta.name, "vals": vals})

    def insert_batch(self, batch) -> int:
        arrays, validity = self._t.batch_to_arrays(batch)
        return self._rc.commit_write(self._t.meta.name, arrays, validity)

    def insert_numpy(self, arrays, validity=None, strings=None) -> int:
        t = self._t
        strings = strings or {}
        full, val = {}, {}
        n = None
        for col, dtype in t.meta.schema:
            if dtype.is_varlen:
                codes, cats = strings[col]
                arr = t.remap_codes(col, codes, cats)
            else:
                arr = np.asarray(arrays[col], dtype=dtype.np_dtype)
            if n is None:
                n = len(arr)
            full[col] = arr
            v = None if validity is None else validity.get(col)
            val[col] = v.copy() if v is not None else np.ones(n, np.bool_)
        return self._rc.commit_write(t.meta.name, full, val)


class RemoteCatalog:
    """The engine surface of a CN session: reads -> the replica,
    mutations -> a TN RPC and a logtail wait.  `close()` stops the
    logtail consumer and the lease renewer and joins both."""

    TXN_LEASE = 30.0

    def __init__(self, tn_addr, fs: Optional[FileService] = None,
                 data_dir: Optional[str] = None,
                 txn_lease: float = TXN_LEASE):
        if fs is None:
            fs = LocalFS(data_dir)
        self._replica = Engine.open_checkpoint(fs)
        self._client = RpcClient(tn_addr)
        self.consumer = LogtailConsumer(self._replica, tn_addr).start()
        # the CN's own count of open txns (a fast path for merges); the
        # cluster-wide registry is the TN's, fed by the leases below
        self.active_txns = 0
        self._txn_lease = txn_lease
        self._txn_tokens: Dict[int, str] = {}     # txn_id -> TN token
        self._txn_mu = threading.Lock()
        self._closed = threading.Event()
        self._renewer = threading.Thread(target=self._renew_loop,
                                         daemon=True, name="pt-cn-lease")
        self._renewer.start()

    def close(self) -> None:
        self._closed.set()
        self._replica.close()
        self.consumer.stop()
        self._renewer.join(timeout=5)
        pool = self.__dict__.get("_frag_pool")
        if pool is not None:
            pool.close()
        self._client.close()

    # ----------------------------------------------------- txn registry
    def txn_opened(self, txn_id: int) -> None:
        """Lease a token on the TN: merges defer cluster-wide while this
        txn is open."""
        resp = self._call({"op": "txn_begin", "lease": self._txn_lease})
        with self._txn_mu:
            self._txn_tokens[txn_id] = resp["token"]
            self.active_txns += 1

    def txn_closed(self, txn_id: int) -> None:
        with self._txn_mu:
            tok = self._txn_tokens.pop(txn_id, None)
            self.active_txns -= 1
        if tok is not None:
            try:
                self._call({"op": "txn_end", "token": tok})
            except (OSError, ConnectionError, ValueError):
                pass      # the TN is down: the lease expires on its own

    def _renew_loop(self) -> None:
        period = max(1.0, self._txn_lease / 3.0)
        while not self._closed.wait(period):
            with self._txn_mu:
                toks = list(self._txn_tokens.values())
            if toks:
                try:
                    self._call({"op": "txn_renew", "tokens": toks,
                                "lease": self._txn_lease})
                except (OSError, ConnectionError, ValueError):
                    pass  # transient: the next tick retries in the lease

    # --------------------------------------------------------- plumbing
    def __getattr__(self, k):
        # reads and shared state (tables, committed_ts, hlc, locks, fs,
        # _commit_lock, ...) are the replica's
        return getattr(self._replica, k)

    def _call(self, header: dict, blob=b"") -> dict:
        # every TN call carries a request id minted once per logical
        # call: a transport retry re-sends the same rid, and the TN's
        # dedup replays the recorded response (a mid-call disconnect on
        # commit cannot apply it twice)
        header = dict(header, rid=new_rid())
        resp, _ = self._client.call(header, blob)
        if not resp.get("ok"):
            err = resp.get("err", "TN error")
            raise ERR_TYPES.get(resp.get("etype"), ValueError)(err)
        return resp

    def _ddl(self, record: dict) -> dict:
        resp = self._call({"op": "ddl", "record": record})
        self.consumer.wait_ts(resp["applied_ts"])
        return resp

    def _check_breaker(self) -> None:
        if self.consumer.broken:
            raise ReplicaBrokenError(
                f"CN replica quarantined: its logtail apply kept failing "
                f"(last error: {self.consumer.last_error})")

    def sync_frontier(self, timeout: float = 30.0) -> None:
        """Catch the replica up to the TN's current commit frontier (a
        table made through another CN must be visible once the TN has
        it)."""
        try:
            resp = self._call({"op": "ping"})
            self.consumer.wait_ts(resp["committed_ts"], timeout=timeout)
        except (OSError, ConnectionError, ValueError):
            pass                       # the TN is down: the local frontier

    def get_table(self, name: str):
        self._check_breaker()
        try:
            t = self._replica.get_table(name)
        except ValueError:
            # not here yet? close the replication gap once: "no such
            # table" must mean the cluster lacks it, not that this
            # replica lags
            self.sync_frontier()
            t = self._replica.get_table(name)
        return _TableProxy(self, t)

    # ------------------------------------------------------------ writes
    def commit_write(self, table: str, arrays, validity) -> int:
        return self.commit_txn(None, {table: [(arrays, validity)]}, {})

    def commit_txn(self, snapshot_ts, inserts: Dict[str, list],
                   deletes: Dict[str, np.ndarray]) -> int:
        """Ship the workspace to the TN (txn/rpc sender -> tae/rpc
        HandleCommit), each insert a wire blob with varchar columns as
        batch-local DictEncoded over this replica's dictionary."""
        tables, blobs = [], []
        for tname, segs in inserts.items():
            t = self._replica.get_table(tname)
            varlen = {c for c, d in t.meta.schema if d.is_varlen}
            for arrays, validity in segs:
                enc = {c: (to_dict_encoded(t.dicts[c], np.asarray(a),
                                           np.asarray(validity[c]))
                           if c in varlen else np.asarray(a))
                       for c, a in arrays.items()}
                blobs.append(wire.pack(enc, validity))
                tables.append(tname)
        header = {"op": "commit", "snapshot_ts": snapshot_ts,
                  "tables": tables,
                  "deletes": {t: np.asarray(g, np.int64).tolist()
                              for t, g in deletes.items()}}
        resp = self._call(header, pack_blobs(blobs))
        # read-your-writes: our own commit applied locally first
        self.consumer.wait_ts(resp["ts"])
        return resp["affected"]

    # --------------------------------------------------------------- ddl
    def create_table(self, meta, if_not_exists=False, log=True) -> None:
        self._ddl({
            "op": "create_table", "name": meta.name,
            "schema": schema_to_json(meta.schema),
            "pk": meta.primary_key, "auto": meta.auto_increment,
            "not_null": meta.not_null,
            "partition": (meta.partition.to_json()
                          if meta.partition is not None else None),
            "if_not_exists": if_not_exists})

    def drop_table(self, name: str, if_exists=False, log=True) -> None:
        if name not in self._replica.tables and if_exists:
            return
        self._ddl({"op": "drop_table", "name": name,
                   "if_exists": if_exists})

    def create_external(self, meta, location: str, fmt: str, log=True,
                        if_not_exists: bool = False,
                        snapshot=None) -> None:
        self._ddl({"op": "create_external", "name": meta.name,
                   "schema": schema_to_json(meta.schema),
                   "location": location, "fmt": fmt,
                   "snapshot": snapshot, "if_not_exists": if_not_exists})

    def create_stage(self, name, url, log=True) -> None:
        self._ddl({"op": "create_stage", "name": name, "url": url})

    def drop_stage(self, name, log=True) -> None:
        self._ddl({"op": "drop_stage", "name": name})

    def alter_partition_drop(self, table, part, log=True) -> None:
        self._ddl({"op": "alter_partition_drop", "table": table,
                   "part": part})

    def drop_snapshot(self, name) -> None:
        self._ddl({"op": "drop_snapshot", "name": name})

    def create_snapshot(self, name) -> int:
        resp = self._call({"op": "create_snapshot", "name": name})
        self.consumer.wait_ts(resp["applied_ts"])
        return resp["ts"]

    def restore_table(self, table: str, ts: int) -> int:
        resp = self._call({"op": "restore_table", "table": table,
                           "ts": int(ts)})
        self.consumer.wait_ts(resp["applied_ts"])
        return resp["affected"]

    def merge_table(self, name: str, min_segments: int = 2,
                    checkpoint: bool = True) -> int:
        """Forwarded to the TN; the logtail's merge record resyncs the
        table here.  Deferred (-2, Engine.merge_table's code) while any
        CN of the cluster holds a txn lease (the TN's registry); the
        local check is a fast path."""
        if self.active_txns > 0:
            return -2
        resp = self._call({"op": "merge_table", "name": name,
                           "min_segments": min_segments})
        self.consumer.wait_ts(resp["applied_ts"])
        return resp["kept"]

    def checkpoint(self, demote=None) -> None:
        self._call({"op": "checkpoint"})


class FragmentServer:
    """The CN <-> CN pipeline endpoint: runs shipped plan fragments
    against this CN's catalog on `device` (reference: cnservice's
    pipeline RPC server, `compile/remoterunServer.go`).  A fragment that
    raises answers {"ok": False, "err": ..., "etype": ..., "degrade": ...},
    `degrade` true for `fragments.degrade_errors()` (the client then runs
    the statement locally).  `stop()` joins every thread of the
    server."""

    def __init__(self, catalog, port: int = 0, device=None):
        self.catalog = catalog
        self.device = resolve_device(device)
        self.frags_run = 0
        self._count_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(32)
        self._stopping = threading.Event()
        self._svc = ServiceThreads("pt-frag")

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self) -> "FragmentServer":
        self._svc.spawn_accept(self._serve)
        return self

    def stop(self) -> list:
        self._stopping.set()
        return self._svc.shutdown(self._sock)

    def _serve(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            self._svc.spawn_handler(self._handle, conn)

    def _handle(self, conn: socket.socket) -> None:
        from matrixone_tpu_torch.parallel import fragments as FR
        try:
            while True:
                header, blob = recv_msg(conn)
                op = header.get("op")
                if op == "ping":
                    send_msg(conn, {"ok": True})
                    continue
                if op == "stats":
                    send_msg(conn, {"ok": True,
                                    "frags_run": self.frags_run})
                    continue
                if op == "shuffle_put":
                    # a peer pushing its bucket of a repartitioned side
                    FR.shuffle_store_for(self.catalog).put(
                        str(header["shuffle_id"]), header["side"],
                        int(header["from"]), int(header["to"]),
                        bytes(blob))
                    send_msg(conn, {"ok": True})
                    continue
                if op == "shuffle_drop":
                    FR.shuffle_store_for(self.catalog).drop_sid(
                        str(header["shuffle_id"]))
                    send_msg(conn, {"ok": True})
                    continue
                if op != "run_fragment":
                    send_msg(conn, {"ok": False, "err": f"bad op {op}"})
                    continue
                try:
                    run = {"shuffle_scan": FR.run_shuffle_scan,
                           "shuffle_join": FR.run_shuffle_join}.get(
                        header.get("kind"), FR.execute_fragment)
                    # the caller's remaining budget bounds the fragment's
                    # own nested calls (its shuffle pushes)
                    with deadline_scope(
                            ms=header.get("deadline_ms") or 180_000):
                        resp, parts = run(self.catalog, header,
                                          self.device)
                    with self._count_lock:
                        self.frags_run += 1
                except Exception as e:      # noqa: BLE001 — answered
                    resp, parts = {"ok": False,
                                   "err": f"{type(e).__name__}: {e}",
                                   "etype": err_name(e),
                                   "degrade": isinstance(
                                       e, FR.degrade_errors())}, b""
                send_msg(conn, resp, parts)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass


class CNService:
    """One CN: a replica with its logtail consumer, and a fragment
    endpoint for distributed statements over `peers` (the fragment
    addresses of every CN, this one's too).  The JAX package's CN also
    serves the MySQL wire (`MOServer`), which is step 5 of the port."""

    def __init__(self, tn_addr, fs: Optional[FileService] = None,
                 data_dir: Optional[str] = None, frag_port: int = 0,
                 peers: Optional[list] = None, device=None):
        self.catalog = RemoteCatalog(tn_addr, fs=fs, data_dir=data_dir)
        try:
            self.fragments = FragmentServer(self.catalog, port=frag_port,
                                            device=device)
        except BaseException:
            self.catalog.close()
            raise
        if peers:
            self.catalog.dist_peers = list(peers)

    def start(self) -> "CNService":
        self.fragments.start()
        return self

    @property
    def frag_port(self) -> int:
        return self.fragments.port

    def stop(self) -> None:
        self.fragments.stop()
        self.catalog.close()


def rpc_status(catalog) -> dict:
    """mo_ctl('rpc'): every peer's circuit breaker and, on a CN, the
    logtail consumer's breaker."""
    from matrixone_tpu_torch.cluster.rpc import breaker_states
    st = {"breakers": breaker_states()}
    consumer = getattr(catalog, "consumer", None)
    if consumer is not None:
        st["logtail"] = {"state": "open" if consumer.broken else "closed",
                         "strikes": consumer.strikes,
                         "applied_ts": consumer.applied_ts,
                         "last_error": consumer.last_error}
    return st


__all__ = ["CNService", "FragmentServer", "LogtailConsumer",
           "RemoteCatalog", "ReplicaBrokenError", "rpc_status"]
