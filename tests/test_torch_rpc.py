"""The port's RPC fabric (matrixone_tpu_torch/cluster/: frame.py, rpc.py,
wire.py) against the JAX package's, on the CPU.

  * frames of 0 bytes and of 64 MB round-trip, read into one buffer;
  * the wire format (the WAL's insert payload) round-trips every type:
    integers of each width, floats, booleans, decimals, dates, 2-D
    vectors, varchar, NULLs in each, empty and all-NULL columns; and its
    rows equal what the JAX package's Arrow IPC gives back;
  * the chaos drills of tests/test_chaos.py on the port's TN and CN,
    with the fault points armed through the port's INJECTOR: commits
    and DDL exactly once under dropped connections and torn sends, the
    same drop fatal with MO_RPC_RESILIENCE=off, and the breaker opening
    on a stuck peer, failing fast, then closing through its half-open
    probe; each drill's counters move as the JAX package's do;
  * the error taxonomy, the backoff and the request dedup equal the JAX
    package's.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest

from matrixone_tpu.cluster import rpc as jrpc
from matrixone_tpu.storage import arrowio
from matrixone_tpu_torch.cluster import frame, rpc, wire
from matrixone_tpu_torch.storage.engine import (ConflictError,
                                                ConstraintError,
                                                DuplicateKeyError)
from matrixone_tpu_torch.utils import metrics as M
from matrixone_tpu_torch.utils.fault import INJECTOR
from torch_cluster_rig import (  # noqa: F401  (fixtures)
    one_torch_thread, port_faults_disarmed, sessions, sync, tn_pair)


# ------------------------------------------------------------------ frame
@pytest.mark.parametrize("nbytes", [0, 64 << 20])
def test_frame_round_trip(nbytes):
    a, b = socket.socketpair()
    blob = np.random.default_rng(1).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()
    header = {"op": "x", "n": nbytes, "s": "héllo"}
    err = []

    def send():
        try:
            frame.send_msg(a, header, [blob[:nbytes // 3],
                                       blob[nbytes // 3:]])
        except Exception as e:            # noqa: BLE001 — asserted below
            err.append(e)
    t = threading.Thread(target=send)
    t.start()
    try:
        h, got = frame.recv_msg(b)
    finally:
        t.join()
        a.close()
        b.close()
    assert not err
    assert h == header
    assert bytes(got) == blob


def test_frame_reads_what_the_reference_writes():
    """One protocol: the reference's sender, the port's receiver, and
    back."""
    from matrixone_tpu.logservice.replicated import _recv_msg, _send_msg
    a, b = socket.socketpair()
    try:
        _send_msg(a, {"op": "ping", "k": [1, 2]}, b"abc" * 1000)
        h, blob = frame.recv_msg(b)
        assert h == {"op": "ping", "k": [1, 2]} and blob == b"abc" * 1000
        frame.send_msg(b, {"ok": True}, b"")
        assert _recv_msg(a) == ({"ok": True}, b"")
    finally:
        a.close()
        b.close()


def test_a_torn_frame_raises_connection_error():
    a, b = socket.socketpair()
    a.sendall(b"\x10\x00\x00\x00{\"op\"")
    a.close()
    with pytest.raises(ConnectionError):
        frame.recv_msg(b)
    b.close()


# ------------------------------------------------------------------- wire
def _decode(col, valid):
    return [col.cats[c] if ok else None
            for c, ok in zip(np.asarray(col.codes).tolist(),
                             np.asarray(valid, bool).tolist())]


def _columns(n: int, rng):
    valid = rng.random(n) < 0.8
    return {
        "i8": (rng.integers(-128, 127, n).astype(np.int8), valid),
        "i16": (rng.integers(-9999, 9999, n).astype(np.int16), valid),
        "i32": (rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
                valid),
        "i64": (rng.integers(-2**62, 2**62, n).astype(np.int64), valid),
        "u64": (rng.integers(0, 2**63, n).astype(np.uint64), valid),
        "f32": (rng.standard_normal(n).astype(np.float32), valid),
        "f64": (rng.standard_normal(n), valid),
        "b": (rng.random(n) < 0.5, valid),
        "dec": (rng.integers(-10**9, 10**9, n).astype(np.int64), valid),
        "date": (rng.integers(0, 20000, n).astype(np.int32), valid),
        "vec": (rng.standard_normal((n, 7)).astype(np.float32), valid),
        "s": ([None if not ok else f"s{int(x)}é"
               for x, ok in zip(rng.integers(0, 9, n), valid)], valid),
        "all_null": (np.zeros(n, np.int64), np.zeros(n, np.bool_)),
        "s_null": ([None] * n, np.zeros(n, np.bool_)),
    }


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_wire_round_trips_every_type(n):
    cols = _columns(n, np.random.default_rng(n))
    arrays = {k: a for k, (a, _v) in cols.items()}
    valid = {k: v for k, (_a, v) in cols.items()}
    got, gvalid = wire.unpack(wire.pack(arrays, valid))
    assert list(got) == list(arrays)
    for k, a in arrays.items():
        assert np.array_equal(gvalid[k], valid[k]), k
        if isinstance(a, list):
            assert _decode(got[k], gvalid[k]) == a, k
        else:
            assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
            assert np.array_equal(got[k][valid[k]], a[valid[k]]), k
    # the reference's Arrow IPC carries the same rows
    ref, rvalid = arrowio.ipc_to_arrays(arrowio.arrays_to_ipc(
        {k: a for k, a in arrays.items() if k != "vec"},
        {k: v for k, v in valid.items() if k != "vec"}))
    for k in ref:
        if isinstance(arrays[k], list):
            ra = ref[k]
            rv = [ra.cats[c] if ok else None for c, ok in
                  zip(np.asarray(ra.codes).tolist(), rvalid[k].tolist())] \
                if hasattr(ra, "cats") else list(ra)
            assert _decode(got[k], gvalid[k]) == rv, k
        else:
            m = valid[k]
            assert np.array_equal(np.asarray(ref[k])[m], got[k][m]), k


def test_merge_encoded_unions_dictionaries():
    a = wire.encode_strings(["x", "y", None, "x"])
    b = wire.encode_strings(["z", "x"])
    codes, union = wire.merge_encoded([a, b])
    assert union == ["x", "y", "z"]
    assert [union[c] for c in codes] == ["x", "y", "x", "x", "z", "x"]


# ------------------------------------------------------ taxonomy, dedup
def test_taxonomy_and_backoff_match_the_reference():
    for cls in (rpc.TransportError, rpc.BreakerOpen):
        assert issubclass(cls, ConnectionError) and \
            issubclass(cls, rpc.RpcError)
    assert issubclass(rpc.DeadlineExceeded, TimeoutError)
    assert {k: v.__name__ for k, v in rpc.ERR_TYPES.items()} == \
        {k: v.__name__ for k, v in jrpc.ERR_TYPES.items()}
    for e in (ConflictError("x"), DuplicateKeyError("x"),
              ConstraintError("x"), ValueError("x")):
        assert rpc.err_name(e) in ("conflict", "duplicate", "constraint",
                                   "error")
    assert [rpc.err_name(e) for e in (ConflictError(""),
                                      DuplicateKeyError(""),
                                      ConstraintError(""),
                                      RuntimeError(""))] == \
        ["conflict", "duplicate", "constraint", "error"]
    for attempt in range(1, 9):
        cap = min(rpc.BACKOFF_MAX,
                  rpc.BACKOFF_BASE * 2 ** (attempt - 1))
        for _ in range(20):
            d = rpc.backoff_delay(attempt)
            assert 0.5 * cap <= d <= 1.5 * cap
    assert (rpc.RETRIES, rpc.BACKOFF_BASE, rpc.BACKOFF_MAX, rpc.POOL_SIZE,
            rpc.BREAKER_THRESHOLD, rpc.BREAKER_COOLDOWN) == \
        (jrpc.RETRIES, jrpc.BACKOFF_BASE, jrpc.BACKOFF_MAX, jrpc.POOL_SIZE,
         jrpc.BREAKER_THRESHOLD, jrpc.BREAKER_COOLDOWN)


def test_deadline_scopes_only_shrink():
    with rpc.deadline_scope(5.0) as outer:
        with rpc.deadline_scope(60.0) as inner:
            assert inner.expires_at == outer.expires_at
            assert rpc.current_deadline() is inner
        with rpc.deadline_scope(ms=10) as short:
            assert short.remaining() <= 0.01
    assert rpc.current_deadline() is None


@pytest.mark.parametrize("mod", [rpc, jrpc])
def test_request_dedup_waits_for_the_first_attempt(mod):
    d = mod.RequestDedup(cap=2)
    assert d.claim("a") == ("mine", None)
    out = []
    t = threading.Thread(target=lambda: out.append(d.claim("a", 5.0)))
    t.start()
    time.sleep(0.05)
    d.complete("a", {"ok": True, "n": 1}, b"z")
    t.join()
    assert out == [("done", ({"ok": True, "n": 1}, b"z"))]
    for rid in ("b", "c", "d"):
        d.claim(rid)
        d.complete(rid, {"ok": True})
    assert d.claim("a") == ("mine", None)       # evicted (LRU cap 2)


# ----------------------------------------------------------- chaos drills
def test_queries_succeed_under_connection_drops(tn_pair):
    """Every 3rd TN call loses its reply after the request reached the
    TN: 12 commits apply exactly once (retry + request dedup)."""
    s, _s2 = sessions(tn_pair, port=True)
    s.execute("create table t (id bigint primary key, v bigint)")
    retries0 = M.rpc_retries.get(op="commit")
    INJECTOR.add("rpc.recv", "return", "drop", every=3)
    for i in range(12):
        s.execute(f"insert into t values ({i}, {i * 10})")
    rows = s.execute("select count(*) c, sum(v) sv from t").rows()
    INJECTOR.clear()
    assert (int(rows[0][0]), int(rows[0][1])) == (12, 660)
    assert M.rpc_retries.get(op="commit") > retries0


def test_mid_call_disconnect_on_commit_exactly_once(tn_pair):
    s, _s2 = sessions(tn_pair, port=True)
    s.execute("create table once (id bigint primary key, v bigint)")
    attempts0 = M.rpc_attempts.get(op="commit")
    INJECTOR.add("rpc.recv", "return", "drop", times=1)
    s.execute("insert into once values (1, 100)")
    INJECTOR.clear()
    assert M.rpc_attempts.get(op="commit") >= attempts0 + 2
    assert [(int(a), int(b)) for a, b in
            s.execute("select id, v from once").rows()] == [(1, 100)]
    s.execute("insert into once values (2, 200)")
    assert len(s.execute("select * from once").rows()) == 2


def test_partial_send_commit_exactly_once(tn_pair):
    s, _s2 = sessions(tn_pair, port=True)
    s.execute("create table pw (id bigint primary key)")
    INJECTOR.add("rpc.send", "return", "partial", times=1)
    s.execute("insert into pw values (7)")
    fired = INJECTOR.describe()["rpc.send"]["fired"]
    INJECTOR.clear()
    assert fired == 1
    assert [int(r[0]) for r in s.execute("select id from pw").rows()] == [7]


def test_ddl_survives_drops_exactly_once(tn_pair):
    s, _s2 = sessions(tn_pair, port=True)
    INJECTOR.add("rpc.recv", "return", "drop", times=1)
    s.execute("create table ddl_t (id bigint primary key)")
    INJECTOR.clear()
    s.execute("insert into ddl_t values (1)")
    assert len(s.execute("select * from ddl_t").rows()) == 1


def test_resilience_off_surfaces_drop(tn_pair, monkeypatch):
    """With MO_RPC_RESILIENCE=off the same armed fault is fatal: the
    layer, not luck, keeps statements alive."""
    s, _s2 = sessions(tn_pair, port=True)
    s.execute("create table off_t (id bigint primary key)")
    monkeypatch.setenv("MO_RPC_RESILIENCE", "off")
    INJECTOR.add("rpc.recv", "return", "drop", times=1)
    with pytest.raises(rpc.TransportError):
        s.execute("insert into off_t values (1)")
    INJECTOR.clear()
    monkeypatch.delenv("MO_RPC_RESILIENCE")
    s.execute("insert into off_t values (2)")
    assert int(s.execute("select count(*) c from off_t where id = 2"
                         ).rows()[0][0]) == 1


class _StuckPeer:
    """Accepts connections, reads requests and answers none until
    `respond` is set: a persistently slow peer."""

    def __init__(self):
        from matrixone_tpu_torch.utils.lifecycle import ServiceThreads
        self.respond = False
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(16)
        self._svc = ServiceThreads("pt-stuckpeer")
        self._svc.spawn_accept(self._serve)

    def _serve(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            self._svc.spawn_handler(self._handle, conn)

    def _handle(self, c):
        try:
            while True:
                frame.recv_msg(c)
                if self.respond:
                    frame.send_msg(c, {"ok": True})
        except (ConnectionError, OSError):
            pass
        finally:
            c.close()

    def stop(self):
        assert self._svc.shutdown(self._sock) == []


def test_breaker_opens_on_slow_peer_then_half_open_recovers():
    from matrixone_tpu_torch.utils.sync import wait_until
    rpc.reset_breakers()
    peer = _StuckPeer()
    try:
        c = rpc.RpcClient(("127.0.0.1", peer.port), timeout=0.25,
                          retries=1)
        c.breaker.cooldown = 1.0
        for _ in range(c.breaker.threshold):
            with pytest.raises((rpc.TransportError, rpc.DeadlineExceeded,
                                rpc.BreakerOpen)):
                c.call({"op": "ping"}, retryable=False)
        key = f"127.0.0.1:{peer.port}"
        assert rpc.breaker_states()[key]["state"] == "open"
        assert M.rpc_breaker_state.get(peer=key) == 2
        t0 = time.perf_counter()
        with pytest.raises(rpc.BreakerOpen):
            c.call({"op": "ping"}, retryable=False)
        assert time.perf_counter() - t0 < 0.05
        peer.respond = True
        wait_until(lambda: time.monotonic() - c.breaker.opened_at
                   >= c.breaker.cooldown, 5, "cooldown never elapsed")
        resp, _ = c.call({"op": "ping"}, retryable=False)
        assert resp["ok"]
        assert rpc.breaker_states()[key]["state"] == "closed"
        assert M.rpc_breaker_transitions.get(peer=key,
                                             state="half-open") >= 1
        c.close()
    finally:
        peer.stop()
        rpc.reset_breakers()


def test_a_half_open_breaker_admits_one_probe():
    b = rpc.CircuitBreaker(("127.0.0.1", 1), threshold=2, cooldown=0.0)
    jb = jrpc.CircuitBreaker(("127.0.0.1", 1), threshold=2, cooldown=0.0)
    trail = []
    for br in (b, jb):
        steps = []
        for op in ("fail", "fail", "allow", "allow", "fail", "allow",
                   "ok", "allow", "allow"):
            if op == "fail":
                br.record_failure()
            elif op == "ok":
                br.record_success()
            else:
                steps.append(br.allow())
            steps.append(br.state)
        trail.append(steps)
    assert trail[0] == trail[1]
