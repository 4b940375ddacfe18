"""The port's host-peer executor (parallel/fragments.py, over the
fragment servers of cluster/cn.py) against its own local path and the
JAX package's distributed path, on the CPU.

Each rig is a pair on the same data: the port's Engine with its
FragmentServers (device="cpu") and the JAX package's Engine with its
own.  The scenarios of tests/test_distributed_scopes.py's in-process
tests (GROUP BY over varchar keys, scalar aggregates, top-k with and
without an offset, a join under a GROUP BY, the open-transaction and
unsupported-shape refusals), its TPC-H set at sf 0.004 (Q1, Q3, Q6,
Q10, Q18), and tests/test_shuffle_join.py's in-process shuffle joins
(with filters, under an aggregate, small tables staying local, an int
key meeting a bigint key): the port's distributed rows equal its local
rows and the JAX package's distributed rows, and its peers run as many
fragments as the JAX package's.  Unordered shuffle joins are compared
sorted.

The port's own: a fragment that fails inside a peer's executor raises
at the client; a dead peer (transport), a planning refusal and a layout
disagreement each degrade to the local rows.
"""

import socket

import numpy as np
import pytest

from matrixone_tpu.cluster.cn import FragmentServer as JFragmentServer
from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu.storage.engine import Engine as JEngine
from matrixone_tpu.utils import tpch_full as JT
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.cluster import FragmentServer
from matrixone_tpu_torch.cluster import rpc
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.parallel import fragments as FR
from matrixone_tpu_torch.storage.engine import Engine
from matrixone_tpu_torch.utils import metrics as M
from matrixone_tpu_torch.utils import tpch_full as T
from torch_cluster_rig import (  # noqa: F401  (fixtures)
    one_torch_thread, port_faults_disarmed)


class _Rig:
    """One package's engine, n fragment servers over it, a local session
    and a distribution-enabled one."""

    def __init__(self, eng, servers, session_cls, batch_rows, **kw):
        self.eng, self.servers = eng, servers
        eng.dist_peers = [f"127.0.0.1:{f.port}" for f in servers]
        self.s = session_cls(catalog=eng, **kw)
        self.sd = session_cls(catalog=eng, **kw)
        self.sd.variables["dist_min_rows"] = 0
        self.sd.variables["dist_batch_rows"] = batch_rows

    def frags(self) -> int:
        return sum(f.frags_run for f in self.servers)

    def dist(self, sql):
        before = self.frags()
        rows = self.sd.execute(sql).rows()
        return rows, self.frags() - before

    def stop(self):
        for f in self.servers:
            f.stop()


def _port_rig(eng, n, batch_rows):
    return _Rig(eng, [FragmentServer(eng, device="cpu").start()
                      for _ in range(n)], TSession, batch_rows,
                device="cpu")


def _ref_rig(eng, n, batch_rows):
    return _Rig(eng, [JFragmentServer(eng).start() for _ in range(n)],
                JSession, batch_rows)


def _same(got, want) -> bool:
    """Equal rows: exactly, floats within 1e-9 relative."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                if a is None or b is None or \
                        abs(float(a) - float(b)) > 1e-9 * max(
                            1.0, abs(float(a)), abs(float(b))):
                    return False
            elif a != b:
                return False
    return True


def _check(pair, sql, ordered=True):
    """Port local == port distributed == reference distributed, and the
    fragment counts equal.  -> the port's fragment count."""
    port, ref = pair
    local = port.s.execute(sql).rows()
    dist, n = port.dist(sql)
    jdist, jn = ref.dist(sql)
    if not ordered:
        local, dist, jdist = sorted(local), sorted(dist), sorted(jdist)
    assert _same(dist, local), (dist[:3], local[:3])
    assert _same(dist, jdist), (dist[:3], jdist[:3])
    assert n == jn, (n, jn)
    return n


def _both_statements(statements):
    eng, jeng = Engine(), JEngine()
    s, js = TSession(catalog=eng, device="cpu"), JSession(catalog=jeng)
    for sql in statements:
        s.execute(sql)
        js.execute(sql)
    return eng, jeng


# ------------------------------------------------------------ in-process
@pytest.fixture(scope="module")
def dist_pair():
    stmts = ["create table t (id bigint primary key, g varchar(8),"
             " v bigint, d double)"]
    for lo in range(0, 4000, 800):
        stmts.append("insert into t values " + ",".join(
            f"({i},'g{i % 7}',{i % 100},{(i % 13) * 0.5})"
            for i in range(lo, lo + 800)))
    eng, jeng = _both_statements(stmts)
    pair = (_port_rig(eng, 2, 512), _ref_rig(jeng, 2, 512))
    yield pair
    for r in pair:
        r.stop()


def test_dist_group_by_with_varchar_keys(dist_pair):
    assert _check(dist_pair, "select g, sum(v), count(*), avg(v), min(v),"
                             " max(v) from t group by g order by g") == 2


def test_dist_scalar_aggregate(dist_pair):
    assert _check(dist_pair, "select sum(v), count(*), avg(d), min(id),"
                             " max(id) from t where v < 80") == 2


def test_dist_topk(dist_pair):
    assert _check(dist_pair,
                  "select id, v from t order by v desc, id limit 9") == 2


def test_dist_topk_with_offset(dist_pair):
    _check(dist_pair,
           "select id, v from t order by v desc, id limit 5 offset 3")


def test_dist_join_group_by(dist_pair):
    port, ref = dist_pair
    for r in dist_pair:
        r.s.execute("create table dim (k bigint primary key,"
                    " tag varchar(8))")
        r.s.execute("insert into dim values " + ",".join(
            f"({i},'d{i % 3}')" for i in range(100)))
    assert _check(dist_pair, "select dim.tag, sum(t.v), count(*) from t"
                             " join dim on t.v = dim.k where dim.k < 60"
                             " group by dim.tag order by dim.tag") == 2


def test_dist_falls_back_inside_txn(dist_pair):
    """An open txn's workspace is invisible to peers: the statement runs
    locally and sees the uncommitted row."""
    port, _ref = dist_pair
    port.sd.execute("begin")
    try:
        before = port.frags()
        port.sd.execute("insert into t values (999001, 'gx', 1, 0.0)")
        rows = port.sd.execute(
            "select count(*) from t where id = 999001").rows()
        assert int(rows[0][0]) == 1
        assert port.frags() == before
    finally:
        port.sd.execute("rollback")


def test_dist_unsupported_shapes_fall_back(dist_pair):
    for sql in ("select g, count(distinct v) from t group by g order by g",
                "select id, row_number() over (partition by g order by id)"
                " from t order by id limit 5"):
        assert _check(dist_pair, sql) == 0


def test_layout_disagreement_degrades(dist_pair, monkeypatch):
    """Peers that report different table signatures (a merge resync in
    flight), or a layout that changes under a fragment, degrade to the
    local rows."""
    import threading
    port, _ref = dist_pair
    sql = "select g, sum(v) from t group by g order by g"
    want = port.s.execute(sql).rows()
    real = FR.table_signature
    # each peer's handler thread sees a layout of its own
    monkeypatch.setattr(FR, "table_signature", lambda c, t, s: real(
        c, t, s) + threading.current_thread().name)
    dist, n = port.dist(sql)
    assert n == 2 and dist == want      # both ran, then disagreed
    calls = iter(range(1 << 30))
    monkeypatch.setattr(FR, "table_signature", lambda c, t, s: real(
        c, t, s) + str(next(calls)))
    dist, n = port.dist(sql)
    assert n == 0 and dist == want      # changed under each fragment


def test_a_failure_inside_a_peer_raises(dist_pair, monkeypatch):
    """Out of memory (or a failed launch) inside a peer's fragment is not
    a reason to degrade: it raises at the client, with the peer's
    error."""
    from matrixone_tpu_torch.vm import operators as O
    port, _ref = dist_pair
    sql = "select g, sum(v) from t group by g order by g"

    def oom(self, *a, **k):
        raise RuntimeError("CUDA error: out of memory")
    monkeypatch.setattr(O.AggOp, "_partial_vals", oom)
    monkeypatch.setattr(O.AggOp, "_dense_init", lambda self, ex: None)
    with pytest.raises(FR.FragmentError, match="out of memory"):
        port.sd.execute(sql)
    monkeypatch.undo()
    assert port.dist(sql)[0] == port.s.execute(sql).rows()


def test_dead_peer_degrades_to_local(monkeypatch):
    """A peer that is gone: every statement still answers (the local
    run), and once its breaker opens the statement skips it at once."""
    from matrixone_tpu_torch.utils.sync import wait_until
    rpc.reset_breakers()
    monkeypatch.setenv("MO_FRAG_TIMEOUT", "2.0")
    eng = Engine()
    s = TSession(catalog=eng, device="cpu")
    s.execute("create table t (id bigint primary key, g varchar(8),"
              " v bigint)")
    s.execute("insert into t values " + ",".join(
        f"({i},'g{i % 5}',{i % 100})" for i in range(2000)))
    sql = "select g, sum(v) from t group by g order by g"
    want = s.execute(sql).rows()
    f1 = FragmentServer(eng, device="cpu").start()
    dead = _dead_addr()
    eng.dist_peers = [f1.addr, dead]
    sd = TSession(catalog=eng, device="cpu")
    sd.variables["dist_min_rows"] = 0
    errs0 = M.rpc_errors.get(kind="breaker", op="run_fragment")
    try:
        for _ in range(4):
            assert sd.execute(sql).rows() == want
        wait_until(lambda: rpc.breaker_states().get(
            dead, {}).get("state") == "open", 10,
            "the dead peer's breaker never opened")
        assert sd.execute(sql).rows() == want
        assert M.rpc_errors.get(kind="breaker", op="run_fragment") > errs0
    finally:
        FR.pool_for(eng).close()
        assert f1.stop() == []
        rpc.reset_breakers()


def _dead_addr() -> str:
    """The address of a port nothing listens on."""
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    port = dead.getsockname()[1]
    dead.close()
    return f"127.0.0.1:{port}"


@pytest.mark.parametrize("dead_at", [1, 2])
def test_dead_peer_in_a_shuffle_degrades_to_local(monkeypatch, dead_at):
    """A shuffle join whose peer `dead_at` (not the first) is gone: each
    live peer's push to it fails inside that peer, which degrades as the
    coordinator's own failed call does, so the statement returns the
    local rows and no peer keeps a bucket of it."""
    rpc.reset_breakers()
    monkeypatch.setenv("MO_FRAG_TIMEOUT", "5.0")
    eng = Engine()
    s = TSession(catalog=eng, device="cpu")
    s.execute("create table fact (id bigint primary key, k bigint,"
              " v bigint)")
    s.execute("create table dim (k bigint primary key, nm varchar(8))")
    s.execute("insert into fact values " + ",".join(
        f"({i},{(i * 7) % 300},{i % 50})" for i in range(3000)))
    s.execute("insert into dim values " + ",".join(
        f"({k},'n{k % 37}')" for k in range(300)))
    sql = "select f.id, f.v, d.nm from fact f join dim d on f.k = d.k"
    want = sorted(s.execute(sql).rows())
    live = [FragmentServer(eng, device="cpu").start() for _ in range(2)]
    addrs = [f.addr for f in live]
    addrs.insert(dead_at, _dead_addr())
    eng.dist_peers = addrs
    sd = TSession(catalog=eng, device="cpu")
    sd.variables["dist_min_rows"] = 0
    sd.variables["dist_batch_rows"] = 512
    puts0 = M.rpc_errors.get(kind="transport", op="shuffle_put") + \
        M.rpc_errors.get(kind="breaker", op="shuffle_put")
    try:
        assert sorted(sd.execute(sql).rows()) == want
        assert M.rpc_errors.get(kind="transport", op="shuffle_put") + \
            M.rpc_errors.get(kind="breaker", op="shuffle_put") > puts0
        assert sum(f.frags_run for f in live) == 0
        assert FR.shuffle_store_for(eng)._buckets == {}
    finally:
        FR.pool_for(eng).close()
        assert [t for f in live for t in f.stop()] == []
        rpc.reset_breakers()


def test_stuck_shuffle_wait_degrades():
    """Buckets that never all arrive degrade; so does every failure of
    the fabric, and a fragment's own error does not."""
    st = FR.ShuffleStore()
    st.put("s", "L", 0, 1, b"x")
    with pytest.raises(FR.FragmentDegrade, match="1/2 buckets"):
        st.wait_all("s", "L", 1, 2, timeout=0.05)
    for e in (rpc.TransportError("x"), rpc.DeadlineExceeded("x"),
              rpc.BreakerOpen("x"), FR.FragmentDegrade("x")):
        assert isinstance(e, FR.degrade_errors())
    assert not isinstance(RuntimeError("CUDA error: out of memory"),
                          FR.degrade_errors())


# ------------------------------------------------------------------ TPC-H
@pytest.fixture(scope="module")
def tpch_pair():
    jeng = JEngine()
    JT.load_tpch(jeng, sf=0.004, seed=1)
    eng = convert.tables_from_numpy(convert.tables_to_numpy(jeng))
    pair = (_port_rig(eng, 2, 4096), _ref_rig(jeng, 2, 4096))
    yield pair
    for r in pair:
        r.stop()


@pytest.mark.parametrize("qnum", [1, 3, 6, 10, 18])
def test_tpch_distributed_matches_local_and_reference(tpch_pair, qnum):
    ran = _check(tpch_pair, T.QUERIES[qnum])
    if qnum in (1, 3, 6, 18):
        # Q18's inlined HAVING subquery distributes too: 4 fragments
        assert ran == (4 if qnum == 18 else 2), ran


# --------------------------------------------------------------- shuffle
@pytest.fixture(scope="module")
def shuffle_pair():
    rng = np.random.default_rng(17)
    stmts = ["create table fact (id bigint primary key, k bigint,"
             " v bigint)",
             "create table dim (k bigint primary key, nm varchar(8),"
             " w bigint)",
             "insert into fact values " + ",".join(
                 f"({i},{rng.integers(0, 800)},{rng.integers(0, 50)})"
                 for i in range(6000)),
             "insert into dim values " + ",".join(
                 f"({k},'n{k % 37}',{k % 11})" for k in range(800))]
    eng, jeng = _both_statements(stmts)
    pair = (_port_rig(eng, 3, 1024), _ref_rig(jeng, 3, 1024))
    yield pair
    for r in pair:
        r.stop()


def test_shuffle_join_exact_vs_local(shuffle_pair):
    pushed0 = M.fragment_pushed_rows.get()
    # 2n shuffle_scan fragments + n shuffle_join fragments
    assert _check(shuffle_pair, "select f.id, f.v, d.nm, d.w from fact f"
                                " join dim d on f.k = d.k",
                  ordered=False) == 9
    assert M.fragment_pushed_rows.get() > pushed0


def test_shuffle_join_with_filters(shuffle_pair):
    assert _check(shuffle_pair, "select f.id, d.nm from fact f join dim d"
                                " on f.k = d.k where f.v >= 25 and"
                                " d.w <= 5", ordered=False) == 9


def test_shuffle_join_under_aggregate(shuffle_pair):
    _check(shuffle_pair, "select d.nm, count(*), sum(f.v) from fact f"
                         " join dim d on f.k = d.k group by d.nm"
                         " order by d.nm")


def test_small_tables_stay_local(shuffle_pair):
    port, _ref = shuffle_pair
    port.sd.variables["dist_min_rows"] = 10_000_000
    try:
        sql = "select f.id from fact f join dim d on f.k = d.k"
        rows, n = port.dist(sql)
        assert n == 0
        assert sorted(rows) == sorted(port.s.execute(sql).rows())
    finally:
        port.sd.variables["dist_min_rows"] = 0


def test_mixed_width_keys_and_negative(shuffle_pair):
    """An int key and a bigint key hash to the same buckets (integers
    widen to int64 first); negative keys too."""
    for r in shuffle_pair:
        r.s.execute("create table l32 (id bigint primary key, k int)")
        r.s.execute("create table r64 (k bigint primary key, w bigint)")
        r.s.execute("insert into l32 values " + ",".join(
            f"({i},{(i % 40) - 20})" for i in range(1200)))
        r.s.execute("insert into r64 values " + ",".join(
            f"({k},{k * 7})" for k in range(-20, 20)))
    assert _check(shuffle_pair, "select l.id, r.w from l32 l join r64 r"
                                " on l.k = r.k", ordered=False) == 9
    assert len(shuffle_pair[0].s.execute(
        "select l.id, r.w from l32 l join r64 r on l.k = r.k").rows()) \
        == 1200


def test_row_hash_is_stable_and_width_blind():
    a32 = np.array([-1, 0, 7, 2**31 - 1], np.int32)
    h = FR._stable_row_hash([a32])
    assert np.array_equal(h, FR._stable_row_hash([a32.astype(np.int64)]))
    assert h.dtype == np.uint64 and len(set(h.tolist())) == 4
    from matrixone_tpu_torch.cluster import wire
    s = wire.encode_strings(["x", "y", "x"])
    hs = FR._stable_row_hash([s])
    assert hs[0] == hs[2] != hs[1]
    assert FR._stable_row_hash([s, a32[:3]]).dtype == np.uint64
