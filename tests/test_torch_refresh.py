"""TPC-H's refresh functions through the port's write path, on the CPU.

The same RF1 and RF2 text (`utils/tpch_full.py`: `rf1`, `rf2`) goes to
the JAX session, the port's CPU session and the sqlite3 oracle, over
the 8-table corpus at sf 0.004, seed 1.  After RF1 alone, and after RF1
and RF2, all 22 queries must equal sqlite3 (`run_compare`) and the JAX
session's normalized rows.  The JAX side runs its
per-operator path (MO_PLAN_FUSION=0) with its Pallas kernels in
interpret mode (MO_HAND_KERNELS=1), as tests/test_torch_tpch.py runs it.

Also: a JAX engine with history (several segments, tombstones, an
UPDATE, a named snapshot) carried across by `convert` answers AS OF and
current reads as the JAX engine does, and queries whose dictionaries
grew under an INSERT (a new `l_shipmode`, a new `p_type`) see the new
strings.
"""

import numpy as np
import pytest

from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu.utils import tpch_full as JT
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.utils import tpch_full as TT

SF, SEED = 0.004, 1


@pytest.fixture(scope="module")
def env():
    mp = pytest.MonkeyPatch()
    mp.setenv("MO_PLAN_FUSION", "0")
    mp.setenv("MO_HAND_KERNELS", "1")
    yield
    mp.undo()


def _corpus(refreshes):
    """(JAX session, port session, sqlite3) over the corpus after each
    of `refreshes` (callables tables -> Refresh) in turn."""
    js = JSession()
    tables = JT.load_tpch(js.catalog, sf=SF, seed=SEED)
    ts = TSession(catalog=convert.tables_from_numpy(
        convert.tables_to_numpy(js.catalog)), device="cpu")
    conn = TT.to_sqlite(tables)
    for make in refreshes:
        rf = make(tables)
        for sql in rf.statements:
            assert (js.execute(sql).affected
                    == ts.execute(sql).affected), sql
        TT.apply_sqlite(conn, rf.statements)
        tables = TT.apply_refresh(tables, rf)
    return js, ts, conn, tables


def _rf1(tables):
    return TT.rf1(tables, SF, seed=11)


def _rf2(tables):
    return TT.rf2(tables, SF, seed=12)


@pytest.fixture(scope="module")
def after_rf1(env):
    js, ts, conn, _ = _corpus([_rf1])
    yield js, ts, conn
    conn.close()


@pytest.fixture(scope="module")
def after_both(env):
    js, ts, conn, tables = _corpus([_rf1, _rf2])
    yield js, ts, conn, tables
    conn.close()


def _hold(js, ts, conn, qnum):
    TT.run_compare(ts, conn, qnum)
    sql = TT.QUERIES[qnum]
    assert (TT.normalize_rows(ts.execute(sql).rows())
            == TT.normalize_rows(js.execute(sql).rows()))


def test_refresh_text_is_the_spec_shape():
    """RF1: SF x 1500 orders above the largest key, 1-7 lines each,
    INSERTs of at most 500 rows in one transaction; RF2: as many
    existing orders by key, at most 150 keys a DELETE, lineitem first."""
    tables = TT.gen_tpch(0.1, SEED)
    rf = TT.rf1(tables, 0.1, seed=3)
    assert rf.statements[0] == "begin" and rf.statements[-1] == "commit"
    orders, lines = rf.inserts["orders"], rf.inserts["lineitem"]
    top = tables["orders"]["o_orderkey"].max()
    np.testing.assert_array_equal(orders["o_orderkey"],
                                  np.arange(top + 1, top + 151))
    per = np.bincount(lines["l_orderkey"] - top - 1)
    assert per.min() >= 1 and per.max() <= 7 and len(per) == 150
    body = rf.statements[1:-1]
    assert sum(s.count("), (") + 1 for s in body) == 150 + len(
        lines["l_orderkey"])
    assert all(s.count("), (") < 500 for s in body)
    rf2 = TT.rf2(TT.apply_refresh(tables, rf), 0.1, seed=4)
    assert len(rf2.delete_keys) == 150
    assert len(set(rf2.delete_keys.tolist())) == 150
    assert rf2.statements[1].startswith("delete from lineitem")
    assert rf2.statements[-2].startswith("delete from orders")
    assert all(s.count(",") < 150 for s in rf2.statements[1:-1])


@pytest.mark.parametrize("qnum", sorted(TT.QUERIES))
def test_after_rf1_equals_sqlite_and_reference(after_rf1, qnum):
    _hold(*after_rf1, qnum)


@pytest.mark.parametrize("qnum", sorted(TT.QUERIES))
def test_after_rf1_and_rf2_equals_sqlite_and_reference(after_both, qnum):
    js, ts, conn, _ = after_both
    _hold(js, ts, conn, qnum)


def test_refreshes_change_what_the_oracles_see(after_both):
    """The refreshed engines hold the refreshed arrays' row counts."""
    js, ts, conn, tables = after_both
    for t in ("orders", "lineitem"):
        n = len(tables[t][t[0] + "_orderkey"])
        assert ts.execute(f"select count(*) from {t}").rows() == [(n,)]
        assert conn.execute(f"select count(*) from {t}").fetchall() == [(n,)]


def test_grown_dictionaries_are_seen(env):
    """An INSERT that adds a new l_shipmode and a new p_type: the
    grouped aggregate (its dense key space), LIKE and the string
    functions see the new strings, as the JAX session and sqlite3 do."""
    js, ts, conn, _ = _corpus([])
    stmts = ["insert into part values (100001, 'plum plum plum', "
             "'Manufacturer#9', 'Brand#99', 'SHINY GLOWING TIN', 7, "
             "'SM CASE', 901.00, 'new part')",
             "insert into lineitem values (1, 100001, 1, 8, 5.00, 4505.00, "
             "0.05, 0.01, 'N', 'O', '1995-09-10', '1995-09-20', "
             "'1995-09-30', 'NONE', 'ROCKET', 'new mode')"]
    for sql in stmts:
        js.execute(sql)
        ts.execute(sql)
        conn.execute(sql)
    for sql in ["select l_shipmode, count(*), sum(l_quantity) from lineitem "
                "group by l_shipmode order by l_shipmode",
                "select l_returnflag, l_shipmode, count(*) from lineitem "
                "group by l_returnflag, l_shipmode",
                "select count(*) from part where p_type like 'SHINY%'",
                "select p_type, upper(p_type), length(p_type) from part "
                "where p_size = 7 and p_type like '%TIN'",
                "select count(*) from lineitem where l_shipmode in "
                "('ROCKET', 'MAIL')"]:
        got = TT.normalize_rows(ts.execute(sql).rows())
        assert got == TT.normalize_rows(js.execute(sql).rows()), sql
        assert TT.rows_match(got, TT.normalize_rows(
            conn.execute(TT.to_sqlite_sql(sql)).fetchall())), sql
    for q in (12, 14):
        _hold(js, ts, conn, q)


def test_convert_carries_history(env):
    """Segments with their commit timestamps, tombstones and a named
    snapshot cross to the port: AS OF reads at the snapshot and at a
    raw timestamp, and current reads, equal the JAX engine's."""
    js = JSession()
    js.execute("create table h (id bigint primary key, g varchar(8), "
               "x decimal(10,2))")
    js.execute("insert into h values (1, 'a', 1.25), (2, 'b', 2.50), "
               "(3, 'a', 3.75)")
    js.execute("insert into h values (4, 'c', 4.00)")
    ts_mid = js.catalog.committed_ts
    js.execute("delete from h where id = 2")
    js.execute("create snapshot before_update")
    js.execute("update h set x = x * 2, g = 'z' where id >= 3")
    js.execute("insert into h values (2, 'b', 9.99)")
    js.execute("delete from h where id = 1")
    tcat = convert.tables_from_numpy(convert.tables_to_numpy(js.catalog))
    ts = TSession(catalog=tcat, device="cpu")
    assert tcat.snapshots == js.catalog.snapshots
    t, j = tcat.get_table("h"), js.catalog.get_table("h")
    assert [s.commit_ts for s in t.segments] == [s.commit_ts
                                                 for s in j.segments]
    assert [(ts_, g.tolist()) for ts_, g in t.tombstones] == \
        [(ts_, g.tolist()) for ts_, g in j.tombstones]
    for sql in ["select id, g, x from h order by id",
                "select id, g, x from h as of snapshot 'before_update' "
                "order by id",
                f"select id, g, x from h as of timestamp {ts_mid} "
                "order by id",
                "select g, count(*), sum(x) from h group by g order by g",
                "select cur.id, cur.x, old.x from h cur join h as of "
                "snapshot 'before_update' old on cur.id = old.id "
                "order by cur.id"]:
        assert ts.execute(sql).rows() == js.execute(sql).rows(), sql
    gids = np.arange(-1, t.next_gid, dtype=np.int64)
    for ts_ in (None, js.catalog.snapshots["before_update"], ts_mid):
        np.testing.assert_array_equal(t.visible_gids(gids, ts_),
                                      j.visible_gids(gids, ts_))
    live = t.visible_gids(gids)
    for a, b in zip(t.fetch_rows(live, ["id", "g", "x"]),
                    j.fetch_rows(live, ["id", "g", "x"])):
        for c in ("id", "g", "x"):
            np.testing.assert_array_equal(a[c], b[c])
    # the carried engine keeps writing where the JAX one would
    for s in (ts, js):
        s.execute("insert into h values (1, 'n', 0.01)")
    with pytest.raises(Exception) as e:
        ts.execute("insert into h values (3, 'dup', 0)")
    assert type(e.value).__name__ == "DuplicateKeyError"
    assert ts.execute("select id, g, x from h order by id").rows() == \
        js.execute("select id, g, x from h order by id").rows()
