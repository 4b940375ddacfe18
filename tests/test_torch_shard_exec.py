"""The port's device-shard SQL executor (`parallel/dist_query.py`) against
its own local path, the JAX package's sharded path and sqlite3, on the
CPU.

The JAX session shards over the 8 virtual CPU devices its conftest
provides; the port runs under `simulated_slots(8)` (8 slots on the one
CPU) with the plain versions of its kernels, and every batch takes the
fused path (MO_FUSION_MIN_ROWS=0), so each shard's partial comes out of
a fused fragment's carry.  The counterparts of tests/test_shard_exec.py:

  * Q3's shape at 2, 4 and 8 shards bit-identical to the port's local
    rows, and at 8 to the JAX package's sharded rows; scalar aggregates
    and a top-k; Q5, Q9 and Q18 against sqlite3 (rows as multisets);
  * the merge counted once a statement and by kind, the dense psum
    merge, EXPLAIN's text (its exchanges) equal to the JAX package's;
  * the degrade ladder over the TPC-H corpus (9 shards on 8 slots,
    COUNT(DISTINCT), a small input): local rows, no merge, answered and
    reported as the JAX package answers and reports them.

Every sharded statement is also run by the JAX session and its sharded
rows are the port's.  The tests over tables made by hand (the merges by
kind, the open transaction, a ShardDegrade, a card fault, `PARTITION BY
HASH ... SHARDS n`, the shuffle join, the audited merge site) are in
tests/test_torch_shard_tables.py; the two files share
tests/torch_shard_rig.py.
"""

import pytest

from matrixone_tpu.frontend.session import Session as JSession
from matrixone_tpu.utils import tpch_full as JT
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.parallel.mesh import devices
from matrixone_tpu_torch.utils import metrics as M
from matrixone_tpu_torch.utils import tpch_full as T
from torch_shard_rig import (  # noqa: F401  (fixtures)
    merged_statements as _merged_statements, one_torch_thread, sharded as
    _sharded, slots)


def _port_of(js) -> TSession:
    return TSession(catalog=convert.tables_from_numpy(
        convert.tables_to_numpy(js.catalog)), device="cpu")


@pytest.fixture(scope="module")
def corpus(slots):
    js = JSession()
    tables = JT.load_tpch(js.catalog, sf=0.004, seed=1)
    conn = T.to_sqlite(tables)
    yield js, _port_of(js), conn
    conn.close()


Q3_SHAPE = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
"""


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_q3_bit_identical_to_local_and_reference(corpus, n_shards):
    js, ts, _ = corpus
    assert len(devices("cpu")) == 8
    local = ts.execute(Q3_SHAPE).rows()
    m0 = _merged_statements()
    got = _sharded(ts, n_shards, Q3_SHAPE)
    assert got == local and len(got) == 10
    assert _merged_statements() == m0 + 1
    assert got == _sharded(js, n_shards, Q3_SHAPE)


def test_scalar_agg_and_topk(corpus):
    js, ts, _ = corpus
    scalar = ("select count(*), sum(l_quantity), min(l_extendedprice),"
              " max(l_extendedprice), avg(l_discount) from lineitem")
    topk = ("select l_orderkey, l_extendedprice from lineitem"
            " order by l_extendedprice desc, l_orderkey limit 25")
    s0 = M.exchange_partial_merge.get(kind="scalar")
    t0 = M.exchange_partial_merge.get(kind="topk")
    for sql in (scalar, topk):
        got = _sharded(ts, 4, sql)
        assert got == ts.execute(sql).rows()
        assert got == _sharded(js, 4, sql)
    assert M.exchange_partial_merge.get(kind="scalar") == s0 + 1
    assert M.exchange_partial_merge.get(kind="topk") == t0 + 1


@pytest.mark.parametrize("qnum", [5, 9, 18])
def test_q5_q9_q18_sharded_vs_sqlite(corpus, qnum):
    js, ts, conn = corpus
    sql = T.QUERIES[qnum]
    local = T.normalize_rows(ts.execute(sql).rows())
    sharded = T.normalize_rows(_sharded(ts, 4, sql))
    assert T.rows_match(sharded, local)
    assert T.rows_match(sharded, T.normalize_rows(_sharded(js, 4, sql)))
    want = T.normalize_rows(conn.execute(T.to_sqlite_sql(sql)).fetchall())
    assert T.rows_match(sharded, want)


def _exchanges(text):
    return [(ln.split()[0], tok) for ln in text.splitlines()
            for tok in ln.split() if tok.startswith("exchange=")]


@pytest.mark.parametrize("sql", [
    Q3_SHAPE,
    "select l_linestatus, count(*) from lineitem group by l_linestatus",
    T.QUERIES[5]], ids=["q3", "group_by", "q5"])
def test_explain_exchanges_equal_the_reference(corpus, sql):
    js, ts, _ = corpus
    got = _sharded(ts, 4, "explain " + sql, text=True)
    assert got == _sharded(js, 4, "explain " + sql, text=True)
    assert _exchanges(got)
    assert {t.split("=", 1)[1] for _n, t in _exchanges(got)} <= \
        {"broadcast", "shuffle", "local"}


# ------------------------------------------------------- degrade ladder

@pytest.mark.parametrize("case", ["mesh_too_small", "distinct",
                                  "small_input"])
def test_degrade_answers_locally(corpus, case):
    js, ts, _ = corpus
    sql = ("select l_linestatus, count(*) from lineitem"
           " group by l_linestatus order by l_linestatus")
    n = 4
    if case == "mesh_too_small":
        n = len(devices("cpu")) + 1             # 9 shards on 8 slots
    elif case == "distinct":
        sql = "select count(distinct l_orderkey) from lineitem"
    local = ts.execute(sql).rows()
    before = _merged_statements()
    answers = []
    for s in (ts, js):
        s.execute(f"set query_shards = {n}")
        s.execute("set dist_min_rows = "
                  + ("100000000" if case == "small_input" else "0"))
        try:
            answers.append((s.execute(sql).rows(),
                            s.execute("explain " + sql).text))
        finally:
            s.execute("set query_shards = 0")
            s.execute("set dist_min_rows = 100000")
    (got, text), (jgot, jtext) = answers
    assert got == local
    assert _merged_statements() == before
    assert "exchange=" not in text
    # answered and reported as the reference answers and reports it
    assert got == jgot and text == jtext
