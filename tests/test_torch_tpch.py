"""TPC-H through the port's SQL session against the JAX package, on the CPU.

The tables are made in a JAX engine and carried across with
`convert.tables_from_numpy`; the JAX session runs its per-operator path
(MO_PLAN_FUSION=0) with its Pallas kernels in interpret mode
(MO_HAND_KERNELS=1), as tests/test_torch_sql.py runs it.

  * tests/test_tpch.py's cases on the port: Q1 (exact, `q1_check`, on
    the dense small-key aggregate, shown by the AggOp's `agg_chunks`
    counter), Q6 (the integer oracle), SSB Q1.1-Q1.3 and Q1 over 4096-row
    scan batches, each also equal to the JAX session's rows;
  * all 22 queries of `utils/tpch_full.py` at sf 0.004, seed 1 (the
    corpus of tests/test_tpch_full.py), each held to the sqlite3 oracle
    by `run_compare` and equal to the JAX session's normalized rows.
"""

import numpy as np
import pytest

from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu.utils import tpch as jtpch
from matrixone_tpu.utils import tpch_full as JT
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.utils import metrics as TM
from matrixone_tpu_torch.utils import tpch as ttpch
from matrixone_tpu_torch.utils import tpch_full as TT


@pytest.fixture(scope="module")
def env():
    mp = pytest.MonkeyPatch()
    mp.setenv("MO_PLAN_FUSION", "0")
    mp.setenv("MO_HAND_KERNELS", "1")
    yield
    mp.undo()


def _port(js) -> TSession:
    return TSession(catalog=convert.tables_from_numpy(
        convert.tables_to_numpy(js.catalog)), device="cpu")


@pytest.fixture(scope="module")
def lineitem(env):
    js = JSession()
    arrays = jtpch.load_lineitem(js.catalog, 50_000, seed=7)
    return js, _port(js), arrays


@pytest.mark.parametrize("batch_rows", [1 << 20, 4096])
def test_q1_exact_on_the_dense_path(lineitem, batch_rows):
    js, ts, arrays = lineitem
    ts.variables["batch_rows"] = js.variables["batch_rows"] = batch_rows
    try:
        d0 = TM.agg_chunks.get(path="dense")
        g0 = TM.agg_chunks.get(path="general")
        rows = ts.execute(ttpch.Q1_SQL).rows()
        chunks = TM.agg_chunks.get(path="dense") - d0
        assert chunks == -(-len(arrays["l_orderkey"]) // batch_rows)
        assert TM.agg_chunks.get(path="general") == g0
        want = js.execute(jtpch.Q1_SQL).rows()
    finally:
        ts.variables["batch_rows"] = js.variables["batch_rows"] = 1 << 20
    oracle = ttpch.q1_oracle(arrays)
    keys = [(r[0], r[1]) for r in rows]
    assert keys == sorted(keys)
    assert ttpch.q1_check(rows, oracle)
    assert rows == want
    # the checker itself must catch corruption
    bad = [tuple([rows[0][0], rows[0][1], rows[0][2] + 1]
                 + list(rows[0][3:]))] + rows[1:]
    assert not ttpch.q1_check(bad, oracle)
    assert not ttpch.q1_check(rows[:-1], oracle)


@pytest.mark.parametrize("batch_rows", [1 << 20, 4096])
def test_q6_exact(lineitem, batch_rows):
    js, ts, arrays = lineitem
    ts.variables["batch_rows"] = batch_rows
    try:
        rows = ts.execute(ttpch.Q6_SQL).rows()
    finally:
        ts.variables["batch_rows"] = 1 << 20
    sel = (arrays["l_shipdate"] >= 8766) & (arrays["l_shipdate"] < 9131) & \
          (arrays["l_discount"] >= 5) & (arrays["l_discount"] <= 7) & \
          (arrays["l_quantity"] < 2400)
    rev = int((arrays["l_extendedprice"][sel].astype(object)
               * arrays["l_discount"][sel]).sum())
    assert abs(rows[0][0] - rev / 10000) < 1e-9
    assert rows == js.execute(jtpch.Q6_SQL).rows()


def test_ssb_q1x_exact(env):
    js = JSession()
    lo, dates = jtpch.load_ssb(js.catalog, 30_000, seed=5)
    ts = _port(js)
    for q, sql in (("q11", ttpch.SSB_Q11), ("q12", ttpch.SSB_Q12),
                   ("q13", ttpch.SSB_Q13)):
        got = ts.execute(sql).rows()[0][0]
        expect = ttpch.ssb_q1_oracle(lo, dates, q)
        if expect == 0:
            assert got is None or got == 0, (q, got)
        else:
            assert got == expect, (q, got, expect)
        assert ts.execute(sql).rows() == js.execute(sql).rows()


def test_q1_streaming_multi_batch(env):
    """Same rows when the scan is split into many device batches (the
    dense accumulator's cross-chunk add), as the JAX session's."""
    js = JSession()
    jtpch.load_lineitem(js.catalog, 30_000, seed=3)
    ts = _port(js)
    big = ts.execute(ttpch.Q1_SQL).rows()
    ts.variables["batch_rows"] = js.variables["batch_rows"] = 4096
    small = ts.execute(ttpch.Q1_SQL).rows()
    assert small == big
    assert small == js.execute(jtpch.Q1_SQL).rows()


# ------------------------------------------------------ the 22 queries

@pytest.fixture(scope="module")
def corpus(env):
    js = JSession()
    tables = JT.load_tpch(js.catalog, sf=0.004, seed=1)
    conn = TT.to_sqlite(tables)
    yield js, _port(js), conn
    conn.close()


def test_port_corpus_equals_reference_corpus():
    """The port's copy of the generator makes the reference's tables."""
    a, b = JT.gen_tpch(0.004, 1), TT.gen_tpch(0.004, 1)
    assert a.keys() == b.keys()
    for t in a:
        assert a[t].keys() == b[t].keys()
        for c in a[t]:
            np.testing.assert_array_equal(a[t][c], b[t][c])
    assert TT.QUERIES == JT.QUERIES


@pytest.mark.parametrize("qnum", sorted(TT.QUERIES))
def test_tpch_query_equals_sqlite_and_reference(corpus, qnum):
    js, ts, conn = corpus
    TT.run_compare(ts, conn, qnum)
    got = TT.normalize_rows(ts.execute(TT.QUERIES[qnum]).rows())
    want = TT.normalize_rows(js.execute(TT.QUERIES[qnum]).rows())
    assert got == want
