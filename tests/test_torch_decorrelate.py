"""Decorrelated subqueries bind to the same names on every run, on the
CPU.

The port names the semi-join and derived-table columns that
decorrelation adds (`__sj{n}_k{i}`, `__dc{n}_...`) by their position in
the statement, counted from 0 for each statement, where the JAX package
draws n from a process counter.  So a second run of the same SQL
through one port session binds the same plan, and its fused fragments
look up the keys the first run made: the fragment cache counts no new
miss (`mo_fusion_compile_total{outcome="miss"}`).  Statements: the EXISTS
and NOT EXISTS queries of tests/test_torch_cuda.py's `FUSED_CARD_SQL`,
a correlated scalar subquery, a nested EXISTS, and TPC-H Q4, Q17, Q20
and Q21 at sf 0.004.  Both packages run fused with every batch fused
(`fusion_env`, MO_FUSION_MIN_ROWS=0); the rows equal the JAX session's,
floats within rtol 1e-4 / atol 1e-3 (the reference's tolerance).
"""

import pytest

from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu.utils import tpch_full as JT
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.sql import ast, decorrelate as D
from matrixone_tpu_torch.sql.parser import parse_one
from matrixone_tpu_torch.utils import metrics as TM
from matrixone_tpu_torch.utils import tpch_full as TT
from test_torch_cuda import FUSED_CARD_SQL, _fusion_tables
from torch_fusion_lockstep import ATOL, RTOL, fusion_env  # noqa: F401
from torch_scripts import run_step, same_outcome

pytestmark = pytest.mark.usefixtures("fusion_env")

CARD_SQL = [s for s in FUSED_CARD_SQL if "exists" in s]
MORE_SQL = [
    # a correlated scalar subquery: a grouped derived table
    "select id from ft where q > (select avg(w) from fd where fd.k = ft.k)"
    " order by id",
    "select count(*) from ft where q < (select max(w) from fd"
    " where fd.k = ft.k and fd.w > 30)",
    # nested: the inner EXISTS decorrelates inside the outer one's select
    "select count(*) from fd where exists (select 1 from ft where"
    " ft.k = fd.k and exists (select 1 from fdup where fdup.k = ft.k))",
]


def _misses() -> float:
    return TM.fusion_compile.get(outcome="miss")


def _twice_adds_no_key(sess, sql):
    """-> the first run's outcome; the second run must equal it and add
    no fragment key."""
    first = run_step(sess, sql)
    assert first[0] == "ok", (sql, first)
    m0 = _misses()
    assert run_step(sess, sql) == first
    assert _misses() == m0, f"a warm run keyed anew: {sql!r}"
    return first


@pytest.fixture(scope="module")
def small():
    steps = _fusion_tables()
    j, t = JSession(), TSession(device="cpu")
    for st in steps:
        j.execute(st)
        t.execute(st)
    return j, t


@pytest.mark.parametrize("sql", CARD_SQL + MORE_SQL)
def test_second_run_adds_no_fragment_key(small, sql):
    j, t = small
    got = _twice_adds_no_key(t, sql)
    want = run_step(j, sql)
    assert same_outcome(got, want, RTOL, ATOL), (sql, got, want)


@pytest.fixture(scope="module")
def tpch():
    js = JSession()
    tables = JT.load_tpch(js.catalog, sf=0.004, seed=1)
    ts = TSession(catalog=convert.tables_from_numpy(
        convert.tables_to_numpy(js.catalog)), device="cpu")
    return js, ts, tables


@pytest.mark.parametrize("qnum", [4, 17, 20, 21])
def test_tpch_subquery_second_run_adds_no_fragment_key(tpch, qnum):
    js, ts, tables = tpch
    sql = TT.QUERIES[qnum]
    got = _twice_adds_no_key(ts, sql)
    want = run_step(js, sql)
    assert want[0] == "ok"
    assert TT.normalize_rows(got[2]) == TT.normalize_rows(want[2])
    conn = TT.to_sqlite(tables)
    try:
        TT.run_compare(ts, conn, qnum)
    finally:
        conn.close()


def _aliases(sel) -> list:
    return [sj.alias for sj in sel.semijoins]


def test_names_count_from_zero_in_each_statement():
    """Two rewrites of the same text give the same names; a statement
    with two EXISTS numbers them 0 and 1; outside a session the rewrite
    opens its own numbering."""
    eng = TSession(device="cpu")
    for st in _fusion_tables():
        eng.execute(st)
    sql = ("select count(*) from ft where exists (select 1 from fd where"
           " fd.k = ft.k) and not exists (select 1 from fdup where"
           " fdup.k = ft.k)")
    names = []
    for _ in range(2):
        sel = parse_one(sql)
        D.decorrelate_select(sel, eng.catalog)
        names.append(_aliases(sel))
    assert names[0] == names[1] == ["__sj0", "__sj1"]
    with D.statement_names():
        a, b = parse_one(sql), parse_one(sql)
        D.decorrelate_select(a, eng.catalog)
        D.decorrelate_select(b, eng.catalog)
    # one statement: unique names across its pieces
    assert _aliases(a) + _aliases(b) == ["__sj0", "__sj1", "__sj2", "__sj3"]
    assert isinstance(a, ast.Select)
