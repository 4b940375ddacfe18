"""The port's SQL path against the JAX package, on the CPU.

TPC-H Q3 (customer x orders x lineitem, a grouped aggregate and ORDER
BY ... LIMIT 10) and a float GROUP BY run from SQL text through both
sessions over the same tables (`convert.tables_from_numpy` carries the
JAX engine's segments and dictionaries across).  The JAX package runs
its per-operator path (MO_PLAN_FUSION=0) with its Pallas kernels in
interpret mode (MO_HAND_KERNELS=1), as its own tests run them.

  * Q3's rows equal the JAX session's and the integer-domain
    `q3_oracle`, with one scan batch and with many small ones;
  * the float GROUP BY's integer-valued sums are exact, and its N(0,1)
    sums are within the reference's segment-sum tolerance (rtol 1e-4,
    atol 1e-3) of the JAX session's and of an f64 sum;
  * the bound, cost-optimized plans print the same `explain` text, which
    holds the port's copies of the SQL front end to the originals.
"""

import datetime

import numpy as np
import pytest
import torch

from matrixone_tpu.container import dtypes as jdt
from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu.sql import plan as JP
from matrixone_tpu.sql.binder import Binder as JBinder
from matrixone_tpu.sql.cbo import optimize_plan as j_optimize
from matrixone_tpu.sql.parser import parse_one as j_parse_one
from matrixone_tpu.storage.engine import TableMeta as JMeta
from matrixone_tpu.utils import tpch as jtpch
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.ops import kernels as TK
from matrixone_tpu_torch.sql import plan as TP
from matrixone_tpu_torch.utils import tpch as ttpch

N_LINEITEM = 8000
N_V = 6000
GROUP_BY = "select grp, sum(xi), sum(xn) from v group by grp order by grp"
EPOCH = datetime.date(1970, 1, 1)


@pytest.fixture(scope="module")
def sessions():
    mp = pytest.MonkeyPatch()
    mp.setenv("MO_PLAN_FUSION", "0")
    mp.setenv("MO_HAND_KERNELS", "1")
    js = JSession()
    lineitem = jtpch.load_lineitem(js.catalog, N_LINEITEM, seed=3)
    q3data = jtpch.load_tpch_q3(js.catalog, N_LINEITEM // 4, seed=3)
    rng = np.random.default_rng(5)
    ids = np.arange(N_V, dtype=np.int64)
    v = {"id": ids, "grp": ids % 1000,
         "xi": rng.integers(0, 16, N_V).astype(np.float32),
         "xn": rng.standard_normal(N_V).astype(np.float32)}
    js.catalog.create_table(JMeta(
        "v", [("id", jdt.INT64), ("grp", jdt.INT64), ("xi", jdt.FLOAT32),
              ("xn", jdt.FLOAT32)], ["id"]))
    js.catalog.get_table("v").insert_numpy(v)
    ts = TSession(catalog=convert.tables_from_numpy(
        convert.tables_to_numpy(js.catalog)), device="cpu")
    yield js, ts, (lineitem, q3data, v)
    mp.undo()


def _exact_q3(rows, oracle) -> bool:
    """bench.py's Q3 check: keys, revenue x 10000, days."""
    return len(rows) == len(oracle) and all(
        g[0] == e[0] and round(g[1] * 10000) == e[1]
        and (g[2] - EPOCH).days == e[2] for g, e in zip(rows, oracle))


@pytest.mark.parametrize("batch_rows", [1 << 20, 1024])
def test_q3_rows_equal_reference_and_oracle(sessions, batch_rows):
    js, ts, (lineitem, q3data, _) = sessions
    js.variables["batch_rows"] = ts.variables["batch_rows"] = batch_rows
    try:
        want = js.execute(jtpch.Q3_SQL).rows()
        got = ts.execute(ttpch.Q3_SQL).rows()
    finally:
        js.variables["batch_rows"] = ts.variables["batch_rows"] = 1 << 20
    assert len(got) == 10
    assert got == want
    assert _exact_q3(got, ttpch.q3_oracle(lineitem, q3data))


def test_q3_oracle_check_catches_corruption(sessions):
    js, ts, (lineitem, q3data, _) = sessions
    rows = ts.execute(ttpch.Q3_SQL).rows()
    oracle = ttpch.q3_oracle(lineitem, q3data)
    bad = [(rows[0][0], rows[0][1] + 0.0001) + tuple(rows[0][2:])] + rows[1:]
    assert _exact_q3(rows, oracle)
    assert not _exact_q3(bad, oracle)
    assert not _exact_q3(rows[:-1], oracle)


@pytest.mark.parametrize("batch_rows", [1 << 20, 1024])
def test_float_group_by_equals_reference(sessions, batch_rows):
    js, ts, (_, _, v) = sessions
    js.variables["batch_rows"] = ts.variables["batch_rows"] = batch_rows
    try:
        want = js.execute(GROUP_BY).rows()
        got = ts.execute(GROUP_BY).rows()
    finally:
        js.variables["batch_rows"] = ts.variables["batch_rows"] = 1 << 20
    assert len(got) == len(want) == 1000
    assert [r[0] for r in got] == [r[0] for r in want] == list(range(1000))
    g = v["grp"]
    xi_exact = np.bincount(g, weights=v["xi"].astype(np.int64),
                           minlength=1000)
    xn_f64 = np.bincount(g, weights=v["xn"].astype(np.float64),
                         minlength=1000)
    # integer-valued f32 sums are exact whatever the order
    assert [r[1] for r in got] == [r[1] for r in want] == xi_exact.tolist()
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose([r[2] for r in got], xn_f64, rtol=1e-4,
                               atol=1e-3)


def test_float_group_by_takes_the_segment_sum_route(sessions, monkeypatch):
    """The port's AggOp asks the seam for the segment-sum kernel for both
    float32 sums, once per scan batch each, at the group table's 4096
    slots; the merge of partial tables and the counts do not."""
    _, ts, _ = sessions
    calls = []
    real = TK.grouped_scatter_add

    def spy(values, gids, mask, max_groups, use_pallas=False):
        calls.append((values.dtype, max_groups, use_pallas))
        return real(values, gids, mask, max_groups, use_pallas=use_pallas)

    monkeypatch.setattr(TK, "grouped_scatter_add", spy)
    ts.variables["batch_rows"] = 1024
    try:
        ts.execute(GROUP_BY)
    finally:
        ts.variables["batch_rows"] = 1 << 20
    kernel_route = [c for c in calls if c[2]]
    assert len(kernel_route) == 2 * -(-N_V // 1024)
    assert set(kernel_route) == {(torch.float32, 4096, True)}
    assert len(calls) > len(kernel_route)      # the merges


def _j_plan(js, sql):
    node = JBinder(js.catalog).bind_statement(j_parse_one(sql))
    return j_optimize(node, js.catalog)


@pytest.mark.parametrize("sql", [jtpch.Q3_SQL, GROUP_BY])
def test_plans_explain_alike(sessions, sql):
    js, ts, _ = sessions
    want = JP.explain(_j_plan(js, sql))
    got = TP.explain(ts.plan(sql))
    assert got == want
    assert "Join" in got or "Aggregate" in got
