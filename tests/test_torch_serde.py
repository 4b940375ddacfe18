"""The port's plan serialization (`sql/serde.py`) against the JAX
package's, on the CPU.

Each of the 22 TPC-H queries of `utils/tpch_full.py` is bound and
optimized by both sessions over the same tables (sf 0.004, carried
across with `convert`); `plan_to_json` of the port's plan equals the
JAX package's, and a plan read back by `plan_from_json` writes the same
JSON again.  The one difference is the decorrelation rewrite's names:
the JAX package numbers them with a process-wide counter, the port per
statement (`sql/decorrelate.statement_names`), so `__sj7_k0` there is
`__sj0_k0` here (and `__dc2.` a table alias); the comparison reads
both numbers as N.
"""

import json
import re

import pytest
import torch

from matrixone_tpu.frontend.session import Session as JSession
from matrixone_tpu.sql import serde as JS
from matrixone_tpu.sql.binder import Binder as JBinder
from matrixone_tpu.sql.parser import parse_one as j_parse_one
from matrixone_tpu.utils import tpch_full as JT
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.sql import serde as TS
from matrixone_tpu_torch.sql.expr import AggCall, BoundCol, BoundFunc
from matrixone_tpu_torch.container import dtypes as dt

_DECORRELATED = re.compile(r"__(sj|dc)\d+([._])")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs six test processes at once (xdist): torch's own
    thread pool in each would oversubscribe the cores, and these tests'
    many small ops per shard are what it slows most."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sessions():
    js = JSession()
    JT.load_tpch(js.catalog, sf=0.004, seed=1)
    ts = TSession(catalog=convert.tables_from_numpy(
        convert.tables_to_numpy(js.catalog)), device="cpu")
    return js, ts


def _text(plan_json) -> str:
    return _DECORRELATED.sub(r"__\1N\2", json.dumps(plan_json,
                                                    sort_keys=True))


@pytest.mark.parametrize("qnum", sorted(JT.QUERIES))
def test_plan_json_equals_the_reference_and_round_trips(sessions, qnum):
    js, ts = sessions
    sql = JT.QUERIES[qnum]
    sel = j_parse_one(sql)
    js._prepare_select(sel)
    jplan = js._cbo(JBinder(js.catalog).bind_statement(sel))
    got = TS.plan_to_json(ts.plan(sql))
    assert _text(got) == _text(JS.plan_to_json(jplan))
    assert TS.plan_to_json(TS.plan_from_json(got)) == got


def test_expression_and_aggregate_codecs_round_trip():
    x = BoundCol("t.x", dt.decimal64(15, 2))
    e = BoundFunc("mul", [x, x], x.dtype)
    assert TS.expr_to_json(TS.expr_from_json(TS.expr_to_json(e))) == \
        TS.expr_to_json(e)
    a = AggCall("sum", e, False, x.dtype, "_agg0")
    assert TS.agg_to_json(TS.agg_from_json(TS.agg_to_json(a))) == \
        TS.agg_to_json(a)
    with pytest.raises(TypeError):
        TS.expr_to_json(object())
