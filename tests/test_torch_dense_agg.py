"""The port's dense small-key GROUP BY against the JAX package, on the CPU.

  * `ops/agg.dense_lane_partials` (one `index_add_` for the int lanes,
    block sums over the rows sorted by slot for the float lanes) against
    the reference's unrolled masked sums on the same seeded numpy
    inputs: int64 lanes and the rows lane bit-equal, float64 lanes
    within rtol 1e-12, with and without NULL slots, NULL keys, masked
    rows, per-lane masks and narrow int8 codes; a NaN or an inf stays in
    its own slot, at row counts over, at and under whole blocks, as in
    the reference;
  * the AggOp's dense path through SQL: the rows equal the JAX
    session's, the path is the dense one (the `agg_chunks` counter),
    `MO_DENSE_GROUPS=0` and `MO_DENSE_GROUPS_MAX` send it to the general
    path with the same answer, and a float32 SUM over a BOOL key is
    summed in f64, as the reference sums it;
  * an AggOp whose key dictionary grows mid-stream converts its dense
    partials to the general table and gives the reference's rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrixone_tpu.container import dtypes as jdt
from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu.ops import agg as JA
from matrixone_tpu.sql.binder import Binder as JBinder
from matrixone_tpu.sql.parser import parse_one as j_parse_one
from matrixone_tpu.storage.engine import TableMeta as JMeta
from matrixone_tpu.vm import operators as JO
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.ops import agg as TA
from matrixone_tpu_torch.sql.binder import Binder as TBinder
from matrixone_tpu_torch.sql.parser import parse_one as t_parse_one
from matrixone_tpu_torch.utils import metrics as TM
from matrixone_tpu_torch.vm import operators as TO
from matrixone_tpu_torch.vm.process import ExecContext


# ------------------------------------------------------ dense_lane_partials

def _lanes(rng, n):
    """(int lanes, float lanes) as (value, mask) numpy pairs: a count
    lane (value None), int64 decimals near 2^40 and int32 values, f64
    and f32 values, each with and without its own mask."""
    def mask():
        return rng.random(n) < 0.8
    ints = [(None, None), (None, mask()),
            (rng.integers(-(1 << 40), 1 << 40, n), None),
            (rng.integers(-1000, 1000, n).astype(np.int32), mask())]
    floats = [(rng.standard_normal(n) * 1e6, None),
              (rng.standard_normal(n).astype(np.float32), mask()),
              (rng.random(n), mask())]
    return ints, floats


@pytest.mark.parametrize("sizes,with_null,code_dtype", [
    ((3, 2), True, np.int32), ((3, 2), False, np.int32),
    ((5,), True, np.int8), ((5,), False, np.int8),
    ((2, 3, 2), True, np.int16), ((1, 4), False, np.int32)])
def test_dense_lane_partials_match_reference(sizes, with_null, code_dtype):
    n = 3000
    rng = np.random.default_rng(sum(sizes) * 7 + with_null)
    codes = [rng.integers(0, s, n).astype(code_dtype) for s in sizes]
    valids = [(rng.random(n) < 0.85) if with_null else np.ones(n, bool)
              for _ in sizes]
    row_mask = rng.random(n) < 0.9
    ints, floats = _lanes(rng, n)

    def jx(a):
        return None if a is None else jnp.asarray(a)

    def tx(a):
        return None if a is None else torch.from_numpy(np.asarray(a))
    want = JA.dense_lane_partials(
        tuple(jx(c) for c in codes), tuple(jx(v) for v in valids),
        jx(row_mask), tuple(jx(v) for v, _ in ints),
        tuple(jx(m) for _, m in ints), tuple(jx(v) for v, _ in floats),
        tuple(jx(m) for _, m in floats), sizes=sizes, with_null=with_null)
    got = TA.dense_lane_partials(
        [tx(c) for c in codes], [tx(v) for v in valids], tx(row_mask),
        [tx(v) for v, _ in ints], [tx(m) for _, m in ints],
        [tx(v) for v, _ in floats], [tx(m) for _, m in floats],
        sizes=sizes, with_null=with_null)
    w_ints, w_floats, w_rows = (np.asarray(a) for a in want)
    g_ints, g_floats, g_rows = (a.numpy() for a in got)
    _, g_slots = TA.dense_slot_strides(sizes, null_slots=with_null)
    assert g_ints.dtype == np.int64 and g_floats.dtype == np.float64
    assert g_ints.shape == w_ints.shape == (len(ints), g_slots)
    assert g_floats.shape == w_floats.shape == (len(floats), g_slots)
    np.testing.assert_array_equal(g_ints, w_ints)
    np.testing.assert_array_equal(g_rows, w_rows)
    np.testing.assert_allclose(g_floats, w_floats, rtol=1e-12, atol=0)
    assert g_rows.sum() == row_mask.sum()


@pytest.mark.parametrize("n", [5000, 2048, 3])
def test_dense_float_lanes_keep_nan_and_inf_in_their_slot(n):
    """Row counts over, at and under whole blocks of the sorted rows
    (`_SUM_BLOCK`, 1024) give the reference's sums; a NaN and an inf
    poison only their own slot, and a masked-out NaN none."""
    rng = np.random.default_rng(n)
    codes = [rng.integers(0, 3, n).astype(np.int32)]
    valids = [rng.random(n) < 0.9]
    row_mask = rng.random(n) < 0.95
    x = rng.standard_normal(n) * 1e3
    y = rng.standard_normal(n)
    lane_mask = rng.random(n) < 0.8
    row_mask[:3] = True
    codes[0][:3], valids[0][:3] = (0, 1, 2), True
    x[0], x[1] = np.nan, np.inf
    y[2], lane_mask[2] = np.nan, False
    want = JA.dense_lane_partials(
        (jnp.asarray(codes[0]),), (jnp.asarray(valids[0]),),
        jnp.asarray(row_mask), (), (), (jnp.asarray(x), jnp.asarray(y)),
        (None, jnp.asarray(lane_mask)), sizes=(3,), with_null=True)[1]
    got = TA.dense_lane_partials(
        [torch.from_numpy(codes[0])], [torch.from_numpy(valids[0])],
        torch.from_numpy(row_mask), [], [],
        [torch.from_numpy(x), torch.from_numpy(y)],
        [None, torch.from_numpy(lane_mask)], sizes=(3,),
        with_null=True)[1].numpy()
    want = np.asarray(want)
    assert np.isnan(got[0, 0]) and got[0, 1] == np.inf
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("null_slots", [True, False])
def test_dense_slot_strides_match_reference(null_slots):
    for sizes in [(1,), (3, 2), (2, 3, 4), (7, 1, 5)]:
        assert (TA.dense_slot_strides(sizes, null_slots=null_slots)
                == JA.dense_slot_strides(sizes, null_slots=null_slots))


# ------------------------------------------------------- the AggOp, by SQL

N_DG = 5000
DG_SQL = ("select k, b, count(*), count(v), sum(v), avg(v), avg(f), "
          "stddev_pop(f), sum(d) from dg group by k, b order by k, b")


@pytest.fixture(scope="module")
def dg_sessions():
    """A table with a varchar key (3 values and NULL), a BOOL key (with
    NULL), NULL-bearing int/f64/decimal values and a float32 column
    whose exact sum an f32 accumulator cannot hold."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MO_PLAN_FUSION", "0")
    mp.setenv("MO_HAND_KERNELS", "1")
    rng = np.random.default_rng(5)
    js = JSession()
    js.catalog.create_table(JMeta(
        "dg", [("id", jdt.INT64), ("k", jdt.varchar(4)), ("b", jdt.BOOL),
               ("v", jdt.INT64), ("f", jdt.FLOAT64),
               ("d", jdt.decimal64(15, 2)), ("x", jdt.FLOAT32)], ["id"]))
    ids = np.arange(N_DG, dtype=np.int64)
    b = rng.integers(0, 2, N_DG).astype(bool)
    # per BOOL group: one 2^24 and many 1.0s (f32 sums drop the 1.0s)
    x = np.ones(N_DG, np.float32)
    x[np.flatnonzero(b)[0]] = x[np.flatnonzero(~b)[0]] = 16777216.0
    arrays = {"id": ids, "k": rng.integers(0, 3, N_DG).astype(np.int32),
              "b": b, "v": rng.integers(-1000, 1000, N_DG),
              "f": rng.standard_normal(N_DG),
              "d": rng.integers(-10**9, 10**9, N_DG), "x": x}
    validity = {"k": rng.random(N_DG) < 0.9, "b": rng.random(N_DG) < 0.9,
                "v": rng.random(N_DG) < 0.9, "f": rng.random(N_DG) < 0.9,
                "d": rng.random(N_DG) < 0.95}
    js.catalog.get_table("dg").insert_numpy(
        arrays, validity=validity,
        strings={"k": (arrays["k"], ["x", "y", "z"])})
    # the BOOL key of the f32 case never NULL
    js.catalog.create_table(JMeta(
        "bx", [("id", jdt.INT64), ("b", jdt.BOOL), ("x", jdt.FLOAT32)],
        ["id"]))
    js.catalog.get_table("bx").insert_numpy({"id": ids, "b": b, "x": x})
    ts = TSession(catalog=convert.tables_from_numpy(
        convert.tables_to_numpy(js.catalog)), device="cpu")
    yield js, ts, (b, x)
    mp.undo()


def _same_rows(got, want, rel=1e-9):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, e in zip(g, w):
            if isinstance(e, float) and isinstance(a, float):
                assert a == pytest.approx(e, rel=rel, abs=1e-9)
            else:
                assert a == e


def _chunks(path):
    return TM.agg_chunks.get(path=path)


def test_dense_path_equals_reference(dg_sessions):
    js, ts, _ = dg_sessions
    d0, g0 = _chunks("dense"), _chunks("general")
    got = ts.execute(DG_SQL).rows()
    assert _chunks("dense") - d0 == 1 and _chunks("general") == g0
    want = js.execute(DG_SQL).rows()
    assert len(got) == 12             # (3 + NULL) x (2 + NULL)
    _same_rows(got, want, rel=1e-12)


@pytest.mark.parametrize("env", [{"MO_DENSE_GROUPS": "0"},
                                 {"MO_DENSE_GROUPS_MAX": "11"}])
def test_dense_switches_send_the_aggregate_to_the_general_path(
        dg_sessions, monkeypatch, env):
    """MO_DENSE_GROUPS=0 turns the dense path off; a MO_DENSE_GROUPS_MAX
    below (3 + 1) x (2 + 1) = 12 slots does too.  The answers stay the
    reference's under the same setting."""
    js, ts, _ = dg_sessions
    dense = ts.execute(DG_SQL).rows()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    d0, g0 = _chunks("dense"), _chunks("general")
    got = ts.execute(DG_SQL).rows()
    assert _chunks("dense") == d0 and _chunks("general") - g0 == 1
    _same_rows(got, js.execute(DG_SQL).rows())
    _same_rows(got, dense)


def test_dense_max_groups_at_the_key_space_keeps_the_dense_path(
        dg_sessions, monkeypatch):
    js, ts, _ = dg_sessions
    monkeypatch.setenv("MO_DENSE_GROUPS_MAX", "12")
    d0 = _chunks("dense")
    ts.execute(DG_SQL).rows()
    assert _chunks("dense") - d0 == 1


def test_float32_sum_over_bool_key_is_summed_in_f64(dg_sessions):
    """The dense path sums float lanes in f64, as the reference does:
    2^24 + (k - 1) ones is exact, where an f32 accumulator stops at
    2^24."""
    js, ts, (b, x) = dg_sessions
    sql = "select b, sum(x) from bx group by b order by b"
    d0 = _chunks("dense")
    got = ts.execute(sql).rows()
    assert _chunks("dense") - d0 == 1
    exact = [float(x[b == k].astype(np.float64).sum()) for k in (False, True)]
    assert [r[1] for r in got] == exact
    assert exact[0] > 16777216.0 + 100
    assert got == js.execute(sql).rows()


# ------------------------------------ a key dictionary that grows mid-stream

AGG_SQL = "select k, count(*), sum(v), avg(f) from t group by k"


def _agg_node(binder, parse_one, catalog):
    node = binder(catalog).bind_select(parse_one(AGG_SQL))
    while type(node).__name__ != "Aggregate":
        node = node.child
    return node


class _Chunks:
    """A child operator that yields prepared ExecBatches."""

    def __init__(self, schema, batches):
        self.schema = schema
        self._batches = batches

    def execute(self):
        yield from self._batches


def _host_rows(ex, schema, to_np):
    mask = to_np(ex.mask)
    out = []
    cols = []
    for name, _ in schema:
        c = ex.batch.columns[name]
        data = np.broadcast_to(to_np(c.data), mask.shape)
        valid = np.broadcast_to(to_np(c.validity), mask.shape)
        d = ex.dicts.get(name)
        cols.append([None if not v else (d[int(x)] if d is not None
                                         else x.item())
                     for x, v in zip(data, valid)])
    for i in np.flatnonzero(mask):
        out.append(tuple(c[i] for c in cols))
    return sorted(out, key=repr)


def test_dictionary_growth_mid_stream_converts_dense_to_general():
    """Chunk 1 sees the dictionary ['p', 'q'], chunk 2 ['p', 'q', 'r']:
    the dense key space is stale at chunk 2, so the AggOp converts its
    partials to the general table and merges chunk 2 there."""
    js = JSession()
    js.catalog.create_table(JMeta(
        "t", [("id", jdt.INT64), ("k", jdt.varchar(4)), ("v", jdt.INT64),
              ("f", jdt.FLOAT64)], ["id"]))
    js.execute("insert into t values (0, 'p', 1, 0.5)")
    tcat = convert.tables_from_numpy(convert.tables_to_numpy(js.catalog))
    jnode = _agg_node(JBinder, j_parse_one, js.catalog)
    tnode = _agg_node(TBinder, t_parse_one, tcat)
    scan = jnode.child
    rng = np.random.default_rng(9)
    chunks = []
    for n, dict_ in ((700, ["p", "q"]), (900, ["p", "q", "r"])):
        arrays = {"id": np.arange(n, dtype=np.int64),
                  "k": rng.integers(0, len(dict_), n).astype(np.int32),
                  "v": rng.integers(-50, 50, n),
                  "f": rng.standard_normal(n)}
        validity = {c: rng.random(n) < 0.9 for c in arrays}
        chunks.append((arrays, validity, {"k": dict_}, n))
    jbatches = [JO.chunk_to_execbatch(a, v, d, n, scan.columns, scan.schema)
                for a, v, d, n in chunks]
    tbatches = [TO.chunk_to_execbatch(a, v, d, n, scan.columns,
                                      tnode.child.schema,
                                      torch.device("cpu"))
                for a, v, d, n in chunks]
    jop = JO.AggOp(jnode, _Chunks(scan.schema, jbatches))
    top = TO.AggOp(tnode, _Chunks(tnode.child.schema, tbatches),
                   ExecContext(catalog=tcat, device="cpu"), use_pallas=True)
    d0, g0 = _chunks("dense"), _chunks("general")
    (tex,) = list(top.execute())
    assert _chunks("dense") - d0 == 1 and _chunks("general") - g0 == 1
    (jex,) = list(jop.execute())
    got = _host_rows(tex, tnode.schema, lambda a: a.numpy())
    want = _host_rows(jex, jnode.schema, np.asarray)
    assert [r[:3] for r in got] == [r[:3] for r in want]
    np.testing.assert_allclose([r[3] for r in got], [r[3] for r in want],
                               rtol=1e-12)
    assert {r[0] for r in got} == {"p", "q", "r", None}
