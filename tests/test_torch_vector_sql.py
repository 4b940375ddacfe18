"""Vector search through SQL on the port against the JAX package, on the
CPU: CREATE INDEX ... USING ivfflat | ivfpq, the VectorTopK rewrite,
incremental index upkeep and the index cache.

Search parity is held on one index: the JAX session builds it, and
`convert.tables_from_numpy` / `convert.indexes_from_numpy` carry the
tables, the built index, its row gids and its delta segment into the
port's session, so both search the same lists.  Each query's rows must
have the same ids and distances within tests/test_pallas_kernels.py's
L2 tolerance (rtol 1e-5, atol 1e-4), and the VectorTopK candidates the
same ids.  Build parity (each package building its own index) is held
by recall and by the scenarios of tests/test_vector_sql.py,
tests/test_index_incremental.py (all but the task-service test) and
tests/test_txn_storage.py::test_merge_rebuilds_indexes run through
both sessions.
"""

import threading
import time

import numpy as np
import pytest
import torch

from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu_torch import convert, indexing as TIX
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.serving import serving_for
from matrixone_tpu_torch.sql.parser import parse_one as t_parse
from matrixone_tpu_torch.utils import metrics as TM
from matrixone_tpu_torch.vectorindex.cache import (IndexCache,
                                                   index_nbytes)
from matrixone_tpu_torch.vm import vector_scan as TVS
from matrixone_tpu_torch.vm.compile import compile_plan as t_compile
from torch_compare import reference_env  # noqa: F401

RTOL, ATOL = 1e-5, 1e-4

pytestmark = pytest.mark.usefixtures("reference_env")


# ------------------------------------------------------------ helpers

def _vec(v) -> str:
    return "[" + ",".join(f"{x:.4f}" for x in v) + "]"


def _knn_sql(q, table="items", col="emb", fn="l2_distance", k=10):
    return (f"select id, {fn}({col}, '{_vec(q)}') d from {table} "
            f"order by d limit {k}")


def _session(pkg, catalog=None):
    if pkg == "jax":
        return JSession() if catalog is None else JSession(catalog=catalog)
    return TSession(catalog=catalog, device="cpu")


def _carry(jsess) -> TSession:
    """The port's session over the JAX session's tables and indexes."""
    eng = convert.tables_from_numpy(convert.tables_to_numpy(jsess.catalog))
    convert.indexes_from_numpy(convert.indexes_to_numpy(jsess.catalog), eng,
                               device="cpu")
    return TSession(catalog=eng, device="cpu")


def _assert_rows_equal(got, want):
    assert len(got) == len(want), (got, want)
    assert [r[0] for r in got] == [r[0] for r in want], (got, want)
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want],
                               rtol=RTOL, atol=ATOL)


def _plan(sess, sql):
    if isinstance(sess, TSession):
        return sess.plan_select(t_parse(sql))
    from matrixone_tpu.sql.binder import Binder
    from matrixone_tpu.sql.optimize import apply_indices
    from matrixone_tpu.sql.parser import parse_one
    node = Binder(sess.catalog).bind_select(parse_one(sql))
    return apply_indices(node, sess.catalog,
                         nprobe=int(sess.variables.get("ivf_nprobe", 8)))


def _node_types(node):
    out = []

    def walk(n):
        out.append(type(n).__name__)
        for a in ("child", "left", "right"):
            c = getattr(n, a, None)
            if c is not None:
                walk(c)
    walk(node)
    return out


def _vector_topk(node):
    while type(node).__name__ != "VectorTopK":
        node = node.child
    return node


def _candidates(sess, sql):
    """The ids the VectorTopK source of `sql` yields, in its order."""
    vt = _vector_topk(_plan(sess, sql))
    if isinstance(sess, TSession):
        op = t_compile(vt, sess._ctx())
    else:
        from matrixone_tpu.vm.compile import compile_plan
        from matrixone_tpu.vm.process import ExecContext
        op = compile_plan(vt, ExecContext(catalog=sess.catalog,
                                          variables=sess.variables))
    ids = []
    for ex in op.execute():
        b = sess._to_host(ex, vt.schema)
        ids += b.columns[f"{vt.table}.id"].to_pylist()
    return ids


def _clustered_rows(n, d, seed, n_centers=8, scale=4.0, noise=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)) * scale
    data = np.stack([centers[i % n_centers] + rng.standard_normal(d) * noise
                     for i in range(n)])
    return centers, data


def _fill(sess, table, data, d, chunk=500, start=0):
    sess.execute(f"create table {table} (id bigint primary key, "
                 f"emb vecf32({d}))")
    rows = [f"({start + i}, '{_vec(v)}')" for i, v in enumerate(data)]
    for j in range(0, len(rows), chunk):
        sess.execute(f"insert into {table} values "
                     + ", ".join(rows[j:j + chunk]))


# ------------------------------------ tests/test_vector_sql.py's scenarios

@pytest.fixture(scope="module")
def vsess(reference_env):  # noqa: F811
    """tests/test_vector_sql.py's table (2000 x 16, 8 centres) and index
    (ivfflat, lists 16, l2), built by the JAX session and carried over."""
    centers, data = _clustered_rows(2000, 16, 11)
    j = JSession()
    _fill(j, "items", data, 16)
    j.execute("create index iv using ivfflat on items (emb) "
              "lists = 16 op_type = 'vector_l2_ops'")
    return j, _carry(j), centers


def test_index_rewrite_in_plan(vsess):
    j, t, centers = vsess
    sql = _knn_sql(centers[0])
    types = _node_types(_plan(t, sql))
    assert "VectorTopK" in types and "Scan" not in types
    assert types == _node_types(_plan(j, sql))
    vt, jvt = _vector_topk(_plan(t, sql)), _vector_topk(_plan(j, sql))
    assert (vt.index_name, vt.k, vt.metric, vt.nprobe) == \
        (jvt.index_name, jvt.k, jvt.metric, jvt.nprobe) == ("iv", 30, "l2", 8)
    assert t.execute("explain " + sql).text == j.execute("explain " + sql).text


def test_knn_rows_and_candidates_equal_the_reference(vsess):
    j, t, centers = vsess
    for ci in range(4):
        sql = _knn_sql(centers[ci])
        _assert_rows_equal(t.execute(sql).rows(), j.execute(sql).rows())
        assert _candidates(t, sql) == _candidates(j, sql)


def test_knn_results_match_exact(vsess):
    """The reference test's recall bar, against the port's own exact scan
    (the plan without the index rewrite)."""
    _j, t, centers = vsess
    for ci in range(4):
        sql = _knn_sql(centers[ci])
        rows = t.execute(sql).rows()
        ds = [r[1] for r in rows]
        assert len(rows) == 10 and ds == sorted(ds)
        t.variables["ivf_nprobe"] = 8
        exact = _exact_rows(t, sql)
        assert len({r[0] for r in rows} & {r[0] for r in exact}) >= 8


def _exact_rows(tsess, sql):
    from matrixone_tpu_torch.sql.binder import Binder
    node = Binder(tsess.catalog).bind_select(t_parse(sql))
    rows = []
    for ex in t_compile(node, tsess._ctx()).execute():
        b = tsess._to_host(ex, node.schema)
        rows += list(zip(b.columns["id"].to_pylist(),
                         b.columns["d"].to_pylist()))
    return rows


def test_show_indexes_equal_the_reference(vsess):
    j, t, _c = vsess
    assert t.execute("show indexes from items").rows() == \
        j.execute("show indexes from items").rows() == \
        [("iv", "ivfflat", "emb", 0)]


def test_knn_excludes_deleted(vsess):
    j, t, centers = vsess
    sql = _knn_sql(centers[1])
    victim = t.execute(sql).rows()[0][0]
    for s in (j, t):
        s.execute(f"delete from items where id = {victim}")
    rows = t.execute(sql).rows()
    assert victim not in {r[0] for r in rows} and len(rows) == 10
    _assert_rows_equal(rows, j.execute(sql).rows())
    # a delete needs no index change: no delta, same built index
    assert "_delta_gids" not in t.catalog.indexes["iv"].options
    assert t.execute("show indexes from items").rows() == \
        j.execute("show indexes from items").rows()


@pytest.mark.parametrize("algo,op_type,fn", [
    ("ivfflat", "vector_cosine_ops", "cosine_distance"),
    ("ivfpq", "vector_cosine_ops", "cosine_distance"),
    ("ivfflat", "vector_ip_ops", "inner_product"),
    ("ivfpq", "vector_l2_ops", "l2_distance")])
def test_metrics_and_algos_equal_the_reference(algo, op_type, fn):
    """tests/test_vector_sql.py::test_cosine_index's table (200 x 8,
    lists 4) under each metric and algorithm the port serves."""
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((200, 8))
    j = JSession()
    _fill(j, "docs", vals, 8)
    j.execute(f"create index cv using {algo} on docs (emb) "
              f"lists = 4 op_type = '{op_type}'")
    t = _carry(j)
    for qi in (7, 50, 123):
        sql = _knn_sql(vals[qi], "docs", fn=fn, k=3)
        assert "VectorTopK" in _node_types(_plan(t, sql))
        _assert_rows_equal(t.execute(sql).rows(), j.execute(sql).rows())
        assert _candidates(t, sql) == _candidates(j, sql)
    if fn == "cosine_distance":
        rows = t.execute(_knn_sql(vals[7], "docs", fn=fn, k=3)).rows()
        assert rows[0][0] == 7 and rows[0][1] < 1e-6


@pytest.mark.parametrize("algo", ["ivfflat", "ivfpq"])
@pytest.mark.parametrize("lit", [
    "[nan,0,0,0,0,0,0,0]", "[nan,nan,nan,nan,nan,nan,nan,nan]",
    "[1e39,0,0,0,0,0,0,0]", "[1e39,-1e39,0,0,0,0,0,1]"])
def test_knn_with_a_non_finite_query_vector(algo, lit):
    """A vector literal holding nan, or a component past f32's range
    (1e39 is inf in f32, and inf - inf is NaN in the L2 expansion),
    scores every probe and candidate NaN or inf, so the k-th score of
    each top k is NaN or inf.  The indexed statement answers, as the
    reference's does: k rows of the table, each distance the reference's
    `l2_distance` of the same row (NaN or inf).  Where the literal holds
    nan, both packages keep the same candidates: every list's lanes past
    its end (+inf) before its NaN rows, so the row at a list's first
    position repeats.  Where it holds 1e39 the candidates are not
    compared: they rank the NaNs that inf - inf makes, whose sign bit
    x86 sets and CUDA clears, and XLA ranks a NaN with its sign set
    first where the port ranks every NaN last (ROADMAP.md section C)."""
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((200, 8))
    j = JSession()
    _fill(j, "docs", vals, 8)
    j.execute(f"create index cv using {algo} on docs (emb) "
              f"lists = 4 op_type = 'vector_l2_ops'")
    t = _carry(j)
    sql = (f"select id, l2_distance(emb, '{lit}') d from docs "
           f"order by d limit 3")
    assert "VectorTopK" in _node_types(_plan(t, sql))
    rows = t.execute(sql).rows()
    ids = [r[0] for r in rows]
    assert len(rows) == 3 and set(ids) <= set(range(200))
    want = dict(j.execute(
        f"select id, l2_distance(emb, '{lit}') d from docs "
        f"where id in ({', '.join(map(str, set(ids)))})").rows())
    np.testing.assert_array_equal([r[1] for r in rows],
                                  [want[i] for i in ids])
    assert all(np.isnan(d) or d == np.inf for d in want.values())
    if "nan" in lit:
        assert _candidates(t, sql) == _candidates(j, sql)


def test_index_over_a_stored_nan_embedding():
    """A stored embedding that holds nan scores NaN against every
    centroid in each package's own kmeans at CREATE INDEX, and its
    list's centroid turns NaN; every other row must still rank that
    centroid last, so the index answers a KNN statement with the
    reference's rows, the exact nearest ones."""
    rng = np.random.default_rng(4)
    vals = rng.standard_normal((200, 8))
    vals[17, 2] = np.nan
    outs = []
    for pkg in PKGS:
        s = _session(pkg)
        _fill(s, "docs", vals, 8)
        s.execute("create index cv using ivfflat on docs (emb) "
                  "lists = 4 op_type = 'vector_l2_ops'")
        s.variables["ivf_nprobe"] = 4      # every list: an exact answer
        outs.append(s.execute(_knn_sql(vals[3], "docs", k=5)).rows())
        assert s.execute("select count(*) from docs").rows() == [(200,)]
    _assert_rows_equal(outs[1], outs[0])
    assert outs[1][0][0] == 3


def test_each_package_builds_an_index_of_equal_recall():
    """Build parity: each session builds its own IVF-Flat and IVF-PQ
    index over the same rows; recall@10 against the exact rows is at the
    reference's level."""
    centers, data = _clustered_rows(2000, 16, 5, n_centers=16, scale=1.0,
                                    noise=0.35)
    rng = np.random.default_rng(9)
    queries = centers[rng.integers(0, 16, 12)] + \
        0.35 * rng.standard_normal((12, 16))
    recalls = {}
    for pkg in ("jax", "port"):
        s = _session(pkg)
        _fill(s, "items", data, 16)
        for algo in ("ivfflat", "ivfpq"):
            s.execute(f"create index ix_{algo} using {algo} on items (emb) "
                      f"lists = 16")
            hits = 0
            for q in queries:
                got = {r[0] for r in s.execute(_knn_sql(q)).rows()}
                d = ((data - q) ** 2).sum(1)
                hits += len(got & set(np.argsort(d)[:10].tolist()))
            recalls[pkg, algo] = hits / (10 * len(queries))
            s.execute(f"drop table items")
            _fill(s, "items", data, 16)
    for algo in ("ivfflat", "ivfpq"):
        assert recalls["port", algo] >= 0.8, recalls
        assert recalls["port", algo] >= recalls["jax", algo] - 0.1, recalls


# ------------------------------------ the delta segment, carried across

@pytest.mark.parametrize("algo,op_type,fn", [
    ("ivfflat", "vector_l2_ops", "l2_distance"),
    ("ivfpq", "vector_l2_ops", "l2_distance"),
    ("ivfflat", "vector_cosine_ops", "cosine_distance"),
    ("ivfpq", "vector_cosine_ops", "cosine_distance")])
def test_delta_rows_equal_the_reference(algo, op_type, fn):
    """The JAX session takes rows into its delta segment; carried across,
    the port's search merges the same delta with the same distances.
    Then both sessions take one more row into their own deltas."""
    centers, data = _clustered_rows(600, 16, 21)
    j = JSession()
    _fill(j, "items", data, 16)
    j.execute(f"create index dv using {algo} on items (emb) lists = 8 "
              f"op_type = '{op_type}'")
    new = [centers[i % 8] + 0.01 * (i + 1) for i in range(5)]
    j.execute("insert into items values " + ", ".join(
        f"({5000 + i}, '{_vec(v)}')" for i, v in enumerate(new)))
    sql = _knn_sql(centers[2], fn=fn, k=5)
    want = j.execute(sql).rows()                  # fills the JAX delta
    jix = j.catalog.indexes["dv"]
    assert len(jix.options["_delta_gids"]) == 5
    t = _carry(j)
    tix = t.catalog.indexes["dv"]
    np.testing.assert_array_equal(tix.options["_delta_gids"],
                                  jix.options["_delta_gids"])
    assert 5002 in {r[0] for r in want}
    _assert_rows_equal(t.execute(sql).rows(), want)
    assert _candidates(t, sql) == _candidates(j, sql)
    built = tix.index_obj
    for s in (j, t):
        s.execute(f"insert into items values (6000, '{_vec(centers[2])}')")
    for q in (centers[2], centers[5]):
        sql = _knn_sql(q, fn=fn, k=5)
        _assert_rows_equal(t.execute(sql).rows(), j.execute(sql).rows())
        assert _candidates(t, sql) == _candidates(j, sql)
    assert tix.index_obj is built
    assert len(tix.options["_delta_gids"]) == 6


def test_delta_distances_are_the_search_s_own():
    """Each metric's delta distance is the quantity that algorithm's
    search returns: squared l2, 1 - cos, 1 - ip for ivfflat, squared l2
    of the normalised vectors for ivfpq under cosine.  Exact on the
    delta (f64 oracle); the search's own (bf16) distance of the same row
    lies near it."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    x64, q64 = x[:50].astype(np.float64), x[0].astype(np.float64)
    xn = x64 / np.linalg.norm(x64, axis=1, keepdims=True)
    qn = q64 / np.linalg.norm(q64)
    oracle = {("ivfflat", "l2"): ((x64 - q64) ** 2).sum(1),
              ("ivfflat", "cosine"): 1.0 - xn @ qn,
              ("ivfflat", "ip"): 1.0 - x64 @ q64,
              ("ivfpq", "cosine"): ((xn - qn) ** 2).sum(1)}
    from matrixone_tpu_torch.vectorindex import ivf_flat as TI
    for (algo, metric), want in oracle.items():
        s = TSession(device="cpu")
        _fill(s, "v", x, 16)
        op = {"l2": "vector_l2_ops", "cosine": "vector_cosine_ops",
              "ip": "vector_ip_ops"}[metric]
        s.execute(f"create index i using {algo} on v (emb) lists = 1 "
                  f"op_type = '{op}'")
        ix = s.catalog.indexes["i"]
        q = torch.from_numpy(x[:1])
        dd = TVS.delta_distances(ix, q, x[:50])
        np.testing.assert_allclose(dd, want, rtol=1e-5, atol=1e-4)
        if algo == "ivfflat":
            dist, pos = TI.search(ix.index_obj, q, k=300, nprobe=1)
            by_pos = dict(zip(pos[0].tolist(), dist[0].tolist()))
            near = np.array([by_pos[i] for i in range(50)])
            np.testing.assert_allclose(dd, near, rtol=0.01, atol=0.1)


# ------------------------- tests/test_index_incremental.py's scenarios

def _mk_session(pkg, n=3000, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, d)).astype(np.float32)
    lab = rng.integers(0, 32, n)
    data = centers[lab] + rng.normal(size=(n, d)).astype(np.float32) * 0.2
    s = _session(pkg)
    s.execute(f"create table v (id bigint primary key, e vecf32({d}))")
    rows = ",".join(
        f"({i}, '[{','.join(f'{x:.5f}' for x in data[i])}]')"
        for i in range(n))
    s.execute(f"insert into v values {rows}")
    s.execute("create index iv using ivfflat on v(e) lists = 16")
    return s, data, rng, centers


def _knn(s, q, k=5):
    qs = "[" + ",".join(f"{x:.5f}" for x in q) + "]"
    r = s.execute(f"select id from v order by l2_distance(e, '{qs}') "
                  f"limit {k}")
    return [int(x[0]) for x in r.rows()]


def _indexing(pkg):
    if pkg == "jax":
        from matrixone_tpu import indexing
        return indexing
    return TIX


PKGS = ["jax", "port"]


@pytest.mark.parametrize("pkg", PKGS)
def test_insert_does_not_full_rebuild_and_search_sees_new_rows(pkg):
    s, data, rng, centers = _mk_session(pkg)
    ix = next(iter(s.catalog.indexes.values()))
    _indexing(pkg).refresh_if_dirty(s.catalog, ix)
    built_obj = ix.index_obj
    new_vec = centers[3] + 0.01
    qs = "[" + ",".join(f"{x:.5f}" for x in new_vec) + "]"
    s.execute(f"insert into v values (999999, '{qs}')")
    assert ix.dirty
    got = _knn(s, new_vec, k=3)
    assert got[0] == 999999, got            # the new row is findable...
    assert ix.index_obj is built_obj        # ...with no rebuild (same obj)
    assert len(ix.options["_delta_gids"]) == 1
    s.execute("delete from v where id = 999999")
    assert 999999 not in _knn(s, new_vec, k=3)


@pytest.mark.parametrize("pkg", PKGS)
def test_delta_overflow_triggers_recluster(pkg):
    s, data, rng, centers = _mk_session(pkg, n=500)
    ix = next(iter(s.catalog.indexes.values()))
    _indexing(pkg).refresh_if_dirty(s.catalog, ix)
    built_obj = ix.index_obj
    rows = []
    for i in range(100):
        v = centers[i % 32] + 0.05
        rows.append(f"({10000 + i}, "
                    f"'[{','.join(f'{x:.5f}' for x in v)}]')")
    s.execute("insert into v values " + ",".join(rows))
    _indexing(pkg).refresh_if_dirty(s.catalog, ix)
    assert ix.index_obj is not built_obj
    assert "_delta_gids" not in ix.options


@pytest.mark.parametrize("pkg", PKGS)
def test_fold_delta_matches_full_rebuild_recall(pkg):
    s, data, rng, centers = _mk_session(pkg, n=2000)
    ix = next(iter(s.catalog.indexes.values()))
    _indexing(pkg).refresh_if_dirty(s.catalog, ix)
    rows = []
    for i in range(50):
        v = centers[i % 32] + rng.normal(size=centers.shape[1]) * 0.2
        rows.append(f"({20000 + i}, "
                    f"'[{','.join(f'{x:.5f}' for x in v)}]')")
    s.execute("insert into v values " + ",".join(rows))
    queries = centers[:8] + 0.03
    with_delta = [_knn(s, q, k=10) for q in queries]
    assert _indexing(pkg).fold_delta(s.catalog, ix)
    assert "_delta_gids" not in ix.options
    after = [_knn(s, q, k=10) for q in queries]
    overlap = np.mean([len(set(a) & set(b)) / 10
                       for a, b in zip(with_delta, after)])
    assert overlap >= 0.9, overlap


@pytest.mark.parametrize("pkg", PKGS)
def test_index_cache_budget_evicts_lru(pkg):
    if pkg == "jax":
        from matrixone_tpu.vectorindex.cache import IndexCache as Cache
        from matrixone_tpu.vectorindex.cache import index_nbytes as nbytes
    else:
        Cache, nbytes = IndexCache, index_nbytes
    s, data, rng, centers = _mk_session(pkg, n=400)
    ix = next(iter(s.catalog.indexes.values()))
    _indexing(pkg).refresh_if_dirty(s.catalog, ix)
    nb = nbytes(ix.index_obj)
    assert nb > 0
    cache = Cache(budget_bytes=nb + 10)
    cache.put(ix)

    class FakeMeta:
        name = "other"
        index_obj = ix.index_obj
        dirty = False
    other = FakeMeta()
    cache.put(other)                    # exceeds budget -> evict LRU (ix)
    assert ix.index_obj is None and ix.dirty
    assert other.index_obj is not None
    assert cache.stats()["evictions"] == 1
    got = _knn(s, centers[0], k=3)
    assert len(got) == 3 and ix.index_obj is not None


def test_index_nbytes_counts_every_tensor():
    s, data, rng, centers = _mk_session("port", n=400)
    idx = s.catalog.indexes["iv"].index_obj
    want = sum(t.numel() * t.element_size()
               for t in (idx.centroids, idx.vectors, idx.r_norm2,
                         idx.r_dot_c, idx.ids, idx.offsets))
    assert index_nbytes(idx) == want
    assert s.catalog.index_cache.stats()["used"] == want


@pytest.mark.parametrize("pkg", PKGS)
def test_merge_rebuilds_indexes(pkg):
    """tests/test_txn_storage.py::test_merge_rebuilds_indexes."""
    s = _session(pkg)
    s.execute("create table it (id bigint, e vecf32(8))")
    rng = np.random.default_rng(0)
    for i in range(40):
        v = rng.standard_normal(8)
        s.execute(f"insert into it values ({i}, "
                  f"'[{','.join(f'{x:.3f}' for x in v)}]')")
    s.execute("create index ix using ivfflat on it (e) lists = 4")
    assert s.catalog.merge_table("it") == 40
    assert s.catalog.indexes["ix"].dirty
    q = s.execute("select id from it order by "
                  "l2_distance(e, '[0,0,0,0,0,0,0,0]') limit 3").rows()
    assert len(q) == 3
    assert not s.catalog.indexes["ix"].dirty


# ------------------------------------------------ the port's own surface

def test_cached_full_scan_plan_is_planned_again_after_create_index():
    """CREATE INDEX bumps ddl_gen, so what the plan cache holds from
    before the index existed is planned again: the KNN statement's entry
    (a full-scan plan, which the cache keeps as an uncacheable entry, as
    the reference's does: its vector literal is no parameter) and a
    cached plan of another statement on the table."""
    centers, data = _clustered_rows(400, 8, 2)
    t = TSession(device="cpu")
    _fill(t, "items", data, 8)
    sql = _knn_sql(centers[0], k=5)
    other = "select id from items where id > 3 order by id limit 2"
    before = [t.execute(sql).rows() for _ in range(3)]
    for _ in range(3):
        t.execute(other)
    pc = serving_for(t.catalog).plan_cache
    assert sorted(e.cacheable for e in pc._entries.values()) == [False, True]
    hits = TM.plan_cache_ops.get(outcome="hit")
    t.execute(other)
    assert TM.plan_cache_ops.get(outcome="hit") == hits + 1
    inval = TM.plan_cache_ops.get(outcome="invalidated")
    t.execute("create index iv using ivfflat on items (emb) lists = 4")
    runs = []
    orig = TVS.VectorTopKOp.execute

    def counted(self):
        runs.append(self.node.index_name)
        return orig(self)
    TVS.VectorTopKOp.execute = counted
    try:
        after = t.execute(sql).rows()
        t.execute(other)
    finally:
        TVS.VectorTopKOp.execute = orig
    assert runs == ["iv"]
    assert TM.plan_cache_ops.get(outcome="invalidated") == inval + 2
    assert [r[0] for r in after] == [r[0] for r in before[0]]
    assert all(e.ddl_gen == t.catalog.ddl_gen for e in pc._entries.values())


def test_vector_topk_plans_are_never_cached():
    centers, data = _clustered_rows(400, 8, 2)
    t = TSession(device="cpu")
    _fill(t, "items", data, 8)
    t.execute("create index iv using ivfflat on items (emb) lists = 4")
    hits = TM.plan_cache_ops.get(outcome="hit")
    for q in (centers[0], centers[0], centers[1], centers[0]):
        t.execute(_knn_sql(q, k=5))
    assert TM.plan_cache_ops.get(outcome="hit") == hits
    pc = serving_for(t.catalog).plan_cache
    assert not any(e.cacheable for e in pc._entries.values()
                   if e.plan is None or "VectorTopK" in _node_types(e.plan))
    assert any(not e.cacheable for e in pc._entries.values())


def test_index_over_an_empty_table():
    outs = {}
    for pkg in PKGS:
        s = _session(pkg)
        s.execute("create table e (id bigint primary key, emb vecf32(4))")
        s.execute("create index ie using ivfflat on e (emb) lists = 4")
        assert s.catalog.indexes["ie"].index_obj is None
        sql = "select id, l2_distance(emb, '[0,0,0,0]') d from e " \
              "order by d limit 3"
        first = s.execute(sql).rows()
        s.execute("insert into e values (1, '[1,0,0,0]'), (2, '[0,2,0,0]'),"
                  " (3, '[0,0,3,0]'), (4, '[0,0,0,4]')")
        outs[pkg] = (first, s.execute(sql).rows(),
                     s.catalog.indexes["ie"].index_obj is not None)
    assert outs["port"] == outs["jax"] == (
        [], [(1, 1.0), (2, 2.0), (3, 3.0)], True)


@pytest.mark.parametrize("pkg", PKGS)
def test_insert_racing_a_refresh_waits_for_the_commit_lock(pkg, monkeypatch):
    """A refresh holds the commit lock from its table read to its
    trailing dirty=False: an INSERT issued in between commits only after
    it, and re-marks the index dirty, so the next query finds the row."""
    s, data, rng, centers = _mk_session(pkg, n=600)
    ix = next(iter(s.catalog.indexes.values()))
    mod = _indexing(pkg)
    orig = mod._try_incremental
    new_vec = centers[5] + 0.01
    qs = "[" + ",".join(f"{x:.5f}" for x in new_vec) + "]"
    writer_done = threading.Event()
    seen = {}

    def writer():
        _session(pkg, s.catalog).execute(
            f"insert into v values (777777, '{qs}')")
        writer_done.set()

    def slow_incremental(engine, meta):
        th = threading.Thread(target=writer)
        th.start()
        time.sleep(0.3)
        seen["writer_done_during_refresh"] = writer_done.is_set()
        seen["thread"] = th
        return orig(engine, meta)

    s.execute(f"insert into v values (777776, '{qs}')")
    monkeypatch.setattr(mod, "_try_incremental", slow_incremental)
    mod.refresh_if_dirty(s.catalog, ix)
    monkeypatch.setattr(mod, "_try_incremental", orig)
    seen["thread"].join(10)
    assert seen["writer_done_during_refresh"] is False
    assert writer_done.is_set() and ix.dirty
    assert set(_knn(s, new_vec, k=3)[:2]) == {777776, 777777}


@pytest.mark.parametrize("algo", ["hnsw", "fulltext"])
def test_index_kinds_not_ported_raise(algo):
    """HNSW and FULLTEXT indexes, once refused as not ported, now create
    on an empty table as the reference's do, and are listed."""
    col = "txt" if algo == "fulltext" else "e"
    for pkg in PKGS:
        s = _session(pkg)
        s.execute("create table h (id bigint, e vecf32(4), txt varchar(20))")
        s.execute(f"create index hx using {algo} on h ({col})")
        assert s.catalog.indexes["hx"].algo == algo, pkg
        assert s.execute("show indexes from h").rows()[0][:3] == \
            ("hx", algo, col), pkg


@pytest.mark.parametrize("sql", [
    "create index x on d (emb)",
    "create index x using ivfflat on d (id)",
    "create index x using ivfpq on d (emb) op_type = 'vector_ip_ops'",
    "create index x using ivfpq on d (emb) subspaces = 3",
    "create index x using ivf_pq on d (emb) lists = 2",
    "create index x using ivf_flat on d (emb) lists = 2 "
    "op_type = 'vector_ip_ops'"])
def test_create_index_outcomes_equal_the_reference(sql):
    outs = []
    for pkg in PKGS:
        s = _session(pkg)
        s.execute("create table d (id bigint, emb vecf32(8))")
        s.execute("insert into d values " + ", ".join(
            f"({i}, '[{','.join(str((i * 7 + k) % 5) for k in range(8))}]')"
            for i in range(20)))
        try:
            s.execute(sql)
            outs.append(("ok", s.execute("show indexes from d").rows()))
        except Exception as e:   # noqa: BLE001 — the class is compared
            outs.append(("err", type(e).__name__))
    assert outs[0] == outs[1], outs


def test_sharded_vector_topk_answers_the_single_rows(monkeypatch):
    """`SET ivf_shards = 2` under 8 slots answers the rows of
    `ivf_shards = 0`; the mesh's slot count bounds the shards (one CPU is
    one slot), not torch.cuda.device_count()."""
    from matrixone_tpu_torch.parallel import simulated_slots

    class _Idx:
        device = torch.device("cpu")
        nlist = 64
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert TVS.ivf_shards({"ivf_shards": 4}, _Idx()) == 1
    with simulated_slots(8):
        assert TVS.ivf_shards({"ivf_shards": 4}, _Idx()) == 4
        assert TVS.ivf_shards({"ivf_shards": 9}, _Idx()) == 8
        assert TVS.ivf_shards({"ivf_shards": 1}, _Idx()) == 1
        assert TVS.ivf_shards({}, _Idx()) == 0
    t = TSession(device="cpu")
    t.execute("create table s (id bigint, emb vecf32(4))")
    rng = np.random.default_rng(9)
    t.execute("insert into s values " + ", ".join(
        f"({i}, '[{','.join(f'{x:.4f}' for x in rng.normal(size=4))}]')"
        for i in range(60)))
    t.execute("create index si using ivfflat on s (emb) lists = 4")
    sql = ("select id, l2_distance(emb, '[0.1,0.2,0,0.3]') d from s "
           "order by d limit 5")
    want = t.execute(sql).rows()
    assert "_sharded" not in t.catalog.indexes["si"].options
    t.execute("set ivf_shards = 2")
    with simulated_slots(8):
        assert t.execute(sql).rows() == want
    assert t.catalog.indexes["si"].options["_sharded"][1] == 2


def test_drop_table_drops_its_indexes_and_cache_entries():
    t = TSession(device="cpu")
    t.execute("create table s (id bigint, emb vecf32(4))")
    t.execute("insert into s values (1, '[1,0,0,0]'), (2, '[0,1,0,0]')")
    t.execute("create index si using ivfflat on s (emb) lists = 2")
    assert t.catalog.index_cache.stats()["entries"] == 1
    gen = t.catalog.ddl_gen
    t.execute("drop table s")
    assert t.catalog.indexes == {}
    assert t.catalog.index_cache.stats() == {
        "used": 0, "budget": 8 << 30, "entries": 0, "evictions": 0}
    assert t.catalog.ddl_gen > gen


def test_in_transaction_reads_take_the_exact_scan():
    centers, data = _clustered_rows(200, 8, 3)
    t = TSession(device="cpu")
    _fill(t, "items", data, 8)
    t.execute("create index iv using ivfflat on items (emb) lists = 4")
    sql = _knn_sql(centers[0], k=3)
    t.execute("begin")
    t.execute(f"insert into items values (9999, '{_vec(centers[0])}')")
    assert "VectorTopK" not in _node_types(_plan(t, sql))
    assert t.execute(sql).rows()[0] == (9999, 0.0)
    t.execute("rollback")
    assert "VectorTopK" in _node_types(_plan(t, sql))


def test_wal_replay_and_commits_mark_indexes_dirty():
    """A commit, and a commit applied from the WAL (the restart replay,
    as the reference's replica applies it), mark the table's indexes
    dirty; a commit to another table does not."""
    from matrixone_tpu_torch.storage.engine import WalApplier
    t = TSession(device="cpu")
    for name in ("s", "other"):
        t.execute(f"create table {name} (id bigint, emb vecf32(4))")
    t.execute("insert into s values (1, '[1,0,0,0]'), (2, '[0,1,0,0]')")
    t.execute("create index si using ivfflat on s (emb) lists = 2")
    ix = t.catalog.indexes["si"]
    assert not ix.dirty
    t.execute("insert into other values (1, '[1,0,0,0]')")
    assert not ix.dirty
    src = TSession(device="cpu")
    src.execute("create table s (id bigint, emb vecf32(4))")
    src.execute("insert into s values (3, '[0,0,1,0]')")
    ap = WalApplier(t.catalog)
    for header, blob in src.catalog.wal.replay():
        if header["op"] in ("insert", "delete", "commit"):
            ap.apply(header, blob)
    assert ix.dirty
    # the frontier moves past the replayed commit, as Engine.open moves it
    t.catalog.hlc.update(ap.max_ts)
    t.catalog.committed_ts = max(t.catalog.committed_ts, ap.max_ts)
    rows = t.execute("select id, l2_distance(emb, '[0,0,1,0]') d from s "
                     "order by d limit 1").rows()
    assert rows == [(3, 0.0)] and not ix.dirty
    t.execute("delete from s where id = 3")
    assert ix.dirty
