"""HNSW on the port against the JAX package, on the CPU.

`matrixone_tpu_torch.vectorindex.hnsw` is the reference's host graph:
its numpy route (`build_py`, and `search`'s walk) must give the
reference's ids and distances on the data of
tests/test_vectorindex.py's HNSW tests, and its native route (the port's
own copy of `mo_hnsw_*` in `native/mo_native.cpp`, the same code under
the same g++ flags) the reference's native ids and distances bit for
bit, l2 and cosine.  The reference's recall bars hold on the port.
Through SQL, tests/test_vector_sql.py::test_hnsw_sql_index runs on both
sessions, and an HNSW index carried across with `convert` answers as
before.
"""

import numpy as np
import pytest

from matrixone_tpu.vectorindex import brute_force as jbrute
from matrixone_tpu.vectorindex import hnsw as JH
from matrixone_tpu_torch import convert, native as tnative
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.vectorindex import hnsw as TH
from matrixone_tpu_torch.vectorindex.cache import index_nbytes
from matrixone_tpu_torch.vectorindex.recall import recall_at_k
from torch_compare import (assert_same, reference_compiled,  # noqa: F401
                           reference_env)


def _clustered_data(rng, n, d, n_clusters=50):
    """tests/test_vectorindex.py's `_clustered_data`."""
    centers = rng.standard_normal((n_clusters, d)) * 5
    labels = rng.integers(0, n_clusters, n)
    return (centers[labels] + rng.standard_normal((n, d))).astype(np.float32)


def _oracle_data():
    """test_hnsw_native_walker_matches_python_oracle's data."""
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(16, 24)).astype(np.float32)
    lab = rng.integers(0, 16, 1400)
    data = centers[lab] + \
        rng.normal(size=(1400, 24)).astype(np.float32) * 0.15
    q = centers[rng.integers(0, 16, 64)] + \
        rng.normal(size=(64, 24)).astype(np.float32) * 0.15
    return data, q


def _recall_data():
    """test_hnsw_recall's data."""
    rng = np.random.default_rng(77)
    x = _clustered_data(rng, n=3000, d=24)
    q = (x[rng.integers(0, len(x), 16)]
         + 0.01 * rng.standard_normal((16, 24))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def oracle_graphs():
    """The numpy route's graph of both packages on the oracle data (the
    slow build, once)."""
    data, q = _oracle_data()
    return (data, q, JH.build_py(data, M=12, ef_construction=64),
            TH.build_py(data, M=12, ef_construction=64))


def _assert_same_graph(got, want):
    np.testing.assert_array_equal(got.vectors, want.vectors)
    assert len(got.neighbors) == len(want.neighbors)
    for g, w in zip(got.neighbors, want.neighbors):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.node_level, want.node_level)
    assert got.entry == want.entry


def test_build_py_and_search_equal_reference(oracle_graphs):
    data, q, want, got = oracle_graphs
    _assert_same_graph(got, want)
    for k, ef in ((10, 96), (1, 16), (40, 64)):
        d_w, i_w = JH.search(want, q, k=k, ef=ef)
        d_g, i_g = TH.search(got, q, k=k, ef=ef)
        np.testing.assert_array_equal(i_g, i_w)
        np.testing.assert_array_equal(d_g, d_w)


def test_build_py_cosine_equals_reference():
    rng = np.random.default_rng(78)
    x = rng.standard_normal((400, 16)).astype(np.float32)
    q = x[:4] * 2.5
    want = JH.build_py(x, M=12, metric="cosine")
    got = TH.build_py(x, M=12, metric="cosine")
    _assert_same_graph(got, want)
    d_w, i_w = JH.search(want, q, k=3, ef=48)
    d_g, i_g = TH.search(got, q, k=3, ef=48)
    np.testing.assert_array_equal(i_g, i_w)
    np.testing.assert_array_equal(d_g, d_w)
    np.testing.assert_array_equal(i_g[:, 0], np.arange(4))


def test_empty_build_searches_nothing():
    got = TH.build_py(np.zeros((0, 8), np.float32))
    d, i = TH.search(got, np.ones((2, 8), np.float32), k=3)
    assert d.shape == i.shape == (2, 0)
    with pytest.raises(ValueError):
        TH.build(np.ones((4, 8), np.float32), metric="ip")


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("seed", [0, 3])
def test_native_route_bit_identical_to_reference(reference_compiled, metric,
                                                 seed):
    x, q = _recall_data()
    if metric == "cosine":
        x = np.random.default_rng(78).standard_normal(
            (1500, 16)).astype(np.float32)
        q = x[:16] * 2.5
    want = JH.build(x, M=12, ef_construction=48, metric=metric, seed=seed)
    got = TH.build(x, M=12, ef_construction=48, metric=metric, seed=seed)
    assert isinstance(want, JH.NativeHnswIndex)
    assert isinstance(got, TH.NativeHnswIndex), "the port's library loads"
    assert tnative.route() == "c" and tnative.get_lib().mo_has_hnsw
    for k, ef in ((10, 64), (3, 48), (50, 100)):
        d_w, i_w = JH.search(want, q, k=k, ef=ef)
        d_g, i_g = TH.search(got, q, k=k, ef=ef)
        np.testing.assert_array_equal(i_g, i_w)
        assert d_g.tobytes() == d_w.tobytes()
    assert index_nbytes(got) == 0          # host memory, no device bytes


def test_recall_bars_of_the_reference_hold_on_the_port(oracle_graphs):
    # test_hnsw_recall: >= 0.9 against the exact top 10, self-hit first
    import jax.numpy as jnp
    x, q = _recall_data()
    index = TH.build(x, M=12, ef_construction=48)
    assert isinstance(index, TH.NativeHnswIndex)
    d, ids = TH.search(index, q, k=10, ef=64)
    padded, n = jbrute.pad_dataset(jnp.asarray(x), chunk_size=1024)
    _, truth = jbrute.search(padded, jnp.asarray(q), k=10, n_valid=n,
                             chunk_size=1024)
    assert recall_at_k(ids, np.asarray(truth)) >= 0.9
    assert (np.diff(d, axis=1) >= -1e-5).all()
    np.testing.assert_array_equal(ids[:, 0], np.asarray(truth)[:, 0])
    # test_hnsw_native_walker_matches_python_oracle: the native route
    # >= 0.9 and within 0.05 of the numpy route
    data, q2, _want, py = oracle_graphs
    nat = TH.build(data, M=12, ef_construction=64)
    d2 = ((data[None, :, :] - q2[:, None, :]) ** 2).sum(-1)
    truth2 = np.argsort(d2, axis=1)[:, :10]
    r_nat = recall_at_k(TH.search(nat, q2, k=10, ef=96)[1], truth2)
    r_py = recall_at_k(TH.search(py, q2, k=10, ef=96)[1], truth2)
    assert r_nat >= 0.9, r_nat
    assert r_nat >= r_py - 0.05, (r_nat, r_py)


# ------------------------------------------------------------- SQL

def _vec(v) -> str:
    return "[" + ",".join(f"{x:.4f}" for x in v) + "]"


def _hnsw_sql_script():
    """test_vector_sql.py::test_hnsw_sql_index as a script."""
    rng = np.random.default_rng(8)
    vals = rng.standard_normal((500, 16)).astype(np.float32)
    rows = ",".join(f"({i}, '{_vec(vals[i])}')" for i in range(500))
    q = _vec(vals[42])
    knn = f"select id, l2_distance(e, '{q}') d from hx order by d limit 3"
    return [
        "create table hx (id bigint, e vecf32(16))",
        "insert into hx values " + rows,
        "create index hn using hnsw on hx (e) m = 12 ef_construction = 48",
        knn,
        "show indexes from hx",
        "delete from hx where id = 42",
        knn,
        f"insert into hx values (900, '{q}')",
        knn,
        "!create index hip using hnsw on hx (e) op_type = 'vector_ip_ops'",
    ], knn


@pytest.mark.usefixtures("reference_env")
def test_hnsw_sql_index_equals_reference():
    steps, knn = _hnsw_sql_script()
    got, port = assert_same(steps, rtol=1e-5, atol=1e-4)
    assert got[3][2][0][0] == 42
    assert 42 not in [r[0] for r in got[6][2]]
    assert got[8][2][0][0] == 900
    txt = port.execute("explain " + knn).text
    assert "VectorTopK" in txt and "hn" in txt


@pytest.mark.parametrize("route", ["c", "numpy"])
def test_index_carried_across_searches_alike(route, monkeypatch):
    if route == "numpy":
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    steps, knn = _hnsw_sql_script()
    s = TSession(device="cpu")
    for sql in steps[:3]:
        s.execute(sql)
    ix = s.catalog.indexes["hn"]
    assert isinstance(ix.index_obj, TH.NativeHnswIndex) == (route == "c")
    rng = np.random.default_rng(9)
    qs = rng.standard_normal((12, 16)).astype(np.float32)
    want = TH.search(ix.index_obj, qs, k=10, ef=64)
    carried = convert.indexes_to_numpy(s.catalog)
    assert carried["hn"]["index"]["route"] == ("native" if route == "c"
                                               else "numpy")
    eng = convert.tables_from_numpy(convert.tables_to_numpy(s.catalog))
    convert.indexes_from_numpy(carried, eng, device="cpu")
    got = TH.search(eng.indexes["hn"].index_obj, qs, k=10, ef=64)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    t = TSession(catalog=eng, device="cpu")
    assert t.execute(knn).rows() == s.execute(knn).rows()
