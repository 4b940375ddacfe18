"""The port's cluster-sharded IVF serving (`vectorindex/sharded.py`)
against the JAX package's, on the CPU.

The JAX package shards over the 8 virtual CPU devices of its conftest,
the port over 8 slots on the one CPU (`simulated_slots(8)`).  One index
is built by the JAX package and carried across (`convert`), so both
search the same lists.  The counterparts of tests/test_sharded_ivf.py:
after the exact re-rank a sharded search serves the single index's ids
and distances at 2 and 8 shards; every row on one shard, the imbalance
bounded; odd batches and the probe-capacity fast mode; `SET ivf_shards`
through SQL.  Then the sharded index carried across in both directions:
the reference's packing searched by the port returns the reference's
ids, and the port's packing of the same index is the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrixone_tpu.parallel.mesh import make_mesh as jmake_mesh
from matrixone_tpu.vectorindex import ivf_flat as JI
from matrixone_tpu.vectorindex import sharded as JS
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.parallel import mesh as MS
from matrixone_tpu_torch.utils import metrics as M
from matrixone_tpu_torch.vectorindex import ivf_flat as TI
from matrixone_tpu_torch.vectorindex import sharded as TS


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
def ivf_setup():
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((48, 24)) * 4
    x = (centers[rng.integers(0, 48, 6000)]
         + rng.standard_normal((6000, 24)) * 0.4).astype(np.float32)
    q = (x[rng.integers(0, len(x), 17)]
         + 0.01 * rng.standard_normal((17, 24))).astype(np.float32)
    jidx = JI.build(jnp.asarray(x), nlist=24, n_iter=6, kmeans_sample=None,
                    compute_dtype=None, storage_dtype=jnp.bfloat16)
    fields = {f: np.asarray(getattr(jidx, f))
              for f in convert.IVF_FLAT_FIELDS}
    fields.update(metric=jidx.metric,
                  max_cluster_size=jidx.max_cluster_size, n=jidx.n)
    with MS.simulated_slots(8):
        yield x, q, jidx, convert.ivf_flat_from_numpy(fields, device="cpu")


def _mesh(n):
    return MS.make_mesh(n, device="cpu")


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_bit_identical_post_rerank(ivf_setup, n_shards):
    x, q, _jidx, idx = ivf_setup
    sidx = TS.shard_ivf(idx, _mesh(n_shards))
    _d1, i1 = TI.search(idx, q, k=10, nprobe=8)
    _d2, i2 = TS.search_sharded(sidx, q, k=10, nprobe=8)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    rd1, ri1 = TI.rerank_exact(xt, qt, i1)
    rd2, ri2 = TI.rerank_exact(xt, qt, i2)
    np.testing.assert_array_equal(ri1.numpy(), ri2.numpy())
    np.testing.assert_array_equal(rd1.numpy(), rd2.numpy())


def test_sharded_rows_partitioned_and_balanced(ivf_setup):
    x, _q, _jidx, idx = ivf_setup
    sidx = TS.shard_ivf(idx, _mesh(4))
    seen = []
    for s in range(4):
        seen.extend(sidx.ids[s][:int(sidx.local_offsets[s][-1])].tolist())
    assert sorted(seen) == list(range(len(x)))
    assert 1.0 <= M.vector_shard_imbalance.get() <= 1.5


def test_sharded_odd_batch_and_capacity(ivf_setup):
    _x, q, _jidx, idx = ivf_setup
    sidx = TS.shard_ivf(idx, _mesh(8))
    _d, i = TS.search_sharded(sidx, q[:5], k=7, nprobe=8)
    assert i.shape == (5, 7)
    _de, i_exact = TS.search_sharded(sidx, q, k=10, nprobe=8)
    _df, i_fast = TS.search_sharded(sidx, q, k=10, nprobe=8,
                                    probe_capacity=2)
    overlap = np.mean([len(set(i_exact[r].tolist())
                           & set(i_fast[r].tolist())) / 10
                       for r in range(len(q))])
    assert overlap >= 0.9, overlap


def test_reference_packing_searched_by_the_port(ivf_setup):
    """The reference's sharded index, carried across, serves the
    reference's ids (f32 compute on both sides) and distances."""
    x, q, jidx, _idx = ivf_setup
    jsidx = JS.shard_ivf(jidx, jmake_mesh(8))
    fields = {f: np.asarray(getattr(jsidx, f))
              for f in ("centroids",) + convert.SHARDED_IVF_FIELDS}
    fields.update(metric=jsidx.metric, n=jsidx.n,
                  max_cluster_size=jsidx.max_cluster_size)
    tsidx = convert.sharded_ivf_from_numpy(fields, _mesh(8))
    jd, ji = JS.search_sharded(jsidx, jnp.asarray(q), k=10, nprobe=8,
                               compute_dtype=jnp.float32)
    td, ti = TS.search_sharded(tsidx, q, k=10, nprobe=8,
                               compute_dtype=torch.float32)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # a distance is a sum of f32 terms as large as ||c||^2 + ||q||^2
    # (the probe's expanded L2): the L2 tolerance (rtol 1e-5) of that
    # scale
    c = fields["centroids"].astype(np.float64)
    scale = (c * c).sum(1).max() + (q.astype(np.float64) ** 2).sum(1).max()
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5 * scale)


def test_port_packing_is_the_reference_packing(ivf_setup):
    _x, _q, jidx, idx = ivf_setup
    got = convert.sharded_ivf_to_numpy(TS.shard_ivf(idx, _mesh(8)))
    want = JS.shard_ivf(jidx, jmake_mesh(8))
    for f in ("centroids",) + convert.SHARDED_IVF_FIELDS:
        w = np.asarray(getattr(want, f))
        if w.dtype.name == "bfloat16":
            w = w.astype(np.float32)
        np.testing.assert_array_equal(got[f], w, err_msg=f)
    assert (got["metric"], got["n"], got["max_cluster_size"]) == \
        (want.metric, want.n, want.max_cluster_size)


def test_sql_routes_onto_mesh_with_ivf_shards():
    from matrixone_tpu_torch.frontend import Session
    s = Session(device="cpu")
    s.execute("create table docs (id bigint primary key, emb vecf32(16))")
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((8, 16)) * 4
    rows = []
    for i in range(1500):
        v = centers[i % 8] + rng.standard_normal(16) * 0.3
        rows.append(f"({i}, '[{','.join(f'{x:.4f}' for x in v)}]')")
    for j in range(0, 1500, 500):
        s.execute("insert into docs values " + ", ".join(rows[j:j + 500]))
    s.execute("create index dv using ivfflat on docs (emb) "
              "lists = 16 op_type = 'vector_l2_ops'")
    qv = "[" + ",".join(f"{x:.4f}" for x in centers[2]) + "]"
    sql = (f"select id from docs order by l2_distance(emb, '{qv}') "
           f"limit 5")
    single = [r[0] for r in s.execute(sql).rows()]
    s.execute("set ivf_shards = 4")
    ix = s.catalog.indexes["dv"]
    with MS.simulated_slots(8):
        assert [r[0] for r in s.execute(sql).rows()] == single
    # the repack is cached on the IndexMeta, keyed by index_obj
    assert ix.options["_sharded"][0] is ix.index_obj
    assert ix.options["_sharded"][1] == 4
    s.execute("set ivf_shards = 0")
    assert [r[0] for r in s.execute(sql).rows()] == single
