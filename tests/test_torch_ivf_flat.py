"""The port's IVF-Flat index against the JAX package, on the CPU.

Search parity is held on one index: the JAX package builds it, and
`matrixone_tpu_torch.convert` carries its arrays across, bf16 included,
so both packages search the same lists with the same inputs.  Build
parity is held by recall, since k-means draws from different random
streams in the two packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrixone_tpu.vectorindex import brute_force as JB
from matrixone_tpu.vectorindex import ivf_flat as JI
from matrixone_tpu.vectorindex.recall import recall_at_k
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.vectorindex import brute_force as TB
from matrixone_tpu_torch.vectorindex import ivf_flat as TI
from matrixone_tpu_torch.vectorindex import recall as TR

FIELDS = ("centroids", "vectors", "r_norm2", "r_dot_c", "ids", "offsets")


def _clustered(seed, n, d, n_centers=64, noise=0.35):
    """bench.py's recipe (N(0,1) centres, N(0, 0.35^2) noise), numpy."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    lab = rng.integers(0, n_centers, n)
    x = centers[lab] + noise * rng.standard_normal((n, d)).astype(np.float32)
    qlab = rng.integers(0, n_centers, 64)
    q = centers[qlab] + noise * rng.standard_normal((64, d)).astype(
        np.float32)
    return x.astype(np.float32), q.astype(np.float32)


def _convert(jidx):
    fields = {f: np.asarray(getattr(jidx, f)) for f in FIELDS}
    fields.update(metric=jidx.metric, max_cluster_size=jidx.max_cluster_size,
                  n=jidx.n)
    return convert.ivf_flat_from_numpy(fields, device="cpu")


@pytest.fixture(scope="module")
def data():
    return _clustered(0, 6000, 32)


@pytest.fixture(scope="module")
def jax_indexes(data):
    x, _ = data
    kw = dict(nlist=32, n_iter=6, kmeans_sample=None, compute_dtype=None)
    return {"f32": JI.build(jnp.asarray(x), **kw),
            "bf16": JI.build(jnp.asarray(x), storage_dtype=jnp.bfloat16,
                             **kw)}


def test_convert_carries_every_field(jax_indexes):
    for jidx in jax_indexes.values():
        tidx = _convert(jidx)
        for f in FIELDS:
            j = np.asarray(getattr(jidx, f))
            t = getattr(tidx, f)
            if j.dtype.name == "bfloat16":
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    t.view(torch.int16).numpy(), j.view(np.int16))
            else:
                np.testing.assert_array_equal(t.numpy(), j)
        assert (tidx.metric, tidx.max_cluster_size, tidx.n) == \
            (jidx.metric, jidx.max_cluster_size, jidx.n)


@pytest.mark.parametrize("storage,b", [("f32", 64), ("f32", 1), ("f32", 3),
                                       ("f32", 37), ("bf16", 64),
                                       ("bf16", 37)])
def test_search_matches_reference_on_converted_index(data, jax_indexes,
                                                     storage, b):
    """Same index, same queries: distances within rtol 1e-5/atol 1e-4
    (f32 storage, f32 compute) or 1e-2 (bf16 storage and compute), and
    the per-query id sets equal on >= 99% of queries."""
    _, q = data
    q = q[:b]
    jidx = jax_indexes[storage]
    tidx = _convert(jidx)
    if storage == "f32":
        jcd, tcd, tol = jnp.float32, torch.float32, dict(rtol=1e-5,
                                                         atol=1e-4)
    else:
        jcd, tcd, tol = jnp.bfloat16, torch.bfloat16, dict(rtol=1e-2,
                                                           atol=1e-2)
    jd, ji = JI.search(jidx, jnp.asarray(q), k=10, nprobe=6,
                       query_chunk=16, compute_dtype=jcd)
    td, ti = TI.search(tidx, q, k=10, nprobe=6, query_chunk=16,
                       compute_dtype=tcd)
    assert td.shape == (b, 10) and ti.dtype == torch.int32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **tol)
    same = np.mean([set(a) == set(c) for a, c in
                    zip(ti.numpy().tolist(), np.asarray(ji).tolist())])
    assert same >= 0.99, same


def test_cosine_search_matches_reference():
    x, q = _clustered(3, 4000, 24)
    jidx = JI.build(jnp.asarray(x), nlist=16, metric="cosine", n_iter=6,
                    kmeans_sample=None, compute_dtype=None)
    tidx = _convert(jidx)
    jd, ji = JI.search(jidx, jnp.asarray(q), k=8, nprobe=8,
                       compute_dtype=jnp.float32)
    td, ti = TI.search(tidx, q, k=8, nprobe=8, compute_dtype=torch.float32)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    same = np.mean([set(a) == set(c) for a, c in
                    zip(ti.numpy().tolist(), np.asarray(ji).tolist())])
    assert same >= 0.99, same


def test_rerank_exact_bit_identical(data, jax_indexes):
    """Same candidate ids: the f64 sequential re-rank gives the JAX
    package's distances and order bit for bit."""
    x, q = data
    _, ids = JI.search(jax_indexes["f32"], jnp.asarray(q[:8]), k=10,
                       nprobe=8, compute_dtype=jnp.float32)
    ids = np.array(ids)
    jd, ji = JI.rerank_exact(jnp.asarray(x), jnp.asarray(q[:8]),
                             jnp.asarray(ids))
    td, ti = TI.rerank_exact(torch.from_numpy(x), torch.from_numpy(q[:8]),
                             torch.from_numpy(ids))
    assert td.dtype == torch.float64
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_brute_force_matches_reference(data):
    x, q = data
    jp, n = JB.pad_dataset(jnp.asarray(x), chunk_size=4096)
    js, ji = JB.search(jp, jnp.asarray(q), k=10, n_valid=n, chunk_size=4096)
    tp, tn = TB.pad_dataset(torch.from_numpy(x), chunk_size=4096)
    assert tn == n and tp.shape == tuple(jp.shape)
    ts, ti = TB.search(tp, torch.from_numpy(q), k=10, n_valid=tn,
                       chunk_size=4096)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-4)


def test_build_recall_matches_reference_at_bench_smoke_shape():
    """bench.py's smoke configuration (20k x 64, nlist 64, 6 minibatch
    Lloyd iterations, split balancing, bf16 k-means products): the
    port's build reaches the reference's recall@20 within 0.02.  Both
    are averaged over three build seeds, since the two packages draw
    different k-means samples."""
    x, q = _clustered(11, 20000, 64, n_centers=2048)
    q = np.concatenate([q, _clustered(12, 64, 64, n_centers=2048)[1]])
    jp, n = JB.pad_dataset(jnp.asarray(x), chunk_size=8192)
    _, truth = JB.search(jp, jnp.asarray(q), k=20, n_valid=n,
                         chunk_size=8192)
    truth = np.asarray(truth)
    kw = dict(nlist=64, n_iter=6, balance_weight=0.3, kmeans_sample=20000,
              kmeans_minibatch=65536, balance_mode="split")
    rj, rt = [], []
    for seed in range(3):
        jidx = JI.build(jnp.asarray(x), compute_dtype=jnp.bfloat16,
                        seed=seed, **kw)
        _, ji = JI.search(jidx, jnp.asarray(q), k=20, nprobe=8,
                          query_chunk=64, compute_dtype=jnp.float32)
        rj.append(recall_at_k(np.asarray(ji), truth))
        tidx = TI.build(x, compute_dtype=torch.bfloat16, seed=seed,
                        device="cpu", **kw)
        _, ti = TI.search(tidx, q, k=20, nprobe=8, query_chunk=64,
                          compute_dtype=torch.float32)
        rt.append(TR.recall_at_k(ti.numpy(), truth))
        offs = tidx.offsets.numpy()
        assert offs[0] == 0 and offs[-1] == len(x)
        assert np.diff(offs).max() <= tidx.max_cluster_size
        assert sorted(tidx.ids.numpy().tolist()) == list(range(len(x)))
    assert abs(np.mean(rt) - np.mean(rj)) <= 0.02, (rt, rj)


def test_search_profiled_and_metrics(data, jax_indexes):
    from matrixone_tpu_torch.utils import metrics as M
    _, q = data
    tidx = _convert(jax_indexes["f32"])
    q0 = M.vector_search_queries.get()
    p0 = M.vector_search_pad_rows.get()
    TI.search(tidx, q[:37], k=5, nprobe=4, compute_dtype=torch.float32)
    assert M.vector_search_queries.get() - q0 == 37
    assert M.vector_search_pad_rows.get() - p0 == 64 - 37
    s0 = M.vector_search_seconds.get(stage="score")
    prof = TI.search_profiled(tidx, q[:37], k=5, nprobe=4,
                              compute_dtype=torch.float32)
    _, ids = TI.search(tidx, q[:37], k=5, nprobe=4,
                       compute_dtype=torch.float32)
    np.testing.assert_array_equal(prof["ids"], ids.numpy())
    assert M.vector_search_seconds.get(stage="score") > s0
