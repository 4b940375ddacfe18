"""The port's IVF-PQ index against the JAX package, on the CPU.

Search parity is held on one index: the JAX package builds it, and
`matrixone_tpu_torch.convert` carries its arrays across field by field,
so both packages search the same lists and codes with the same queries.
The JAX search runs both of its ADC paths: the XLA `take_along_axis`
gather (`use_pallas=False`) and the Pallas one-hot kernel in interpret
mode (`use_pallas=True`).  The port sums the M table entries in its own
order, so scores are held to rtol 1e-5 / atol 1e-4 in f32 compute and
1e-2 in bf16 compute, and per-query id sets to >= 99% equal.  Build
parity is held by recall, since k-means draws from different random
streams in the two packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrixone_tpu.indexing import _pick_subspaces
from matrixone_tpu.vectorindex import brute_force as JB
from matrixone_tpu.vectorindex import ivf_pq as JP
from matrixone_tpu.vectorindex.recall import recall_at_k
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.ops import cuda_kernels as CK
from matrixone_tpu_torch.vectorindex import ivf_flat as TI
from matrixone_tpu_torch.vectorindex import ivf_pq as TP


def _clustered(seed, n, d, n_clusters=50, nq=64):
    """The JAX package's IVF-PQ test recipe (test_vectorindex.py:
    N(0, 5^2) centres, unit noise), numpy; queries near data rows."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)) * 5
    x = (centers[rng.integers(0, n_clusters, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    q = (x[rng.integers(0, n, nq)]
         + 0.01 * rng.standard_normal((nq, d))).astype(np.float32)
    return x, q


def _convert(jidx):
    fields = {f: np.asarray(getattr(jidx, f)) for f in convert.IVF_PQ_FIELDS}
    fields.update(metric=jidx.metric, max_cluster_size=jidx.max_cluster_size,
                  n=jidx.n)
    return convert.ivf_pq_from_numpy(fields, device="cpu")


def _same_sets(a, b):
    return np.mean([set(r) == set(s) for r, s in
                    zip(np.asarray(a).tolist(), np.asarray(b).tolist())])


@pytest.fixture(scope="module")
def indexes():
    """One JAX index per metric, built at 6000 x 32 (nlist 32, M 8)."""
    out = {}
    for metric, seed in (("l2", 0), ("cosine", 1)):
        x, q = _clustered(seed, 6000, 32)
        jidx = JP.build(jnp.asarray(x), nlist=32, n_subspaces=8,
                        metric=metric, n_iter=6, pq_iter=6,
                        kmeans_sample=None, compute_dtype=None)
        out[metric] = (jidx, q)
    return out


def test_pick_subspaces_matches_reference():
    assert [TP.pick_subspaces(d) for d in range(1, 2049)] == \
        [_pick_subspaces(d) for d in range(1, 2049)]
    assert TP.pick_subspaces(768) == 96


def test_convert_carries_every_field(indexes):
    for jidx, _ in indexes.values():
        tidx = _convert(jidx)
        for f in convert.IVF_PQ_FIELDS:
            j = np.asarray(getattr(jidx, f))
            t = getattr(tidx, f)
            assert t.numpy().dtype == j.dtype, f
            np.testing.assert_array_equal(t.numpy(), j)
        assert tidx.codes.dtype == torch.uint8
        assert (tidx.metric, tidx.max_cluster_size, tidx.n) == \
            (jidx.metric, jidx.max_cluster_size, jidx.n)
        assert (tidx.nlist, tidx.dim, tidx.n_subspaces) == \
            (jidx.nlist, jidx.dim, jidx.n_subspaces)


@pytest.mark.parametrize("metric,b,compute,use_pallas", [
    ("l2", 64, "f32", False), ("l2", 64, "f32", True),
    ("l2", 1, "f32", False), ("l2", 3, "bf16", False),
    ("l2", 37, "bf16", True), ("l2", 64, "bf16", False),
    ("cosine", 64, "f32", False), ("cosine", 37, "f32", True),
    ("cosine", 3, "bf16", False), ("cosine", 1, "bf16", True)])
def test_search_matches_reference_on_converted_index(indexes, metric, b,
                                                     compute, use_pallas):
    """Same index, same queries, each of the JAX package's ADC paths:
    distances within rtol 1e-5/atol 1e-4 (f32 compute) or 1e-2 (bf16),
    per-query id sets equal on >= 99% of queries, ids int32."""
    jidx, q = indexes[metric]
    q = q[:b]
    tidx = _convert(jidx)
    if compute == "f32":
        jcd, tcd, tol = None, None, dict(rtol=1e-5, atol=1e-4)
    else:
        jcd, tcd, tol = jnp.bfloat16, torch.bfloat16, dict(rtol=1e-2,
                                                           atol=1e-2)
    jd, ji = JP.search(jidx, jnp.asarray(q), k=10, nprobe=6,
                       query_chunk=16, compute_dtype=jcd,
                       use_pallas=use_pallas)
    td, ti = TP.search(tidx, q, k=10, nprobe=6, query_chunk=16,
                       compute_dtype=tcd)
    assert td.shape == (b, 10) and ti.dtype == torch.int32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **tol)
    assert _same_sets(ti.numpy(), ji) >= 0.99


class _Unindexable(torch.Tensor):
    """Codes that fail the test if anything indexes or gathers them."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in {
                "__getitem__", "index_select", "take", "take_along_dim",
                "gather"}:
            raise AssertionError(f"the search gathered codes ({func})")
        return super().__torch_function__(func, types, args, kwargs or {})


def test_search_routes_adc_through_the_seam(indexes, monkeypatch):
    """The search scores its candidates through `ops/kernels.
    adc_score_lists` (the ADC kernel's list form on the card), once per
    query chunk, on the index's own [n, M] uint8 codes with each probed
    list's CSR bounds, and never gathers codes into a padded tensor."""
    from matrixone_tpu_torch.ops import kernels as TK
    jidx, q = indexes["l2"]
    tidx = _convert(jidx)
    tidx.codes = tidx.codes.as_subclass(_Unindexable)
    seen = []

    def spy(codes, starts, ends, lut, pad):
        assert codes is tidx.codes
        offs = tidx.offsets.tolist()
        lists = set(zip(offs, offs[1:]))
        assert set(zip(starts.tolist(), ends.tolist())) <= lists
        seen.append((tuple(codes.shape), codes.dtype, tuple(starts.shape),
                     tuple(lut.shape), pad))
        return CK.adc_score_lists_plain(codes.as_subclass(torch.Tensor),
                                        starts, ends,
                                        lut.to(torch.float32), pad)

    def no_dense(*a, **kw):
        raise AssertionError("the search ran the dense form")

    monkeypatch.setattr(TK, "adc_score_lists", spy)
    monkeypatch.setattr(TK, "adc_score", no_dense)
    TP.search(tidx, q[:37], k=5, nprobe=4, query_chunk=16)
    pad = tidx.max_cluster_size
    assert seen == [((tidx.n, 8), torch.uint8, (16 * 4,), (16 * 4, 8, 256),
                     pad)] * 4
    with pytest.raises(AssertionError, match="gathered codes"):
        tidx.codes[torch.zeros(3, dtype=torch.int64)]


def test_search_metrics_and_refusals(indexes):
    from matrixone_tpu_torch.utils import metrics as M
    jidx, q = indexes["l2"]
    tidx = _convert(jidx)
    q0 = M.vector_search_queries.get()
    p0 = M.vector_search_pad_rows.get()
    TP.search(tidx, q[:37], k=5, nprobe=4)
    assert M.vector_search_queries.get() - q0 == 37
    assert M.vector_search_pad_rows.get() - p0 == 64 - 37
    x = np.zeros((300, 12), np.float32)
    with pytest.raises(ValueError, match="l2/cosine"):
        TP.build(x, nlist=4, n_subspaces=4, metric="ip", device="cpu")
    with pytest.raises(ValueError, match="divide"):
        TP.build(x, nlist=4, n_subspaces=5, device="cpu")


@pytest.fixture(scope="module")
def ref_test_shape():
    """test_vectorindex.py's IVF-PQ shape (20000 x 32, nlist 32, M 8),
    with 256 queries so a recall difference of 0.05 is not noise, and
    the exact top-10 of each."""
    x, q = _clustered(1234, 20000, 32, nq=256)
    padded, n = JB.pad_dataset(jnp.asarray(x), chunk_size=4096)
    _, truth = JB.search(padded, jnp.asarray(q), k=10, n_valid=n,
                         chunk_size=4096)
    return x, q, np.asarray(truth)


def test_build_matches_reference_recall(ref_test_shape):
    """The port's own build: uint8 codes [n, 8], the JAX package's recall
    bars (raw ADC recall@10 >= 0.40; >= 0.85 after an exact re-rank of a
    k = 100 pool), and raw recall within 0.05 of the JAX build's on the
    same data."""
    x, q, truth = ref_test_shape
    kw = dict(nlist=32, n_subspaces=8, n_iter=8, pq_iter=6,
              kmeans_sample=None, compute_dtype=None)
    tidx = TP.build(x, device="cpu", **kw)
    assert tidx.codes.dtype == torch.uint8
    assert tuple(tidx.codes.shape) == (len(x), 8)
    assert tuple(tidx.codebooks.shape) == (8, 256, 4)
    offs = tidx.offsets.numpy()
    assert offs[0] == 0 and offs[-1] == len(x)
    assert np.diff(offs).max() <= tidx.max_cluster_size
    assert tidx.max_cluster_size % 128 == 0
    assert sorted(tidx.ids.numpy().tolist()) == list(range(len(x)))
    _, ti = TP.search(tidx, q, k=10, nprobe=8, query_chunk=16)
    rt = recall_at_k(ti.numpy(), truth)
    assert rt >= 0.40, rt
    _, pool = TP.search(tidx, q, k=100, nprobe=8, query_chunk=16)
    _, rr = TI.rerank_exact(torch.from_numpy(x), torch.from_numpy(q), pool)
    assert recall_at_k(rr.numpy()[:, :10], truth) >= 0.85
    jidx = JP.build(jnp.asarray(x), **{**kw, "compute_dtype": None})
    _, ji = JP.search(jidx, jnp.asarray(q), k=10, nprobe=8, query_chunk=16)
    rj = recall_at_k(np.asarray(ji), truth)
    assert abs(rt - rj) <= 0.05, (rt, rj)


def test_small_build_pads_codebooks():
    """Fewer rows than 256 codewords: each codebook is padded with 1e10
    rows, so codes stay uint8-addressable and never pick a pad row."""
    x, q = _clustered(5, 100, 16, n_clusters=4, nq=8)
    tidx = TP.build(x, nlist=4, n_subspaces=4, n_iter=4, pq_iter=4,
                    kmeans_sample=None, compute_dtype=None, device="cpu")
    assert tuple(tidx.codebooks.shape) == (4, 256, 4)
    assert bool((tidx.codebooks[:, 100:] == 1e10).all())
    assert int(tidx.codes.max()) < 100
    d, ids = TP.search(tidx, q, k=5, nprobe=4)
    assert ids.shape == (8, 5) and bool(torch.isfinite(d).all())


def test_bench_recipe_recall_matches_reference(capsys):
    """bench.py's data recipe (N(0,1) centres about 488 rows each, noise
    0.35, d = 768) at its IVF-PQ widths (M = 96, lists of about 977
    rows, nprobe 8), cut to 10000 rows: the port's raw recall@20 is the
    JAX package's within 0.05 over 256 queries.  Both sit far below the
    0.40 bar the JAX package sets on its own test data: in 768 dims the
    rows of one centre are all about equally far from a query, and the
    PQ error of 8-dim subspaces is larger than those gaps.  The two
    recalls are printed (run with -s) as the record of that."""
    rng = np.random.default_rng(0)
    n, d = 10000, 768
    centers = rng.standard_normal((n // 488, d)).astype(np.float32)
    x = (centers[rng.integers(0, len(centers), n)]
         + 0.35 * rng.standard_normal((n, d))).astype(np.float32)
    q = (centers[rng.integers(0, len(centers), 256)]
         + 0.35 * rng.standard_normal((256, d))).astype(np.float32)
    padded, n_real = JB.pad_dataset(jnp.asarray(x), chunk_size=4096)
    _, truth = JB.search(padded, jnp.asarray(q), k=20, n_valid=n_real,
                         chunk_size=4096)
    truth = np.asarray(truth)
    kw = dict(nlist=n // 977, n_subspaces=TP.pick_subspaces(d), n_iter=10,
              balance_weight=0.3, kmeans_sample=None, compute_dtype=None)
    jidx = JP.build(jnp.asarray(x), **kw)
    _, ji = JP.search(jidx, jnp.asarray(q), k=20, nprobe=8, query_chunk=64)
    rj = recall_at_k(np.asarray(ji), truth)
    tidx = TP.build(x, device="cpu", **kw)
    _, ti = TP.search(tidx, q, k=20, nprobe=8, query_chunk=64)
    rt = recall_at_k(ti.numpy(), truth)
    with capsys.disabled():
        print(f"\nbench recipe, 10000 x 768, M 96: raw ADC recall@20 "
              f"JAX package {rj:.4f}, port {rt:.4f}")
    assert abs(rt - rj) <= 0.05, (rt, rj)
