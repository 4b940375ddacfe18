"""The port's WorkerCore (matrixone_tpu_torch.worker) on the CPU:
index lifecycle, the micro-batcher under threads, error isolation and
health, held against the JAX package's WorkerCore on the same data."""

import threading

import numpy as np
import pytest
import torch

from matrixone_tpu.worker.server import WorkerCore as JaxWorkerCore
from matrixone_tpu_torch.vectorindex.recall import recall_at_k
from matrixone_tpu_torch.worker import WorkerCore


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs six test processes at once (xdist): torch's own
    thread pool in each would oversubscribe the cores, and these tests'
    many small ops per shard are what it slows most."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed, n, d):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, d)).astype(np.float32) * 3.0
    x = centers[rng.integers(0, 40, n)] + 0.3 * rng.standard_normal(
        (n, d)).astype(np.float32)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def worker():
    w = WorkerCore(device="cpu")
    w.load_index("ix1", _data(0, 3000, 24), nlist=12)
    return w


def test_index_lifecycle(worker):
    data = _data(0, 3000, 24)
    q = data[:5] + 0.001
    dists, ids = worker.search_index("ix1", q, k=3, nprobe=12)
    assert ids.shape == (5, 3) and ids.dtype == np.int64
    assert dists.dtype == np.float32
    np.testing.assert_array_equal(ids[:, 0], np.arange(5))   # self-hit
    assert (np.diff(dists, axis=1) >= 0).all()
    assert worker.health()["indexes"] == ["ix1"]
    with pytest.raises(KeyError):
        worker.search_index("missing_index", np.zeros((1, 24), np.float32))
    with pytest.raises(ValueError, match="unknown index mode"):
        worker.load_index("ix_bad", data, nlist=8, mode="striped")


def test_sharded_and_replicated_modes(worker):
    """tests/test_worker.py's modes over 8 slots: each answers a self
    query with itself; one slot serves the single index."""
    from matrixone_tpu_torch.parallel import simulated_slots
    rng = np.random.default_rng(6)
    data = rng.normal(size=(1200, 8)).astype(np.float32)
    q = data[17:18]
    with simulated_slots(8):
        for mode in ("sharded", "replicated"):
            r = worker.load_index(f"ix_{mode}", data, nlist=8, mode=mode)
            assert r["mode"] == mode and r["devices"] == 8
            _d, ids = worker.search_index(f"ix_{mode}", q, k=3, nprobe=8)
            assert int(ids[0][0]) == 17, (mode, ids[0])
        assert worker.indexes["ix_sharded"]["sharded"].n_shards == 8
        assert len(worker.indexes["ix_replicated"]["replicas"]) == 8
    worker.load_index("ix_one", data, nlist=8, mode="sharded")
    assert worker.indexes["ix_one"]["mode"] == "single"


def test_sharded_mode_recall_parity(worker):
    """Sharded recall@10 at the single index's nprobe budget matches or
    beats the single index's (tests/test_worker.py's bar), and is the
    JAX worker's sharded recall on the same data within 0.02 (each
    worker builds with its own settings, as in
    test_recall_matches_reference_worker)."""
    from matrixone_tpu_torch.parallel import simulated_slots
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(64, 16)).astype(np.float32) * 3.0
    labels = rng.integers(0, 64, 6000)
    data = (centers[labels]
            + rng.normal(size=(6000, 16)).astype(np.float32) * 0.4)
    queries = (centers[rng.integers(0, 64, 100)]
               + rng.normal(size=(100, 16)).astype(np.float32) * 0.4)
    truth = np.argsort(((queries[:, None, :] - data[None, :, :]) ** 2
                        ).sum(-1), axis=1)[:, :10]
    with simulated_slots(8):
        worker.load_index("rp_single", data, nlist=32, mode="single")
        worker.load_index("rp_shard", data, nlist=32, mode="sharded")
        r_single = recall_at_k(
            worker.search_index("rp_single", queries, k=10, nprobe=8)[1],
            truth)
        r_shard = recall_at_k(
            worker.search_index("rp_shard", queries, k=10, nprobe=8)[1],
            truth)
    jw = JaxWorkerCore()
    jw.load_index("rp_shard", data, nlist=32, mode="sharded")
    assert jw.indexes["rp_shard"]["mode"] == "sharded"
    r_jax = recall_at_k(
        jw.search_index("rp_shard", queries, k=10, nprobe=8)[1], truth)
    assert r_single > 0.8, r_single
    assert r_shard >= r_single - 0.01, (r_shard, r_single)
    assert r_shard >= r_jax - 0.02, (r_shard, r_jax)


def test_empty_queries(worker):
    d, i = worker.search_index("ix1", np.zeros((0, 24), np.float32), k=3)
    assert d.shape == (0, 1) and i.shape == (0, 1)
    assert d.dtype == np.float32 and i.dtype == np.int64


def test_recall_matches_reference_worker():
    """Both workers build with their own settings on the same data; the
    port's served recall@10 is the reference's within 0.02."""
    data = _data(1, 4000, 16)
    q = data[::97][:40] + 0.01
    truth = np.argsort(((data[None] - q[:, None]) ** 2).sum(-1),
                       axis=1, kind="stable")[:, :10]
    tw = WorkerCore(device="cpu")
    tw.load_index("a", data, nlist=16)
    jw = JaxWorkerCore()
    jw.load_index("a", data, nlist=16)
    rt = recall_at_k(tw.search_index("a", q, k=10, nprobe=4)[1], truth)
    rj = recall_at_k(jw.search_index("a", q, k=10, nprobe=4)[1], truth)
    assert rt >= rj - 0.02, (rt, rj)


def test_malformed_dim_fails_alone(worker):
    """A request with the wrong dimension fails on its own thread; a
    concurrent well-formed request still succeeds."""
    data = _data(0, 3000, 24)
    barrier = threading.Barrier(2)
    out = {}

    def good():
        barrier.wait(timeout=30)
        out["good"] = worker.search_index("ix1", data[:2], k=3)[1]

    def bad():
        barrier.wait(timeout=30)
        try:
            worker.search_index("ix1", np.zeros((2, 7), np.float32), k=3)
        except RuntimeError as e:      # the search's shape error
            out["bad"] = e

    ts = [threading.Thread(target=good), threading.Thread(target=bad)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert "bad" in out
    np.testing.assert_array_equal(out["good"][:, 0], [0, 1])


def test_micro_batcher_coalesces_concurrent_searches():
    """Concurrent requests coalesce into fewer dispatches, and every
    caller gets exactly its own rows back.  The worker owns a test-sized
    linger (50 ms) and a barrier releases the burst together, so the
    gate is a coalescing ratio, not a race against the scheduler."""
    w = WorkerCore(device="cpu", linger_s=0.05)
    data = _data(2, 2000, 8)
    w.load_index("batched", data, nlist=8)
    w.search_index("batched", data[:1], k=1, nprobe=8)        # warm
    h0 = w.health()
    n = 24
    results = [None] * n
    barrier = threading.Barrier(n)

    def one(i):
        barrier.wait(timeout=60)
        results[i] = int(w.search_index("batched", data[i * 3:i * 3 + 1],
                                        k=1, nprobe=8)[1][0][0])

    ts = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert results == [i * 3 for i in range(n)]
    h1 = w.health()
    reqs = h1["batch_requests"] - h0["batch_requests"]
    disp = h1["batch_dispatches"] - h0["batch_dispatches"]
    assert reqs == n
    assert reqs - disp >= reqs * 0.25, (reqs, disp)


def test_health(worker):
    h = worker.health()
    assert h["backend"] == "cpu" and h["devices"] == ["cpu"]
    assert h["uptime_s"] >= 0
    assert h["batch_requests"] >= h["batch_dispatches"] >= 0
    assert set(h) >= {"indexes", "batch_requests", "batch_dispatches"}


def test_worker_index_is_the_references_kind():
    """The worker builds as the JAX worker does (bf16 residuals, nothing
    beside them): no index type of the port keeps a second copy of its
    vectors."""
    import dataclasses

    from matrixone_tpu_torch.vectorindex import IvfFlatIndex, IvfPqIndex
    w = WorkerCore(device="cpu")
    w.load_index("ix", _data(4, 2000, 16), nlist=8)
    idx = w.indexes["ix"]["index"]
    assert isinstance(idx, IvfFlatIndex)
    assert idx.vectors.dtype == torch.bfloat16
    for cls in (IvfFlatIndex, IvfPqIndex):
        assert "vectors_lo" not in {f.name for f in dataclasses.fields(cls)}
    assert not hasattr(idx, "vectors_lo")


def test_worker_serves_a_converted_jax_index_as_the_jax_worker():
    """The JAX worker builds its bf16 index; the port's worker serves the
    same index, carried across by `convert`: per-query id sets equal on
    >= 99% of queries, through both workers' search_index."""
    from matrixone_tpu_torch import convert
    data = _data(3, 4000, 32)
    q = data[::53][:64] + 0.05
    jw = JaxWorkerCore()
    jw.load_index("a", data, nlist=16)
    jidx = jw.indexes["a"]["index"]
    fields = {f: np.asarray(getattr(jidx, f))
              for f in convert.IVF_FLAT_FIELDS}
    fields.update(metric=jidx.metric, n=jidx.n,
                  max_cluster_size=jidx.max_cluster_size)
    tw = WorkerCore(device="cpu")
    tw.indexes["a"] = {"mode": "single", "n": len(data),
                       "index": convert.ivf_flat_from_numpy(fields,
                                                            device="cpu")}
    assert tw.indexes["a"]["index"].vectors.dtype == torch.bfloat16
    _, ji = jw.search_index("a", q, k=10, nprobe=4)
    _, ti = tw.search_index("a", q, k=10, nprobe=4)
    same = np.mean([set(a) == set(b) for a, b in
                    zip(np.asarray(ji).tolist(), ti.tolist())])
    assert same >= 0.99, same
