"""On-card tests of the port: they need a CUDA device and skip without
one.  This file imports neither `jax` nor the JAX package, so on a
machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The CPU tests (tests/test_torch_*.py) hold the port against the JAX
package; these hold each CUDA kernel against its plain version and the
CUDA paths against the CPU paths on the same index.
"""

import dataclasses

import numpy as np
import pytest
import torch

from matrixone_tpu_torch.ops import cuda_kernels as CK
from matrixone_tpu_torch.ops.hash import unsigned_order
from matrixone_tpu_torch.ops import kernels as TK

pytestmark = pytest.mark.cuda


def _to(index, device):
    """A copy of an index dataclass with its tensors on `device`."""
    return type(index)(**{
        f.name: (getattr(index, f.name).to(device)
                 if isinstance(getattr(index, f.name), torch.Tensor)
                 else getattr(index, f.name))
        for f in dataclasses.fields(index)})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,b,d", [(4480, 256, 768), (1, 1, 100),
                                   (1000, 3, 65), (130, 64, 16)])
def test_kernel_matches_plain_version(cuda, n, b, d):
    """The fused kernel against its plain version in f64, at unaligned
    shapes, with chip_smoke.py's bound 1e-5 * (x2 + q2) + 1e-4."""
    g = torch.Generator(device=cuda)
    g.manual_seed(n + b + d)
    x = torch.randn(n, d, generator=g, device=cuda)
    q = torch.randn(b, d, generator=g, device=cuda)
    before = CK.LAUNCHES.get("l2_distance_sq")
    at_shape = CK.LAUNCHES.shapes("l2_distance_sq").get((n, b, d), 0)
    got = TK.l2_distance_sq_exact(x, q)
    torch.cuda.synchronize()
    assert CK.LAUNCHES.get("l2_distance_sq") == before + 1
    assert CK.LAUNCHES.shapes("l2_distance_sq")[(n, b, d)] == at_shape + 1
    x64, q64 = x.double(), q.double()
    x2, q2 = (x64 * x64).sum(1, keepdim=True), (q64 * q64).sum(1)
    ref = CK.l2_distance_sq_plain(x64, q64, q2)
    tol = 1e-5 * (x2 + q2[None, :]) + 1e-4
    assert got.shape == (n, b) and got.dtype == torch.float32
    assert bool(((got.double() - ref).abs() <= tol).all())


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.randn(8, 4, device=cuda)
    q = torch.randn(3, 4, device=cuda)
    q2 = (q * q).sum(1)
    with pytest.raises(TypeError):
        CK.l2_distance_sq(x.double(), q, q2)
    with pytest.raises(ValueError, match="contiguous"):
        CK.l2_distance_sq(torch.randn(4, 8, device=cuda).T, q, q2)
    with pytest.raises(ValueError):
        CK.l2_distance_sq(x, torch.randn(3, 5, device=cuda), q2)
    empty = CK.l2_distance_sq(x[:0], q, q2)
    assert empty.shape == (0, 3)


def test_cuda_search_matches_cpu_search(cuda):
    """One index, searched on the CPU (plain version) and on the card
    (the kernel and cuBLAS): the same ids, distances within rtol 1e-5."""
    from matrixone_tpu_torch.vectorindex import ivf_flat
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((32, 48)).astype(np.float32)
    x = (centers[rng.integers(0, 32, 8000)]
         + 0.35 * rng.standard_normal((8000, 48))).astype(np.float32)
    q = (centers[rng.integers(0, 32, 64)]
         + 0.35 * rng.standard_normal((64, 48))).astype(np.float32)
    cpu = ivf_flat.build(x, nlist=32, n_iter=6, kmeans_sample=None,
                         compute_dtype=None, device="cpu")
    card = _to(cpu, cuda)
    before = CK.LAUNCHES.get("l2_distance_sq")
    dc, ic = ivf_flat.search(cpu, q, k=10, nprobe=8,
                             compute_dtype=torch.float32)
    dg, ig = ivf_flat.search(card, q, k=10, nprobe=8,
                             compute_dtype=torch.float32)
    assert CK.LAUNCHES.get("l2_distance_sq") > before
    assert ig.is_cuda
    same = np.mean([set(a) == set(b) for a, b in
                    zip(ic.numpy().tolist(), ig.cpu().numpy().tolist())])
    assert same >= 0.99, same
    np.testing.assert_allclose(dg.cpu().numpy(), dc.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_worker_on_the_card(cuda):
    from matrixone_tpu_torch.worker import WorkerCore
    rng = np.random.default_rng(1)
    data = rng.standard_normal((3000, 24)).astype(np.float32)
    w = WorkerCore()
    assert w.device.type == "cuda"
    w.load_index("ix", data, nlist=12)
    _, ids = w.search_index("ix", data[:5] + 0.001, k=3, nprobe=12)
    np.testing.assert_array_equal(ids[:, 0], np.arange(5))
    assert w.health()["backend"] == "cuda"


@pytest.mark.parametrize("g,p,m,dtype", [
    (16, 100, 8, torch.uint8), (8, 129, 1, torch.int32),
    (64, 1, 96, torch.uint8), (32, 4096, 96, torch.int32),
    (4, 129, 300, torch.uint8), (2, 1000, 300, torch.int32)])
def test_adc_kernel_matches_plain_version(cuda, g, p, m, dtype):
    """The ADC kernel against its plain version in f64 at ragged P, at
    M = 300 (a 300 KB LUT, over a block's shared memory, so the kernel
    loops over LUT tiles), with uint8 and int32 codes; the bound is the
    reference's 1e-5 * |want| + 1e-4."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(g * p + m)
    codes = torch.randint(0, 256, (g, p, m), generator=gen,
                          device=cuda).to(dtype)
    lut = torch.randn(g, m, 256, generator=gen, device=cuda)
    before = CK.LAUNCHES.get("adc_score")
    got = TK.adc_score(codes, lut)
    torch.cuda.synchronize()
    assert CK.LAUNCHES.get("adc_score") == before + 1
    assert CK.LAUNCHES.shapes("adc_score")[(g, p, m)] >= 1
    want = CK.adc_score_plain(codes, lut.double())
    assert got.shape == (g, p) and got.dtype == torch.float32
    assert bool(((got.double() - want).abs()
                 <= 1e-5 * want.abs() + 1e-4).all())


def test_adc_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    codes = torch.randint(0, 256, (2, 5, 4), device=cuda).to(torch.uint8)
    lut = torch.randn(2, 4, 256, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        CK.adc_score(codes.cpu(), lut.cpu())
    with pytest.raises(TypeError):
        CK.adc_score(codes.to(torch.int64), lut)
    with pytest.raises(TypeError):
        CK.adc_score(codes, lut.double())
    with pytest.raises(ValueError):
        CK.adc_score(codes, lut[:, :3].contiguous())
    wide = torch.randint(0, 256, (2, 5, 8), device=cuda).to(torch.uint8)
    with pytest.raises(ValueError, match="contiguous"):
        CK.adc_score(wide[:, :, :4], lut)
    with pytest.raises(ValueError, match=r"\[0, 256\)"):
        CK.adc_score(torch.full((2, 5, 4), 256, dtype=torch.int32,
                                device=cuda), lut)
    assert CK.adc_score(codes[:, :0].contiguous(), lut).shape == (2, 0)


@pytest.mark.parametrize("n,b,d", [(4480, 256, 768), (1000, 3, 65),
                                   (130, 64, 16)])
def test_masked_kernel_matches_plain_version(cuda, n, b, d):
    """The masked kernel against its plain version in f64 (+inf exactly
    on masked rows); an all-true mask gives the unmasked kernel's bits
    and an all-false one all +inf."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n + b + d)
    x = torch.randn(n, d, generator=gen, device=cuda)
    q = torch.randn(b, d, generator=gen, device=cuda)
    mask = torch.rand(n, generator=gen, device=cuda) < 0.7
    before = CK.LAUNCHES.get("l2_distance_sq_masked")
    got = TK.l2_distance_sq_masked_exact(x, q, mask)
    torch.cuda.synchronize()
    assert CK.LAUNCHES.get("l2_distance_sq_masked") == before + 1
    x64, q64 = x.double(), q.double()
    want = CK.l2_distance_sq_masked_plain(x64, q64, (q64 * q64).sum(1),
                                          mask)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    keep = ~torch.isinf(want)
    assert bool(((got.double() - want).abs()[keep]
                 <= (1e-5 * want.abs() + 1e-4)[keep]).all())
    every = torch.ones_like(mask)
    assert torch.equal(TK.l2_distance_sq_masked_exact(x, q, every),
                       TK.l2_distance_sq_exact(x, q))
    assert bool(torch.isinf(TK.l2_distance_sq_masked_exact(
        x, q, torch.zeros_like(mask))).all())
    with pytest.raises(TypeError):
        CK.l2_distance_sq_masked(x, q, (q * q).sum(1), mask.to(torch.int32))
    with pytest.raises(ValueError):
        CK.l2_distance_sq_masked(x, q, (q * q).sum(1), mask[:-1])


def test_cuda_ivf_pq_search_matches_cpu_search(cuda):
    """One IVF-PQ index, searched on the CPU (plain versions) and on the
    card (the ADC and L2 kernels): per-query id sets equal on >= 99% of
    queries, distances within rtol 1e-5 / atol 1e-4."""
    from matrixone_tpu_torch.vectorindex import ivf_pq
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((32, 48)).astype(np.float32)
    x = (centers[rng.integers(0, 32, 8000)]
         + 0.35 * rng.standard_normal((8000, 48))).astype(np.float32)
    q = (centers[rng.integers(0, 32, 64)]
         + 0.35 * rng.standard_normal((64, 48))).astype(np.float32)
    cpu = ivf_pq.build(x, nlist=32, n_subspaces=12, n_iter=6, pq_iter=6,
                       kmeans_sample=None, compute_dtype=None, device="cpu")
    card = _to(cpu, cuda)
    before = CK.LAUNCHES.snapshot()
    dc, ic = ivf_pq.search(cpu, q, k=10, nprobe=8, query_chunk=16)
    dg, ig = ivf_pq.search(card, q, k=10, nprobe=8, query_chunk=16)
    after = CK.LAUNCHES.snapshot()
    for name in ("adc_score", "l2_distance_sq"):
        assert after.get(name, 0) > before.get(name, 0), name
    assert ig.is_cuda and ig.dtype == torch.int32
    same = np.mean([set(a) == set(b) for a, b in
                    zip(ic.numpy().tolist(), ig.cpu().numpy().tolist())])
    assert same >= 0.99, same
    np.testing.assert_allclose(dg.cpu().numpy(), dc.numpy(), rtol=1e-5,
                               atol=1e-4)


# ------------------------------------------------- the relational kernels
def _hashes(gen, n: int) -> torch.Tensor:
    """Sorted uint64 hashes as int64 bit patterns: a duplicate run and
    UINT64_MAX (NULL-hash) sentinels, in unsigned order."""
    a = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), generator=gen,
                      device=gen.device, dtype=torch.int64)
    if n:
        a[: n // 5] = a[0]
        a[-min(4, n):] = -1
    return a[torch.argsort(unsigned_order(a), stable=True)]


@pytest.mark.parametrize("n", [0, 1, 2500, (1 << 20) + 3])
@pytest.mark.parametrize("m", [1, 1000, 1 << 20])
def test_sorted_search_kernel_bit_identical(cuda, n, m):
    """Kernel 4 against its plain version, bit for bit (`torch.equal`):
    queries drawn from the sorted values, random ones, and 0, 1 and
    2^64 - 1."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n + 7 * m)
    srt = _hashes(gen, n)
    special = torch.tensor([0, 1, -1], dtype=torch.int64, device=cuda)
    rand = torch.randint(-(1 << 63), (1 << 63) - 1, (m,), generator=gen,
                         device=cuda, dtype=torch.int64)
    if n:
        pick = torch.randint(0, n, (m,), generator=gen, device=cuda)
        rand = torch.where(torch.rand(m, generator=gen, device=cuda) < 0.7,
                           srt[pick], rand)
    q = torch.cat([special, rand])[:m].contiguous()
    before = CK.LAUNCHES.get("sorted_search")
    got = TK.sorted_lookup(srt, q)
    torch.cuda.synchronize()
    assert CK.LAUNCHES.get("sorted_search") == before + 1
    assert CK.LAUNCHES.shapes("sorted_search")[(n, m)] >= 1
    assert got.dtype == torch.int32 and got.shape == (m,)
    assert torch.equal(got, CK.sorted_search_plain(srt, q))


def test_sorted_search_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    s = torch.arange(10, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        CK.sorted_search(s.cpu(), s.cpu())
    with pytest.raises(TypeError):
        CK.sorted_search(s.to(torch.int32), s)
    with pytest.raises(ValueError, match="contiguous"):
        CK.sorted_search(s, torch.arange(20, device=cuda)[::2])
    before = CK.LAUNCHES.get("sorted_search")
    assert CK.sorted_search(s, s[:0]).shape == (0,)
    assert CK.LAUNCHES.get("sorted_search") == before   # m = 0: no launch


@pytest.mark.parametrize("n", [1, 4000, 4096, 1 << 20, 6_000_000])
@pytest.mark.parametrize("g", [1, 19, 1000, 4096])
def test_segment_sum_kernel_matches_plain_version(cuda, n, g):
    """Kernel 3 against its plain version: exact on integer-valued
    values (every partial stays below 2^24), within the reference's
    rtol 1e-4 / atol 1e-3 of an f64 sum on N(0,1) values; masked rows
    whose gids collide with live groups never land."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n + g)
    gids = torch.randint(0, g, (n,), generator=gen, device=cuda,
                         dtype=torch.int32)
    mask = torch.rand(n, generator=gen, device=cuda) < 0.8
    ints = torch.randint(0, 16, (n,), generator=gen,
                         device=cuda).to(torch.float32)
    before = CK.LAUNCHES.get("segment_sum")
    got = TK.grouped_scatter_add(ints, gids, mask, g, use_pallas=True)
    torch.cuda.synchronize()
    assert CK.LAUNCHES.get("segment_sum") == before + 1
    assert got.dtype == torch.float32 and got.shape == (g,)
    want = CK.segment_sum_plain(ints.double(), gids, mask, g)
    if float(want.max()) < (1 << 24):
        assert torch.equal(got.double(), want)
    normal = torch.randn(n, generator=gen, device=cuda)
    got = CK.segment_sum(normal, gids, mask, g)
    want = CK.segment_sum_plain(normal.double(), gids, mask, g)
    assert bool(((got.double() - want).abs()
                 <= 1e-4 * want.abs() + 1e-3).all())
    # a masked row never lands, whatever its gid
    dead = torch.full_like(normal, 1e6)
    assert bool((CK.segment_sum(dead, gids, torch.zeros_like(mask), g)
                 == 0).all())


def test_segment_sum_never_takes_what_the_kernel_does_not_take(cuda):
    """G > 4096, exact dtypes and the merge route (no use_pallas) stay
    on the plain scatter: no launch; the wrapper itself refuses them."""
    v = torch.ones(5000, device=cuda)
    gids = torch.arange(5000, device=cuda, dtype=torch.int32)
    mask = torch.ones(5000, dtype=torch.bool, device=cuda)
    before = CK.LAUNCHES.get("segment_sum")
    wide = TK.grouped_scatter_add(v, gids, mask, 5000, use_pallas=True)
    exact = TK.grouped_scatter_add(v.to(torch.int64), gids, mask, 64,
                                   use_pallas=True)
    f64 = TK.grouped_scatter_add(v.double(), gids, mask, 64,
                                 use_pallas=True)
    merge = TK.grouped_scatter_add(v, gids, mask, 64)
    torch.cuda.synchronize()
    assert CK.LAUNCHES.get("segment_sum") == before
    assert wide.shape == (5000,) and bool((wide == 1).all())
    assert exact.dtype == torch.int64 and f64.dtype == torch.float64
    assert merge.dtype == torch.float32
    with pytest.raises(ValueError, match="4096"):
        CK.segment_sum(v, gids, mask, 5000)
    with pytest.raises(TypeError):
        CK.segment_sum(v.double(), gids, mask, 64)
    with pytest.raises(TypeError):
        CK.segment_sum(v, gids.to(torch.int64), mask, 64)
    with pytest.raises(ValueError, match="CUDA"):
        CK.segment_sum(v.cpu(), gids.cpu(), mask.cpu(), 64)


def test_sql_on_the_card_matches_the_cpu(cuda):
    """TPC-H Q3 and the float GROUP BY on the card (both kernels on the
    path) give the CPU session's rows: Q3 exactly, with the oracle; the
    integer-valued float sums exactly, the N(0,1) ones within rtol 1e-4
    / atol 1e-3."""
    from matrixone_tpu_torch.container import dtypes as dt
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.storage.engine import Engine, TableMeta
    from matrixone_tpu_torch.utils import tpch
    eng = Engine()
    lineitem = tpch.load_lineitem(eng, 40_000, seed=1)
    q3data = tpch.load_tpch_q3(eng, 10_000, seed=1)
    rng = np.random.default_rng(3)
    ids = np.arange(30_000, dtype=np.int64)
    eng.create_table(TableMeta("v", [("id", dt.INT64), ("grp", dt.INT64),
                                     ("xi", dt.FLOAT32), ("xn", dt.FLOAT32)],
                               ["id"]))
    eng.get_table("v").insert_numpy({
        "id": ids, "grp": ids % 1000,
        "xi": rng.integers(0, 16, len(ids)).astype(np.float32),
        "xn": rng.standard_normal(len(ids)).astype(np.float32)})
    card, host = Session(catalog=eng), Session(catalog=eng, device="cpu")
    assert card.device.type == "cuda"
    card.variables["batch_rows"] = host.variables["batch_rows"] = 8192
    CK.LAUNCHES.reset()
    rows = card.execute(tpch.Q3_SQL).rows()
    assert CK.LAUNCHES.get("sorted_search") > 0
    assert rows == host.execute(tpch.Q3_SQL).rows()
    epoch = __import__("datetime").date(1970, 1, 1)
    want = tpch.q3_oracle(lineitem, q3data)
    assert [(r[0], round(r[1] * 10000), (r[2] - epoch).days)
            for r in rows] == want
    sql = "select grp, sum(xi), sum(xn) from v group by grp order by grp"
    CK.LAUNCHES.reset()
    got = card.execute(sql).rows()
    assert CK.LAUNCHES.shapes("segment_sum")
    assert {s[1] for s in CK.LAUNCHES.shapes("segment_sum")} == {4096}
    ref = host.execute(sql).rows()
    assert [r[:2] for r in got] == [r[:2] for r in ref]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in ref],
                               rtol=1e-4, atol=1e-3)
