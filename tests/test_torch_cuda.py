"""On-card tests of the port: they need a CUDA device and skip without
one.  This file imports neither `jax` nor the JAX package, so on a
machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The CPU tests (tests/test_torch_*.py) hold the port against the JAX
package; these hold each CUDA kernel against its plain version and the
CUDA paths against the CPU paths on the same index.
"""

import contextlib
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


# every tile shape (b <= 32, b <= 256, b > 256), load path (d % 4 == 0
# or not), depth split (small n) and ragged edge of the L2 kernel
L2_EDGE_SHAPES = [(n, b, d) for n in (1, 63, 65, 5226)
                  for b in (1, 32, 255, 256, 257)
                  for d in (1, 8, 65, 100, 768, 769)]


def _l2_check(x, q, got):
    """|got - f64| <= 1e-5 * (x2 + q2) + 1e-4 (chip_smoke.py's bound)."""
    x64, q64 = x.double(), q.double()
    x2, q2 = (x64 * x64).sum(1, keepdim=True), (q64 * q64).sum(1)
    ref = CK.l2_distance_sq_plain(x64, q64, q2)
    tol = 1e-5 * (x2 + q2[None, :]) + 1e-4
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert bool(((got.double() - ref).abs() <= tol).all())


@pytest.mark.parametrize("n,b,d", [(4480, 256, 768), (1, 1, 100),
                                   (1000, 3, 65), (130, 64, 16)]
                         + L2_EDGE_SHAPES)
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
    assert got.shape == (n, b)
    _l2_check(x, q, got)


@pytest.mark.parametrize("n,b,d,offset", [
    (5226, 256, 8, 1), (1000, 256, 768, 1), (63, 32, 100, 3),
    (4480, 257, 65, 3), (1024, 256, 768, 5)])
def test_kernel_at_unaligned_bases(cuda, n, b, d, offset):
    """Rows that start `offset` floats into their storage (a slice
    x[s:] of a contiguous array): the kernel's 4-byte load path where
    the base is not on 16 bytes, whatever d is."""
    g = torch.Generator(device=cuda)
    g.manual_seed(n + b + d + offset)
    flat = torch.randn(n * d + offset, generator=g, device=cuda)
    x = flat[offset:].view(n, d)
    q = torch.randn(b + 1, d, generator=g, device=cuda)[1:]
    assert x.is_contiguous() and q.is_contiguous()
    _l2_check(x, q, TK.l2_distance_sq_exact(x, q))
    slice_rows = torch.randn(n + 3, d, generator=g, device=cuda)[3:]
    _l2_check(slice_rows, q, TK.l2_distance_sq_exact(slice_rows, q))


@pytest.mark.parametrize("n,b,d", [(1024, 256, 768), (1024, 32, 768),
                                   (5226, 256, 768), (65536, 256, 768),
                                   (131072, 256, 8), (1000, 3, 65)])
def test_kernel_is_deterministic(cuda, n, b, d):
    """Two launches on the same inputs give the same bits, where the
    depth is split over blocks (small n) and where it is not."""
    g = torch.Generator(device=cuda)
    g.manual_seed(n * 7 + b + d)
    x = torch.randn(n, d, generator=g, device=cuda)
    q = torch.randn(b, d, generator=g, device=cuda)
    first = TK.l2_distance_sq_exact(x, q)
    second = TK.l2_distance_sq_exact(x, q)
    assert torch.equal(first, second)
    _l2_check(x[:2048], q, first[:2048])


@pytest.mark.parametrize("n,d", [(65536, 768), (5226, 768), (4096, 8)])
def test_kernel_at_near_duplicates(cuda, n, d):
    """Queries that are rows of x plus noise of 1e-3, as the exact
    truth's nearest rows are: x.q ~ ||x||^2, the largest the product
    gets, and distances near 0."""
    g = torch.Generator(device=cuda)
    g.manual_seed(n + d)
    centres = torch.randn(64, d, generator=g, device=cuda)
    x = centres[torch.randint(0, 64, (n,), generator=g, device=cuda)] \
        + 0.35 * torch.randn(n, d, generator=g, device=cuda)
    q = x[:256] + 1e-3 * torch.randn(256, d, generator=g, device=cuda)
    got = TK.l2_distance_sq_exact(x, q)
    _l2_check(x[:4096], q, got[:4096])


def test_l2_kernels_do_not_spill(cuda):
    """Every L2 tile kernel compiles without local memory (spills)."""
    rows = CK.l2_kernel_attributes()
    assert rows and all(r["local_bytes"] == 0 for r in rows), rows


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


def _adc_lists(gen, m, dtype, long_rows=2500, pad=None):
    """Inverted lists [n, M] on the card with empty lists, a list longer
    than a block's 2048 lanes and ragged ones, the groups that probe
    them, a LUT per group and (pad) a pad that is a multiple of
    nothing."""
    sizes = torch.tensor([0, long_rows, 1, 255, 256, 257, 700, 0, 33])
    offs = torch.cat([torch.zeros(1, dtype=torch.int64), sizes.cumsum(0)])
    n = int(offs[-1])
    codes = torch.randint(0, 256, (n, m), generator=gen,
                          device=gen.device).to(dtype)
    lists = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 8, 1, 0, 6])
    starts = offs[lists].to(torch.int32).to(gen.device)
    ends = offs[lists + 1].to(torch.int32).to(gen.device)
    lut = torch.randn(len(lists), m, 256, generator=gen, device=gen.device)
    return codes, starts, ends, lut, pad or long_rows + 7


@pytest.mark.parametrize("m", [1, 8, 96, 97, 300, 304])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_adc_list_form_matches_the_dense_form(cuda, m, dtype):
    """The list form against the dense form on the padded gather: the
    same bits on every valid lane, +inf on every other; both within
    1e-5 * |want| + 1e-4 of f64.  M = 97 (rows off 16 bytes: the plain
    path), 300 and 304 (m-tiles, on the plain and the 16-byte path for
    uint8 codes), int32 codes, empty lists and a list longer than a
    block's share."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m)
    codes, starts, ends, lut, pad = _adc_lists(gen, m, dtype)
    before = CK.LAUNCHES.get("adc_score_lists")
    got = TK.adc_score_lists(codes, starts, ends, lut, pad)
    torch.cuda.synchronize()
    assert CK.LAUNCHES.get("adc_score_lists") == before + 1
    assert CK.LAUNCHES.shapes("adc_score_lists")[(len(starts), pad, m)] >= 1
    lane = torch.arange(pad, device=cuda)
    cand = starts.long()[:, None] + lane
    valid = cand < ends.long()[:, None]
    gathered = codes[torch.where(valid, cand, 0)].contiguous()
    dense = TK.adc_score(gathered, lut)
    assert got.shape == (len(starts), pad) and got.dtype == torch.float32
    assert torch.equal(got, torch.where(valid, dense, float("inf")))
    want = CK.adc_score_plain(gathered, lut.double())
    assert bool(((got.double() - want).abs()[valid]
                 <= (1e-5 * want.abs() + 1e-4)[valid]).all())
    # a pad shorter than the long list cuts it, as the plain version does
    cut = TK.adc_score_lists(codes, starts, ends, lut, 1000)
    assert torch.equal(cut, got[:, :1000])


def test_adc_list_form_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """Inputs the kernel does not take raise, and so does a launch whose
    grid the card refuses (past 2^31 - 1 blocks): the binding raises
    before it allocates or launches."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    codes, starts, ends, lut, pad = _adc_lists(gen, 8, torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        CK.adc_score_lists(codes.cpu(), starts, ends, lut, pad)
    with pytest.raises(ValueError, match="CUDA"):
        CK.adc_score_lists(codes, starts.cpu(), ends, lut, pad)
    with pytest.raises(TypeError):
        CK.adc_score_lists(codes, starts.long(), ends, lut, pad)
    with pytest.raises(ValueError):
        CK.adc_score_lists(codes, starts[:-1], ends, lut, pad)
    with pytest.raises(ValueError):
        CK.adc_score_lists(codes[:, :4].contiguous(), starts, ends, lut, pad)
    before = CK.LAUNCHES.get("adc_score_lists")
    with pytest.raises(RuntimeError, match="grid"):
        CK.adc_score_lists(codes, starts[:1].contiguous(),
                           ends[:1].contiguous(), lut[:1].contiguous(),
                           2048 << 31)
    assert CK.LAUNCHES.get("adc_score_lists") == before
    assert CK.adc_score_lists(codes, starts, ends, lut, 0).shape == \
        (len(starts), 0)


@pytest.mark.parametrize("n,b,d", [(4480, 256, 768), (1000, 3, 65),
                                   (130, 64, 16), (1024, 256, 768),
                                   (1024, 32, 768), (65, 257, 769),
                                   (131072, 256, 8)])
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
    for name in ("adc_score_lists", "l2_distance_sq"):
        assert after.get(name, 0) > before.get(name, 0), name
    assert after.get("adc_score", 0) == before.get("adc_score", 0)
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
        a[: n // 5] = a[0].item()
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


@pytest.mark.parametrize("stride", [1, 2, 13, 257])
@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_sorted_search_tree_edges_bit_identical(cuda, stride, offset):
    """The sample tree's edges, bit for bit against the plain version: n
    just below, at and above stride times the sample count S = 2^14 - 1
    (where the stride steps) and S + 1 past the step below it, a run of
    equal keys starting just before, at or after a sample and crossing
    several, keys at 0, 2^63 - 1, 2^63 and 2^64 - 1, m of no particular
    size."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(stride * 10 + offset + 1)
    cap = (1 << CK.SORTED_SEARCH_LEVELS) - 1
    for n in (stride * cap + offset, (stride - 1) * cap + 1 + offset):
        if n < 1:
            continue
        srt = _hashes(gen, n)
        step = CK.sorted_search_plan(n)[0]
        if n > 4 * step + 8:
            at = 2 * step + offset
            srt[at:at + 2 * step + 1] = srt[at].item()
        srt[:2] = 0
        if n > 4:
            srt[2:4] = torch.tensor([(1 << 63) - 1, -(1 << 63)],
                                    device=cuda)
        srt = srt[torch.argsort(unsigned_order(srt), stable=True)]
        q = torch.cat([torch.tensor([0, 1, -1, (1 << 63) - 1, -(1 << 63)],
                                    device=cuda), srt[:300007],
                       srt[:300007] + 1, srt[:300007] - 1]).contiguous()
        got = CK.sorted_search(srt.contiguous(), q)
        torch.cuda.synchronize()
        assert torch.equal(got, CK.sorted_search_plain(srt, q)), n


@pytest.mark.parametrize("n,m", [(196608, 1 << 20), (262144, 524288),
                                 ((1 << 22), 100003)])
def test_sorted_search_at_q3_and_budget_shapes(cuda, n, m):
    """Q3's build sizes and the join's 2^22-row budget, with queries in
    runs as a probe side sends them, bit for bit."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n + m)
    srt = _hashes(gen, n)
    reps = torch.randint(1, 8, (m,), generator=gen, device=cuda)
    keys = torch.where(torch.rand(m, generator=gen, device=cuda) < 0.5,
                       srt[torch.randint(0, n, (m,), generator=gen,
                                         device=cuda)],
                       torch.randint(-(1 << 63), (1 << 63) - 1, (m,),
                                     generator=gen, device=cuda))
    q = torch.repeat_interleave(keys, reps)[:m].contiguous()
    got = TK.sorted_lookup(srt, q)
    torch.cuda.synchronize()
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
    with pytest.raises(RuntimeError):       # a tree past shared memory
        CK.build().sorted_search(s, s, 1, 10, 15)
    with pytest.raises(RuntimeError):
        CK.build().sorted_search(s, s, 1, 10, 3)
    assert CK.LAUNCHES.get("sorted_search") == before


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


def _segsum_walk(v, g, m, G):
    """(segment_sum(v, g, m, G), the head row of the walk its launch
    counted: 0-3 for the 16-byte walk, -1 for the scalar one)."""
    before = CK.LAUNCHES.shapes("segment_sum_walk")
    out = CK.segment_sum(v, g, m, G)
    after = CK.LAUNCHES.shapes("segment_sum_walk")
    (head,), = [k for k, c in after.items() if c != before.get(k, 0)]
    return out, head


def _segsum_edge(gen, case: str, n: int = 1 << 20):
    """(values, gids, mask, G) of one edge input, integer-valued: zipf,
    gids Zipf-skewed (s = 1.2) over 4096 groups; offset3, three views at
    a common offset of 3 elements (the vector walk from its head row);
    offset_mixed, views at offsets 1, 0, 1 (the scalar walk);
    out_of_range, unmasked gids of -1, G and 2^31 - 1; nan_inf, masked
    rows holding NaN and +-inf and one unmasked NaN in group 7."""
    dev = "cuda"
    v = torch.randint(0, 16, (n + 4,), generator=gen,
                      device=dev).to(torch.float32)
    m = torch.rand(n + 4, generator=gen, device=dev) < 0.8
    if case == "zipf":
        rank = torch.arange(1, 4097, device=dev, dtype=torch.float64)
        g = torch.multinomial(rank ** -1.2, n + 4, replacement=True,
                              generator=gen).to(torch.int32)
        return v[:n], g[:n], m[:n], 4096
    g = torch.randint(0, 1000, (n + 4,), generator=gen, device=dev,
                      dtype=torch.int32)
    if case == "offset3":
        return v[3:n + 3], g[3:n + 3], m[3:n + 3], 1000
    if case == "offset_mixed":
        return v[1:n + 1], g[:n], m[1:n + 1], 1000
    v, g, m = v[:n].clone(), g[:n].clone(), m[:n].clone()
    if case == "out_of_range":
        g[::7] = -1
        g[1::11] = 1000
        g[2::13] = (1 << 31) - 1
        return v, g, m, 1000
    assert case == "nan_inf"
    m[::5] = False
    v[::5] = float("nan")
    v[1::10] = float("inf")
    v[6::10] = float("-inf")
    m[1::10] = m[6::10] = False
    v[8], m[8], g[8] = float("nan"), True, 7
    return v, g, m, 1000


@pytest.mark.parametrize("case", ["zipf", "offset3", "offset_mixed",
                                  "out_of_range", "nan_inf"])
def test_segment_sum_edge_inputs_match_plain_version(cuda, case):
    """Skewed, unaligned, out-of-range and NaN/inf inputs give the plain
    version's answer exactly (integer-valued sums below 2^24): NaN only in
    the unmasked NaN's group, masked values nowhere."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(31)
    v, g, m, G = _segsum_edge(gen, case)
    got, head = _segsum_walk(v, g, m, G)
    assert head == {"offset3": 1, "offset_mixed": -1}.get(case, 0)
    want = CK.segment_sum_plain(v.double(), g, m, G)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert int(torch.isnan(want).sum()) == (case == "nan_inf")
    keep = ~torch.isnan(want)
    assert torch.equal(got[keep].double(), want[keep])


@pytest.mark.parametrize("g", [1, 19, 1000, 4096])
def test_segment_sum_same_bits_on_every_launch(cuda, g):
    """Five launches on 6M N(0,1) values give the same bits: no float
    atomic decides the order of a sum."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(g)
    n = 6_000_000
    v = torch.randn(n, generator=gen, device=cuda)
    gids = torch.randint(0, g, (n,), generator=gen, device=cuda,
                         dtype=torch.int32)
    m = torch.rand(n, generator=gen, device=cuda) < 0.8
    first = CK.segment_sum(v, gids, m, g)
    for _ in range(4):
        assert torch.equal(CK.segment_sum(v, gids, m, g).view(torch.int32),
                           first.view(torch.int32))


@pytest.mark.parametrize("n", [100, 1 << 20])
@pytest.mark.parametrize("g", [19, 4096])
def test_segment_sum_writes_every_slot(cuda, n, g):
    """The output (and scratch) come from the allocator unset: blocks of
    their sizes are filled with NaN and freed just before the call, and
    every slot still holds the plain version's sum (empty groups +0.0)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n + g)
    v = torch.randint(0, 16, (n,), generator=gen,
                      device=cuda).to(torch.float32)
    gids = torch.randint(0, g, (n,), generator=gen, device=cuda,
                         dtype=torch.int32)
    m = torch.rand(n, generator=gen, device=cuda) < 0.5
    want = CK.segment_sum_plain(v.double(), gids, m, g)
    for size in (g, 132 * g):
        junk = torch.full((size,), float("nan"), device=cuda)
        del junk
        got = CK.segment_sum(v, gids, m, g)
        assert torch.equal(got.double(), want)
    empty = want == 0
    assert bool((got[empty] == 0).all())
    assert not bool(torch.signbit(got[empty]).any())


def test_segment_sum_n0_launches_nothing(cuda):
    """n = 0 returns G zeros and launches nothing."""
    v = torch.zeros(0, device=cuda)
    gids = torch.zeros(0, dtype=torch.int32, device=cuda)
    m = torch.zeros(0, dtype=torch.bool, device=cuda)
    before = CK.LAUNCHES.snapshot()
    out = CK.segment_sum(v, gids, m, 64)
    torch.cuda.synchronize()
    assert CK.LAUNCHES.snapshot() == before
    assert out.shape == (64,) and bool((out == 0).all())


@pytest.mark.parametrize("n", [2, 4097])
@pytest.mark.parametrize("ov,og,om", [(0, 0, 0), (1, 1, 1), (3, 3, 3),
                                      (4, 4, 4), (1, 0, 1), (0, 0, 2)])
def test_segment_sum_walk_follows_the_views_alignment(cuda, ov, og, om, n):
    """Views at their own element offsets: the kernel takes the 16-byte
    walk from the first row where values and gids lie on 16 bytes and the
    mask on 4 when one row serves all three (found here by a search of
    the four candidate rows), else the scalar walk; either way it gives
    the plain version's sums exactly."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n + ov)
    v = torch.randint(0, 16, (n + 4,), generator=gen,
                      device=cuda).to(torch.float32)[ov:ov + n]
    g = torch.randint(0, 1000, (n + 4,), generator=gen, device=cuda,
                      dtype=torch.int32)[og:og + n]
    m = (torch.rand(n + 4, generator=gen, device=cuda) < 0.8)[om:om + n]
    want = next((h for h in range(4)
                 if (v.data_ptr() + 4 * h) % 16 == 0
                 and (g.data_ptr() + 4 * h) % 16 == 0
                 and (m.data_ptr() + h) % 4 == 0), -1)
    got, head = _segsum_walk(v, g, m, 1000)
    assert head == want
    if ov == og == om:
        assert head == (-ov) % 4
    assert torch.equal(got.double(),
                       CK.segment_sum_plain(v.double(), g, m, 1000))


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


@pytest.mark.parametrize("with_null", [True, False])
def test_dense_lane_partials_on_the_card_match_the_cpu(cuda, with_null):
    """int64 lanes and rows exact, f64 lanes within rtol 1e-12, with
    narrow int8 codes, NULL keys, masked rows and per-lane masks."""
    from matrixone_tpu_torch.ops import agg as A
    n = 1 << 20
    g = torch.Generator().manual_seed(7 + with_null)

    def rnd(*shape):
        return torch.rand(*shape, generator=g)
    codes = [torch.randint(0, s, (n,), generator=g).to(torch.int8)
             for s in (3, 2)]
    valids = [rnd(n) < (0.95 if with_null else 1.0) for _ in range(2)]
    lane_mask = rnd(n) < 0.9
    args = (codes, valids, rnd(n) < 0.97,
            [None, torch.randint(-10 ** 9, 10 ** 9, (n,), generator=g)],
            [lane_mask, None],
            [torch.randn(n, generator=g, dtype=torch.float64) * 1e3,
             torch.randn(n, generator=g).float()],
            [None, lane_mask])
    kw = {"sizes": (3, 2), "with_null": with_null}
    host = A.dense_lane_partials(*args, **kw)

    def on(a):
        if isinstance(a, (list, tuple)):
            return [on(x) for x in a]
        return None if a is None else a.to(cuda)
    got = [t.cpu() for t in A.dense_lane_partials(*on(args), **kw)]
    assert torch.equal(got[0], host[0]) and torch.equal(got[2], host[2])
    torch.testing.assert_close(got[1], host[1], rtol=1e-12, atol=0)


@pytest.mark.parametrize("with_null", [True, False])
def test_dense_f64_lanes_same_bits_on_5_launches(cuda, with_null):
    """The f64 lanes (block sums over the rows sorted by slot, no
    atomics) give the same bits on 5 launches at Q1's layout and 6M
    rows, within rtol 1e-12 of the CPU."""
    from matrixone_tpu_torch.ops import agg as A
    n = 6_000_000
    g = torch.Generator().manual_seed(11 + with_null)
    codes = [torch.randint(0, s, (n,), generator=g).to(torch.int8)
             for s in (3, 2)]
    valids = [torch.rand(n, generator=g) < (0.99 if with_null else 1.0)
              for _ in range(2)]
    lane_mask = torch.rand(n, generator=g) < 0.9
    floats = [torch.randn(n, generator=g, dtype=torch.float64) * 1e4
              for _ in range(3)]
    args = (codes, valids, torch.rand(n, generator=g) < 0.98, [], [],
            floats, [None, lane_mask, lane_mask])
    kw = {"sizes": (3, 2), "with_null": with_null}
    host = A.dense_lane_partials(*args, **kw)[1]

    def on(a):
        if isinstance(a, (list, tuple)):
            return [on(x) for x in a]
        return None if a is None else a.to(cuda)
    card = on(args)
    runs = [A.dense_lane_partials(*card, **kw)[1].cpu() for _ in range(5)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    torch.testing.assert_close(runs[0], host, rtol=1e-12, atol=0)


def test_dense_f64_lanes_same_bits_at_the_dense_cap(cuda):
    """At the dense path's widest layout (one key of 255 codes and its
    NULL slot: 256 slots, by 16 f64 lanes) the lanes give the same bits
    on 5 launches, each slot within 1e-12 of its summed magnitudes from
    the CPU's sum (the card and the CPU reduce in other orders, and a
    slot's sum of 4096 values of 1e4 can cancel to near 0, past any
    relative bound)."""
    from matrixone_tpu_torch.ops import agg as A
    n = 1 << 20
    g = torch.Generator().manual_seed(12)
    codes = [torch.randint(0, 255, (n,), generator=g).to(torch.int16)]
    valids = [torch.rand(n, generator=g) < 0.99]
    row_mask = torch.rand(n, generator=g) < 0.98
    floats = [torch.randn(n, generator=g, dtype=torch.float64) * 1e4
              for _ in range(16)]
    args = (codes, valids, row_mask, [], [], floats, [None] * 16)
    kw = {"sizes": (255,), "with_null": True}
    host = A.dense_lane_partials(*args, **kw)[1]
    magnitude = A.dense_lane_partials(
        codes, valids, row_mask, [], [], [f.abs() for f in floats],
        [None] * 16, **kw)[1]

    def on(a):
        if isinstance(a, (list, tuple)):
            return [on(x) for x in a]
        return None if a is None else a.to(cuda)
    card = on(args)
    runs = [A.dense_lane_partials(*card, **kw)[1].cpu() for _ in range(5)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    assert ((runs[0] - host).abs() <= 1e-12 * magnitude).all()


def _spill_tables():
    """A probe side of 20000 rows (duplicate and NULL keys, strings) and
    a 3000-row build side, in 4096-row batches."""
    from torch_scripts import insert_sql
    f = [(i, None if i % 11 == 7 else i % 400, f"t{i % 5}", i % 100)
         for i in range(20000)]
    d = [(None if i % 13 == 5 else i % 550, f"n{i % 7}", i)
         for i in range(3000)]
    return ["create table f (id bigint, k bigint, tag varchar(8), v bigint)",
            insert_sql("f", f),
            "create table d (k bigint, name varchar(8), w bigint)",
            insert_sql("d", d),
            "set batch_rows = 4096"]


SPILL_SQL = [
    "select f.id, d.w from f join d on f.k = d.k order by f.id, d.w",
    "select f.id, d.name from f left join d on f.k = d.k"
    " order by f.id, d.name",
    "select count(*) from f where exists (select 1 from d where d.k = f.k)",
    "select count(*) from f where not exists (select 1 from d"
    " where d.k = f.k)",
    "select d.name, sum(f.v), count(*) from f join d on f.k = d.k"
    " group by d.name order by d.name",
    "select f.id, d.w from f join d on f.tag = d.name"
    " where f.id < 300 order by f.id, d.w",
]


@pytest.mark.parametrize("fusion", ["0", "1"])
@pytest.mark.parametrize("sql", SPILL_SQL)
def test_spilled_join_on_the_card_equals_the_unspilled(cuda, monkeypatch,
                                                       sql, fusion):
    """A join whose build passes a 256-row budget spills to the host and
    gives the rows of the unspilled run on the card and of the CPU, fused
    (the fused join hands the spill to its JoinOp) and per-operator."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.utils import metrics as M
    monkeypatch.setenv("MO_FUSION_MIN_ROWS", "0")
    monkeypatch.delenv("MO_PLAN_FUSION", raising=False)
    card, host = Session(), Session(device="cpu")
    for st in _spill_tables() + [f"set plan_fusion = {fusion}"]:
        card.execute(st)
        host.execute(st)
    want = card.execute(sql).rows()
    s0 = M.join_spills.get()
    for sess in (card, host):
        sess.variables["join_build_budget"] = 256
    got = card.execute(sql).rows()
    assert M.join_spills.get() > s0
    assert got == want
    assert host.execute(sql).rows() == want


def test_spilled_group_by_on_the_card_equals_the_unspilled(cuda,
                                                           monkeypatch):
    """5c's float GROUP BY shape (an integer key, f32 sums on the segment
    sum) past a 1024-group budget in 8 partitions: exact counts and
    integer sums, float sums within rtol 1e-4 / atol 1e-3 of the
    unspilled run; the segment sum launches in the partitions."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.serving import serving_for
    from matrixone_tpu_torch.utils import metrics as M
    from matrixone_tpu_torch.vm import operators as O
    from torch_scripts import insert_sql
    rng = np.random.default_rng(5)
    rows = [(i, i % 6000, float(rng.integers(0, 16)),
             float(rng.standard_normal())) for i in range(40000)]
    card = Session()
    card.execute("create table v (id bigint, grp bigint, xi float,"
                 " xn float)")
    card.execute(insert_sql("v", rows))
    sql = ("select grp, count(*), sum(xi), sum(xn) from v group by grp"
           " order by grp")
    want = card.execute(sql).rows()
    orig = O.AggOp.__init__

    def tiny(self, node, child, **kw):
        kw.update(max_groups=256, max_device_groups=1024,
                  spill_partitions=8)
        orig(self, node, child, **kw)
    monkeypatch.setattr(O.AggOp, "__init__", tiny)
    # a cached tree holds the AggOps built before the patch
    monkeypatch.setattr(serving_for(card.catalog).plan_cache, "enabled",
                        False)
    a0 = M.agg_spills.get()
    CK.LAUNCHES.reset()
    got = card.execute(sql).rows()
    assert M.agg_spills.get() > a0
    assert CK.LAUNCHES.get("segment_sum") > 0
    assert [r[:3] for r in got] == [r[:3] for r in want]
    np.testing.assert_allclose([r[3] for r in got], [r[3] for r in want],
                               rtol=1e-4, atol=1e-3)


def test_tpch_on_the_card_matches_the_cpu_and_the_oracles(cuda):
    """Q1 on the dense path (by the AggOp's counter) and Q6 at 40K
    lineitem rows give the CPU session's rows and pass `q1_check` and
    the integer oracle; the 22 queries of `tpch_full` at sf 0.004 equal
    sqlite3's rows and the CPU session's."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.storage.engine import Engine
    from matrixone_tpu_torch.utils import metrics as M
    from matrixone_tpu_torch.utils import tpch, tpch_full
    eng = Engine()
    lineitem = tpch.load_lineitem(eng, 40_000, seed=1)
    card, host = Session(catalog=eng), Session(catalog=eng, device="cpu")
    card.variables["batch_rows"] = host.variables["batch_rows"] = 16384
    dense0 = M.agg_chunks.get(path="dense")
    rows = card.execute(tpch.Q1_SQL).rows()
    assert M.agg_chunks.get(path="dense") - dense0 == 3
    assert tpch.q1_check(rows, tpch.q1_oracle(lineitem))
    assert rows == host.execute(tpch.Q1_SQL).rows()
    rows = card.execute(tpch.Q6_SQL).rows()
    li = lineitem
    sel = (li["l_shipdate"] >= 8766) & (li["l_shipdate"] < 9131) & \
          (li["l_discount"] >= 5) & (li["l_discount"] <= 7) & \
          (li["l_quantity"] < 2400)
    rev = int((li["l_extendedprice"][sel].astype(object)
               * li["l_discount"][sel]).sum())
    assert abs(rows[0][0] - rev / 10000) < 1e-9
    assert rows == host.execute(tpch.Q6_SQL).rows()
    eng = Engine()
    conn = tpch_full.to_sqlite(tpch_full.load_tpch(eng, sf=0.004, seed=1))
    card, host = Session(catalog=eng), Session(catalog=eng, device="cpu")
    for q in sorted(tpch_full.QUERIES):
        tpch_full.run_compare(card, conn, q)
        sql = tpch_full.QUERIES[q]
        assert (tpch_full.normalize_rows(card.execute(sql).rows())
                == tpch_full.normalize_rows(host.execute(sql).rows())), q


def _dml_script():
    """CREATE, INSERT (strings, DATEs, DECIMALs, NULLs), an UPDATE of a
    DECIMAL column, a DELETE, a join over the tombstoned table, a
    rolled-back transaction, and reads between them."""
    rows_c = ", ".join(
        f"({i}, {'null' if i % 13 == 0 else repr(f'n{i % 37}')}, "
        f"{'null' if i % 11 == 0 else f'{i * 1.25:.2f}'}, "
        f"'{2020 + i % 5}-0{1 + i % 9}-{10 + i % 19}', "
        f"{'null' if i % 7 == 0 else repr(f'x{i % 3}')})"
        for i in range(1, 2001))
    rows_o = ", ".join(f"({1 + (7 * j) % 2000}, {j % 50})"
                       for j in range(3000))
    full = "select id, name, price, d, note from c order by id"
    return [
        "create table c (id int primary key, name varchar(20), "
        "price decimal(12,2), d date, note varchar(10))",
        f"insert into c values {rows_c}",
        "create table o (cid int, qty bigint)",
        f"insert into o values {rows_o}",
        full,
        "update c set price = price * 3 + 0.07 where id % 5 = 0",
        "update c set price = price / 7 where id % 6 = 1 and price / 3 > 20",
        "delete from c where id % 9 = 0",
        full,
        "#join",
        "select c.name, count(*), sum(o.qty), sum(c.price), min(c.d) "
        "from c join o on c.id = o.cid group by c.name order by c.name",
        "begin",
        "insert into c values (5000, 'late', 1.01, '2030-01-01', null)",
        "update c set price = 0 where id < 500",
        "delete from c where id > 1500",
        "select count(*), sum(price) from c",
        "rollback",
        "select count(*), sum(price), count(name), count(note) from c",
        full]


def test_dml_on_the_card_matches_the_cpu(cuda):
    """The write path's plans on the card give the CPU session's rows
    and counts, statement for statement; the join over the tombstoned
    table launches the sorted search."""
    from matrixone_tpu_torch.frontend import Session
    outs = {}
    for dev in ("cuda", "cpu"):
        s = Session() if dev == "cuda" else Session(device="cpu")
        assert s.device.type == dev
        out = []
        for sql in _dml_script():
            if sql == "#join":
                CK.LAUNCHES.reset()
                continue
            r = s.execute(sql)
            out.append((r.rows(), r.affected))
            if dev == "cuda" and sql.startswith("select c.name"):
                assert CK.LAUNCHES.get("sorted_search") > 0
        outs[dev] = out
    assert outs["cuda"] == outs["cpu"]
    assert len(outs["cpu"][-1][0]) == 2000 - 2000 // 9


def _port_outcomes(device, steps):
    """Each step's outcome on a fresh port session on `device`, the
    Sample seed counter reset first (the draws must be the CPU's)."""
    import itertools
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.sql import binder
    from torch_scripts import run_step
    binder._sample_seed = itertools.count(1)
    s = Session(device=device)
    return [run_step(s, st.lstrip("!")) for st in steps]


def _executor_cases():
    from torch_scripts import BUILTINS, SETOPS, WINDOW
    for group, cases in (("window", WINDOW), ("setops", SETOPS),
                         ("builtins", BUILTINS)):
        for name in cases:
            yield f"{group}:{name}"


@pytest.mark.parametrize("case", list(_executor_cases()))
def test_executor_script_on_the_card_matches_the_cpu(cuda, case):
    """The window, set-operation and function scripts of the CPU tests
    on a CUDA session give the CPU session's outcomes: rows exact, float
    window sums and averages within rtol 1e-4 / atol 1e-3 and vector
    distances within 1e-12, the same exception classes."""
    import torch_scripts as TS
    group, name = case.split(":")
    steps = {"window": TS.WINDOW, "setops": TS.SETOPS,
             "builtins": TS.BUILTINS}[group][name]
    tol = {"window": (1e-4, 1e-3),
           "builtins": (1e-12, 1e-12)}.get(group, (None, None))
    want = _port_outcomes("cpu", steps)
    got = _port_outcomes("cuda", steps)
    for step, g, w in zip(steps, got, want):
        assert (w[0] == "err") == step.startswith("!"), (step, w)
        assert TS.same_outcome(g, w, *tol), (step, g, w)


def test_full_outer_join_on_the_card_launches_the_sorted_search(cuda):
    """FULL OUTER over 20K x 12K rows with duplicate and NULL keys: the
    probe goes through the sorted-search kernel, and the rows, the
    unmatched build rows included, are the CPU session's."""
    from matrixone_tpu_torch.frontend import Session
    from torch_scripts import insert_sql
    rng = np.random.default_rng(9)
    a = [(i, None if i % 31 == 0 else int(rng.integers(0, 9000)))
         for i in range(20_000)]
    b = [(i, None if i % 29 == 0 else int(rng.integers(6000, 15000)))
         for i in range(12_000)]
    steps = ["create table fa (id bigint, k bigint)",
             "create table fb (id bigint, k bigint)",
             insert_sql("fa", a), insert_sql("fb", b),
             "set batch_rows = 8192"]
    sql = ("select count(*), sum(case when fa.id is null then 1 else 0 "
           "end), sum(case when fb.id is null then 1 else 0 end), "
           "sum(fa.id), sum(fb.id) from fa full outer join fb "
           "on fa.k = fb.k")
    rows = {}
    for dev in ("cpu", "cuda"):
        s = Session(device=dev)
        for st in steps:
            s.execute(st)
        CK.LAUNCHES.reset()
        rows[dev] = s.execute(sql).rows()
        if dev == "cuda":
            assert CK.LAUNCHES.get("sorted_search") > 0
    assert rows["cuda"] == rows["cpu"]
    ka = {k for _, k in a if k is not None}
    kb = {k for _, k in b if k is not None}
    only_b = sum(1 for _, k in b if k is None or k not in ka)
    only_a = sum(1 for _, k in a if k is None or k not in kb)
    assert rows["cpu"][0][1:3] == (only_b, only_a)


# ------------------------------------------- fused fragments (CUDA graphs)

@pytest.fixture
def fused_everywhere(cuda, monkeypatch):
    """Every batch takes the fused path (MO_FUSION_MIN_ROWS=0)."""
    monkeypatch.setenv("MO_FUSION_MIN_ROWS", "0")
    monkeypatch.delenv("MO_PLAN_FUSION", raising=False)
    return cuda


def _fusion_tables():
    """`ft`: 5000 rows in five 1024-row scan batches; `fd`: a build
    side with NULL keys; `fdup`: three keys of 20 duplicates each, past
    the probe's max_matches of 4."""
    from torch_scripts import insert_sql
    rng = np.random.default_rng(17)
    ft = [(i, int(rng.integers(0, 60)) if i % 17 else None,
           ["aa", "bb", "cc", "dd"][i % 4] if i % 23 else None,
           float(rng.standard_normal()), round(float(rng.random()) * 90, 2))
          for i in range(5000)]
    fd = [(k if k % 7 else None, f"n{k % 5}", k * 3) for k in range(80)]
    return ["create table ft (id bigint, k bigint, g varchar(4), x double,"
            " q decimal(12,2))",
            insert_sql("ft", ft),
            "create table fd (k bigint, name varchar(4), w bigint)",
            insert_sql("fd", fd),
            "create table fdup (k bigint, z bigint)",
            insert_sql("fdup", [(i % 3, i) for i in range(60)]),
            "set batch_rows = 1024"]


FUSED_CARD_SQL = [
    # dense grouped terminal over a dict key: decimal sums exact
    "select g, count(*) c, sum(q) sq, avg(q) aq, sum(x) sx from ft"
    " where k > 3 group by g order by g",
    # scalar terminal (step0, then stepN over the carry)
    "select count(*), sum(q), min(x), max(k), avg(x) from ft where k < 50",
    # a stream fragment feeding a sort, and a fused LIMIT
    "select id, x * 2 y from ft where g like 'b%' and k > 10 order by id",
    "select id from ft where x > 0 limit 7",
    # LIMIT counters carried across three, four and five batches (each
    # replay's count is the next replay's input)
    "select id from ft where x > 2.5 limit 20",
    "select id from ft where k > 3 limit 10 offset 3000",
    "select ft.id, fd.w from ft join fd on ft.k = fd.k where ft.x > 1.5"
    " limit 5 offset 250",
    # the top-k terminal over five batches
    "select id, x from ft order by x desc, id limit 9",
    # join probe fragments: stream, grouped carry, semi and anti
    "select ft.id, fd.w from ft join fd on ft.k = fd.k order by ft.id",
    "select fd.name, sum(ft.q) s, count(*) n from ft join fd"
    " on ft.k = fd.k group by fd.name order by fd.name",
    "select count(*) from ft where exists (select 1 from fd"
    " where fd.k = ft.k)",
    "select count(*) from ft where not exists (select 1 from fd"
    " where fd.k = ft.k)",
    # the duplicate fan-out re-run, stream and under a grouped carry
    "select ft.id, fdup.z from ft join fdup on ft.k = fdup.k"
    " order by ft.id, fdup.z",
    "select ft.g, sum(fdup.z) s, count(*) n from ft join fdup"
    " on ft.k = fdup.k group by ft.g order by ft.g",
    # a window fragment
    "select id, rank() over (partition by g order by k) r from ft"
    " order by id",
]


def _close(got, want, rtol=1e-4, atol=1e-3):
    from torch_scripts import same_outcome
    return same_outcome(("ok", None, got, None), ("ok", None, want, None),
                        rtol, atol)


@pytest.mark.parametrize("sql", FUSED_CARD_SQL)
def test_fused_fragment_graphs_match_the_eager_step(fused_everywhere, sql):
    """Each fragment captured as CUDA graphs and replayed over at least
    three batches gives the rows of the same step run eagerly (the CPU
    session's fused path) and of the per-operator path on the card:
    exact lanes equal, float lanes within rtol 1e-4 / atol 1e-3 (the
    card's f64 index_add_ and scans add in another order)."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.utils import metrics as M
    card, host = Session(), Session(device="cpu")
    for st in _fusion_tables():
        card.execute(st)
        host.execute(st)
    want = host.execute(sql).rows()
    r0 = M.fusion_graphs.get(event="replay")
    f0 = M.fusion_exec.get(mode="fused")
    got = card.execute(sql).rows()
    assert M.fusion_exec.get(mode="fused") > f0
    # the window takes one concatenated batch; a satisfied LIMIT stops
    # pulling after its first
    assert M.fusion_graphs.get(event="replay") - r0 >= (
        1 if "rank()" in sql or "limit 7" in sql else 3)
    assert _close(got, want), (got[:4], want[:4])
    card.execute("set plan_fusion = 0")
    assert _close(card.execute(sql).rows(), want)
    c0 = M.fusion_graphs.get(event="capture")
    card.execute("set plan_fusion = 1")
    assert _close(card.execute(sql).rows(), want)
    # a warm run replays the captured graphs and captures nothing, a
    # decorrelated EXISTS too (its columns are named per statement)
    assert M.fusion_graphs.get(event="capture") == c0


def test_fused_literal_change_reuses_the_graph(fused_everywhere):
    """Statements that differ only in lifted literal values replay one
    graph: no capture after the first, and each gives its own rows."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.utils import metrics as M
    card, host = Session(), Session(device="cpu")
    for st in _fusion_tables():
        card.execute(st)
        host.execute(st)
    # the float literals share one scale: a literal's DECIMAL scale is
    # part of its type, and so of the key
    sql = "select count(*), sum(q) from ft where k > {} and x < {}"
    card.execute(sql.format(1, "0.50"))
    c0 = M.fusion_graphs.get(event="capture")
    for lo, hi in ((5, "0.25"), (40, "1.75"), (1, "0.50"), (59, "0.05")):
        q = sql.format(lo, hi)
        assert card.execute(q).rows() == host.execute(q).rows(), q
    assert M.fusion_graphs.get(event="capture") == c0


def test_fused_rekeyed_dictionary_captures_again(fused_everywhere):
    """A table rebuilt with a dictionary of the same length and other
    strings keys a new graph (its baked LIKE LUT would be stale), and
    gives the new rows."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.utils import metrics as M
    from torch_scripts import insert_sql
    card = Session()
    card.execute("set batch_rows = 1024")
    sql = "select count(*) from rk where g like 'a%'"
    for strings, want in ((["aa", "bb", "cc"], 1000), (["ab", "ac", "cc"],
                                                       2000)):
        card.execute("drop table if exists rk")
        card.execute("create table rk (g varchar(4), v bigint)")
        card.execute(insert_sql("rk", [(strings[i % 3], i)
                                       for i in range(3000)]))
        c0 = M.fusion_graphs.get(event="capture")
        assert card.execute(sql).rows() == [(want,)]
        assert M.fusion_graphs.get(event="capture") > c0


def test_fused_f32_lanes_narrow_on_the_card_by_default(fused_everywhere,
                                                      monkeypatch):
    """An f32 sum under a varchar key on the card with the default
    MO_NARROW_ENCODINGS (`auto`, on for CUDA): the fused dense grouped
    terminal rounds the lane to bf16, so each sum is within the
    reference's documented 0.4% of the f64 sum and not within 1e-4 of it
    (every x sits 0.003 above a bf16 step and rounds down).  With
    MO_NARROW_ENCODINGS=0 the fused rows are the per-operator rows
    (within rtol 1e-4 / atol 1e-3: the card's f64 lanes add in another
    order) and the f64 sums."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.utils import metrics as M
    from torch_scripts import insert_sql
    monkeypatch.delenv("MO_NARROW_ENCODINGS", raising=False)
    rng = np.random.default_rng(23)
    x = (1 + rng.integers(0, 128, 4000) / 128 + 0.003).astype(np.float32)
    g = [f"g{i % 7}" for i in range(4000)]
    card = Session()
    card.execute("create table nv (g varchar(4), x float)")
    card.execute(insert_sql("nv", [(g[i], float(x[i]))
                                   for i in range(4000)]))
    card.execute("set batch_rows = 1024")
    sql = "select g, sum(x) sx, count(*) n from nv group by g order by g"
    want = {}
    for gi, xi in zip(g, x.astype(np.float64)):
        want[gi] = want.get(gi, 0.0) + xi
    f0 = M.fusion_exec.get(mode="fused")
    narrowed = card.execute(sql).rows()
    assert M.fusion_exec.get(mode="fused") > f0
    assert [r[0] for r in narrowed] == sorted(want)
    assert [r[2] for r in narrowed] == [g.count(k) for k in sorted(want)]
    for gk, sx, _n in narrowed:
        rel = abs(sx - want[gk]) / want[gk]
        assert 1e-4 < rel <= 0.004, (gk, sx, want[gk])
    monkeypatch.setenv("MO_NARROW_ENCODINGS", "0")
    wide = card.execute(sql).rows()
    card.execute("set plan_fusion = 0")
    perop = card.execute(sql).rows()
    assert _close(wide, perop)
    assert _close(wide, [(k, want[k], g.count(k)) for k in sorted(want)])


def test_fused_cache_keeps_its_graphs_under_the_byte_bound(
        fused_everywhere, monkeypatch):
    """With the cache's byte bound at one byte, every capture evicts all
    older entries: the cache keeps one entry, its graphs hold what
    `stats()` says, evicted graphs are counted, and every query still
    gives the CPU session's rows (a later run captures again)."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.utils import metrics as M
    from matrixone_tpu_torch.vm import fusion
    monkeypatch.setattr(fusion.FragmentCompileCache, "max_held_bytes",
                        staticmethod(lambda device: 1))
    fusion.CACHE.clear()
    card, host = Session(), Session(device="cpu")
    for st in _fusion_tables():
        card.execute(st)
        host.execute(st)
    ev0 = M.fusion_graphs.get(event="evict")
    for sql in FUSED_CARD_SQL[:4] + FUSED_CARD_SQL[:2]:
        assert _close(card.execute(sql).rows(), host.execute(sql).rows())
        # the CPU session's entries hold no graph
        held = [e for e in fusion.CACHE._lru.snapshot() if e["graphs"]]
        assert len(held) == 1, len(held)
        assert fusion.CACHE.stats()["held_bytes"] > 0
    assert M.fusion_graphs.get(event="evict") - ev0 >= 5


def test_sorted_search_in_a_graph_is_the_plain_search(cuda):
    """The sorted-search kernel captured in a CUDA graph: each replay's
    positions equal `sorted_search_plain` on the replay's inputs, bit
    for bit, and each replay counts one launch."""
    from matrixone_tpu_torch.vm.graphs import StepGraph
    g = torch.Generator(device=cuda).manual_seed(5)
    n, m = 196608, 1 << 18

    def inputs():
        s = torch.randint(-2 ** 62, 2 ** 62, (n,), generator=g,
                          device=cuda)
        s = s[torch.argsort(unsigned_order(s))]
        q = torch.randint(-2 ** 62, 2 ** 62, (m,), generator=g,
                          device=cuda)
        q[: m // 2] = s[torch.randint(0, n, (m // 2,), generator=g,
                                      device=cuda)]
        return s, q

    step = StepGraph(lambda s, q: (TK.sorted_lookup(s, q),))
    for i in range(4):
        s, q = inputs()
        before = CK.LAUNCHES.get("sorted_search")
        (out,) = step((s, q))
        torch.cuda.synchronize()
        assert CK.LAUNCHES.get("sorted_search") - before == (2 if i == 0
                                                              else 1)
        assert torch.equal(out, CK.sorted_search_plain(s, q))
    assert step.replays == 4


# ------------------------------- object-backed segments (the device tier)

def _object_backed(tmp_path, rows=20_000, batches=3, sub="obj"):
    """`big` (id, grp, val, f, g) in `batches` commits of `rows` rows,
    checkpointed and demoted to object-backed segments on a LocalFS,
    with some rows deleted before the checkpoint; the block cache
    cold."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.storage import blockcache
    from matrixone_tpu_torch.storage.engine import Engine
    from matrixone_tpu_torch.storage.fileservice import LocalFS
    eng = Engine(LocalFS(str(tmp_path / sub)))
    s = Session(catalog=eng, device="cpu")
    s.execute("create table big (id bigint, grp bigint, val bigint, "
              "f double, g varchar(4))")
    rng = np.random.default_rng(23)
    t = eng.get_table("big")
    for b in range(batches):
        ids = np.arange(b * rows, (b + 1) * rows, dtype=np.int64)
        t.insert_numpy({"id": ids, "grp": ids % 7, "val": ids * 3,
                        "f": rng.standard_normal(rows)},
                       strings={"g": (rng.integers(0, 3, rows),
                                      ["x", "y", "z"])})
    s.execute("delete from big where id % 1000 = 7")
    eng.checkpoint(demote=True)
    assert all(seg.is_lazy for seg in t.segments)
    blockcache.CACHE.clear()
    blockcache.CACHE.reset_stats()
    return eng


OBJ_SQL = ("select grp, g, count(*), sum(val), sum(f) from big "
           "where id >= 100 group by grp, g order by grp, g")


@pytest.fixture
def cache_env(cuda, monkeypatch):
    for v in ("MO_BLOCK_CACHE_MB", "MO_DEVICE_CACHE_MB",
              "MO_BLOCK_CACHE_DISABLE", "MO_SCAN_PREFETCH"):
        monkeypatch.delenv(v, raising=False)
    yield cuda
    from matrixone_tpu_torch.storage import blockcache
    blockcache.CACHE.clear()


def test_warm_object_backed_scan_uploads_nothing(cache_env, tmp_path):
    """After one cold scan every column lives in the device tier as a
    CUDA tensor; a warm scan decodes and uploads nothing, and its rows
    are the CPU session's."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.storage import blockcache
    eng = _object_backed(tmp_path)
    card = Session(catalog=eng)
    card.execute("set plan_fusion = 0")
    want = Session(catalog=eng, device="cpu").execute(OBJ_SQL).rows()
    assert _close(card.execute(OBJ_SQL).rows(), want)
    blockcache.CACHE.reset_stats()
    for _ in range(2):
        assert _close(card.execute(OBJ_SQL).rows(), want)
    st = blockcache.CACHE.stats()
    assert st["uploaded_bytes"] == 0 and st["decode_seconds"] == 0.0, st
    assert st["device_tier"]["hit_rate"] == 1.0, st
    cuda_keys = [k for k in blockcache.CACHE._dev if k[-1].startswith(
        "cuda")]
    assert cuda_keys
    for k in cuda_keys:
        assert blockcache.CACHE._dev[k].is_cuda


def test_cold_fused_scan_with_read_ahead_captures(cache_env, tmp_path,
                                                  monkeypatch):
    """A cold fused scan over 3+ batches with the read-ahead thread on:
    the thread decodes into the host tier only, so the steps' graphs
    capture while it runs; the rows are the CPU session's, warm too."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.utils import metrics as M
    monkeypatch.setenv("MO_FUSION_MIN_ROWS", "0")
    monkeypatch.setenv("MO_SCAN_PREFETCH", "2")
    monkeypatch.delenv("MO_PLAN_FUSION", raising=False)
    eng = _object_backed(tmp_path)
    host = Session(catalog=eng, device="cpu")
    card = Session(catalog=eng)
    for s in (host, card):
        s.execute("set batch_rows = 8192")
    sqls = [OBJ_SQL,
            "select count(*), sum(val), min(f), max(id) from big "
            "where grp < 5"]
    wants = [host.execute(q).rows() for q in sqls]
    from matrixone_tpu_torch.storage import blockcache
    blockcache.CACHE.clear()
    c0 = M.fusion_graphs.get(event="capture")
    r0 = M.fusion_graphs.get(event="replay")
    p0 = M.scan_prefetch.get(outcome="ready") + \
        M.scan_prefetch.get(outcome="waited")
    for q, want in zip(sqls, wants):
        assert _close(card.execute(q).rows(), want), q
    assert M.fusion_graphs.get(event="capture") > c0
    assert M.fusion_graphs.get(event="replay") - r0 >= 3
    assert M.scan_prefetch.get(outcome="ready") + \
        M.scan_prefetch.get(outcome="waited") - p0 >= 3
    c1 = M.fusion_graphs.get(event="capture")
    for q, want in zip(sqls, wants):
        assert _close(card.execute(q).rows(), want), q
    assert M.fusion_graphs.get(event="capture") == c1


def test_device_tier_eviction_holds_a_1mb_budget(cache_env, tmp_path,
                                                  monkeypatch):
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.storage import blockcache
    monkeypatch.setenv("MO_DEVICE_CACHE_MB", "1")
    eng = _object_backed(tmp_path)
    card = Session(catalog=eng)
    card.execute("set plan_fusion = 0")
    want = Session(catalog=eng, device="cpu").execute(OBJ_SQL).rows()
    for _ in range(2):
        assert _close(card.execute(OBJ_SQL).rows(), want)
        dev = blockcache.CACHE.stats()["device_tier"]
        assert dev["used_bytes"] <= 1 << 20, dev
    st = blockcache.CACHE.stats()
    assert st["device_tier"]["evictions"] > 0
    assert st["device_tier"]["peak_bytes"] <= 1 << 20
    assert st["host_tier"]["evictions"] == 0


def test_drop_path_after_a_merge_leaves_no_stale_tensor(cache_env,
                                                        tmp_path):
    """A merge and its fence GC drop the merged-away objects' tensors
    from the device tier; the merged table's rows stay the CPU's."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.storage import blockcache
    eng = _object_backed(tmp_path)
    card = Session(catalog=eng)
    card.execute("set plan_fusion = 0")
    host = Session(catalog=eng, device="cpu")
    card.execute(OBJ_SQL).rows()
    old = {seg.obj_path for seg in eng.get_table("big").segments}
    assert any(k[1] in old for k in blockcache.CACHE._dev)
    card.execute("delete from big where id < 50")
    assert eng.merge_table("big") > 0
    assert eng.gc_fences()["released"] == 1
    assert not any(k[1] in old for k in blockcache.CACHE._dev)
    assert not any(k[1] in old for k in blockcache.CACHE._host)
    assert _close(card.execute(OBJ_SQL).rows(),
                  host.execute(OBJ_SQL).rows())
    assert card.execute("select count(*) from big where id < 100"
                        ).rows() == [(50,)]


# ---------------------------------------------- serving on the card


def _q3_engine(n=60_000):
    """TPC-H Q3's tables at sf 0.01 (lineitem 60000 rows) in an
    in-memory engine."""
    from matrixone_tpu_torch.storage.engine import Engine
    from matrixone_tpu_torch.utils import tpch
    eng = Engine()
    tpch.load_lineitem(eng, n, seed=3)
    tpch.load_tpch_q3(eng, n // 4, seed=3)
    return eng


def test_tree_reuse_of_fused_q3_equals_a_fresh_compile(fused_everywhere):
    """Fused Q3 over 4 probe batches, 3 segment values, through the plan
    cache's reused tree: each run equals a fresh compile (plan cache
    off) on the card and the CPU session; a second round reuses the
    tree and replays the probe graphs without capturing."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.serving import serving_for
    from matrixone_tpu_torch.utils import metrics as M
    from matrixone_tpu_torch.utils import tpch
    sql = tpch.Q3_SQL.replace("'BUILDING'", "?")
    values = ["MACHINERY", "AUTOMOBILE", "BUILDING"]
    eng = _q3_engine()
    card = Session(catalog=eng)
    host = Session(catalog=eng, device="cpu")
    for s in (card, host):
        s.execute("set batch_rows = 16384")
    want = [host.execute(sql, [v]).rows() for v in values]
    card.execute(sql, ["HOUSEHOLD"])        # notes the template
    got = [card.execute(sql, [v]).rows() for v in values]
    t0 = M.plan_cache_ops.get(outcome="tree_hit")
    c0 = M.fusion_graphs.get(event="capture")
    r0 = M.fusion_graphs.get(event="replay")
    again = [card.execute(sql, [v]).rows() for v in values]
    assert M.plan_cache_ops.get(outcome="tree_hit") - t0 == 3
    assert M.fusion_graphs.get(event="capture") == c0
    assert M.fusion_graphs.get(event="replay") - r0 >= 3 * 4
    sv = serving_for(eng)
    sv.plan_cache.enabled = False
    try:
        fresh = [card.execute(sql, [v]).rows() for v in values]
    finally:
        sv.plan_cache.enabled = True
    for g, a, f, w in zip(got, again, fresh, want):
        assert g == a == f
        assert _close(g, w)
    assert len({str(g) for g in got}) == 3


def test_concurrent_fused_statements_equal_the_serial_rows(
        fused_everywhere):
    """Four threads, each its own session on one engine, run the same
    fused statements with their own parameters 20 times: every result
    equals the serial run's, no capture fails and nothing runs eagerly
    (a thread that finds its key's graph owned captures a spare)."""
    import threading
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.utils import metrics as M
    card = Session()
    for st in _fusion_tables():
        card.execute(st)
    sqls = ["select g, count(*) c, sum(q) sq, avg(q) aq from ft"
            " where k > ? group by g order by g",
            "select fd.name, sum(ft.q) s, count(*) n from ft join fd"
            " on ft.k = fd.k where ft.x > ? group by fd.name"
            " order by fd.name",
            "select id from ft where k > ? limit 20"]
    params = [[3], [17], [29], [41]]
    serial = {(i, t): card.execute(q, p).rows()
              for i, q in enumerate(sqls) for t, p in enumerate(params)}
    e0 = M.fusion_exec.get(mode="eager")
    d0 = M.fusion_dispatch.get(kind="eager")
    errors, mismatches = [], []

    def worker(t):
        s = Session(catalog=card.catalog)
        s.execute("set batch_rows = 1024")
        try:
            for _ in range(20):
                for i, q in enumerate(sqls):
                    got = s.execute(q, params[t]).rows()
                    if got != serial[(i, t)]:
                        mismatches.append((t, i))
        except Exception as e:      # noqa: BLE001 — asserted below
            errors.append(repr(e))
        finally:
            s.close()
    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    assert not errors, errors[:3]
    assert not mismatches, mismatches[:5]
    assert M.fusion_exec.get(mode="eager") == e0
    assert M.fusion_dispatch.get(kind="eager") == d0


def test_result_cache_hit_is_host_and_survives_replays(fused_everywhere):
    """A result-cache hit returns the host columns of the first run;
    later executions of the same fused graph with other parameters
    (which rewrite the graph's outputs) leave them unchanged."""
    from matrixone_tpu_torch.frontend import Session
    card = Session()
    for st in _fusion_tables():
        card.execute(st)
    card.execute("select mo_ctl('serving','result:on')")
    sql = "select id, x * 2 y from ft where k > ? and g = 'aa' order by id"
    first = card.execute(sql, [5])
    rows = first.rows()
    for col in first.batch.columns.values():
        assert isinstance(col.data, np.ndarray)
    for lo in (10, 20, 30, 40):
        card.execute(sql, [lo])
    hit = card.execute(sql, [5])
    assert hit.batch is first.batch
    assert hit.rows() == rows == first.rows()
    card.execute("select mo_ctl('serving','result:off')")


def test_object_read_fault_in_the_read_ahead_raises_cleanly(
        cache_env, tmp_path, monkeypatch):
    """An `object.read` fault hit by the read-ahead thread of a cold
    fused scan reaches the query as its error; the next query answers
    with the CPU session's rows and no read-ahead thread is left."""
    import threading
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.storage import blockcache
    from matrixone_tpu_torch.utils.fault import INJECTOR
    monkeypatch.setenv("MO_FUSION_MIN_ROWS", "0")
    monkeypatch.setenv("MO_SCAN_PREFETCH", "2")
    eng = _object_backed(tmp_path)
    host = Session(catalog=eng, device="cpu")
    card = Session(catalog=eng)
    for s in (host, card):
        s.execute("set batch_rows = 8192")
    want = host.execute(OBJ_SQL).rows()
    card.plan(OBJ_SQL)
    blockcache.CACHE.clear()
    INJECTOR.add("object.read", "return", "fail", every=4)
    try:
        with pytest.raises(IOError, match="object.read"):
            card.execute(OBJ_SQL)
    finally:
        INJECTOR.clear()
    assert not any(t.name == "mo-scan-prefetch" and t.is_alive()
                   for t in threading.enumerate())
    assert _close(card.execute(OBJ_SQL).rows(), want)
    assert _close(card.execute(OBJ_SQL).rows(), want)


def test_tree_reuse_rekeys_baked_string_parameters(fused_everywhere):
    """A string parameter the fused step bakes (the scan's deferred
    `g = ?`) re-keys the fragment through a reused tree: each value over
    five batches gives the CPU session's rows, a value seen before
    replays its own graph, and a second round captures nothing.  An IN
    list of parameters is uncacheable, as in the reference (the binder
    folds its values), and runs right all the same."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.utils import metrics as M
    card, host = Session(), Session(device="cpu")
    for st in _fusion_tables():
        card.execute(st)
        host.execute(st)
    cases = [("select count(*), sum(q) s, max(k) from ft where g = ?"
              " and k > 3", [["aa"], ["bb"], ["cc"], ["dd"]], True),
             ("select g, count(*) c, sum(x) sx from ft where g in (?, ?)"
              " group by g order by g",
              [["aa", "bb"], ["cc", "dd"], ["bb", "cc"]], False)]
    for sql, vals, cacheable in cases:
        # the CPU session's runs count in the same process-wide counters:
        # take its rows first
        want = [host.execute(sql, v).rows() for v in vals]
        card.execute(sql, vals[-1])           # notes the template
        t0 = M.plan_cache_ops.get(outcome="tree_hit")
        for v, w in zip(vals, want):
            assert _close(card.execute(sql, v).rows(), w), (sql, v)
        assert M.plan_cache_ops.get(outcome="tree_hit") - t0 == \
            (len(vals) - 1 if cacheable else 0)
        c0 = M.fusion_graphs.get(event="capture")
        r0 = M.fusion_graphs.get(event="replay")
        for v, w in zip(vals, want):
            assert _close(card.execute(sql, v).rows(), w), (sql, v)
        assert M.fusion_graphs.get(event="capture") == c0
        assert M.fusion_graphs.get(event="replay") - r0 >= 5 * len(vals)


#: (SQL with `?` parameters, the warm-up's values, three runs' values):
#: tests/test_torch_serving.py's tree-reuse cases, on the card
TPCH_PARAM_CARD = {
    "q1": ("Q1_SQL", ("where l_shipdate", "where l_quantity >= ? and"
                      " l_shipdate"), [1], [[3], [10], [25]]),
    "q3": ("Q3_SQL", ("'BUILDING'", "?"), ["BUILDING"],
           [["MACHINERY"], ["AUTOMOBILE"], ["BUILDING"]]),
    "q6": ("Q6_SQL", ("0.05 and 0.07", "? and ?"), [0.05, 0.07],
           [[0.02, 0.04], [0.06, 0.08], [0.01, 0.09]]),
    "group_by": (None, None, [0], [[100], [7000], [31000]]),
}


@pytest.fixture(scope="module")
def tpch_card_engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from matrixone_tpu_torch.container import dtypes as dt
    from matrixone_tpu_torch.storage.engine import TableMeta
    eng = _q3_engine()
    rng = np.random.default_rng(5)
    ids = np.arange(60_000, dtype=np.int64)
    eng.create_table(TableMeta("v", [("id", dt.INT64), ("grp", dt.INT64),
                                     ("xi", dt.FLOAT32), ("xn", dt.FLOAT32)],
                               ["id"]))
    eng.get_table("v").insert_numpy(
        {"id": ids, "grp": ids % 1000,
         "xi": rng.integers(0, 16, 60_000).astype(np.float32),
         "xn": rng.standard_normal(60_000).astype(np.float32)})
    return eng


@pytest.mark.parametrize("path", ["fused", "per_operator"])
@pytest.mark.parametrize("query", sorted(TPCH_PARAM_CARD))
def test_tree_reuse_on_the_card_equals_a_fresh_compile(
        tpch_card_engine, monkeypatch, query, path):
    """Q1, Q3, Q6 and 5c's GROUP BY at sf 0.01 through the plan cache's
    reused tree on the card, 16384-row batches (4+ of lineitem), three
    parameter values: each equals a fresh compile on the card (plan
    cache off) and the CPU session; the three runs take the tree
    twice."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.serving import serving_for
    from matrixone_tpu_torch.utils import metrics as M
    from matrixone_tpu_torch.utils import tpch
    monkeypatch.setenv("MO_FUSION_MIN_ROWS", "0")
    name, swap, warm, runs = TPCH_PARAM_CARD[query]
    if name is None:
        sql = ("select grp, sum(xi), sum(xn) from v where id >= ?"
               " group by grp order by grp")
    else:
        sql = getattr(tpch, name).replace(*swap)
        if query == "q6":
            sql = sql.replace("< 24", "< ?")
            warm = warm + [24]
            runs = [r + [q] for r, q in zip(runs, (30, 12, 40))]
    eng = tpch_card_engine
    sv = serving_for(eng)
    sv.plan_cache.clear()
    host = Session(catalog=eng, device="cpu")
    card = Session(catalog=eng)
    for s in (host, card):
        s.execute("set batch_rows = 16384")
        s.variables["plan_fusion"] = 1 if path == "fused" else 0
    sv.plan_cache.enabled = False
    try:
        want = [host.execute(sql, p).rows() for p in runs]
        fresh = [card.execute(sql, p).rows() for p in runs]
    finally:
        sv.plan_cache.enabled = True
    card.execute(sql, warm)
    t0 = M.plan_cache_ops.get(outcome="tree_hit")
    got = [card.execute(sql, p).rows() for p in runs]
    assert M.plan_cache_ops.get(outcome="tree_hit") - t0 == 2
    assert got == fresh
    for g, w in zip(got, want):
        assert _close(g, w), (g[:3], w[:3])
    assert len({str(g) for g in got}) == 3


# ------------------------------------------ vector search through SQL

def _vsql_sessions(algo, cuda, n=4000, d=64, op_type="vector_l2_ops"):
    """A CPU session that built an index over clustered rows, and a card
    session over the same tables with that index carried across
    (`convert`), both on their own engines."""
    from matrixone_tpu_torch import convert
    from matrixone_tpu_torch.frontend import Session
    rng = np.random.default_rng(31)
    centres = rng.standard_normal((16, d)).astype(np.float32)
    data = (centres[rng.integers(0, 16, n)]
            + 0.35 * rng.standard_normal((n, d))).astype(np.float32)
    host = Session(device="cpu")
    host.execute(f"create table items (id bigint primary key, "
                 f"emb vecf32({d}))")
    host.catalog.get_table("items").insert_numpy(
        {"id": np.arange(n, dtype=np.int64), "emb": data})
    host.execute(f"create index iv using {algo} on items (emb) lists = 16 "
                 f"op_type = '{op_type}'")
    eng = convert.tables_from_numpy(convert.tables_to_numpy(host.catalog))
    convert.indexes_from_numpy(convert.indexes_to_numpy(host.catalog), eng,
                               device=cuda)
    return host, Session(catalog=eng), centres, data


def _vsql(q, k=10, fn="l2_distance"):
    vec = "[" + ",".join(repr(float(x)) for x in q) + "]"
    return (f"select id, {fn}(emb, '{vec}') d from items order by d "
            f"limit {k}")


def _same_rows(got, want):
    assert [r[0] for r in got] == [r[0] for r in want], (got, want)
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("algo,op_type,fn", [
    ("ivfflat", "vector_l2_ops", "l2_distance"),
    ("ivfpq", "vector_l2_ops", "l2_distance"),
    ("ivfflat", "vector_cosine_ops", "cosine_distance")])
def test_vector_topk_on_the_card_equals_the_cpu_session(cuda, algo, op_type,
                                                        fn):
    """VectorTopK on the card over an index carried from the CPU session
    gives the CPU session's rows; the plan holds VectorTopK and the card
    launches the L2 kernel (and for IVF-PQ the ADC list form, never the
    dense form)."""
    host, card, centres, _ = _vsql_sessions(algo, cuda, op_type=op_type)
    assert card.catalog.indexes["iv"].index_obj.device.type == "cuda"
    l2 = CK.LAUNCHES.get("l2_distance_sq")
    adc = CK.LAUNCHES.get("adc_score_lists")
    dense = CK.LAUNCHES.get("adc_score")
    for q in centres[:6] + 0.1:
        sql = _vsql(q, fn=fn)
        assert "VectorTopK" in card.execute("explain " + sql).text
        _same_rows(card.execute(sql).rows(), host.execute(sql).rows())
    if op_type == "vector_l2_ops":
        assert CK.LAUNCHES.get("l2_distance_sq") >= l2 + 6
    if algo == "ivfpq":
        assert CK.LAUNCHES.get("adc_score_lists") >= adc + 6
        assert CK.LAUNCHES.get("adc_score") == dense


def test_vector_delta_on_the_card(cuda):
    """Rows inserted after the build are served from the delta segment,
    scored by the L2 kernel at (delta rows, 1, d), with the same index
    object; the CPU session doing the same gives the same rows; a DELETE
    hides them."""
    host, card, centres, _ = _vsql_sessions("ivfflat", cuda)
    ix = card.catalog.indexes["iv"]
    built = ix.index_obj
    new = centres[2] + 0.01 * np.arange(1, 31, dtype=np.float32)[:, None]
    ins = "insert into items values " + ", ".join(
        f"({10000 + i}, '[{','.join(repr(float(x)) for x in v)}]')"
        for i, v in enumerate(new))
    for s in (host, card):
        s.execute(ins)
    at = CK.LAUNCHES.shapes("l2_distance_sq").get((30, 1, 64), 0)
    sql = _vsql(centres[2])
    got = card.execute(sql).rows()
    assert {r[0] for r in got} <= set(range(10000, 10030))
    assert CK.LAUNCHES.shapes("l2_distance_sq")[(30, 1, 64)] == at + 1
    assert ix.index_obj is built and len(ix.options["_delta_gids"]) == 30
    _same_rows(got, host.execute(sql).rows())
    for s in (host, card):
        s.execute("delete from items where id >= 10000")
    got = card.execute(sql).rows()
    assert not {r[0] for r in got} & set(range(10000, 10030))
    _same_rows(got, host.execute(sql).rows())


def test_vector_index_eviction_frees_card_memory(cuda):
    """An index evicted under a small IndexCache budget releases its card
    memory, and the next query rebuilds it on the card."""
    import gc
    from matrixone_tpu_torch.vectorindex.cache import index_nbytes
    _host, card, centres, data = _vsql_sessions("ivfflat", cuda, n=20000,
                                                d=256)
    eng = card.catalog
    ix = eng.indexes["iv"]
    nbytes = index_nbytes(ix.index_obj)
    want = card.execute(_vsql(centres[0])).rows()
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    eng.index_cache.budget = 1
    card.execute("create table small (id bigint, emb vecf32(256))")
    card.catalog.get_table("small").insert_numpy(
        {"id": np.arange(100, dtype=np.int64), "emb": data[:100]})
    card.execute("create index ivs using ivfflat on small (emb) lists = 2")
    eng.index_cache.budget = 8 << 30
    gc.collect()
    assert ix.index_obj is None and ix.dirty
    assert mem0 - torch.cuda.memory_allocated() >= 0.9 * nbytes
    got = card.execute(_vsql(centres[0])).rows()
    assert ix.index_obj is not None and ix.index_obj.device.type == "cuda"
    assert [r[0] for r in got] == [r[0] for r in want]


def test_warm_knn_statement_captures_no_new_graph(fused_everywhere):
    """With every batch fused, the fragment above VectorTopK (the
    distance recomputed, then the top-k) captures on the first run; three
    warm runs of the statement capture nothing and give the same rows."""
    from matrixone_tpu_torch.utils import metrics as M
    host, card, centres, _ = _vsql_sessions("ivfflat", fused_everywhere)
    sql = _vsql(centres[3])
    before = M.fusion_graphs.get(event="capture")
    first = card.execute(sql).rows()
    c0 = M.fusion_graphs.get(event="capture")
    assert c0 > before
    for _ in range(3):
        assert card.execute(sql).rows() == first
    assert M.fusion_graphs.get(event="capture") == c0
    _same_rows(first, host.execute(sql).rows())


# ------------------------------------------ HNSW, full text, llm_embed

def _ft_corpus(n=3000, seed=41):
    """Zipf-drawn documents, a tenth of them duplicated (BM25 ties)."""
    rng = np.random.default_rng(seed)
    words = [f"t{i}" for i in range(400)]
    p = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    p /= p.sum()
    texts = [" ".join(rng.choice(words, rng.integers(3, 30), p=p))
             for _ in range(n)]
    return texts + texts[:n // 10], words


def test_fulltext_scores_and_top_k_on_the_card_equal_the_cpu(cuda):
    """The postings on the card score every document as the plain CPU
    scoring does (the card's division within rtol 1e-5), and the top k
    orders ties by position, as the CPU does."""
    from matrixone_tpu_torch import fulltext as FT
    texts, words = _ft_corpus()
    host = FT.build(texts, device="cpu")
    card = FT.build(texts, device=cuda)
    assert card.doc_idx.device.type == "cuda"
    ties = 0
    for q in ["t0", "t5 t17", "t3 t3 t250", "t399", "nothing here",
              " ".join(words[40:43])]:
        s_h = FT.score_all(host, q)
        s_c = FT.score_all(card, q)
        np.testing.assert_allclose(s_c, s_h, rtol=1e-5, atol=1e-7)
        for k in (1, 10, 400):
            v_h, i_h = FT.search(host, q, k)
            v_c, i_c = FT.search(card, q, k)
            # positions equal where the CPU's scores are not within the
            # card's tolerance of a neighbour's
            close = np.isclose(v_h[:-1], v_h[1:], rtol=1e-5, atol=0) & \
                (v_h[:-1] != v_h[1:])
            if not close.any():
                np.testing.assert_array_equal(i_c, i_h)
            ties += int((v_h[:-1] == v_h[1:]).sum())
    assert ties > 0


def _search_sessions(cuda):
    """A CPU and a card session, each with its own engine, loaded with
    the same rows and indexes (built in each)."""
    from matrixone_tpu_torch.frontend import Session
    rng = np.random.default_rng(43)
    data = rng.standard_normal((2000, 32)).astype(np.float32)
    texts, _ = _ft_corpus(800)
    out = []
    for dev in ("cpu", cuda):
        s = Session(device=dev)
        s.execute("create table hv (id bigint primary key, emb vecf32(32))")
        s.catalog.get_table("hv").insert_numpy(
            {"id": np.arange(len(data), dtype=np.int64), "emb": data})
        s.execute("create index hn using hnsw on hv (emb) m = 12 "
                  "ef_construction = 48")
        s.execute("create table docs (id bigint primary key, body text)")
        s.catalog.get_table("docs").insert_numpy(
            {"id": np.arange(len(texts), dtype=np.int64)},
            strings={"body": (np.arange(len(texts)), texts)})
        s.execute("create index ft using fulltext on docs (body)")
        out.append(s)
    return out[0], out[1], data


def test_hnsw_and_match_statements_on_the_card_equal_the_cpu(cuda):
    host, card, data = _search_sessions(cuda)
    assert card.catalog.indexes["ft"].index_obj.device.type == "cuda"
    for q in data[:5] + 0.05:
        sql = _vsql(q).replace("items", "hv")
        assert "VectorTopK" in card.execute("explain " + sql).text
        _same_rows(card.execute(sql).rows(), host.execute(sql).rows())
    for q in ("t1", "t7 t30", "t2 t2 t9", "t350"):
        sql = (f"select id, match(body) against ('{q}') sc from docs "
               f"order by sc desc limit 10")
        assert "FulltextTopK" in card.execute("explain " + sql).text
        _same_rows(card.execute(sql).rows(), host.execute(sql).rows())


def test_fulltext_index_eviction_frees_card_memory(cuda):
    """The full-text postings evicted under a small budget release their
    card memory; the next MATCH statement rebuilds them on the card."""
    import gc
    from matrixone_tpu_torch.vectorindex.cache import index_nbytes
    _host, card, _data = _search_sessions(cuda)
    eng = card.catalog
    ix = eng.indexes["ft"]
    nbytes = index_nbytes(ix.index_obj)
    assert nbytes > 0 and index_nbytes(eng.indexes["hn"].index_obj) == 0
    sql = ("select id, match(body) against ('t4 t11') sc from docs "
           "order by sc desc limit 10")
    want = card.execute(sql).rows()
    eng.index_cache.touch(eng.indexes["hn"])
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    eng.index_cache.budget = 1
    card.execute("create table small (id bigint, body text)")
    card.execute("insert into small values (1, 'a b'), (2, 'b c')")
    card.execute("create index fs using fulltext on small (body)")
    eng.index_cache.budget = 8 << 30
    gc.collect()
    assert ix.index_obj is None and ix.dirty
    assert mem0 - torch.cuda.memory_allocated() >= 0.9 * nbytes
    got = card.execute(sql).rows()
    assert ix.index_obj is not None and ix.index_obj.device.type == "cuda"
    _same_rows(got, want)


def test_llm_embed_in_a_fused_step_gathers_on_the_card(fused_everywhere):
    """llm_embed over a dictionary column inside a captured step: one
    call per distinct text, every row the endpoint's vector for its
    text, a warm run captures nothing."""
    import http.server
    import json
    import threading
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.utils import metrics as M
    calls = []

    def vec(text):
        return [float(len(text) + i * 0.25) for i in range(8)]

    class H(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):     # noqa: N802
            pass

        def do_POST(self):             # noqa: N802
            req = json.loads(self.rfile.read(
                int(self.headers.get("Content-Length", 0))))
            calls.append(req["text"])
            body = json.dumps({"embedding": vec(req["text"])}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        s = Session(device=fused_everywhere)
        s.execute(f"set llm_endpoint = 'http://127.0.0.1:"
                  f"{srv.server_address[1]}/card'")
        s.execute("set llm_embed_dim = 8")
        texts = [f"text number {i:03d}" + "x" * (i % 7) for i in range(40)]
        codes = np.random.default_rng(5).integers(0, 40, 5000)
        s.execute("create table e (id bigint, txt varchar(40))")
        s.catalog.get_table("e").insert_numpy(
            {"id": np.arange(5000, dtype=np.int64)},
            strings={"txt": (codes, texts)})
        sql = "select id, llm_embed(txt) from e"
        rows = s.execute(sql).rows()
        assert sorted(calls) == sorted(texts)
        for i, v in rows:
            assert list(v) == vec(texts[codes[i]])
        c0 = M.fusion_graphs.get(event="capture")
        assert s.execute(sql).rows() == rows
        assert M.fusion_graphs.get(event="capture") == c0
        assert len(calls) == len(texts)
    finally:
        srv.shutdown()
        srv.server_close()


# ------------------------------------------------------------- ingest

def _ingest_sessions():
    from matrixone_tpu_torch.frontend import Session
    return Session(device="cuda"), Session(device="cpu")


def test_load_data_of_a_3_row_csv_on_the_card(cuda, tmp_path):
    """LOAD DATA through a stage on a CUDA session: the rows a CPU
    session loads from the same file, scanned on the card."""
    (tmp_path / "people.csv").write_text(
        'id,name,age,price\n1,ann,30,12.50\n2,"b,o",25,3.01\n3,cy,,100.99\n')
    rows = []
    for s in _ingest_sessions():
        s.execute(f"create stage st url = 'file://{tmp_path}'")
        s.execute("create table people (id bigint primary key, "
                  "name varchar(16), age bigint, price decimal(15,2))")
        r = s.execute("load data infile 'stage://st/people.csv' into "
                      "table people")
        assert r.affected == 3
        rows.append(s.execute("select id, name, age, price from people "
                              "where age is null or age > 26 order by id"
                              ).rows())
        s.close()
    assert rows[0] == rows[1] == [(1, "ann", 30, 12.5),
                                  (3, "cy", None, 100.99)]


def _ingest_csvs(tmp_path, n_cust=3000, seed=3):
    """customer and orders of `tpch_full`'s generator at a small scale,
    written as CSV the way chip_smoke.py's phase 15 writes them."""
    import chip_smoke
    from matrixone_tpu_torch.utils import tpch_full
    tables = tpch_full.gen_tpch(sf=n_cust / 150_000, seed=seed)
    for name in ("customer", "orders"):
        chip_smoke.write_tpch_csv(str(tmp_path / f"{name}.csv"), name,
                                  tables[name])
    return tables


def test_ingest_join_on_the_card_and_its_sorted_search(fused_everywhere,
                                                        tmp_path):
    """chip_smoke.py's phase-15 join at a small size: loaded customer and
    orders and an external orders table give the CPU session's rows on
    the card; every sorted search the runs made (graph replays
    included) equals its plain version on its own inputs."""
    import chip_smoke
    _ingest_csvs(tmp_path)
    outs = []
    for s in _ingest_sessions():
        for st in chip_smoke.ingest_ddl(str(tmp_path)):
            s.execute(st)
        outs.append(s)
    seen = []
    real = TK.sorted_lookup

    def lookup(srt, q):
        out = real(srt, q)
        if srt.is_cuda:
            seen.append((srt, q, out))
        return out
    TK.sorted_lookup = lookup
    try:
        CK.LAUNCHES.reset()
        cuda_rows = [outs[0].execute(chip_smoke.INGEST_JOIN_SQL.format(
            orders=t)).rows() for t in ("orders", "orders", "orders_x")]
        torch.cuda.synchronize()
    finally:
        TK.sorted_lookup = real
    cpu_rows = outs[1].execute(chip_smoke.INGEST_JOIN_SQL.format(
        orders="orders")).rows()
    assert cuda_rows[0] == cuda_rows[1] == cuda_rows[2] == cpu_rows
    assert CK.LAUNCHES.get("sorted_search") > 0 and seen
    for srt, q, out in seen:
        assert torch.equal(out, CK.sorted_search_plain(srt, q))
    for s in outs:
        s.close()


def test_external_csv_table_scanned_on_the_card(cuda, tmp_path):
    """An external CSV table on a CUDA session: the scan uploads its
    chunks to the card and gives the CPU session's rows, cold and from
    the decoded-chunk cache."""
    lines = ["id,grp,v,name"] + [
        f"{i},{'' if i % 11 == 0 else i % 5},{i * 0.25},n{i % 3}"
        for i in range(5000)]
    (tmp_path / "e.csv").write_text("\n".join(lines) + "\n")
    sql = ("select grp, name, count(*), sum(v), sum(id) from e "
           "where id >= 100 group by grp, name order by grp, name")
    rows = []
    for s in _ingest_sessions():
        s.variables["batch_rows"] = 1024
        s.execute(f"create external table e (id bigint, grp int, v double, "
                  f"name varchar(4)) location '{tmp_path}/e.csv'")
        rows.append([s.execute(sql).rows() for _ in range(2)])
        s.close()
    assert rows[0][0] == rows[0][1] == rows[1][0]


def test_topk_smallest_captures_in_a_graph(cuda):
    """`ops/topk.topk_smallest` makes no host sync: it captures in a CUDA
    graph, and each replay keeps the lowest tied positions, as on the
    CPU, with NaN of either sign (ranked after +inf) and +-0.0 among
    the scores."""
    from matrixone_tpu_torch.ops.topk import topk_smallest
    nan = float("nan")
    table = torch.tensor([0.0, 1.0, 2.0, nan, -0.0], device=cuda)
    table = torch.cat([table, -table[3:4]])          # a NaN, sign set

    def draw(seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        return table[torch.randint(0, 6, (64, 100), device=cuda,
                                   generator=g)]

    x = draw(99)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        topk_smallest(x, 10)                       # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        v, i = topk_smallest(x, 10)
    for seed in range(3):
        x.copy_(draw(seed))
        graph.replay()
        torch.cuda.synchronize()
        cv, ci = topk_smallest(x.cpu(), 10)
        assert torch.equal(i.cpu(), ci)
        assert torch.equal(v.cpu().nan_to_num(7.0), cv.nan_to_num(7.0))
    assert int(i.max()) < 100


# ------------------------------- UDFs, materialized views, the canary

#: JAX's result dtypes with 64-bit mode on, for the operations whose
#: torch defaults differ (the CPU tests hold the shim to JAX itself)
SHIM_DTYPES = {
    ("int32", "x / x"): "float32", ("int32", "x * 2.0"): "float64",
    ("int32", "x + 1"): "int32", ("int32", "jnp.sqrt(x)"): "float32",
    ("int32", "jnp.sum(x)"): "int64", ("int32", "jnp.mean(x)"): "float32",
    ("int32", "jnp.where(x > 0, 1, 0) * x"): "int32",
    ("int32", "round(x)"): "int64", ("int32", "x ** 0.5"): "float64",
    ("int32", "jnp.minimum(x, 1.5)"): "float64",
    ("int64", "x / x"): "float64", ("int64", "jnp.sqrt(x)"): "float64",
    ("int64", "jnp.mean(x)"): "float64", ("int64", "x // 2"): "int64",
    ("float32", "x * 2.0"): "float32", ("float32", "x + 1"): "float32",
    ("float32", "jnp.exp(x)"): "float32", ("bool", "x / x"): "float32",
    ("bool", "x * 2.0"): "float64", ("bool", "x + 1"): "int64",
    ("bool", "x ** 2"): "int32", ("bool", "jnp.sum(x)"): "int64"}


def test_udf_shim_dtypes_and_refusals_on_the_card(cuda):
    import math

    from matrixone_tpu_torch.udf import jnp
    ns = jnp.namespace()
    cols = {"int32": [1, -2, 3], "int64": [1, -2, 3],
            "float32": [1.5, -2.0, 3.0], "bool": [True, False, True]}
    for (cname, expr), want in SHIM_DTYPES.items():
        dt_ = getattr(torch, cname)
        out = {}
        for dev in ("cuda", "cpu"):
            x = jnp.Array(torch.tensor(cols[cname], dtype=dt_,
                                       device=dev), traced=True)
            with jnp.on_device(dev):
                out[dev] = eval(expr, {"jnp": ns, "x": x})   # noqa: S307
        assert str(out["cuda"].dtype) == want, (cname, expr)
        assert out["cuda"]._t.is_cuda
        torch.testing.assert_close(out["cuda"]._t.cpu(), out["cpu"]._t,
                                   equal_nan=True)
    x = jnp.Array(torch.arange(4.0, device=cuda), traced=True)
    for refuse in (lambda: bool(x > 1), lambda: float(x[0]),
                   lambda: int(x[0]), lambda: x.item(), lambda: x.tolist(),
                   lambda: np.asarray(x), lambda: np.exp(x),
                   lambda: math.exp(x[0]), lambda: x[x > 1],
                   lambda: range(x[0])):
        with pytest.raises(TypeError):
            refuse()


def _udf_on(device, body, n, pad, seed):
    """One eval_udf_call of `body` over n rows padded to `pad` on
    `device` (a fresh compile cache: the tier is decided anew) ->
    (values, validity, tier), or ("error", class name)."""
    from matrixone_tpu_torch.container import device as tdev, dtypes as tdt
    from matrixone_tpu_torch.sql import binder
    from matrixone_tpu_torch.sql.expr import BoundCol
    from matrixone_tpu_torch.udf import catalog as ucat, executor as uexec
    from matrixone_tpu_torch.vm.exprs import ExecBatch
    uexec.COMPILE_CACHE.clear()
    rng = np.random.default_rng(seed)
    arrays = {"a": rng.integers(-50, 50, n).astype(np.int64),
              "b": np.round(rng.normal(0, 3, n), 3),
              "c": np.round(rng.normal(0, 2, n), 2).astype(np.float32)}
    valid = {k: rng.random(n) > 0.2 for k in "abc"}
    dtypes = {"a": tdt.INT64, "b": tdt.FLOAT64, "c": tdt.FLOAT32}
    db = tdev.from_numpy(arrays, dtypes, valid, n_rows=n, pad_to=pad,
                         device=device)
    ex = ExecBatch(batch=db, dicts={}, mask=db.row_mask())
    u = ucat.UdfMeta("g", "scalar", ["x", "y", "z"],
                     [dtypes[c] for c in "abc"], tdt.FLOAT64, "python",
                     body, True, True)
    call = binder._bind_udf_call(u, [BoundCol(c, dtypes[c]) for c in "abc"])
    try:
        col = uexec.eval_udf_call(call, ex)
    except Exception as e:   # noqa: BLE001 — compared by class
        return "error", type(e).__name__
    return (col.data.cpu().numpy()[:n], col.validity.cpu().numpy()[:n],
            uexec.expected_tier(call))


def _udf_card_agrees(body, n, pad, seed=0):
    import re
    got, want = (_udf_on(d, body, n, pad, seed) for d in ("cuda", "cpu"))
    if isinstance(want[0], str) or isinstance(got[0], str):
        assert got == want, (body, got, want)
        return "error"
    assert got[2] == want[2], (body, got[2], want[2])
    assert np.array_equal(got[1], want[1]), body
    v = want[1]
    rtol = (1e-5 if "z" in body else
            1e-9 if re.search(r"exp|log|sqrt|tanh|power", body) else 1e-12)
    np.testing.assert_allclose(got[0][v], want[0][v], rtol=rtol, atol=1e-6,
                               equal_nan=True, err_msg=body)
    return got[2]


def test_udf_reference_bodies_take_the_same_tier_on_the_card(cuda):
    """Every body of the reference's UDF tests: the card's tier and
    values equal the CPU session's (which the CPU tests hold to the
    reference's), at padded lengths 1, 16 and 1024."""
    from torch_scripts import UDF_REFERENCE_BODIES
    for body in UDF_REFERENCE_BODIES:
        for n, pad in ((1, 1), (11, 16), (700, 1024)):
            _udf_card_agrees(body, n, pad, seed=n)


def test_udf_generated_bodies_agree_on_the_card(cuda):
    """The CPU tests' generated bodies (the same grammar and wrappers),
    on the card against the CPU: the same tier and the same values."""
    from hypothesis import HealthCheck, given, settings, strategies as st

    from torch_scripts import UDF_BINARY, UDF_LEAVES, UDF_TIER, UDF_UNARY
    exprs = st.recursive(
        st.sampled_from(UDF_LEAVES),
        lambda inner: st.one_of(
            st.builds(lambda f, e: f.format(e), st.sampled_from(UDF_UNARY),
                      inner),
            st.builds(lambda f, a, b: f.format(a, b),
                      st.sampled_from(UDF_BINARY), inner, inner)),
        max_leaves=6)

    @settings(max_examples=60, deadline=None, derandomize=True,
              suppress_health_check=[HealthCheck.too_slow,
                                     HealthCheck.function_scoped_fixture])
    @given(expr=exprs, wrap=st.sampled_from(UDF_TIER),
           pad=st.integers(1, 64), seed=st.integers(0, 1 << 16))
    def check(expr, wrap, pad, seed):
        tier = _udf_card_agrees(wrap.format(expr), pad - pad // 4, pad,
                                seed)
        assert tier in ("error", "jit" if wrap == "{}" else "row")
    check()


def test_udf_out_of_memory_on_the_card_surfaces(cuda, monkeypatch):
    """A jit-tier body that runs the card out of memory (a real failed
    allocation inside `jnp.exp`): the error surfaces, no row loop runs,
    the body keeps its jit tier, and the next call takes it."""
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.udf import executor as uexec, jnp as tjnp
    from matrixone_tpu_torch.utils import metrics as M

    def oom(x):
        torch.empty(1 << 45, dtype=torch.float64, device=cuda)  # 256 TiB
        return x
    uexec.COMPILE_CACHE.clear()
    s = Session(device="cuda")
    s.execute("create table t (b double)")
    s.execute("insert into t values (1.5), (2.5), (null)")
    s.execute("create function ex1(x double) returns double language "
              "python as $$ jnp.exp(x) $$")
    rows, fails = M.udf_rows.get(tier="row"), \
        uexec.COMPILE_CACHE.stats()["trace_failures"]
    with monkeypatch.context() as mp:
        mp.setattr(tjnp, "exp", oom)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            s.execute("select ex1(b) from t")
    assert M.udf_rows.get(tier="row") == rows
    assert uexec.COMPILE_CACHE.stats()["trace_failures"] == fails
    assert "UdfCall ex1 [jit]" in s.execute(
        "explain select ex1(b) from t").text
    uexec.COMPILE_CACHE.clear()      # the entry compiled the patched exp
    got = s.execute("select ex1(b) from t where b is not null").rows()
    np.testing.assert_allclose([r[0] for r in got], np.exp([1.5, 2.5]),
                               rtol=1e-12, atol=0.0)
    s.close()


def test_mview_dense_delta_replays_one_graph(fused_everywhere):
    """A Q1-shaped view on the card: the first delta of a padded shape
    captures the dense step as a graph, which holds work (torch warns of
    a capture that recorded nothing), every later one is ONE replay and
    nothing runs eagerly; the view equals its defining SELECT and the
    CPU session's view.  (`select * from q1` captures an empty graph:
    its fragment passes the scanned columns through, so the replay has
    nothing to do; the inputs are copied into the graph's buffers before
    it.)"""
    import warnings
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.utils import metrics as M
    q = ("select flag, status, sum(qty), avg(price), count(*) from li "
         "group by flag, status")
    outs = []
    for dev in ("cuda", "cpu"):
        s = Session(device=dev)
        s.execute("create table li (flag varchar(1), status varchar(1), "
                  "qty decimal(10,2), price double)")
        s.execute("insert into li values ('A','F',1.0,2.5),('N','O',2.0,3.5)")
        s.execute("create materialized view q1 as select flag, status, "
                  "sum(qty) sq, avg(price) ap, count(*) n from li "
                  "group by flag, status")

        def counts():
            return (M.fusion_graphs.get(event="capture"),
                    M.fusion_graphs.get(event="replay"),
                    M.mview_apply.get(tier="dense"),
                    M.fusion_dispatch.get(kind="eager"))
        c0 = counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            s.execute("insert into li values ('A','F',3.0,1.0)")
            c1 = counts()
            s.execute("insert into li values ('N','F',4.0,2.0)")
            s.execute("insert into li values ('A','O',5.0,2.5)")
            c3 = counts()
        assert not [w for w in caught
                    if "CUDA Graph is empty" in str(w.message)]
        if dev == "cuda":
            assert c1[0] - c0[0] == 1 and c1[1] - c0[1] == 1, (c0, c1)
            assert c3[0] == c1[0] and c3[1] - c1[1] == 2, (c1, c3)
            assert c3[2] - c0[2] == 3 and c3[3] == c0[3]
        rows = sorted(s.execute("select * from q1").rows())
        assert rows == sorted(s.execute(q).rows())
        outs.append(rows)
        s.close()
    assert outs[0] == outs[1]


def test_segment_sum_over_poisoned_padding(cuda):
    """The padding canary on the card: a batch uploaded armed carries NaN
    and the int canary in its padded tail; the segment sum over it is
    bit-identical to its plain version and to the unarmed upload's, and a
    GROUP BY armed equals its unarmed rows with no finding."""
    from matrixone_tpu_torch.container import device as tdev, dtypes as tdt
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.utils import qa
    rng = np.random.default_rng(5)
    n, g = 70001, 1000
    arrays = {"v": rng.integers(0, 16, n).astype(np.float32),
              "g": rng.integers(0, g, n).astype(np.int32)}
    dtypes = {"v": tdt.FLOAT32, "g": tdt.INT32}
    sums = []
    for armed in (True, False):
        with qa.armed_scope() if armed else contextlib.nullcontext():
            b = tdev.from_numpy(arrays, dtypes, n_rows=n, device=cuda)
        v, gid, m = b.columns["v"].data, b.columns["g"].data, b.row_mask()
        assert bool(torch.isnan(v[n:]).all()) == armed
        got = CK.segment_sum(v, gid, m, g)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32),
                           CK.segment_sum_plain(v, gid, m, g)
                           .view(torch.int32))
        sums.append(got)
    assert torch.equal(sums[0].view(torch.int32), sums[1].view(torch.int32))
    s = Session(device="cuda")
    s.execute("create table pz (grp int, x float)")
    s.execute("insert into pz values " + ", ".join(
        f"({i % 17}, {float(i % 7)})" for i in range(3001)))
    sql = "select grp, sum(x), count(*) from pz group by grp order by grp"
    want = s.execute(sql).rows()
    CK.LAUNCHES.reset()
    with qa.armed_scope(), qa.capture() as probe:
        got = s.execute(sql).rows()
    assert got == want and probe.findings() == []
    assert CK.LAUNCHES.get("segment_sum") > 0
    s.close()


# ------------------------------------------- device shards (slot mesh)

def _shard_sessions(device):
    """A session on `device` over `sh`: 8 inserts of 3072 rows, read in
    1024-row batches, so each of 8 shards of the chunk round robin gets
    three batches of one padded shape."""
    from matrixone_tpu_torch.frontend import Session
    s = Session(device=device)
    s.execute("create table sh (id bigint, g varchar(4), v bigint,"
              " x float)")
    rng = np.random.default_rng(23)
    for lo in range(0, 8 * 3072, 3072):
        s.execute("insert into sh values " + ", ".join(
            f"({i}, 'g{i % 5}', {i % 97}, {float(rng.standard_normal()):.6f})"
            for i in range(lo, lo + 3072)))
    s.execute("set batch_rows = 1024")
    return s


def _on_shards(s, n, sql):
    s.execute(f"set query_shards = {n}")
    s.execute("set dist_min_rows = 0")
    try:
        return s.execute(sql).rows()
    finally:
        s.execute("set query_shards = 0")


def test_eight_shards_replay_one_graph_and_keep_their_partials(
        fused_everywhere):
    """8 shards run the same captured fragment one after another (the key
    holds the exchange's shape and the device, not the shard index); each
    shard's dense partial is the graph's carry, copied out of it before
    the next shard replays it (`FusedFragmentOp._keep_partial`).  Without
    that copy the merge would add shard 7's carry 8 times and the rows
    would differ from the local ones."""
    from matrixone_tpu_torch.parallel import simulated_slots
    from matrixone_tpu_torch.utils import metrics as M
    from matrixone_tpu_torch.vm import fusion
    from matrixone_tpu_torch.vm import graphs as G
    s = _shard_sessions("cuda")
    sql = "select g, count(*), sum(v) from sh group by g order by g"
    local = s.execute(sql).rows()
    fusion.CACHE.clear()
    with simulated_slots(8):
        first = _on_shards(s, 8, sql)                # captures
        replays = max(g.replays for e in fusion.CACHE._lru.snapshot()
                      for g in G.entry_graphs(e))
        c0 = M.fusion_graphs.get(event="capture")
        d0 = M.exchange_partial_merge.get(kind="dense")
        got = _on_shards(s, 8, sql)
    assert first == got == local
    # one graph took all 8 shards' 3 batches each (its capture's replay
    # included); a graph per shard would hold 3 replays at most
    assert replays == 8 * 3
    assert M.fusion_graphs.get(event="capture") == c0
    assert M.exchange_partial_merge.get(kind="dense") == d0 + 1


def test_sharded_float_group_by_same_bits_on_five_runs(fused_everywhere):
    """A general-path f32 GROUP BY at 8 shards (the segment-sum kernel in
    every shard, one re-group merge): the same bits on 5 runs, within
    5c's tolerance of the CPU session's sharded rows."""
    from matrixone_tpu_torch.parallel import simulated_slots
    sql = ("select id % 1000 k, sum(x), count(*) from sh group by k"
           " order by k")
    s = _shard_sessions("cuda")
    before = CK.LAUNCHES.get("segment_sum")
    with simulated_slots(8):
        runs = [_on_shards(s, 8, sql) for _ in range(5)]
        cpu = _on_shards(_shard_sessions("cpu"), 8, sql)
    assert CK.LAUNCHES.get("segment_sum") - before >= 5 * 8 * 3
    assert all(r == runs[0] for r in runs[1:])
    assert [(r[0], r[2]) for r in runs[0]] == [(r[0], r[2]) for r in cpu]
    np.testing.assert_allclose([r[1] for r in runs[0]],
                               [r[1] for r in cpu], rtol=1e-4, atol=1e-3)


def test_hash_route_on_the_card_equals_the_host(cuda):
    """The scan's hash route on a chunk already on the card (the block
    cache's device tier) keeps the rows the host route keeps: splitmix64
    read unsigned, modulo the shard count, NULL to shard 0."""
    from matrixone_tpu_torch.vm import operators as O
    rng = np.random.default_rng(31)
    n, shards = 1 << 16, 8
    key = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    valid = rng.random(n) > 0.05
    for s in range(shards):
        host = O._route_keep(key, valid, shards, s)
        dev = O._route_keep(torch.from_numpy(key).to(cuda),
                            torch.from_numpy(valid).to(cuda), shards, s)
        np.testing.assert_array_equal(dev.cpu().numpy(), host)
    arrays = {"k": torch.from_numpy(key).to(cuda), "r": np.arange(n)}
    validity = {"k": torch.from_numpy(valid).to(cuda),
                "r": np.ones(n, bool)}
    a2, _v2, kept, moved = O._hash_route(arrays, validity, n,
                                         ("k", 5, shards), False)
    want = np.flatnonzero(O._route_keep(key, valid, shards, 5))
    assert kept == moved == len(want)
    np.testing.assert_array_equal(a2["r"], want)
    assert a2["k"].is_cuda


# ------------------------------------------- host peers and CN replicas

def _peer_rig(device, n_peers=2):
    """An engine of 8 inserts (8 segments), n FragmentServers on
    `device` over it, and a distribution-enabled session."""
    from matrixone_tpu_torch.cluster import FragmentServer
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.storage.engine import Engine
    eng = Engine()
    s = Session(catalog=eng, device=device)
    s.execute("create table pe (id bigint primary key, g varchar(4),"
              " k bigint, x float)")
    rng = np.random.default_rng(7)
    for lo in range(0, 8000, 1000):
        s.execute("insert into pe values " + ",".join(
            f"({i},'g{i % 6}',{i % 300},{float(rng.standard_normal()):.6f})"
            for i in range(lo, lo + 1000)))
    s.execute("create table pd (k bigint primary key, w bigint)")
    s.execute("insert into pd values " + ",".join(
        f"({k},{k % 13})" for k in range(300)))
    servers = [FragmentServer(eng, device=device).start()
               for _ in range(n_peers)]
    eng.dist_peers = [f.addr for f in servers]
    sd = Session(catalog=eng, device=device)
    sd.variables["dist_min_rows"] = 0
    sd.variables["dist_batch_rows"] = 1024
    return s, sd, servers


PEER_SQL = [
    "select g, sum(x), count(*), min(k) from pe group by g order by g",
    "select pd.w, sum(pe.k), count(*) from pe join pd on pe.k = pd.k"
    " group by pd.w order by pd.w",
    "select id, k from pe order by k desc, id limit 11",
]


def test_fragments_on_cuda_peers_give_the_cpu_rows(fused_everywhere):
    """The same statements on CUDA fragment servers and on CPU ones:
    equal rows (f32 sums within 5c's tolerance), the peers' f32 GROUP BY
    launching the segment sum and their join probes the sorted search,
    and a shuffle join as a multiset."""
    _s, sd, servers = _peer_rig("cuda")
    _cs, csd, cservers = _peer_rig("cpu")
    try:
        for sql in PEER_SQL:
            seg0 = CK.LAUNCHES.get("segment_sum")
            srch0 = CK.LAUNCHES.get("sorted_search")
            got, want = sd.execute(sql).rows(), csd.execute(sql).rows()
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    if isinstance(a, float):
                        assert abs(a - b) <= 1e-3 + 1e-4 * abs(b)
                    else:
                        assert a == b
            if "sum(x)" in sql:
                assert CK.LAUNCHES.get("segment_sum") > seg0
            if "join" in sql:
                assert CK.LAUNCHES.get("sorted_search") > srch0
        sql = "select pe.id, pd.w from pe join pd on pe.k = pd.k"
        assert sorted(sd.execute(sql).rows()) == \
            sorted(csd.execute(sql).rows())
        assert sum(f.frags_run for f in servers) == \
            sum(f.frags_run for f in cservers) > 0
    finally:
        for f in servers + cservers:
            assert f.stop() == []


def test_card_fault_in_a_peer_surfaces(fused_everywhere, monkeypatch):
    """A launch that fails inside a peer's fragment is not a reason to
    run locally: it raises at the client with the peer's error; with
    the fault gone the same statement distributes again."""
    import threading

    from matrixone_tpu_torch.parallel import fragments as FR
    from matrixone_tpu_torch.vm import fusion
    _s, sd, servers = _peer_rig("cuda")
    sql = PEER_SQL[1]
    real = CK.sorted_search
    # a graph captured by an earlier test would replay the real launch
    fusion.CACHE.clear()

    def failed_launch(*a, **k):
        if threading.current_thread().name.startswith("pt-frag-conn"):
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        return real(*a, **k)
    try:
        monkeypatch.setattr(CK, "sorted_search", failed_launch)
        with pytest.raises(FR.FragmentError, match="illegal memory"):
            sd.execute(sql)
        monkeypatch.setattr(CK, "sorted_search", real)
        fusion.CACHE.clear()
        before = sum(f.frags_run for f in servers)
        assert sd.execute(sql).rows() == _s.execute(sql).rows()
        assert sum(f.frags_run for f in servers) == before + 2
    finally:
        for f in servers:
            assert f.stop() == []


def test_cn_replica_scan_runs_on_the_card(cuda, tmp_path):
    """A TN on the card and a CN replica whose session runs on it: the
    replica's scan uploads to the card, a join launches the sorted
    search, and the rows equal a CPU session's on the same replica."""
    from matrixone_tpu_torch.cluster import RemoteCatalog, TNService
    from matrixone_tpu_torch.frontend import Session
    from matrixone_tpu_torch.sql.parser import parse_one
    from matrixone_tpu_torch.vm.compile import compile_plan
    tn = TNService(data_dir=str(tmp_path), device="cuda").start()
    cat = RemoteCatalog(("127.0.0.1", tn.port), data_dir=str(tmp_path))
    try:
        s = Session(catalog=cat, device="cuda")
        s.execute("create table ra (id bigint primary key, k bigint)")
        s.execute("create table rb (k bigint primary key, w bigint)")
        s.execute("insert into ra values " + ",".join(
            f"({i},{i % 50})" for i in range(2000)))
        s.execute("insert into rb values " + ",".join(
            f"({k},{k * 3})" for k in range(50)))
        sql = ("select rb.w, count(*) from ra join rb on ra.k = rb.k"
               " group by rb.w order by rb.w")
        op = compile_plan(s.plan_select(parse_one("select k from ra")),
                          s._ctx())
        ex = next(iter(op.execute()))
        assert all(c.data.is_cuda for c in ex.batch.columns.values())
        before = CK.LAUNCHES.get("sorted_search")
        got = s.execute(sql).rows()
        assert CK.LAUNCHES.get("sorted_search") > before
        assert got == Session(catalog=cat, device="cpu").execute(sql).rows()
    finally:
        cat.close()
        assert tn.stop() == []
