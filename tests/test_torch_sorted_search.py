"""The index arithmetic of the sorted-search kernel (csrc/sorted_search.cu),
on the CPU.

The kernel stages every stride-th key of the sorted array in shared
memory as a perfect binary tree in BFS order (the plan,
`sorted_search_plan`; slots past the samples hold 2^64 - 1), descends it
branchlessly to j, the number of samples below a query, and finishes
with a binary search of the keys between sample j - 1 and sample j in
device memory.  The card cannot run here, so this file emulates that
arithmetic in numpy step for step (the tree's slot formula, the fixed
`levels` steps of the descent, the interval bounds, the fixed number of
finishing halvings, the int32 result), on uint64 keys, and holds it
against `np.searchsorted(..., side='left')` at the kernel's hazards:
runs of equal keys that cross a sample, keys at 0 and 2^64 - 1 and on
both sides of the sign bit, n = 0 and 1, n just below, at and above the
sample count and its multiples, n up to the join's 2^22-row build
budget, and m of no particular size.  The plain version the card
compares the kernel with (`sorted_search_plain`) and the JAX package's
Pallas kernel (interpret mode) are held to the same answers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrixone_tpu.ops import pallas_kernels as PK
from matrixone_tpu_torch.ops import cuda_kernels as CK

U64_MAX = (1 << 64) - 1


def tree(sorted_u64: np.ndarray, stride: int, samples: int,
         levels: int) -> np.ndarray:
    """The kernel's tree [2^levels] (slot 0 unused): slot k (BFS order)
    holds in-order slot i = (2p + 1) 2^(levels - 1 - d) - 1 of the
    perfect tree, d = floor(log2 k), p = k - 2^d: sample i, or 2^64 - 1
    past the samples."""
    out = np.zeros(1 << levels, np.uint64)
    for k in range(1, 1 << levels):
        d = k.bit_length() - 1
        i = ((2 * (k - (1 << d)) + 1) << (levels - 1 - d)) - 1
        out[k] = sorted_u64[i * stride] if i < samples else U64_MAX
    return out


def emulate(sorted_u64: np.ndarray, q: np.ndarray) -> np.ndarray:
    """The kernel's result [m] int32 for uint64 sorted keys and queries."""
    n = len(sorted_u64)
    stride, samples, levels = CK.sorted_search_plan(n)
    t = tree(sorted_u64, stride, samples, levels)
    k = np.ones(len(q), np.int64)
    for _ in range(levels):                  # the descent: levels steps
        k = 2 * k + (t[k] < q)
    j = k - (1 << levels)                    # samples below q
    end = j * stride
    a = np.where(j > 0, end - stride + 1, 0)
    span = np.where(j > 0, np.minimum(end, n) - a, 0)
    fin = (stride - 1).bit_length() if stride > 1 else 0
    for _ in range(fin):                     # the finish: fixed halvings
        live = span > 0
        half = span >> 1
        idx = np.where(live, a + half, 0)
        below = live & (sorted_u64[idx] < q) if n else live
        a = np.where(below, a + half + 1, a)
        span = np.where(live, np.where(below, span - half - 1, half), 0)
    assert (span == 0).all()
    return a.astype(np.int32)


def _keys(seed: int, n: int, run: int = 0, at: int = 0) -> np.ndarray:
    """n sorted uint64 keys, random over the whole range, with a run of
    `run` equal keys placed from sorted position `at`, and 0, 2^63 - 1,
    2^63 and 2^64 - 1 among them when n allows."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 64, n, dtype=np.uint64, endpoint=False)
    special = np.array([0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1],
                       np.uint64)
    k[: min(4, n)] = special[: min(4, n)]
    k.sort()
    if run and n:
        at = min(at, n - 1)
        k[at:at + run] = k[at]
        k.sort()
    return k


def _queries(seed: int, keys: np.ndarray, m: int) -> np.ndarray:
    """m queries: keys of the array, their neighbours (+-1) and random
    values, with 0, 1, 2^63 - 1, 2^63 and 2^64 - 1 first."""
    rng = np.random.default_rng(seed + 1)
    q = rng.integers(0, 1 << 64, m, dtype=np.uint64, endpoint=False)
    if len(keys):
        pick = keys[rng.integers(0, len(keys), m)]
        step = rng.integers(-1, 2, m).astype(np.int64).astype(np.uint64)
        q = np.where(rng.random(m) < 0.6, pick + step, q)   # wraps mod 2^64
    special = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1],
                       np.uint64)
    q[: min(5, m)] = special[: min(5, m)]
    return q


def _check(keys, q):
    got = emulate(keys, q)
    want = np.searchsorted(keys, q, side="left").astype(np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000, 16382, 16383, 16384,
                               32765, 32766, 32767, 49150, 196608,
                               262144])
def test_emulation_matches_searchsorted_at_default_levels(n):
    """Around the default sample count S = 2^14 - 1 (n = S, S +- 1,
    2S +- 1, 3S + 1) and at Q3's build sizes, with a run of equal
    keys."""
    keys = _keys(n, n, run=n // 5, at=n // 3)
    _check(keys, _queries(n, keys, 4099))


S = (1 << CK.SORTED_SEARCH_LEVELS) - 1      # the most samples a tree holds


@pytest.mark.parametrize("stride", [2, 3, 4, 5, 6, 7, 8, 12, 13, 16, 31,
                                    257])
@pytest.mark.parametrize("where", ["first", "second", "middle",
                                   "next_to_last", "last"])
def test_emulation_matches_searchsorted_at_every_stride(stride, where):
    """n at the first, second, middle, next-to-last and last size that
    takes each stride (from (stride - 1) S + 1 to stride S), so that
    the last interval runs from one key to a full stride, with a run of
    equal keys."""
    lo, hi = (stride - 1) * S + 1, stride * S
    n = {"first": lo, "second": lo + 1, "middle": (lo + hi) // 2,
         "next_to_last": hi - 1, "last": hi}[where]
    assert CK.sorted_search_plan(n)[0] == stride
    keys = _keys(7 * stride + len(where), n, run=3 * stride + 1,
                 at=n // 4)
    _check(keys, _queries(n + stride, keys, 1001))


@pytest.mark.parametrize("stride", [2, 13, 16, 257])
@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_runs_crossing_a_sample_land_on_their_first_key(stride, offset):
    """A run of equal keys that starts just before, at or after a sampled
    position and spans several samples: left insertion must give the
    run's first position, which only the interval before the first
    sample of the run holds (stride 13: Q3's build of 196608 keys;
    257: the join's 2^22-row budget)."""
    n = S * stride
    assert CK.sorted_search_plan(n) == (stride, S, CK.SORTED_SEARCH_LEVELS)
    keys = _keys(stride, n)
    start = 5 * stride + offset
    keys[start:start + 3 * stride] = keys[start]
    keys.sort()
    q = np.concatenate([keys[start - 1:start + 2], _queries(1, keys, 77)])
    _check(keys, q)
    got = emulate(keys, np.array([keys[start]]))
    assert got[0] == np.searchsorted(keys, keys[start], side="left")


def test_all_keys_equal_and_the_extremes():
    """Every key equal (one run across all samples), at 0, 2^63 - 1,
    2^63 and 2^64 - 1: queries below, at and above each."""
    for v in (0, (1 << 63) - 1, 1 << 63, U64_MAX):
        keys = np.full(50000, v, np.uint64)
        q = np.array([0, 1, v - 1 if v else 0, v, min(v + 1, U64_MAX),
                      (1 << 63) - 1, 1 << 63, U64_MAX], np.uint64)
        _check(keys, q)


def test_build_budget_size():
    """n = 2^22, the join's build budget: stride 257 at the default
    tree, m not a multiple of anything."""
    n = 1 << 22
    assert CK.sorted_search_plan(n) == (257, 16321, 14)
    keys = _keys(22, n, run=3000, at=12345)
    _check(keys, _queries(22, keys, 30011))


@pytest.mark.parametrize("ns", [
    list(range(0, 300)),
    [S * k + o for k in (1, 2, 3, 12, 13, 256, 257) for o in (-1, 0, 1)],
    [196608, 262144, (1 << 22) - 1, 1 << 22, (1 << 31) - 2]])
def test_plan_keeps_every_sample_inside_the_tree(ns):
    """samples = ceil(n / stride) <= 2^levels - 1 <= S, the last sample
    inside the array, the stride the least that fits, and levels the
    least that hold the samples."""
    for n in ns:
        stride, samples, levels = CK.sorted_search_plan(n)
        assert samples == -(-n // stride) <= (1 << levels) - 1 <= S
        assert samples == 0 or (samples - 1) * stride < n
        assert stride == 1 or -(-n // (stride - 1)) > S
        assert levels == 0 or samples > (1 << (levels - 1)) - 1


@pytest.mark.parametrize("n,m", [(0, 5), (1, 7), (2500, 1000),
                                 (16385, 3001)])
def test_emulation_matches_the_plain_version_and_the_pallas_kernel(n, m):
    """The same keys as int64 bit patterns through the plain version the
    card checks the kernel against, and through the JAX package's Pallas
    kernel in interpret mode."""
    keys = _keys(n + 3, n, run=n // 5, at=n // 2)
    q = _queries(m, keys, m)
    want = emulate(keys, q)
    plain = CK.sorted_search_plain(torch.from_numpy(keys.view(np.int64)),
                                   torch.from_numpy(q.view(np.int64)))
    np.testing.assert_array_equal(plain.numpy(), want)
    if n:          # the Pallas kernel's tiling takes no empty array
        pallas = PK.sorted_search_pallas(jnp.asarray(keys), jnp.asarray(q),
                                         interpret=True)
        np.testing.assert_array_equal(np.asarray(pallas), want)
