"""The port's ADC scoring (matrixone_tpu_torch.ops) against the JAX package.

The same seeded numpy codes and lookup tables go through the JAX
package's `adc_score_pallas` (in interpret mode, as its own tests run it
on the CPU) or its `take_along_axis` formula (the XLA path of
`ivf_pq._search`), and through the port on the CPU, where the CUDA
kernel's plain version runs.  The port sums the M entries in another
order than either, so scores are held to the reference's own tolerance
(tests/test_pallas_kernels.py: rtol 1e-5, atol 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrixone_tpu.ops import pallas_kernels as PK
from matrixone_tpu_torch.ops import cuda_kernels as CK
from matrixone_tpu_torch.ops import kernels as TK


def _inputs(seed, g, p, m, dtype):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (g, p, m)).astype(dtype)
    lut = rng.standard_normal((g, m, 256)).astype(np.float32)
    return codes, lut


def _take_along_axis(codes, lut):
    """The JAX package's XLA ADC formula (ivf_pq._search)."""
    lut_j = jnp.asarray(lut)[:, None, :, :]                 # [G, 1, M, 256]
    gathered = jnp.take_along_axis(
        lut_j, jnp.asarray(codes, jnp.int32)[..., None], axis=3)[..., 0]
    return np.asarray(jnp.sum(gathered, axis=-1))


@pytest.mark.parametrize("g,p,m,dtype,tile", [(6, 512, 16, np.int32, 256),
                                              (2, 256, 8, np.uint8, 128)])
def test_plain_adc_matches_pallas_kernel(g, p, m, dtype, tile):
    """The reference test's shapes (test_pallas_kernels.py: int32 codes
    at 6 x 512 x 16, uint8 codes at 2 x 256 x 8), through the Pallas
    kernel in interpret mode and the seam's CPU path."""
    codes, lut = _inputs(g + p + m, g, p, m, dtype)
    want = np.asarray(PK.adc_score_pallas(jnp.asarray(codes),
                                          jnp.asarray(lut), tile_c=tile,
                                          interpret=True))
    got = TK.adc_score(torch.from_numpy(codes), torch.from_numpy(lut))
    assert got.dtype == torch.float32 and got.shape == (g, p)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("g,p,m,dtype", [(5, 100, 8, np.uint8),
                                         (3, 1, 96, np.int32),
                                         (4, 129, 1, np.uint8),
                                         (2, 37, 300, np.int32)])
def test_plain_adc_matches_take_along_axis_at_any_p(g, p, m, dtype):
    """Ragged P (the Pallas kernel needs P % tile_c == 0, the port does
    not) and M up to 300, against the XLA formula."""
    codes, lut = _inputs(7 * p + m, g, p, m, dtype)
    want = _take_along_axis(codes, lut)
    got = CK.adc_score_plain(torch.from_numpy(codes), torch.from_numpy(lut))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_adc_seam_runs_the_plain_version_on_the_cpu():
    """A CPU tensor runs the plain version and launches nothing; the
    wrapper itself refuses CPU tensors rather than falling back."""
    codes, lut = _inputs(1, 2, 10, 4, np.uint8)
    tc, tl = torch.from_numpy(codes), torch.from_numpy(lut)
    before = CK.LAUNCHES.get("adc_score")
    got = TK.adc_score(tc, tl.double())       # the seam takes any float lut
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _take_along_axis(codes, lut),
                               rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="CUDA"):
        CK.adc_score(tc, tl)
    assert CK.LAUNCHES.get("adc_score") == before


def test_adc_plain_sums_exactly_on_integer_tables():
    """Integer-valued tables sum exactly in any order: the plain version
    is then bit-identical to the JAX formula."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 256, (4, 300, 96)).astype(np.uint8)
    lut = rng.integers(-50, 50, (4, 96, 256)).astype(np.float32)
    got = TK.adc_score(torch.from_numpy(codes), torch.from_numpy(lut))
    np.testing.assert_array_equal(got.numpy(), _take_along_axis(codes, lut))


# ------------------------------------------------ the list form
def _lists(seed, m, long_rows=2100, pad=None):
    """Inverted lists of uint8 codes [n, M] with an empty list, a list
    longer than a block's share on the card (2048 lanes) and ragged
    ones, the groups that probe them (every list at least once, the empty
    and the long one twice), and a LUT per group."""
    rng = np.random.default_rng(seed)
    sizes = np.array([0, long_rows, 1, 255, 256, 257, 700, 0, 33])
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    codes = rng.integers(0, 256, (int(offsets[-1]), m)).astype(np.uint8)
    lists = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 1, 0, 6])
    starts, ends = offsets[lists], offsets[lists + 1]
    lut = rng.standard_normal((len(lists), m, 256)).astype(np.float32)
    return codes, starts, ends, lut, pad or long_rows


def _padded(codes, starts, ends, pad):
    """The search's padded candidate gather: (codes [G, pad, M], valid
    [G, pad]), lanes past a list's end on row 0."""
    cand = starts[:, None].astype(np.int64) + np.arange(pad)[None, :]
    valid = cand < ends[:, None]
    return codes[np.where(valid, cand, 0)], valid


@pytest.mark.parametrize("m", [1, 8, 96, 97])
def test_list_form_plain_matches_pallas_on_the_padded_gather(m):
    """The list form's plain version against the JAX package's Pallas
    kernel (interpret mode) on the padded gather, masked to +inf past
    each list's end as the reference search masks it: empty lists, a list
    longer than a block's share, pad 2176 (the Pallas tile, 128, divides
    it)."""
    codes, starts, ends, lut, pad = _lists(m, m, pad=2176)
    padded, valid = _padded(codes, starts, ends, pad)
    want = np.asarray(PK.adc_score_pallas(jnp.asarray(padded),
                                          jnp.asarray(lut), tile_c=128,
                                          interpret=True))
    want = np.where(valid, want, np.inf)
    got = TK.adc_score_lists(torch.from_numpy(codes),
                             torch.from_numpy(starts),
                             torch.from_numpy(ends), torch.from_numpy(lut),
                             pad)
    assert got.dtype == torch.float32 and got.shape == (len(starts), pad)
    np.testing.assert_array_equal(np.isinf(got.numpy()), ~valid)
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("m", [1, 8, 96, 97])
@pytest.mark.parametrize("pad", [2100, 2101, 2311, 1307])
def test_list_form_plain_matches_the_reference_formula_at_any_pad(m, pad):
    """Pads that are a multiple of nothing (2101 = 11 x 191, 2311 and
    1307 prime, 2100 the long list's own length; at 1307 the long list is
    cut to the pad) against the reference search's XLA
    formula: take_along_axis over the padded gather, +inf where the lane
    is not valid (matrixone_tpu/vectorindex/ivf_pq.py `_search`)."""
    codes, starts, ends, lut, _ = _lists(3 * m + pad, m, pad=pad)
    padded, valid = _padded(codes, starts, ends, pad)
    want = np.where(valid, _take_along_axis(padded, lut), np.inf)
    got = CK.adc_score_lists_plain(torch.from_numpy(codes),
                                   torch.from_numpy(starts),
                                   torch.from_numpy(ends),
                                   torch.from_numpy(lut), pad).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5, atol=1e-4)


def test_list_form_plain_is_the_dense_form_on_the_gather_masked():
    """Bit for bit: the list form is the dense form on the padded gather,
    +inf past each list's end; with no rows at all every lane is +inf."""
    codes, starts, ends, lut, pad = _lists(11, 96)
    padded, valid = _padded(codes, starts, ends, pad)
    dense = CK.adc_score_plain(torch.from_numpy(padded),
                               torch.from_numpy(lut))
    want = torch.where(torch.from_numpy(valid), dense,
                       torch.full_like(dense, float("inf")))
    got = CK.adc_score_lists_plain(torch.from_numpy(codes),
                                   torch.from_numpy(starts),
                                   torch.from_numpy(ends),
                                   torch.from_numpy(lut), pad)
    assert torch.equal(got, want)
    none = torch.zeros(3, dtype=torch.int32)
    empty = CK.adc_score_lists_plain(torch.zeros(0, 96, dtype=torch.uint8),
                                     none, none, torch.from_numpy(lut[:3]), 5)
    assert empty.shape == (3, 5) and bool(torch.isinf(empty).all())


def test_list_form_seam_runs_the_plain_version_on_the_cpu():
    """A CPU tensor runs the plain version and launches nothing; the
    wrapper itself refuses CPU tensors rather than falling back."""
    codes, starts, ends, lut, pad = _lists(5, 8)
    args = (torch.from_numpy(codes), torch.from_numpy(starts),
            torch.from_numpy(ends), torch.from_numpy(lut))
    before = CK.LAUNCHES.get("adc_score_lists")
    got = TK.adc_score_lists(args[0], args[1].long(), args[2].long(),
                             args[3].double(), pad)
    assert got.dtype == torch.float32
    assert torch.equal(got, CK.adc_score_lists_plain(*args, pad))
    with pytest.raises(ValueError, match="CUDA"):
        CK.adc_score_lists(*args, pad)
    assert CK.LAUNCHES.get("adc_score_lists") == before


def _synthetic_index(seed, m, ds, sizes, nq):
    """A JAX IVF-PQ index made directly from seeded numpy fields (no
    build): lists of the given sizes, random codes and codebooks, and
    queries near the centroids."""
    from matrixone_tpu.vectorindex import ivf_pq as JP
    rng = np.random.default_rng(seed)
    d, nlist = m * ds, len(sizes)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    n = int(offsets[-1])
    cents = rng.standard_normal((nlist, d)).astype(np.float32) * 3
    idx = JP.IvfPqIndex(
        centroids=jnp.asarray(cents),
        codebooks=jnp.asarray(rng.standard_normal((m, 256, ds))
                              .astype(np.float32)),
        codes=jnp.asarray(rng.integers(0, 256, (n, m)).astype(np.uint8)),
        ids=jnp.asarray(rng.permutation(n).astype(np.int32)),
        offsets=jnp.asarray(offsets), metric="l2",
        max_cluster_size=int(-(-max(sizes) // 128) * 128), n=n)
    q = (cents[rng.integers(0, nlist, nq)]
         + rng.standard_normal((nq, d))).astype(np.float32)
    return idx, q


@pytest.mark.parametrize("m,ds,use_pallas", [(8, 4, False), (8, 4, True),
                                             (97, 1, False), (97, 1, True)])
def test_search_through_the_list_form_matches_the_reference_search(
        m, ds, use_pallas):
    """The reference's IVF-PQ `_search` (through `search`, with its XLA
    gather or its Pallas kernel in interpret mode) against the port's
    search, whose scores come from the list form, on one index with an
    empty list, a list longer than a block's share and ragged ones: distances
    within rtol 1e-5 / atol 1e-4, id sets equal on >= 99% of queries."""
    from matrixone_tpu.vectorindex import ivf_pq as JP
    from matrixone_tpu_torch import convert
    from matrixone_tpu_torch.vectorindex import ivf_pq as TP
    jidx, q = _synthetic_index(m + ds, m, ds,
                               [0, 2100, 3, 256, 257, 0, 500, 64], 24)
    fields = {f: np.asarray(getattr(jidx, f)) for f in convert.IVF_PQ_FIELDS}
    fields.update(metric="l2", max_cluster_size=jidx.max_cluster_size,
                  n=jidx.n)
    tidx = convert.ivf_pq_from_numpy(fields, device="cpu")
    jd, ji = JP.search(jidx, jnp.asarray(q), k=10, nprobe=3, query_chunk=8,
                       use_pallas=use_pallas)
    td, ti = TP.search(tidx, q, k=10, nprobe=3, query_chunk=8)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)
    same = np.mean([set(a) == set(b) for a, b in
                    zip(ti.numpy().tolist(), np.asarray(ji).tolist())])
    assert same >= 0.99, same
