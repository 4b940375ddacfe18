"""`ops/topk.topk_smallest` against `jax.lax.top_k(-x, k)`: the same
values and the same positions, ties included.

Where equal scores straddle the k-th value, JAX keeps the lowest
positions among them, in ascending order; `torch.topk` keeps any
(ROADMAP.md section C, fixed).  Hypothesis draws 1-D and 2-D float32
arrays from a few values, so that most draws tie at the cut, with k
from 1 to n.  The values are small integers and the IEEE specials:
NaN of either sign, +-0.0 and +-inf.  A NaN reaches the port's callers
from a vector literal or a stored embedding that holds one, so the
helper must never index past a row.  XLA orders floats by IEEE total
order, in which a NaN whose sign bit is set comes first and -0.0
before +0.0; the port ranks every NaN last and ties -0.0 with +0.0, as
XLA ranks the NaNs that TPU and CUDA arithmetic make and the zeros
that adding 0.0 makes, so JAX is asked about the same array with every
NaN's sign bit cleared and 0.0 added.  Then one IVF-Flat search over
duplicated rows, whose tie crosses k, must return the reference's ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from matrixone_tpu.vectorindex import ivf_flat as JI
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.ops.topk import topk_smallest
from matrixone_tpu_torch.vectorindex import ivf_flat as TI


def _reference(x: np.ndarray, k: int):
    """JAX's top k of x with every NaN's sign bit cleared and 0.0
    added (-0.0 becomes +0.0)."""
    x = np.where(np.isnan(x), np.abs(x), x) + x.dtype.type(0.0)
    v, i = jax.lax.top_k(-jnp.asarray(x), k)
    return -np.asarray(v), np.asarray(i)


def _check(x: np.ndarray, k: int):
    v, i = topk_smallest(torch.from_numpy(x), k)
    rv, ri = _reference(x, k)
    np.testing.assert_array_equal(i.numpy(), ri)
    np.testing.assert_array_equal(v.numpy(), rv)
    assert i.dtype == torch.int64


_NAN = float("nan")
_VALUES = [float(v) for v in range(-3, 4)] + [
    _NAN, -_NAN, -0.0, float("inf"), float("-inf")]


@st.composite
def tied_arrays(draw):
    n = draw(st.integers(1, 40))
    rows = draw(st.sampled_from([None, 1, 2, 5]))
    shape = (n,) if rows is None else (rows, n)
    values = draw(st.lists(st.sampled_from(_VALUES), min_size=1,
                           max_size=4))
    cells = draw(st.lists(st.sampled_from(values),
                          min_size=int(np.prod(shape)),
                          max_size=int(np.prod(shape))))
    k = draw(st.integers(1, n))
    return np.asarray(cells, np.float32).reshape(shape), k


@settings(max_examples=200, deadline=None, database=None,
          derandomize=True)
@given(tied_arrays())
def test_positions_and_values_equal_jax(case):
    x, k = case
    _check(x, k)


def test_section_c_input():
    """ROADMAP.md section C: [1, 0, 0, 0, 0, 0, 0, 0] with k = 2 gives
    positions [1, 2], as the reference does."""
    x = np.array([1, 0, 0, 0, 0, 0, 0, 0], np.float32)
    v, i = topk_smallest(torch.from_numpy(x), 2)
    assert i.tolist() == [1, 2] and v.tolist() == [0.0, 0.0]
    _check(x, 2)


@pytest.mark.parametrize("row,k", [
    ([_NAN] * 5, 3),                       # all NaN
    ([_NAN, _NAN, 1.0], 2),                # fewer than k numbers
    ([_NAN, 2.0, _NAN, 1.0, _NAN], 4),
    ([-_NAN, 1.0, _NAN, -0.0, 0.0, float("-inf")], 6),
    ([float("inf"), _NAN, float("inf"), 1.0], 3)])
def test_nan_rows_keep_the_positions_jax_keeps(row, k):
    """A k-th value that is NaN: every position is in the row, and the
    positions are those `jax.lax.top_k` keeps, every NaN after +inf
    whatever its sign bit, -0.0 tied with +0.0."""
    x = np.asarray(row, np.float32)
    _check(x, k)
    _check(np.stack([x, x[::-1]]), k)
    v, i = topk_smallest(torch.from_numpy(x), k)
    assert int(i.max()) < x.size and len(set(i.tolist())) == k
    n_num = int((~np.isnan(x)).sum())
    assert not np.isnan(v.numpy()[:min(k, n_num)]).any()


def test_float64_and_bfloat16_scores():
    """f64 and bf16 scores rank as JAX ranks them, in their own
    dtype."""
    rng = np.random.default_rng(5)
    x = rng.integers(-2, 3, (3, 17)).astype(np.float64)
    x[0, 3] = x[1, 0] = np.nan
    assert jnp.asarray(x).dtype == jnp.float64     # the package runs x64
    for k in (1, 9, 17):
        v, i = topk_smallest(torch.from_numpy(x), k)
        rv, ri = _reference(x, k)
        np.testing.assert_array_equal(i.numpy(), ri)
        np.testing.assert_array_equal(v.numpy(), rv)
    b = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    v, i = topk_smallest(b, 9)
    rv, ri = _reference(b.float().numpy(), 9)    # bf16 -> f32 is exact
    np.testing.assert_array_equal(i.numpy(), ri)
    assert v.dtype == torch.bfloat16


def test_infinities_and_other_dims():
    """+inf (masked slots) ties like any value; `dim` other than the
    last."""
    x = np.array([[np.inf, 2, np.inf, 1], [np.inf] * 4], np.float32)
    _check(x, 3)
    _check(x, 4)
    y = np.random.default_rng(0).integers(0, 2, (6, 3)).astype(np.float32)
    v, i = topk_smallest(torch.from_numpy(y), 4, dim=0)
    rv, ri = _reference(y.T, 4)
    np.testing.assert_array_equal(i.numpy().T, ri)
    np.testing.assert_array_equal(v.numpy().T, rv)


def test_ivf_flat_search_over_duplicated_rows():
    """Integer points, each stored many times: every query's k-th
    distance is shared by more rows than k keeps, in the probed lists
    and in the merged top k, and the port must keep the reference's
    rows."""
    rng = np.random.default_rng(7)
    base = rng.integers(-4, 5, (12, 8)).astype(np.float32)
    x = np.repeat(base, 25, axis=0)
    rng.shuffle(x)
    q = np.concatenate([base[:6], base[:6] + 1]).astype(np.float32)
    jidx = JI.build(jnp.asarray(x), nlist=4, n_iter=4, kmeans_sample=None,
                    compute_dtype=None)
    fields = {f: np.asarray(getattr(jidx, f)) for f in
              ("centroids", "vectors", "r_norm2", "r_dot_c", "ids",
               "offsets")}
    fields.update(metric=jidx.metric, max_cluster_size=jidx.max_cluster_size,
                  n=jidx.n)
    tidx = convert.ivf_flat_from_numpy(fields, device="cpu")
    for k in (5, 30):
        jd, ji = JI.search(jidx, jnp.asarray(q), k=k, nprobe=2,
                           compute_dtype=jnp.float32)
        td, ti = TI.search(tidx, q, k=k, nprobe=2,
                           compute_dtype=torch.float32)
        # distances of distinct integer points differ by 1 or more;
        # copies of one point score the same bits within each package
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
        d = np.asarray(jd)
        assert all(k - np.searchsorted(row, row[-1] - 0.5) < 25
                   for row in d)     # the cut falls inside a run of copies
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
