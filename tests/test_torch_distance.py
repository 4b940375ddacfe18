"""The port's distances (matrixone_tpu_torch.ops) against the JAX package.

The same seeded numpy inputs go through the JAX function (the Pallas
kernel in interpret mode, and the XLA path of `ops/distance.py`) and
through the port on the CPU, where the CUDA kernel's plain version runs.
Float tolerances are the reference's own for L2
(tests/test_pallas_kernels.py: rtol 1e-5, atol 1e-4); the f64 row-wise
functions must be bit-identical (cosine: to the sequential oracle, see
its test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrixone_tpu.ops import distance as JD
from matrixone_tpu.ops import pallas_kernels as PK
from matrixone_tpu_torch.ops import cuda_kernels as CK
from matrixone_tpu_torch.ops import distance as TD
from matrixone_tpu_torch.ops import kernels as TK


def _pair(seed, n, b, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


@pytest.mark.parametrize("n,b,d", [(2048, 16, 64), (1024, 7, 33)])
def test_plain_l2_matches_pallas_kernel(n, b, d):
    """Tile-aligned n: the Pallas kernel in interpret mode is the
    reference for the CUDA kernel's plain version."""
    x, q = _pair(n + b + d, n, b, d)
    want = np.asarray(PK.l2_distance_sq_pallas(
        jnp.asarray(x), jnp.asarray(q), tile_m=1024, interpret=True))
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    got = CK.l2_distance_sq_plain(xt, qt, (qt * qt).sum(1)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,b,d", [(2048, 16, 64), (1000, 5, 48),
                                   (130, 1, 17), (1, 9, 64)])
def test_l2_distance_sq_matches_reference(n, b, d):
    """Aligned and unaligned shapes through the dispatch seam and
    `distance.l2_distance_sq` (exact f32), against the JAX XLA path."""
    x, q = _pair(7 * n + b, n, b, d)
    want = np.asarray(JD.l2_distance_sq(jnp.asarray(x), jnp.asarray(q),
                                        use_pallas=False))
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    for got in (TK.l2_distance_sq_exact(xt, qt),
                TD.l2_distance_sq(xt, qt)):
        assert got.dtype == torch.float32 and got.shape == (n, b)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_bf16_compute_matches_reference():
    """compute_dtype=bf16: bf16 products accumulated in f32; the result
    is not rounded back to bf16 (XLA's preferred_element_type=f32)."""
    x, q = _pair(3, 512, 8, 64)
    want = np.asarray(JD.l2_distance_sq(jnp.asarray(x), jnp.asarray(q),
                                        compute_dtype=jnp.bfloat16))
    got = TD.l2_distance_sq(torch.from_numpy(x), torch.from_numpy(q),
                            compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    ipw = np.asarray(JD.inner_product(jnp.asarray(x), jnp.asarray(q),
                                      compute_dtype=jnp.bfloat16))
    ipg = TD.inner_product(torch.from_numpy(x), torch.from_numpy(q),
                           compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(ipg.numpy(), ipw, rtol=1e-5, atol=1e-3)


def test_pairwise_ip_cosine_normalize_match_reference():
    x, q = _pair(11, 300, 6, 40)
    jx, jq = jnp.asarray(x), jnp.asarray(q)
    tx, tq = torch.from_numpy(x), torch.from_numpy(q)
    np.testing.assert_allclose(TD.inner_product(tx, tq).numpy(),
                               np.asarray(JD.inner_product(jx, jq)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(TD.cosine_distance(tx, tq).numpy(),
                               np.asarray(JD.cosine_distance(jx, jq)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TD.normalize(tx).numpy(),
                               np.asarray(JD.normalize(jx)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TD.l2_distance(tx, tq).numpy(),
                               np.asarray(JD.l2_distance(jx, jq)),
                               rtol=1e-5, atol=1e-4)


def _left_fold(v):
    acc = np.zeros(v.shape[0])
    for j in range(v.shape[1]):
        acc = acc + v[:, j]
    return acc


@pytest.mark.parametrize("fn", ["l2_distance_rowwise",
                                "inner_product_rowwise"])
def test_rowwise_f64_bit_identical(fn):
    """The sequential f64 fold gives exactly the JAX package's bits."""
    a, b = _pair(5, 64, 64, 96)
    want = np.asarray(getattr(JD, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(TD, fn)(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_cosine_rowwise_bit_identical_to_sequential_oracle():
    """Cosine folds num, |a|^2 and |b|^2 exactly as the JAX package does
    (bit-identical), and ends with 1 - num / sqrt(|a|^2 |b|^2), bit for
    bit the numpy left-fold oracle.  XLA:CPU rewrites the JAX package's
    last step into num * rsqrt(.) under one FMA, which can move the
    result by one ulp, so against JAX the bound is 1 ulp."""
    a, b = _pair(5, 64, 64, 96)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    num, aa, bb = (_left_fold(a64 * b64), _left_fold(a64 * a64),
                   _left_fold(b64 * b64))
    got = TD.cosine_distance_rowwise(torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, 1.0 - num / np.sqrt(aa * bb))
    want = np.asarray(JD.cosine_distance_rowwise(jnp.asarray(a),
                                                 jnp.asarray(b)))
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()


def test_kernel_wrapper_refuses_cpu_tensors():
    """A wrapper launches on CUDA tensors only; the CPU route is the
    seam's decision, never a silent fallback inside the wrapper."""
    x, q = _pair(1, 4, 2, 8)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    before = CK.LAUNCHES.get("l2_distance_sq")
    with pytest.raises(ValueError, match="CUDA"):
        CK.l2_distance_sq(xt, qt, (qt * qt).sum(1))
    TK.l2_distance_sq_exact(xt, qt)             # plain version, no launch
    assert CK.LAUNCHES.get("l2_distance_sq") == before


def test_launch_counts_by_shape():
    """LaunchCounts keeps each kernel's launches in all and by shape
    until reset, which is how a run reads the launches of one path."""
    counts = CK.LaunchCounts()
    counts.add("k", (4, 2, 8))
    counts.add("k", (4, 2, 8))
    counts.add("k", (1, 2, 8))
    counts.add("other")
    assert counts.get("k") == 3 and counts.get("missing") == 0
    assert counts.shapes("k") == {(4, 2, 8): 2, (1, 2, 8): 1}
    assert counts.snapshot() == {"k": 3, "other": 1}
    counts.reset()
    assert counts.get("k") == 0 and counts.shapes("k") == {}


@pytest.mark.parametrize("seed,tile", [(4, 512), (5, 1024)])
def test_plain_masked_l2_matches_pallas_kernel(seed, tile):
    """The reference test's shapes (test_pallas_kernels.py: 2048 x 8 x
    32, a 0.7 Bernoulli mask): the Pallas kernel in interpret mode
    against the seam's CPU path, +inf on exactly the same entries."""
    x, q = _pair(seed, 2048, 8, 32)
    mask = np.random.default_rng(seed).random(2048) < 0.7
    want = np.asarray(PK.l2_distance_sq_masked_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(mask), tile_m=tile,
        interpret=True))
    got = TK.l2_distance_sq_masked_exact(
        torch.from_numpy(x), torch.from_numpy(q),
        torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == (2048, 8)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got[~mask]).all() and np.isfinite(got[mask]).all()
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-5, atol=1e-4)


def test_plain_masked_l2_all_masked_and_unmasked():
    """An all-false mask gives all +inf, as the Pallas kernel does on a
    fully masked tile; an all-true one gives the unmasked distances bit
    for bit."""
    x, q = _pair(6, 2048, 8, 32)
    jall = np.asarray(PK.l2_distance_sq_masked_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.zeros(2048, bool), tile_m=512,
        interpret=True))
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    none = TK.l2_distance_sq_masked_exact(xt, qt, torch.zeros(2048,
                                                            dtype=torch.bool))
    assert np.isinf(jall).all() and bool(torch.isinf(none).all())
    every = TK.l2_distance_sq_masked_exact(xt, qt, torch.ones(2048,
                                                             dtype=torch.bool))
    assert torch.equal(every, TK.l2_distance_sq_exact(xt, qt))


def test_masked_wrapper_refuses_cpu_tensors():
    x, q = _pair(2, 4, 2, 8)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    before = CK.LAUNCHES.get("l2_distance_sq_masked")
    with pytest.raises(ValueError, match="CUDA"):
        CK.l2_distance_sq_masked(xt, qt, (qt * qt).sum(1),
                                 torch.ones(4, dtype=torch.bool))
    assert CK.LAUNCHES.get("l2_distance_sq_masked") == before
