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
