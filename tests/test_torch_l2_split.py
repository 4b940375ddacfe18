"""The arithmetic of the L2 kernel's product (csrc/l2_distance.cu), on
the CPU.

The kernel multiplies on the tensor cores in TF32 with each operand
split in two (3xTF32): v_big = tf32(v), v_small = tf32(v - v_big), with
tf32() rounding the 13 low mantissa bits to nearest, ties away, and
accumulates x_small.q_big, x_big.q_small and x_big.q_big in f32 in that
order at every depth-8 step, into a partial for each depth-32 stage
that is then added to the accumulator; ||x||^2 is a plain f32 sum and
the epilogue is max((x2 + q2) - 2 acc, 0).  The card cannot run here,
so this file emulates that arithmetic with torch on the CPU (rounding
every sum to nearest, where the tensor cores truncate inside a product:
the stage partials keep that truncation small on the card, which
chip_smoke.py measures against f64 at every path shape) and holds it
against f64 with the gate of chip_smoke.py and the on-card tests,
1e-5 * (x2 + q2) + 1e-4, and against the JAX package's Pallas kernel
(interpret mode).  The inputs are the benchmark's recipe (clustered
N(0, 1) centres, noise 0.35, d = 768, and its d = 8 PQ subspaces
against a codebook drawn from the rows), near-duplicate pairs, and
magnitudes 1e-3 and 1e3, made with numpy from a seed.

The split must keep the error under a fifth of the gate.  A single TF32
pass (x_big.q_big alone) keeps about three decimal digits; its margin
on the same data is recorded beside it, and it is what the split is
for.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrixone_tpu.ops import pallas_kernels as PK


def tf32(v: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32, nearest with ties away from zero, the low 13
    mantissa bits cleared: the kernel's (bits + 0x1000) & ~0x1fff."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def emulate(x: torch.Tensor, q: torch.Tensor, passes: int = 3):
    """The kernel's output for f32 x [n, d], q [b, d]: 3 passes is its
    3xTF32 product, 1 pass a single TF32 product."""
    n, d = x.shape
    pad = (-d) % 8
    xp = torch.nn.functional.pad(x, (0, pad))
    qp = torch.nn.functional.pad(q, (0, pad))
    xb, qb = tf32(xp), tf32(qp)
    xs, qs = tf32(xp - xb), tf32(qp - qb)
    acc = torch.zeros(n, q.shape[0], dtype=torch.float32)
    for k0 in range(0, d + pad, 32):              # one shared-memory stage
        part = torch.zeros_like(acc)
        for k in range(k0, min(k0 + 32, d + pad), 8):
            sl = slice(k, k + 8)
            if passes == 3:
                part = part + xs[:, sl] @ qb[:, sl].T
                part = part + xb[:, sl] @ qs[:, sl].T
            part = part + xb[:, sl] @ qb[:, sl].T
        acc = acc + part
    x2 = (x * x).sum(1, keepdim=True)
    q2 = (q * q).sum(1)
    return torch.clamp_min((x2 + q2[None, :]) - 2.0 * acc, 0.0)


def margin(x: np.ndarray, q: np.ndarray, got: torch.Tensor) -> float:
    """max |got - f64| / (1e-5 * (x2 + q2) + 1e-4)."""
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    x2 = (x64 * x64).sum(1)[:, None]
    q2 = (q64 * q64).sum(1)[None, :]
    ref = np.maximum(x2 + q2 - 2.0 * x64 @ q64.T, 0.0)
    tol = 1e-5 * (x2 + q2) + 1e-4
    return float((np.abs(got.numpy().astype(np.float64) - ref) / tol).max())


def bench(seed: int, n: int, b: int, d: int, scale: float = 1.0):
    """The benchmark's recipe: rows and queries around N(0, 1) centres
    with N(0, 0.35^2) noise, times `scale`."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((max(n // 16, 1), d))
    x = centres[rng.integers(0, len(centres), n)] \
        + 0.35 * rng.standard_normal((n, d))
    q = centres[rng.integers(0, len(centres), b)] \
        + 0.35 * rng.standard_normal((b, d))
    return (scale * x).astype(np.float32), (scale * q).astype(np.float32)


def pq_subspace(seed: int, n: int):
    """One d = 8 subspace of the bench data against 256 codewords drawn
    from its rows (the sub-k-means' first assignment): exact matches
    included."""
    x, _ = bench(seed, n, 1, 768)
    sub = np.ascontiguousarray(x[:, 8:16])
    rng = np.random.default_rng(seed + 1)
    return sub, sub[rng.choice(n, 256, replace=False)].copy()


def near_duplicates(seed: int, n: int, b: int, d: int):
    """Queries that are rows of x plus noise of 1e-4: distances near 0
    against (x2 + q2) near 2 d."""
    x, _ = bench(seed, n, 1, d)
    rng = np.random.default_rng(seed + 2)
    q = x[rng.choice(n, b, replace=False)] \
        + 1e-4 * rng.standard_normal((b, d)).astype(np.float32)
    return x, q.astype(np.float32)


CASES = {
    "bench_d768": lambda: bench(0, 1024, 64, 768),
    "pq_d8": lambda: pq_subspace(1, 4096),
    "near_duplicates_d768": lambda: near_duplicates(2, 1024, 64, 768),
    "scale_1e-3": lambda: bench(3, 1024, 64, 768, 1e-3),
    "scale_1e3": lambda: bench(4, 1024, 64, 768, 1e3),
    "odd_d65": lambda: bench(5, 999, 33, 65),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_product_within_a_fifth_of_the_gate(case):
    x, q = CASES[case]()
    got = emulate(torch.from_numpy(x), torch.from_numpy(q))
    assert got.shape == (x.shape[0], q.shape[0])
    assert bool(torch.isfinite(got).all()) and bool((got >= 0).all())
    split = margin(x, q, got)
    single = margin(x, q, emulate(torch.from_numpy(x), torch.from_numpy(q),
                                  passes=1))
    print(f"{case}: max error / gate, 3xTF32 {split:.4f}, "
          f"one TF32 pass {single:.4f}")
    assert split < 0.2, split
    assert single > split


def test_single_pass_misses_the_gate_at_d768():
    """At the benchmark's d = 768 one TF32 pass exceeds the gate that the
    split meets: the reason for the split."""
    x, q = bench(0, 1024, 64, 768)
    single = emulate(torch.from_numpy(x), torch.from_numpy(q), passes=1)
    assert margin(x, q, single) > 1.0


@pytest.mark.parametrize("case", ["bench_d768", "near_duplicates_d768"])
def test_split_product_matches_the_pallas_kernel(case):
    """The emulated kernel against the JAX package's
    `l2_distance_sq_pallas` (interpret mode) on the same inputs, within
    the gate."""
    x, q = CASES[case]()
    want = np.asarray(PK.l2_distance_sq_pallas(
        jnp.asarray(x), jnp.asarray(q), tile_m=1024, interpret=True),
        dtype=np.float64)
    got = emulate(torch.from_numpy(x), torch.from_numpy(q)).numpy()
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    tol = 1e-5 * ((x64 * x64).sum(1)[:, None]
                  + (q64 * q64).sum(1)[None, :]) + 1e-4
    assert bool((np.abs(got - want) <= tol).all())


def test_tf32_rounds_to_nearest_ties_away():
    """tf32() on exact cases: ties go away from zero, the low 13 bits
    are cleared, and v - tf32(v) is exact."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                  # TF32's ulp at 1
    v = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12],
                     dtype=torch.float32)
    got = tf32(v).numpy()
    np.testing.assert_array_equal(
        got, np.array([one + ulp, -(one + ulp), one, one + ulp],
                      dtype=np.float32))
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    big = tf32(w)
    assert not bool((big.view(torch.int32) & 0x1FFF).any())
    rest = (w - big).double()
    assert torch.equal(rest, w.double() - big.double())
