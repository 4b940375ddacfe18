"""The port's relational device ops against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX function and through the
port (`device="cpu"`, where each CUDA kernel's plain version runs):

  * kernel 4 (`sorted_search_pallas`, in interpret mode) and the seam's
    `sorted_lookup`: bit-identical searchsorted-left positions;
  * kernel 3 (`segment_sum_pallas`, in interpret mode) and the seam's
    `grouped_scatter_add`: exact on integer-valued float32 inputs, no
    leak from masked rows whose gids collide with live groups, and exact
    dtypes kept off the float kernel;
  * `hash_columns`, `group_ids`, the segment reductions, `compact`, the
    sorts and the `ops/scalar.py` functions: bit-identical, on NULL-heavy
    and padded batches, decimals of mixed scale, and f32/f64 keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrixone_tpu.container import dtypes as jdt
from matrixone_tpu.container.device import DeviceBatch as JBatch
from matrixone_tpu.container.device import DeviceColumn as JCol
from matrixone_tpu.ops import agg as JA
from matrixone_tpu.ops import filter as JF
from matrixone_tpu.ops import hash as JH
from matrixone_tpu.ops import kernels as HK
from matrixone_tpu.ops import pallas_kernels as PK
from matrixone_tpu.ops import scalar as JS
from matrixone_tpu.ops import sort as JSORT
from matrixone_tpu_torch.container import dtypes as tdt
from matrixone_tpu_torch.container.device import DeviceBatch as TBatch
from matrixone_tpu_torch.container.device import DeviceColumn as TCol
from matrixone_tpu_torch.ops import agg as TA
from matrixone_tpu_torch.ops import cuda_kernels as CK
from matrixone_tpu_torch.ops import filter as TF
from matrixone_tpu_torch.ops import hash as TH
from matrixone_tpu_torch.ops import kernels as TK
from matrixone_tpu_torch.ops import scalar as TS
from matrixone_tpu_torch.ops import sort as TSORT


def _hashes(seed: int, n: int) -> np.ndarray:
    """tests/test_hand_kernels.py's recipe: a duplicate run and NULL-hash
    sentinels, sorted."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    a[: n // 5] = a[0]                          # duplicate run
    a[-4:] = np.uint64(0xFFFFFFFFFFFFFFFF)      # NULL-hash sentinel
    return np.sort(a)


def _queries(srt: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.choice(srt, size=700),
        rng.integers(0, 1 << 64, size=300, dtype=np.uint64),
        np.array([0, 1, (1 << 64) - 1], dtype=np.uint64),
    ])


def _i64(a: np.ndarray) -> torch.Tensor:
    """uint64 hashes as the int64 bit patterns the port carries."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


# --------------------------------------------------------------- kernel 4
@pytest.mark.parametrize("n", [2500, 1100, 1, 4])
def test_sorted_search_plain_matches_pallas_and_lookup(n):
    srt = _hashes(11 + n, n)
    q = _queries(srt, 12 + n)
    want_k = np.asarray(PK.sorted_search_pallas(
        jnp.asarray(srt), jnp.asarray(q), interpret=True)).astype(np.int64)
    want_x = np.asarray(HK.sorted_lookup(jnp.asarray(srt),
                                         jnp.asarray(q))).astype(np.int64)
    got = CK.sorted_search_plain(_i64(srt), _i64(q))
    seam = TK.sorted_lookup(_i64(srt), _i64(q))
    assert got.dtype == torch.int32 and seam.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.int64), want_k)
    assert np.array_equal(got.numpy().astype(np.int64), want_x)
    assert torch.equal(seam, got)


def test_sorted_search_plain_edges():
    """n = 0 gives zeros; m = 0 gives an empty result; a query equal to
    UINT64_MAX lands before the NULL sentinels, as unsigned order says."""
    q = _i64(np.array([0, 5, (1 << 64) - 1], np.uint64))
    empty = torch.zeros(0, dtype=torch.int64)
    assert TK.sorted_lookup(empty, q).tolist() == [0, 0, 0]
    assert TK.sorted_lookup(q, empty).shape == (0,)
    srt = _i64(np.array([1, 1 << 63, (1 << 64) - 1], np.uint64))
    assert TK.sorted_lookup(srt, q).tolist() == [0, 1, 2]


# --------------------------------------------------------------- kernel 3
@pytest.mark.parametrize("n", [4096, 4000, 1, 0])
def test_segment_sum_plain_matches_pallas_and_seam(n):
    """tests/test_hand_kernels.py's recipe: integer-valued f32 (exact in
    any order), 19 groups, a 0.8 Bernoulli mask."""
    rng = np.random.default_rng(21)
    v = rng.integers(0, 16, size=n).astype(np.float32)
    g = rng.integers(0, 19, size=n).astype(np.int32)
    m = rng.random(n) < 0.8
    want_x = np.asarray(HK.grouped_scatter_add(
        jnp.asarray(v), jnp.asarray(g), jnp.asarray(m), 19,
        use_pallas=True))
    tv, tg, tm = (torch.from_numpy(v), torch.from_numpy(g),
                  torch.from_numpy(m))
    got = CK.segment_sum_plain(tv, tg, tm, 19)
    seam = TK.grouped_scatter_add(tv, tg, tm, 19, use_pallas=True)
    assert got.dtype == torch.float32 and got.shape == (19,)
    assert np.array_equal(got.numpy(), want_x)
    assert torch.equal(seam, got)
    if n and n % 512 == 0:
        want_k = np.asarray(PK.segment_sum_pallas(
            jnp.asarray(v), jnp.asarray(g), jnp.asarray(m),
            num_segments=19, tile_n=512, interpret=True))
        assert np.array_equal(got.numpy(), want_k)


def test_segment_sum_float_values_within_reference_tolerance():
    """N(0,1) values: within the reference's own segment-sum tolerance
    (tests/test_pallas_kernels.py: rtol 1e-4, atol 1e-3)."""
    rng = np.random.default_rng(5)
    n, G = 8192, 512
    v = rng.standard_normal(n).astype(np.float32)
    g = rng.integers(0, G, n).astype(np.int32)
    m = rng.random(n) < 0.8
    want = np.asarray(PK.segment_sum_pallas(
        jnp.asarray(v), jnp.asarray(g), jnp.asarray(m), num_segments=G,
        tile_n=2048, interpret=True))
    got = TK.grouped_scatter_add(torch.from_numpy(v), torch.from_numpy(g),
                                 torch.from_numpy(m), G, use_pallas=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_segment_sum_masked_rows_never_leak():
    """A masked row whose gid is a live group adds nothing; nor does an
    unmasked row whose gid lies outside [0, G) (XLA drops it)."""
    v = torch.full((2048,), 100.0)
    g = torch.zeros(2048, dtype=torch.int32)
    g[5] = 9
    m = torch.zeros(2048, dtype=torch.bool)
    m[:3] = True
    m[5] = True
    got = TK.grouped_scatter_add(v, g, m, 4, use_pallas=True)
    assert got.tolist() == [300.0, 0.0, 0.0, 0.0]


def test_grouped_scatter_exact_dtypes_stay_exact():
    """int64 (counts, scaled decimals) and f64 sums take the plain
    scatter and keep their dtype and exactness, as in the reference."""
    v = np.array([1 << 40, 3, -7, 1 << 40], dtype=np.int64)
    g = np.array([0, 0, 1, 1], dtype=np.int32)
    m = np.array([True, True, True, False])
    got = TK.grouped_scatter_add(torch.from_numpy(v), torch.from_numpy(g),
                                 torch.from_numpy(m), 2, use_pallas=True)
    want = np.asarray(HK.grouped_scatter_add(
        jnp.asarray(v), jnp.asarray(g), jnp.asarray(m), 2, use_pallas=True))
    assert got.dtype == torch.int64 and got.tolist() == want.tolist()
    v64 = torch.tensor([1e-17, 1.0, 1e-17], dtype=torch.float64)
    got64 = TK.grouped_scatter_add(v64, torch.zeros(3, dtype=torch.int32),
                                   torch.ones(3, dtype=torch.bool), 1,
                                   use_pallas=True)
    assert got64.dtype == torch.float64
    assert got64[0].item() == np.float64(1e-17) + 1.0 + 1e-17


# ------------------------------------------------------ hashing, grouping
def _key_arrays(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return {
        "i64": rng.integers(-(1 << 62), 1 << 62, n),
        "i32": rng.integers(-50, 50, n).astype(np.int32),
        "i8": rng.integers(0, 100, n).astype(np.int8),
        "f32": rng.standard_normal(n).round(1).astype(np.float32),
        "f64": rng.standard_normal(n).round(2),
        "b": rng.random(n) < 0.5,
        "valid_heavy_null": rng.random(n) < 0.3,
        "valid": rng.random(n) < 0.9,
    }


@pytest.mark.parametrize("col", ["i64", "i32", "i8", "f32", "f64", "b"])
def test_hash_column_bit_identical(col):
    a = _key_arrays(1, 3000)[col]
    want = np.asarray(JH.hash_column(jnp.asarray(a))).view(np.int64)
    assert np.array_equal(TH.hash_column(torch.from_numpy(a)).numpy(), want)


def test_hash_columns_with_nulls_bit_identical():
    k = _key_arrays(2, 3000)
    cols = [k["i8"], k["f32"], k["f64"]]
    vals = [k["valid_heavy_null"], None, k["valid"]]
    want = np.asarray(JH.hash_columns(
        [jnp.asarray(c) for c in cols],
        [None if v is None else jnp.asarray(v) for v in vals]))
    got = TH.hash_columns([torch.from_numpy(c) for c in cols],
                          [None if v is None else torch.from_numpy(v)
                           for v in vals])
    assert np.array_equal(got.numpy(), want.view(np.int64))


@pytest.mark.parametrize("live,mg", [(4000, 4096), (1000, 4096),
                                     (4000, 256), (0, 1024)])
def test_group_ids_bit_identical(live, mg):
    """Padded batches (live < padded), NULL-heavy keys, f32 keys, and an
    overflowing table (more groups than max_groups)."""
    k = _key_arrays(3, 4096)
    kd = [k["i32"], k["f32"]]
    kv = [k["valid_heavy_null"], None]
    rm = np.arange(4096) < live
    want = JA.group_ids([jnp.asarray(c) for c in kd],
                        [None if v is None else jnp.asarray(v) for v in kv],
                        jnp.asarray(rm), mg)
    got = TA.group_ids([torch.from_numpy(c) for c in kd],
                       [None if v is None else torch.from_numpy(v)
                        for v in kv], torch.from_numpy(rm), mg)
    assert int(got.num_groups) == int(want.num_groups)
    assert np.array_equal(got.gids.numpy()[rm], np.asarray(want.gids)[rm])
    assert np.array_equal(got.rep_rows.numpy(), np.asarray(want.rep_rows))


@pytest.mark.parametrize("fn", ["seg_sum", "seg_count", "seg_min",
                                "seg_max"])
def test_segment_reductions_bit_identical(fn):
    rng = np.random.default_rng(4)
    n, mg = 4096, 64
    gids = rng.integers(0, 80, n).astype(np.int32)     # some past mg
    mask = rng.random(n) < 0.6
    for vals in (rng.integers(-1000, 1000, n), rng.integers(
            -9, 9, n).astype(np.float32), rng.random(n) < 0.5):
        if fn == "seg_sum" and vals.dtype == np.bool_:
            continue
        if fn == "seg_count":
            want = JA.seg_count(jnp.asarray(gids), jnp.asarray(mask), mg)
            got = TA.seg_count(torch.from_numpy(gids),
                               torch.from_numpy(mask), mg)
        else:
            want = getattr(JA, fn)(jnp.asarray(vals), jnp.asarray(gids),
                                   jnp.asarray(mask), mg)
            got = getattr(TA, fn)(torch.from_numpy(vals),
                                  torch.from_numpy(gids),
                                  torch.from_numpy(mask), mg)
        assert np.array_equal(got.numpy(), np.asarray(want)), vals.dtype


def test_compact_and_gather_keys_bit_identical():
    k = _key_arrays(6, 4096)
    mask = k["valid_heavy_null"] & (np.arange(4096) < 3000)
    jb = JBatch({"a": JCol(jnp.asarray(k["i64"]), jnp.asarray(k["valid"]),
                           jdt.INT64)}, jnp.asarray(3000, jnp.int32))
    tb = TBatch({"a": TCol(torch.from_numpy(k["i64"]),
                           torch.from_numpy(k["valid"]), tdt.INT64)},
                torch.tensor(3000, dtype=torch.int32))
    for cap in (4096, 1024):
        jc = JF.compact(jb, jnp.asarray(mask), cap)
        tc = TF.compact(tb, torch.from_numpy(mask), cap)
        assert int(tc.n_rows) == int(jc.n_rows)
        assert np.array_equal(tc.columns["a"].data.numpy(),
                              np.asarray(jc.columns["a"].data))
        assert np.array_equal(tc.columns["a"].validity.numpy(),
                              np.asarray(jc.columns["a"].validity))


@pytest.mark.parametrize("desc", [(False, True), (True, False)])
def test_sort_indices_and_top_k_bit_identical(desc):
    """Ties, NULLs and padding: the same permutation and the same top-k
    set in the same order."""
    k = _key_arrays(7, 4096)
    rm = np.arange(4096) < 3900
    cols = [k["i8"], k["f32"]]
    vals = [k["valid_heavy_null"], k["valid"]]
    want = np.asarray(JSORT.sort_indices(
        [jnp.asarray(c) for c in cols], [jnp.asarray(v) for v in vals],
        list(desc), jnp.asarray(rm)))
    got = TSORT.sort_indices([torch.from_numpy(c) for c in cols],
                             [torch.from_numpy(v) for v in vals],
                             list(desc), torch.from_numpy(rm))
    assert np.array_equal(got.numpy(), want)
    for c, v in zip(cols, vals):
        wi, wc = JSORT.top_k_indices(jnp.asarray(c), jnp.asarray(v),
                                     desc[0], jnp.asarray(rm), 50)
        gi, gc = TSORT.top_k_indices(torch.from_numpy(c),
                                     torch.from_numpy(v), desc[0],
                                     torch.from_numpy(rm), 50)
        assert int(gc) == int(wc)
        assert np.array_equal(gi.numpy(), np.asarray(wi))


# ------------------------------------------------------------- ops/scalar
def _dtypes(name):
    """(JAX DType, port DType) of one SQL type by name."""
    kind, _, scale = name.partition(":")
    if kind == "dec":
        return jdt.decimal64(15, int(scale)), tdt.decimal64(15, int(scale))
    return getattr(jdt, kind), getattr(tdt, kind)


def _cols(name, data, valid):
    jt, tt = _dtypes(name)
    return (JCol(jnp.asarray(data), jnp.asarray(valid), jt),
            TCol(torch.from_numpy(np.ascontiguousarray(data)),
                 torch.from_numpy(np.ascontiguousarray(valid)), tt))


def _operands(seed: int, n: int = 1024):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) < 0.6                          # NULL-heavy
    return {
        "dec:2": (rng.integers(-10 ** 6, 10 ** 6, n), valid),
        "dec:4": (rng.integers(-10 ** 8, 10 ** 8, n), rng.random(n) < 0.9),
        "INT64": (rng.integers(-1000, 1000, n), rng.random(n) < 0.8),
        "INT32": (rng.integers(-1000, 1000, n).astype(np.int32),
                  np.ones(n, bool)),
        "FLOAT32": (rng.standard_normal(n).astype(np.float32), valid),
        "FLOAT64": (rng.standard_normal(n) * 100, rng.random(n) < 0.7),
        "DATE": (rng.integers(8000, 11000, n).astype(np.int32),
                 rng.random(n) < 0.9),
        "BOOL": (rng.random(n) < 0.5, rng.random(n) < 0.7),
    }


def _same(jc, tc, exact=True):
    assert str(tc.dtype) == str(jc.dtype)
    jd, jv = np.asarray(jc.data), np.asarray(jc.validity)
    td, tv = tc.data.numpy(), tc.validity.numpy()
    assert td.shape == jd.shape
    assert np.array_equal(tv, jv)
    if exact:
        assert np.array_equal(td[tv], jd[jv]), (td[tv][:5], jd[jv][:5])
    else:
        np.testing.assert_allclose(td[tv], jd[jv], rtol=1e-12, atol=0)


_BINARY = [("add", "dec:2", "dec:4"), ("sub", "dec:4", "dec:2"),
           ("mul", "dec:2", "dec:2"), ("mul", "dec:2", "INT64"),
           ("add", "INT64", "INT32"), ("sub", "DATE", "DATE"),
           ("add", "DATE", "INT32"), ("add", "dec:2", "FLOAT64"),
           ("mul", "FLOAT32", "INT32"), ("mod", "INT64", "INT32"),
           ("mod", "FLOAT64", "FLOAT32"), ("div", "dec:2", "INT32"),
           ("div", "INT64", "INT32")]


@pytest.mark.parametrize("fn,a,b", _BINARY)
def test_scalar_arithmetic_bit_identical(fn, a, b):
    ops = _operands(8)
    ja, ta = _cols(a, *ops[a])
    jb, tb = _cols(b, *ops[b])
    _same(getattr(JS, fn)(ja, jb), getattr(TS, fn)(ta, tb))


@pytest.mark.parametrize("fn", ["eq", "ne", "lt", "le", "gt", "ge"])
@pytest.mark.parametrize("a,b", [("dec:2", "dec:4"), ("dec:2", "INT64"),
                                 ("dec:4", "FLOAT64"), ("INT32", "INT64"),
                                 ("FLOAT32", "FLOAT64"), ("DATE", "DATE")])
def test_scalar_comparisons_bit_identical(fn, a, b):
    ops = _operands(9)
    ja, ta = _cols(a, *ops[a])
    jb, tb = _cols(b, *ops[b])
    _same(getattr(JS, fn)(ja, jb), getattr(TS, fn)(ta, tb))


def test_scalar_const_broadcast_and_logic_bit_identical():
    """Length-1 const operands broadcast; Kleene AND/OR/NOT on NULLs;
    IN lists, IS NULL, CASE WHEN."""
    ops = _operands(10)
    ja, ta = _cols("dec:2", *ops["dec:2"])
    jc = JCol.const(150, jdt.decimal64(15, 2))
    tc = TCol.const(150, tdt.decimal64(15, 2), "cpu")
    _same(JS.lt(ja, jc), TS.lt(ta, tc))
    _same(JS.sub(jc, ja), TS.sub(tc, ta))
    jb1, tb1 = _cols("BOOL", *ops["BOOL"])
    jb2, tb2 = JS.gt(ja, jc), TS.gt(ta, tc)
    _same(JS.logical_and(jb1, jb2), TS.logical_and(tb1, tb2))
    _same(JS.logical_or(jb1, jb2), TS.logical_or(tb1, tb2))
    _same(JS.logical_not(jb1), TS.logical_not(tb1))
    ji, ti = _cols("INT32", *ops["INT32"])
    _same(JS.in_list(ji, [3, -7, 11]), TS.in_list(ti, [3, -7, 11]))
    _same(JS.isnull(ja), TS.isnull(ta))
    jf, tf = _cols("FLOAT64", *ops["FLOAT64"])
    _same(JS.case_when(jb1, ja, JS.cast(jf, jdt.decimal64(15, 2))),
          TS.case_when(tb1, ta, TS.cast(tf, tdt.decimal64(15, 2))))


@pytest.mark.parametrize("src,dst", [("dec:4", "dec:2"), ("dec:2", "dec:4"),
                                     ("dec:4", "FLOAT64"),
                                     ("dec:2", "FLOAT32"),
                                     ("FLOAT64", "dec:2"), ("INT64", "dec:2"),
                                     ("FLOAT64", "INT32"),
                                     ("INT32", "FLOAT64")])
def test_scalar_cast_bit_identical(src, dst):
    ops = _operands(11)
    js, ts = _cols(src, *ops[src])
    jt, tt = _dtypes(dst)
    _same(JS.cast(js, jt), TS.cast(ts, tt))


def test_decimal_rescale_rounds_toward_floor_like_reference():
    """Decimal scale-down is floor division in both packages (negative
    values round toward minus infinity)."""
    data = np.array([-12345, -5, 5, 12345, -100], np.int64)
    js, ts = _cols("dec:4", data, np.ones(5, bool))
    _same(JS.cast(js, jdt.decimal64(15, 2)), TS.cast(ts, tdt.decimal64(15, 2)))
    assert TS.cast(ts, tdt.decimal64(15, 2)).data.tolist() == \
        [-124, -1, 0, 123, -1]


def test_jax_x64_is_on():
    """The reference runs with x64: its float literals are f64."""
    assert jax.config.jax_enable_x64
