"""The port's host library against the JAX package's, on the CPU.

`matrixone_tpu_torch.native` is the port's own copy of the parts of the
JAX package's host library it calls, built from its own source into
`build/torch_native/`.  Held here, with the C library and again with
the numpy fallbacks: `hash64` bit for bit against
`matrixone_tpu.native.hash64` and the port's device hash; the bloom
filter with no false negatives, a false-positive rate within the
reference test's bound (5% at 10 bits an item), and the same bits as
the reference's filter; the roaring bitmap's `test`, `test_range`,
`and_`, `or_` and `count` equal to the reference's (the scenarios of
tests/test_native.py and tests/test_roaring.py); the scan's keep masks
equal to the sorted dead set's, bit for bit; and the tombstoned scan and
the primary-key check through the SQL session.
"""

import numpy as np
import pytest
import torch

from matrixone_tpu import native as jnative
from matrixone_tpu_torch import native as tnative
from matrixone_tpu_torch.ops import hash as H
from matrixone_tpu_torch.storage import engine as TE
from matrixone_tpu_torch.utils import metrics as TM
from torch_compare import (assert_same, reference_compiled,  # noqa: F401
                           reference_env, session)

ROUTES = ["c", "numpy"]


@pytest.fixture()
def rng():
    return np.random.default_rng(7)


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """Each test once over the compiled library and once over the numpy
    fallbacks."""
    if request.param == "numpy":
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    else:
        assert tnative.get_lib() is not None, "g++ is here: must build"
    return request.param


def test_library_builds_into_its_own_directory():
    assert tnative.route() == "c"
    assert tnative._SO.endswith("build/torch_native/libmo_native.so")
    assert "matrixone_tpu_torch" in tnative._SRC


def test_hash64_equals_the_reference_and_the_device(rng, route):
    vals = rng.integers(-2 ** 63, 2 ** 63 - 1, 5000, dtype=np.int64)
    vals[:3] = [0, -1, np.iinfo(np.int64).min]
    got = tnative.hash64(vals)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, jnative.hash64(vals))
    dev = H.hash_column(torch.from_numpy(vals)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, dev)


def test_bloom_no_false_negatives_and_bounded_false_positives(rng, route):
    keys = rng.integers(0, 10 ** 12, 5000)
    bf = tnative.BloomFilter(len(keys))
    bf.add_int64(keys)
    assert bf.probe_int64(keys).all()          # zero false negatives
    other = rng.integers(10 ** 13, 10 ** 14, 5000)
    fpr = bf.probe_int64(other).mean()
    assert fpr < 0.05                          # the reference test's bound
    ref = jnative.BloomFilter(len(keys))
    ref.add_int64(keys)
    np.testing.assert_array_equal(bf.bits, ref.bits)
    np.testing.assert_array_equal(bf.probe_int64(other),
                                  ref.probe_int64(other))


def test_sorted_contains(rng, route):
    hay = np.unique(rng.integers(0, 100000, 5000))
    ids = rng.integers(0, 100000, 2000)
    got = tnative.sorted_contains(hay, ids)
    np.testing.assert_array_equal(got, np.isin(ids, hay))
    np.testing.assert_array_equal(got, jnative.sorted_contains(hay, ids))
    assert not tnative.sorted_contains(np.array([], np.int64), ids).any()


@pytest.mark.parametrize("density", [0.0005, 0.01, 0.3])
def test_roaring_test_and_ranges_equal_the_reference(rng, route, density):
    domain = 1 << 20
    ids = np.unique(rng.integers(0, domain, int(domain * density)))
    got, ref = tnative.RoaringBitmap(ids), jnative.RoaringBitmap(ids)
    assert got.count() == ref.count() == len(ids)
    probes = rng.integers(0, domain, 5000)
    np.testing.assert_array_equal(got.test(probes), ref.test(probes))
    np.testing.assert_array_equal(got.test(probes), np.isin(probes, ids))
    for lo, n in ((int(rng.integers(0, domain - 70000)), 70000),
                  (0, 1), (domain - 5, 10), (65530, 12)):
        np.testing.assert_array_equal(got.test_range(lo, lo + n),
                                      ref.test_range(lo, lo + n))
    np.testing.assert_array_equal(got.to_array(), np.sort(ids))


def test_roaring_set_operations_equal_the_reference(rng, route):
    a_ids = np.unique(rng.integers(0, 1 << 18, 4000))
    b_ids = np.unique(rng.integers(0, 1 << 18, 150000))  # dense containers
    for op, want in (("and_", np.intersect1d(a_ids, b_ids)),
                     ("or_", np.union1d(a_ids, b_ids))):
        got, ref = tnative.RoaringBitmap(a_ids), jnative.RoaringBitmap(a_ids)
        getattr(got, op)(tnative.RoaringBitmap(b_ids))
        getattr(ref, op)(jnative.RoaringBitmap(b_ids))
        np.testing.assert_array_equal(got.to_array(), want)
        np.testing.assert_array_equal(got.to_array(), ref.to_array())
        assert got.count() == ref.count() == len(want)


def test_roaring_duplicates_and_negatives(route):
    rbm = tnative.RoaringBitmap([5, 5, 5, -1, -99, 70000, 70000])
    assert rbm.count() == 2
    assert rbm.test([5, -1, 70000, 6]).tolist() == [True, False, True,
                                                    False]


def test_roaring_memory_under_10pct_of_dense_at_low_density(
        rng, reference_compiled):
    domain = 10_000_000
    ids = np.unique(rng.integers(0, domain, int(domain * 0.001)))
    rbm = tnative.RoaringBitmap(ids)
    assert rbm.nbytes() / (domain // 8) < 0.10
    assert rbm.nbytes() == jnative.RoaringBitmap(ids).nbytes()


def _sorted_keep(dead: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """The keep mask the scan took before the bitmap: the gids [lo, hi)
    not in the sorted unique dead set, by two binary searches."""
    keep = np.ones(hi - lo, np.bool_)
    i0, i1 = np.searchsorted(dead, [lo, hi], side="left")
    keep[dead[i0:i1] - lo] = False
    return keep


def test_scan_keep_masks_equal_the_sorted_dead_set(rng, route):
    """The scan's keep mask from the roaring bitmap equals the one the
    sorted dead set gave, bit for bit, on chunk ranges across and
    between containers."""
    dead = rng.integers(0, 1 << 21, 60000)
    dead[:100] = np.arange(1 << 16, (1 << 16) + 100)
    rbm = tnative.RoaringBitmap(dead)
    srt = np.unique(dead)
    for lo in (0, 4096, (1 << 16) - 50, 1 << 20, (1 << 21) - 1000):
        for n in (1, 1000, 1 << 16, 100_000):
            np.testing.assert_array_equal(~rbm.test_range(lo, lo + n),
                                          _sorted_keep(srt, lo, lo + n))


def test_tombstoned_scan_equals_the_reference(reference_env):  # noqa: F811
    """tests/test_roaring.py's deletes at scale through both sessions:
    scattered tombstones and a tail run, scanned over 4096-row chunks."""
    vals = ",".join(f"({i},{i % 97})" for i in range(30000))
    got, port = assert_same([
        "create table t (id bigint primary key, v bigint)",
        f"insert into t values {vals}",
        "delete from t where v % 7 = 3",
        "delete from t where id >= 29990",
        "select count(*), sum(id) from t",
        "select count(*) from t where id between 100 and 200",
        "set batch_rows = 4096",
        "select count(*), sum(id), min(id), max(id) from t",
    ])
    expect = [i for i in range(30000) if (i % 97) % 7 != 3 and i < 29990]
    assert got[4][2] == [(len(expect), sum(expect))]


def test_primary_key_check_probes_the_bloom_first(reference_env):  # noqa: F811
    """New keys pass with few suspects; a live key raises
    DuplicateKeyError with the message the unfiltered check gave; a
    deleted key is accepted again; a composite key is verified against
    the real tuple."""
    port = session("port")
    port.execute("create table k (id bigint primary key, v bigint)")
    port.execute("insert into k values "
                 + ",".join(f"({i},{i})" for i in range(0, 20000, 2)))
    s0 = TM.pk_bloom_suspects.get()
    port.execute("insert into k values "
                 + ",".join(f"({i},{i})" for i in range(1, 2001, 2)))
    assert TM.pk_bloom_suspects.get() - s0 < 100
    with pytest.raises(TE.DuplicateKeyError,
                       match=r"^duplicate key 4 for 'k'\.id$"):
        port.execute("insert into k values (4, 0)")
    port.execute("delete from k where id = 4")
    port.execute("insert into k values (4, 1)")
    assert port.execute("select v from k where id = 4").rows() == [(1,)]
    assert_same([
        "create table c (a bigint, b bigint, v bigint, primary key (a, b))",
        "insert into c values (1, 1, 0), (1, 2, 0), (2, 1, 0)",
        "!insert into c values (1, 2, 5)",
        "insert into c values (2, 2, 5)",
        "delete from c where a = 1 and b = 2",
        "insert into c values (1, 2, 7)",
        "select a, b, v from c order by a, b",
        "create table s (name varchar(10) primary key, v bigint)",
        "insert into s values ('x', 1), ('y', 2)",
        "!insert into s values ('y', 3)",
        "select count(*) from s",
    ])
