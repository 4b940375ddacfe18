"""Object-backed segments and the two-tier block cache, on the CPU.

The scenarios of tests/test_out_of_core.py (all six), tests/
test_device_cache.py (all seven) and tests/test_scan_hotpath.py:92-160
run through both packages, each on a LocalFS of its own
(`torch_storage_pkgs.run_both`): the rows of every query must be equal,
and where both read the same columns the block cache's counters too
(hits, misses, uploads, entries of both tiers).  The port's device tier
holds CPU tensors here, as the reference's holds arrays of its CPU
backend, so the counters behave as they do there.  The reference's
ranged-read test runs on its S3 fake; here a LocalFS that counts the
bytes it serves stands in (the port has no S3).
"""

import os

import numpy as np
import pytest
import torch

from matrixone_tpu_torch.storage import blockcache as tbc
from matrixone_tpu_torch.storage import objectio
from matrixone_tpu_torch.storage.fileservice import LocalFS
from torch_storage_pkgs import run_both, storage_env  # noqa: F401

pytestmark = pytest.mark.usefixtures("storage_env")

#: the counters both packages keep alike for a scan-only workload
SAME = ("hits", "misses", "entries", "uploaded_bytes", "bytes_fetched")
SAME_DEV = ("hits", "misses", "entries", "used_bytes", "evictions")


def _same_counters(out):
    j, p = out["jax"], out["port"]
    for k in SAME:
        assert p[k] == j[k], (k, p[k], j[k])
    for k in SAME_DEV:
        assert p["device_tier"][k] == j["device_tier"][k], \
            (k, p["device_tier"], j["device_tier"])
    assert p["host_tier"]["entries"] == j["host_tier"]["entries"]


def _bulk(pkg, s, name, n, batches, seed=7, pk=True):
    """`name` (id [pk], grp, val, x) from seeded numpy, `batches`
    commits of n rows each."""
    s.execute(f"create table {name} (id bigint{' primary key' if pk else ''}"
              ", grp bigint, val bigint, x double)")
    rng = np.random.default_rng(seed)
    t = s.catalog.get_table(name)
    for b in range(batches):
        ids = np.arange(b * n, (b + 1) * n, dtype=np.int64)
        t.insert_numpy({"id": ids, "grp": ids % 50,
                        "val": rng.integers(0, 1000, n),
                        "x": np.round(rng.standard_normal(n), 6)})


# ----------------------------------------------- tests/test_out_of_core.py

@pytest.mark.parametrize("prefetch", ["auto", "0"])
def test_scan_larger_than_cache_budget(tmp_path, monkeypatch, prefetch):
    """A 0 MB budget evicts at every admission.  With the read-ahead on,
    which lookups still find their column then depends on the two
    threads' timing, so the counters are compared with it off."""
    if prefetch != "auto":
        monkeypatch.setenv("MO_SCAN_PREFETCH", prefetch)

    def scenario(pkg):
        s = pkg.session(pkg.Engine(pkg.local()))
        _bulk(pkg, s, "big", 4000, 6)
        want_sum = pkg.rows(s, "select sum(val) from big")
        want_grp = pkg.rows(s, "select grp, count(*), sum(val) from big"
                               " group by grp order by grp")
        s.catalog.checkpoint()
        monkeypatch.setenv("MO_BLOCK_CACHE_MB", "0")   # evict always
        pkg.blockcache.CACHE.clear()
        pkg.blockcache.CACHE.peak_bytes = 0
        eng2 = pkg.Engine.open(pkg.local())
        assert all(seg.is_lazy for seg in eng2.get_table("big").segments)
        s2 = pkg.session(eng2)
        assert pkg.rows(s2, "select sum(val) from big") == want_sum
        assert pkg.rows(s2, "select grp, count(*), sum(val) from big"
                            " group by grp order by grp") == want_grp
        st = pkg.blockcache.CACHE.stats()
        monkeypatch.delenv("MO_BLOCK_CACHE_MB")
        assert st["evictions"] > 0, "budget was never exercised"
        assert st["peak_bytes"] <= 2_000_000, st
        return st
    out = run_both(scenario, tmp_path)
    if prefetch != "auto":
        _same_counters(out)


def test_zonemap_prunes_before_fetch(tmp_path):
    def scenario(pkg):
        s = pkg.session(pkg.Engine(pkg.local()))
        s.execute("create table rng (id bigint primary key, v bigint)")
        t = s.catalog.get_table("rng")
        for lo in (0, 10_000, 20_000):             # disjoint id ranges
            ids = np.arange(lo, lo + 1000, dtype=np.int64)
            t.insert_numpy({"id": ids, "v": ids * 2})
        s.catalog.checkpoint()
        pkg.blockcache.CACHE.clear()
        s2 = pkg.session(pkg.Engine.open(pkg.local()))
        m0 = pkg.blockcache.CACHE.stats()["misses"]
        rows = pkg.rows(s2, "select v from rng where id >= 20000"
                            " order by id limit 3")
        assert [int(r[0]) for r in rows] == [40000, 40002, 40004]
        fetched = pkg.blockcache.CACHE.stats()["misses"] - m0
        assert fetched <= 2, f"zonemap prune fetched {fetched} columns"
        return fetched
    out = run_both(scenario, tmp_path)
    assert out["port"] == out["jax"]


def test_incremental_checkpoint_reuses_objects(tmp_path):
    def scenario(pkg):
        s = pkg.session(pkg.Engine(pkg.local()))
        s.execute("create table t (id bigint primary key, v bigint)")
        s.execute("insert into t values (1, 10), (2, 20)")
        s.catalog.checkpoint()
        p = os.path.join(pkg.root, "store", "objects", "t", "seg0.obj")
        mtime1 = os.stat(p).st_mtime_ns
        s.execute("insert into t values (3, 30)")
        s.catalog.checkpoint()
        assert os.stat(p).st_mtime_ns == mtime1, \
            "checkpoint rewrote an unchanged object"
        assert os.path.exists(os.path.join(pkg.root, "store", "objects",
                                           "t", "seg1.obj"))
        s2 = pkg.session(pkg.Engine.open(pkg.local()))
        assert sorted(int(r[0]) for r in
                      pkg.rows(s2, "select id from t order by id")) == \
            [1, 2, 3]
    run_both(scenario, tmp_path)


class _CountingFS(LocalFS):
    """LocalFS counting the bytes its reads serve."""
    served = 0

    def read(self, path):
        b = super().read(path)
        self.served += len(b)
        return b

    def read_range(self, path, offset, length):
        b = super().read_range(path, offset, length)
        self.served += len(b)
        return b


def test_column_granular_ranged_reads(tmp_path):
    """One column's fetch reads that column's blocks, not the object:
    the ranged-read path (the reference proves it on its S3 fake)."""
    fs = _CountingFS(str(tmp_path))
    n = 10_000
    arrays = {"a": np.arange(n, dtype=np.int64),
              "b": np.arange(n, dtype=np.float64) * 1.5,
              "wide": np.zeros(n, dtype=np.int64)}
    validity = {c: np.ones(n, np.bool_) for c in arrays}
    meta = objectio.ObjectMeta(
        table="t", object_id="o1", n_rows=n, commit_ts=1,
        zonemaps=objectio.compute_zonemaps(arrays, validity))
    path = objectio.write_object(fs, meta, arrays, validity)
    total = os.path.getsize(tmp_path / path)
    m2, raw = objectio.read_header_ranged(fs, path)
    assert m2.n_rows == n and "cols" in raw
    fs.served = 0
    b, vb = objectio.read_column_block(fs, path, raw, "b")
    np.testing.assert_array_equal(b, arrays["b"])
    assert vb.all()
    assert fs.served <= 9 * n + 128 < total / 2
    m3, a3, _v3 = objectio.read_object(fs, path)
    np.testing.assert_array_equal(a3["a"], arrays["a"])
    # the block cache fetches one column per miss the same way
    tbc.CACHE.clear()
    d, _vv = tbc.lazy_pair(fs, path, list(arrays))
    fs.served = 0
    assert d["wide"].sum() == 0
    assert fs.served <= (64 << 10) + 9 * n + 128   # header + one column


def test_lazy_segments_survive_dml_and_merge(tmp_path):
    def scenario(pkg):
        s = pkg.session(pkg.Engine(pkg.local()))
        s.execute("create table t (id bigint primary key, v bigint)")
        t = s.catalog.get_table("t")
        for lo in (0, 1000):
            ids = np.arange(lo, lo + 1000, dtype=np.int64)
            t.insert_numpy({"id": ids, "v": ids})
        s.catalog.checkpoint()
        eng2 = pkg.Engine.open(pkg.local())
        s2 = pkg.session(eng2)
        s2.execute("delete from t where id < 500")
        s2.execute("update t set v = v + 1 where id >= 1900")
        assert int(pkg.rows(s2, "select count(*) from t")[0][0]) == 1500
        assert eng2.merge_table("t") == 1500
        assert int(pkg.rows(s2, "select sum(v) from t")[0][0]) == \
            sum(range(500, 1900)) + sum(i + 1 for i in range(1900, 2000))
        eng2.checkpoint()
        s3 = pkg.session(pkg.Engine.open(pkg.local()))
        assert int(pkg.rows(s3, "select count(*) from t")[0][0]) == 1500
        pkg.rows(s3, "select id, v from t where id >= 1895 order by id")
    run_both(scenario, tmp_path)


def test_writer_demotes_segments_on_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("MO_LAZY_SEGMENTS", "1")

    def scenario(pkg):
        s = pkg.session(pkg.Engine(pkg.local()))
        s.execute("create table t (id bigint primary key, v bigint)")
        s.execute("insert into t values (1, 1), (2, 2)")
        s.catalog.checkpoint()
        t = s.catalog.get_table("t")
        assert all(seg.is_lazy for seg in t.segments)
        s.execute("insert into t values (3, 3)")
        assert not t.segments[-1].is_lazy
        assert sorted(int(r[0]) for r in
                      pkg.rows(s, "select id from t order by id")) == \
            [1, 2, 3]
        assert int(pkg.rows(s, "select sum(v) from t where id <= 2"
                            )[0][0]) == 3
        # the key check reads the demoted segment's host columns
        with pytest.raises(Exception) as e:
            s.execute("insert into t values (2, 9)")
        return type(e.value).__name__
    out = run_both(scenario, tmp_path)
    assert out["port"] == out["jax"] == "DuplicateKeyError"


# ---------------------------------------------- tests/test_device_cache.py

ROWS_PER_BATCH = 20_000
BATCHES = 3
GROUP_SQL = ("select grp, count(*), sum(val) from big group by grp "
             "order by grp")


def _build(pkg, sub="dc", rows=ROWS_PER_BATCH):
    """3 x `rows` rows x 3 bigint columns, checkpointed (~1.4 MB decoded
    at 20000: past a 1 MB device budget)."""
    s = pkg.session(pkg.Engine.open(pkg.local(sub)))
    s.execute("create table big (id bigint, grp bigint, val bigint)")
    t = s.catalog.get_table("big")
    for b in range(BATCHES):
        ids = np.arange(b * rows, (b + 1) * rows, dtype=np.int64)
        t.insert_numpy({"id": ids, "grp": ids % 7, "val": ids * 3})
    s.catalog.checkpoint()
    s.close()


def _reopened(pkg, sub="dc"):
    pkg.blockcache.CACHE.clear()
    pkg.blockcache.CACHE.reset_stats()
    eng2 = pkg.Engine.open(pkg.local(sub))
    assert all(seg.is_lazy for seg in eng2.get_table("big").segments)
    return eng2, pkg.session(eng2)


def test_warm_scan_is_device_resident_zero_upload(tmp_path):
    def scenario(pkg):
        _build(pkg)
        _eng, s2 = _reopened(pkg)
        want = pkg.rows(s2, GROUP_SQL)
        pkg.blockcache.CACHE.reset_stats()
        for _ in range(3):
            assert pkg.rows(s2, GROUP_SQL) == want
        st = pkg.blockcache.CACHE.stats()
        dev = st["device_tier"]
        assert st["uploaded_bytes"] == 0, st
        assert st["decode_seconds"] == 0.0, st
        assert dev["hit_rate"] is not None and dev["hit_rate"] >= 0.99
        assert dev["entries"] > 0 and dev["used_bytes"] > 0, dev
        if pkg.name == "port":
            t = next(iter(pkg.blockcache.CACHE._dev.values()))
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        return st
    _same_counters(run_both(scenario, tmp_path))


def test_stats_split_host_vs_device_tier(tmp_path):
    def scenario(pkg):
        _build(pkg)
        _eng, s2 = _reopened(pkg)
        pkg.rows(s2, "select sum(val) from big")
        st = pkg.blockcache.CACHE.stats()
        host, dev = st["host_tier"], st["device_tier"]
        assert st["used_bytes"] == host["used_bytes"] + dev["used_bytes"]
        assert host["entries"] == st["entries"] > 0
        assert host["budget_bytes"] == dev["budget_bytes"] == 256 << 20
        assert dev["entries"] == host["entries"]
        assert dev["used_bytes"] >= host["used_bytes"]
        assert st["peak_bytes"] >= st["used_bytes"]
        return st
    _same_counters(run_both(scenario, tmp_path))


def test_device_budget_zero_means_no_pinning(tmp_path, monkeypatch):
    monkeypatch.setenv("MO_DEVICE_CACHE_MB", "0")

    def scenario(pkg):
        _build(pkg)
        _eng, s2 = _reopened(pkg)
        want = pkg.rows(s2, "select sum(val) from big")
        pkg.blockcache.CACHE.reset_stats()
        assert pkg.rows(s2, "select sum(val) from big") == want
        st = pkg.blockcache.CACHE.stats()
        assert st["device_tier"]["entries"] == 0, st
        assert st["uploaded_bytes"] > 0, st
        assert st["decode_seconds"] == 0.0, st
        assert st["hit_rate"] is not None and st["hit_rate"] >= 0.99, st
        return st
    _same_counters(run_both(scenario, tmp_path))


def test_device_eviction_under_pressure_budget_holds(tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("MO_DEVICE_CACHE_MB", "1")

    def scenario(pkg):
        _build(pkg)
        _eng, s2 = _reopened(pkg)
        q = "select grp, sum(val) from big group by grp order by grp"
        want = pkg.rows(s2, q)
        for _ in range(2):
            assert pkg.rows(s2, q) == want
            dev = pkg.blockcache.CACHE.stats()["device_tier"]
            assert dev["used_bytes"] <= 1 << 20, dev
        st = pkg.blockcache.CACHE.stats()
        dev = st["device_tier"]
        assert dev["evictions"] > 0, "device budget was never exercised"
        assert dev["peak_bytes"] <= 1 << 20, dev
        assert st["host_tier"]["evictions"] == 0
        return st
    _same_counters(run_both(scenario, tmp_path))


def test_mutations_invalidate_warm_device_cache(tmp_path):
    def scenario(pkg):
        _build(pkg, "mut", rows=3000)
        _eng2, s2 = _reopened(pkg, "mut")

        def total():
            return pkg.rows(s2, "select count(*), sum(val) from big")[0]

        n0, sum0 = total()
        assert pkg.blockcache.CACHE.stats()["device_tier"]["entries"] > 0
        s2.execute("insert into big values (900001, 1, 5), (900002, 2, 7)")
        assert total() == (n0 + 2, sum0 + 12)
        s2.execute("delete from big where id = 900001")
        assert total() == (n0 + 1, sum0 + 7)
        s2.execute("update big set val = 17 where id = 900002")
        assert total() == (n0 + 1, sum0 + 17)
        s2.catalog.checkpoint()
        s2.catalog.merge_table("big")
        assert total() == (n0 + 1, sum0 + 17)
        assert total() == (n0 + 1, sum0 + 17)   # warm again, post-merge
        s2.execute("drop table big")
        s2.execute("create table big (id bigint, grp bigint, val bigint)")
        s2.execute("insert into big values (1, 1, 42)")
        assert total() == (1, 42)
    run_both(scenario, tmp_path)


def test_drop_path_purges_both_tiers():
    c = tbc.BlockCache()
    a = np.arange(64, dtype=np.int64)
    for tok in (1, 2):
        c.put((tok, "objects/t/dead.obj", "v", "data"), a, device="cpu")
    c.put((1, "objects/t/live.obj", "v", "data"), a, device="cpu")
    assert c.contains((1, "objects/t/dead.obj", "v", "data"))
    c.drop_path("objects/t/dead.obj")
    for tok in (1, 2):
        assert not c.contains((tok, "objects/t/dead.obj", "v", "data"))
    assert c.contains((1, "objects/t/live.obj", "v", "data"))
    st = c.stats()
    assert st["entries"] == 1
    assert st["device_tier"]["entries"] == 1
    assert st["used_bytes"] == st["host_tier"]["used_bytes"] + \
        st["device_tier"]["used_bytes"]


def test_contains_probe_counts_nothing():
    c = tbc.BlockCache()
    c.put((1, "objects/t/x.obj", "v", "data"),
          np.arange(16, dtype=np.int64), device="cpu")
    before = c.stats()
    assert c.contains((1, "objects/t/x.obj", "v", "data"))
    assert not c.contains((1, "objects/t/x.obj", "w", "data"))
    after = c.stats()
    assert (after["hits"], after["misses"]) == (before["hits"],
                                                before["misses"])
    assert after["uploaded_bytes"] == before["uploaded_bytes"]


def test_host_readers_get_numpy_and_the_scan_tensors(tmp_path):
    """The port's split: `seg.arrays[c]` is the host array (the key
    check, merges and fetch_rows read it), `seg.arrays.device(c, dev)`
    the device tier's tensor; a prefetched cold scan counts as the
    reference's does."""
    from torch_storage_pkgs import packages
    pkg = packages(tmp_path)[1]
    _build(pkg, rows=2000)
    eng, s = _reopened(pkg)
    seg = eng.get_table("big").segments[0]
    assert isinstance(seg.arrays["val"], np.ndarray)
    t = seg.arrays.device("val", "cpu")
    assert isinstance(t, torch.Tensor) and t.dtype == torch.int64
    assert np.array_equal(t.numpy(), seg.arrays["val"])
    assert eng.get_table("big").fetch_rows(np.array([5, 4001]),
                                           ["val"])[0]["val"].tolist() == \
        [15, 12003]


# --------------------------------------- tests/test_scan_hotpath.py:92-160

def test_object_backed_scan_across_batch_boundaries(tmp_path):
    def scenario(pkg):
        s = pkg.session(pkg.Engine(pkg.fs.MemoryFS()))
        n = 30_000
        s.execute("create table bb (id bigint primary key, grp varchar(4),"
                  " val bigint)")
        rng = np.random.default_rng(11)
        grp_cats = ["aa", "bb", "cc"]
        grp = rng.integers(0, 3, n).astype(np.int32)
        val = rng.integers(0, 100_000, n).astype(np.int64)
        t = s.catalog.get_table("bb")
        t.insert_numpy({"id": np.arange(n, dtype=np.int64), "val": val},
                       strings={"grp": (grp, grp_cats)})
        dead_ids = [4095, 4096, 4097, 8191, 8192] + list(range(12_000,
                                                              13_000))
        s.execute("delete from bb where id in (%s)"
                  % ",".join(str(i) for i in dead_ids))
        s.catalog.checkpoint(demote=True)
        assert all(seg.is_lazy for seg in s.catalog.get_table("bb").segments)
        s.variables["batch_rows"] = 4096
        got = pkg.rows(s, "select grp, count(*), sum(val) from bb"
                          " group by grp order by grp")
        alive = np.ones(n, bool)
        alive[dead_ids] = False
        expect = []
        for gi, g in enumerate(grp_cats):
            m = alive & (grp == gi)
            expect.append((g, int(m.sum()), int(val[m].sum())))
        assert got == expect
        got_rows = pkg.rows(s, "select id, val from bb where id >= 4090"
                               " and id <= 4100 order by id")
        assert got_rows == [(int(i), int(val[i])) for i in range(4090, 4101)
                            if alive[i]]
    run_both(scenario, tmp_path)


def test_dense_group_path_matches_general_path(tmp_path, monkeypatch):
    def scenario(pkg):
        s = pkg.session(pkg.Engine(pkg.fs.MemoryFS()))
        s.execute("create table dg (k varchar(4), b bool, v bigint,"
                  " f double)")
        rng = np.random.default_rng(5)
        vals = []
        for _ in range(5_000):
            k = ["'x'", "'y'", "'z'", "null"][rng.integers(0, 4)]
            b = ["true", "false", "null"][rng.integers(0, 3)]
            v = str(int(rng.integers(-1000, 1000))) \
                if rng.integers(0, 10) else "null"
            f = f"{rng.normal():.4f}" if rng.integers(0, 10) else "null"
            vals.append(f"({k},{b},{v},{f})")
        s.execute("insert into dg values " + ",".join(vals))
        s.catalog.checkpoint(demote=True)
        q = ("select k, b, count(*), count(v), sum(v), avg(v), avg(f),"
             " stddev_pop(f) from dg group by k, b order by k, b")
        monkeypatch.delenv("MO_DENSE_GROUPS", raising=False)
        fast = s.execute(q).rows()
        monkeypatch.setenv("MO_DENSE_GROUPS", "0")
        slow = s.execute(q).rows()
        monkeypatch.delenv("MO_DENSE_GROUPS")
        assert len(fast) == len(slow)
        for rf, rs in zip(fast, slow):
            assert rf[:5] == rs[:5]
            for a, b_ in zip(rf[5:], rs[5:]):
                if a is None or b_ is None:
                    assert a == b_
                else:
                    assert a == pytest.approx(b_, rel=1e-9, abs=1e-9)
        return fast
    out = run_both(scenario, tmp_path)
    for rp, rj in zip(out["port"], out["jax"]):
        assert rp[:5] == rj[:5]
        for a, b_ in zip(rp[5:], rj[5:]):
            assert (a is None and b_ is None) or \
                a == pytest.approx(b_, rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("read_ahead", [False, True])
def test_device_chunks_are_the_host_chunks(tmp_path, read_ahead):
    """`iter_chunks(device=...)` keeps the chunks the host path keeps:
    the same sizes (the zonemaps read the host tier, after the keep
    masks), and the same values once its DeviceRefs are served, with
    tombstones straddling chunks and a filter that prunes some."""
    from matrixone_tpu_torch.sql import expr as E
    from matrixone_tpu_torch.container import dtypes as D
    from matrixone_tpu_torch.storage.engine import resolve_chunk
    from torch_storage_pkgs import packages
    pkg = packages(tmp_path)[1]
    eng = pkg.Engine(pkg.local())
    s = pkg.session(eng)
    _bulk(pkg, s, "big", 5000, 3)
    s.execute("delete from big where id % 997 = 3 or (id >= 4000 and "
              "id < 6100)")
    eng.checkpoint(demote=True)
    t = eng.get_table("big")
    cols = ["id", "val", "x"]
    filt = [E.BoundFunc("ge", [E.BoundCol("big.id", D.INT64),
                               E.BoundLiteral(6000, D.INT64)], D.BOOL)]
    kw = dict(filters=filt, qualified_names=[f"big.{c}" for c in cols])
    host = list(t.iter_chunks(cols, 1024, **kw))
    dev = list(t.iter_chunks(cols, 1024, device="cpu",
                             read_ahead=read_ahead, **kw))
    assert [c[3] for c in dev] == [c[3] for c in host]
    assert len(host) < 3 * 5 and host
    for (ha, hv, _d, _n), (da, dv, _d2, _n2) in zip(host, dev):
        ra, rv = resolve_chunk(da, dv, "cpu")
        for c in cols:
            assert isinstance(ra[c], torch.Tensor)
            assert np.array_equal(ra[c].numpy(), ha[c])
            assert np.array_equal(rv[c].numpy(), hv[c])
